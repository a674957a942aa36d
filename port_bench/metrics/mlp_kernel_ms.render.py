"""mlp_kernel_ms.render (ms/frame): the device time of the ray kernels'
launches (``sigma_rays_wgmma_kernel``: K3, or K4 gated;
``eval_rays_wgmma_kernel``: K1, or K5 gated) in the profiled frames, per
frame.  Layer: the kernels, ``kernels/fused_mlp``."""


def read(rec):
    tr = rec.get("trace")
    if rec.get("kind") != "render" or tr is None or not rec["trace_frames"]:
        return None
    busy, n = tr.time_of(rec["mlp_kernels"])
    if n == 0:
        return None
    return 1e3 * busy / rec["trace_frames"]
