"""k1_roofline.train (%): the roofline time of K1's launches
(``eval_rays_wgmma_kernel``, the training forward: a coarse and a fine
launch a step, ``harness/flops.k1_train_launch``) over their device time
in the profiled chunks.  Layer: the kernels, ``kernels/fused_mlp``.
Nothing is read where the profiled steps were gated (K5 shares the
kernel) or the launch counter disagrees with the steps."""
from port_bench.harness.flops import roofline_s

EVAL_RAYS, EVAL_RAYS_GATED = 2, 3       # kernels.LAUNCH_COUNTERS' order


def read(rec):
    tr = rec.get("trace")
    if rec.get("kind") != "train" or tr is None:
        return None
    steps, counts = rec["trace_steps"], rec["trace_launches"]
    if counts[EVAL_RAYS_GATED] or counts[EVAL_RAYS] != 2 * steps:
        return None
    busy, n = tr.time_of(rec["k1_kernels"])
    if n != 2 * steps or busy <= 0:
        return None
    bound = steps * sum(roofline_s(f, b) for f, b in rec["k1_launches"])
    return 100.0 * bound / busy
