"""ngp_mlp_ms.train (ms/step): the device time of the NGP field's fused
MLP launches (``ngp_mlp_fwd_kernel``, ``ngp_mlp_bwd_kernel`` and its
``ngp_mlp_reduce_kernel``: one of each a step) in the profiled chunks,
per step.  Layer: the kernels, ``kernels/ngp_mlp``.  Nothing is read
where the three launch counters disagree with the profiled steps (a
program without them has none)."""
KERNELS = ("ngp_mlp_fwd_kernel", "ngp_mlp_bwd_kernel",
           "ngp_mlp_reduce_kernel")
FWD, BWD, REDUCE = 16, 17, 18                      # LAUNCH_COUNTERS' order


def read(rec):
    tr = rec.get("trace")
    if rec.get("kind") != "train" or rec.get("arch") != "ngp" or tr is None:
        return None
    steps, counts = rec["trace_steps"], rec["trace_launches"]
    if len(counts) <= REDUCE or not steps \
            or any(counts[i] != steps for i in (FWD, BWD, REDUCE)):
        return None
    busy, n = tr.time_of(KERNELS)
    if n != len(KERNELS) * steps:
        return None
    return 1e3 * busy / steps
