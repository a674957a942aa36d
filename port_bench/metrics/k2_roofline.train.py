"""k2_roofline.train (%): the roofline time of K2's backward (its chain,
weight-gradient and reduction launches; one backward for each pass a
step, ``harness/flops.k2_train_launch``) over their device time in the
profiled chunks.  Layer: the kernels, ``kernels/fused_mlp_vjp``.
Nothing is read where the profiled steps were gated (K6) or the launch
counter disagrees with the steps."""
from port_bench.harness.flops import roofline_s

BWD_RAYS, BWD_RAYS_GATED = 6, 7         # kernels.LAUNCH_COUNTERS' order


def read(rec):
    tr = rec.get("trace")
    if rec.get("kind") != "train" or tr is None:
        return None
    steps, counts = rec["trace_steps"], rec["trace_launches"]
    if counts[BWD_RAYS_GATED] or counts[BWD_RAYS] != 2 * steps:
        return None
    busy, n = tr.time_of(rec["k2_kernels"])
    if n < 2 * steps or busy <= 0:
        return None
    bound = steps * sum(roofline_s(f, b) for f, b in rec["k2_launches"])
    return 100.0 * bound / busy
