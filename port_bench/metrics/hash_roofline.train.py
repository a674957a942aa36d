"""hash_roofline.train (%): the roofline time of the hash encoding's
forward and backward launches (``hash_encode_fwd_kernel``,
``hash_encode_bwd_kernel``: each point's bound, ``arch/ngp.
hash_point_bound_s``, times the points they encoded: the steps' samples
and the grid updates' cells) over their device time in the profiled
chunks.  The table gathers and atomics are not counted as device-memory
bytes (the tables fit the L2).  Layer: the kernels,
``kernels/hash_grid``.  Nothing is read where the launch counters
disagree with the profiled steps or the trace."""
from port_bench.harness.trace import kernel_function

FWD, FWD_POINTS, BWD, BWD_POINTS = 9, 10, 11, 12   # LAUNCH_COUNTERS' order


def read(rec):
    tr = rec.get("trace")
    if rec.get("kind") != "train" or rec.get("arch") != "ngp" or tr is None:
        return None
    steps, counts = rec["trace_steps"], rec["trace_launches"]
    if len(counts) <= BWD_POINTS or counts[BWD] != steps \
            or counts[FWD] < steps:
        return None
    names = set(rec["hash_fwd_kernels"]) | set(rec["hash_bwd_kernels"])
    n_fwd = sum(1 for n, _, _ in tr.ops
                if kernel_function(n) in rec["hash_fwd_kernels"])
    busy, n = tr.time_of(names)
    if n_fwd != counts[FWD] or n != counts[FWD] + counts[BWD] or busy <= 0:
        return None
    bound = (counts[FWD_POINTS] + counts[BWD_POINTS]) * rec["hash_point_s"]
    return 100.0 * bound / busy
