"""march_ms.train (ms/step): the device time of the NGP marcher's
launches (``march_count_kernel``, ``march_scan_kernel``,
``march_compact_kernel``: one of each a step) in the profiled chunks, per
step.  Layer: the train step, ``kernels/ngp_march``.  Nothing is read
where the launch counter disagrees with the profiled steps."""
MARCH = 13                                          # LAUNCH_COUNTERS' order


def read(rec):
    tr = rec.get("trace")
    if rec.get("kind") != "train" or rec.get("arch") != "ngp" or tr is None:
        return None
    steps, counts = rec["trace_steps"], rec["trace_launches"]
    if len(counts) <= MARCH or counts[MARCH] != steps or not steps:
        return None
    busy, n = tr.time_of(rec["march_kernels"])
    if n != 3 * steps:
        return None
    return 1e3 * busy / steps
