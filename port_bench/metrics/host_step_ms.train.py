"""host_step_ms.train (ms/step): the host time inside the program's
``nerf/chunk`` spans (``train/chunk.StagedSteps.run``: staging, replays and
their launches; a graph launch blocks while the device's launch queue is
full) in the profiled chunks, per step: what the host spends to keep one
step's device time fed.  Layer: the train loop.  Nothing is read where
the trace holds no ``nerf/`` span."""
from port_bench.harness.spans import spans_of


def read(rec):
    sp = spans_of(rec.get("trace"))
    if rec.get("kind") != "train" or sp is None or not rec["trace_steps"] \
            or not sp.named("chunk"):
        return None
    return 1e3 * sp.host_s("chunk") / rec["trace_steps"]
