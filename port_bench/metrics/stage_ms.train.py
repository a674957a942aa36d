"""stage_ms.train (ms/step): the device time of the ops launched inside
the program's ``nerf/step.stage`` spans (``train/chunk.StagedSteps._stage``:
a step's draws and its slot copies, outside the captured graph) in the
profiled chunks, per step.  Layer: the train loop.  Nothing is read where
the trace holds no ``nerf/`` span."""
from port_bench.harness.spans import spans_of


def read(rec):
    sp = spans_of(rec.get("trace"))
    if rec.get("kind") != "train" or sp is None or not rec["trace_steps"] \
            or not sp.named("step.stage"):
        return None
    return 1e3 * sp.device_s(["step.stage"]) / rec["trace_steps"]
