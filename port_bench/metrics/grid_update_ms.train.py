"""grid_update_ms.train (ms/step): the device time of the ops launched
inside the program's ``nerf/ngp.grid_update`` spans (the occupancy grid's
update between chunks: the cells' density through the hash encoding and
the density MLP, the decay, the maximum and the threshold) in the
profiled chunks, per step.  Layer: the train loop.  Nothing is read where
the trace holds no such span."""
from port_bench.harness.spans import spans_of


def read(rec):
    sp = spans_of(rec.get("trace"))
    if rec.get("kind") != "train" or rec.get("arch") != "ngp" or sp is None \
            or not rec["trace_steps"] or not sp.named("ngp.grid_update"):
        return None
    return 1e3 * sp.device_s(["ngp.grid_update"]) / rec["trace_steps"]
