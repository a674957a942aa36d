"""renderer_idle_ms.render (ms/frame): the device's idle gaps in the
profiled frames whose midpoint falls inside the program's ``nerf/frame``
span on the host (the frame renderer's own bubbles, such as its host
reads), per frame; idle elsewhere (the pipeline's callbacks, host copies)
is left to ``idle_share.render``.  Layer: the frame renderer and
occupancy.  Nothing is read where the trace holds no ``nerf/`` span."""
from port_bench.harness.spans import spans_of


def read(rec):
    sp = spans_of(rec.get("trace"))
    if rec.get("kind") != "render" or sp is None or not rec["trace_frames"] \
            or not sp.named("frame"):
        return None
    return 1e3 * sp.idle_inside("frame") / rec["trace_frames"]
