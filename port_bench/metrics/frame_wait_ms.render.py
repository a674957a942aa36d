"""frame_wait_ms.render (ms): the median over the profiled frames of the
time from the host's start of a ``nerf/frame`` span to the start of the
first device op launched inside it: how long a frame's work waited in the
device's queue behind the frame before it (frames are issued one ahead,
``eval/pipeline.pipelined_frames``).  Layer: the entry and loops.  Nothing
is read where the trace holds no ``nerf/`` span."""
import statistics

from port_bench.harness.spans import spans_of


def read(rec):
    sp = spans_of(rec.get("trace"))
    if rec.get("kind") != "render" or sp is None:
        return None
    waits = sp.first_op_waits("frame")
    return 1e3 * statistics.median(waits) if waits else None
