"""fine_glue_ms.render (ms/frame): the device time of the ops launched
inside the culled renderer's ``nerf/frame.phase2`` spans (``eval/frame``:
the cover blocks' gathers, hierarchical sampling and its sort, the
truncation window, the gate-fine span sort, compositing and the scatter
into the frame), less the ray kernels' (``mlp_kernel_ms.render``), in the
profiled frames, per frame.  Layer: the frame renderer and occupancy.
Nothing is read where the trace holds no ``nerf/`` span."""
from port_bench.harness.render import MLP_KERNELS
from port_bench.harness.spans import spans_of
from port_bench.harness.trace import kernel_function


def read(rec):
    sp = spans_of(rec.get("trace"))
    if rec.get("kind") != "render" or sp is None or not rec["trace_frames"] \
            or not sp.named("frame.phase2"):
        return None
    glue = sp.device_s(["frame.phase2"],
                       skip=lambda n: kernel_function(n) in MLP_KERNELS)
    return 1e3 * glue / rec["trace_frames"]
