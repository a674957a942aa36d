"""coarse_glue_ms.render (ms/frame): the device time of the ops launched
inside the culled renderer's ``nerf/frame.phase0`` and ``nerf/frame.phase1``
spans (``eval/frame``: ray generation, the stratified draw, the coarse
pass's span sort and compositing, the cull, the sort by sample need and
the frame's host read), less the ray kernels' (``mlp_kernel_ms.render``),
in the profiled frames, per frame.  Layer: the frame renderer and
occupancy.  Nothing is read where the trace holds no ``nerf/`` span."""
from port_bench.harness.render import MLP_KERNELS
from port_bench.harness.spans import spans_of
from port_bench.harness.trace import kernel_function

PHASES = ("frame.phase0", "frame.phase1")


def read(rec):
    sp = spans_of(rec.get("trace"))
    if rec.get("kind") != "render" or sp is None or not rec["trace_frames"] \
            or not sp.named("frame.phase1"):
        return None
    glue = sp.device_s(PHASES,
                       skip=lambda n: kernel_function(n) in MLP_KERNELS)
    return 1e3 * glue / rec["trace_frames"]
