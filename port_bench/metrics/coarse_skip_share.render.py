"""coarse_skip_share.render (%): the skipped share of the coarse pass's
(128-ray tile, 8-sample row) blocks under the pre-cull
(``renderer.stats`` ``gate_frac_coarse``), averaged over the window's
frames.  Layer: the frame renderer and occupancy.  Nothing is read
where no frame was pre-culled."""
import math


def read(rec):
    vals = [s["gate_frac_coarse"] for s in rec.get("stats") or []
            if not math.isnan(s["gate_frac_coarse"])]
    if rec.get("kind") != "render" or not vals:
        return None
    return 100.0 * sum(vals) / len(vals)
