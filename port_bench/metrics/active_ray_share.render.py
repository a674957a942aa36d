"""active_ray_share.render (%): the rays the culled renderer kept for
its fine pass (``renderer.stats`` ``n_act``), over every ray of the
window's frames.  Layer: the frame renderer and occupancy,
``eval/frame`` and ``ops/occupancy``."""


def read(rec):
    stats = rec.get("stats") or []
    if rec.get("kind") != "render" or not stats:
        return None
    H, W = rec["hw"]
    return 100.0 * sum(s["n_act"] for s in stats) / (len(stats) * H * W)
