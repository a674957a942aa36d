"""ray_fit_share.train (%): the rays kept within the sample budget over
the rays drawn, in the timed window (the program's device counters,
``train/step.NGPCounters``, read once after the window).  Layer: the
train step, ``kernels/ngp_march``."""


def read(rec):
    w = rec.get("ngp_window") or {}
    if rec.get("kind") != "train" or not w.get("rays_drawn"):
        return None
    return 100.0 * w["rays_kept"] / w["rays_drawn"]
