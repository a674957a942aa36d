"""sample_fill_share.train (%): the samples kept over the budget times
the steps, in the timed window (the program's device counters,
``train/step.NGPCounters``, read once after the window).  Layer: the
train step, ``kernels/ngp_march``."""


def read(rec):
    w = rec.get("ngp_window") or {}
    if rec.get("kind") != "train" or not w.get("rays_drawn") \
            or not rec.get("steps"):
        return None
    return 100.0 * w["samples_kept"] / (rec["budget"] * rec["steps"])
