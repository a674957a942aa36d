"""idle_share.render (%): the profiled frames' window less the union of
the device's busy intervals, over the window.  Layer: the device."""


def read(rec):
    tr = rec.get("trace")
    if rec.get("kind") != "render" or tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
