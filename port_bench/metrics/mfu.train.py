"""mfu.train (%): the model operations of the window's steps
(``harness/flops.train_step_flop``: forward and backward of every sample
of both passes) over the window's seconds, as a share of one H100's
dense bf16 peak.  Layer: the train step, ``train/step`` and
``ops/render.render_rays_train``."""
from port_bench.harness.flops import PEAK_BF16_FLOPS


def read(rec):
    if rec.get("kind") != "train" or not rec.get("steps"):
        return None
    rate = rec["flop_per_step"] * rec["steps"] / rec["window_s"]
    return 100.0 * rate / PEAK_BF16_FLOPS
