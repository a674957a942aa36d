#!/usr/bin/env python
"""Where an eager Instant-NGP training step spends its device time on the
field's two MLPs, at the ``ngp_lego.train`` cell's shapes (4,096 rays,
2^18 samples a step, lego's 800x800 scene made from the seed).

The cell's loop (``port_bench/arch/ngp.TrainLoop``) runs eagerly
(``scan_chunk 1``) through the grid's warm-up, then ``--steps`` more steps
under ``torch.profiler``.  Per step it prints:

- the device time of the whole step;
- the forward MLP: the ops launched inside the program's ``ngp.mlp`` span;
- the backward MLP: the ops that ran, in the stream's order, between the
  compositing backward (``composite_bwd_kernel``) and the hash encoding's
  backward (``hash_encode_bwd_kernel``), less the fill of the hash
  gradient's buffer, listed by name;
- the device time of the three fused MLP kernels where the program has
  them;
- every matrix-product kernel (cutlass, nvjet, cuBLAS) in the traced
  steps, by name, count and ms a step, inside the occupancy grid's update
  (``ngp.grid_update``) or outside it.

Run on the card from the repository's root:

    python3 tools/ngp_mlp_profile.py --seed 7 --steps 16
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

BWD_AFTER, BWD_BEFORE = "composite_bwd_kernel", "hash_encode_bwd_kernel"
FUSED = ("ngp_mlp_fwd_kernel", "ngp_mlp_bwd_kernel", "ngp_mlp_reduce_kernel")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--steps", type=int, default=16)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    from port_bench import arch
    from port_bench.harness.scenes import SCENES
    from port_bench.harness.spans import spans_of
    from port_bench.harness.trace import Trace, kernel_function
    from port_bench.run import make_ctx

    dev = torch.device("cuda")
    ctx = make_ctx("ngp_lego.train", args.seed, 0.0, True, dev, 0.0,
                   nerf_overrides={"scan_chunk": 1})
    a = arch.of(ctx.config)
    scene = SCENES[ctx.config["scene"]["kind"]](ctx.config["scene"],
                                                ctx.seed, dev)
    sd = a.train_weights(ctx.cfg, torch.Generator(device=dev).manual_seed(
        ctx.seed), dev)

    class _Plain:                    # the loop's schedule, unprobed
        def __init__(self, schedule, state):
            self.schedule = schedule

        def __call__(self, step):
            return self.schedule(step)

    loop = a.TrainLoop(ctx.cfg, scene, sd, dev, _Plain)
    try:
        loop.chunk()                 # eager, through the grid's warm-up
        for _ in range(4):
            loop.chunk()
        torch.cuda.synchronize(dev)
        with Trace(dev) as tr:
            n = 0
            while n < args.steps:
                n += loop.chunk()[0]
    finally:
        loop.close()
    sp = spans_of(tr)
    fwd_ms = 1e3 * sp.device_s(["ngp.mlp"]) / n if sp else None
    ops = sorted(tr.ops, key=lambda o: o[1])
    bwd = defaultdict(float)
    inside = False
    for name, _, dur in ops:
        fn = kernel_function(name)
        if fn == BWD_AFTER:
            inside = True
        elif fn == BWD_BEFORE:
            inside = False
        elif inside:
            bwd[name[:100]] += dur
    fill = {k: v for k, v in bwd.items() if "fill" in k.lower()}
    mlp_bwd = {k: 1e3 * v / n for k, v in bwd.items() if k not in fill}
    fused = {k: 1e3 * tr.time_of([k])[0] / n for k in FUSED}
    gemms = defaultdict(lambda: [0, 0.0])
    for op in (sp.ops if sp else []):
        if any(w in op.name for w in ("gemm", "nvjet", "cublas")):
            where = ("grid_update" if op.span >= 0 and "ngp.grid_update"
                     in sp.spans[op.span].names else "step")
            entry = gemms[f"{where}: {op.name[:90]}"]
            entry[0] += 1
            entry[1] += 1e3 * (op.end - op.start) / n
    out = {"device": torch.cuda.get_device_name(0), "steps": n,
           "step_busy_ms": 1e3 * tr.busy_s / n,
           "step_window_ms": 1e3 * tr.window_s / n,
           "mlp_fwd_span_ms": fwd_ms,
           "mlp_bwd_ms": sum(mlp_bwd.values()),
           "hash_grad_fill_ms": 1e3 * sum(fill.values()) / n,
           "fused_ms": fused,
           "gemm_ops": sorted(([k, c, ms] for k, (c, ms) in gemms.items()),
                              key=lambda e: -e[2]),
           "mlp_bwd_ops": sorted(([k, v] for k, v in mlp_bwd.items()),
                                 key=lambda kv: -kv[1])}
    if fwd_ms is not None:
        out["mlp_share_of_busy"] = (fwd_ms + out["mlp_bwd_ms"]) / out[
            "step_busy_ms"]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
