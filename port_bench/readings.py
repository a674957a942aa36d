#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card, in one
process (the benchmark's own runs do not run this):

    python3 port_bench/readings.py --workload <cell> --seeds 1 2 ... \
        [--control-seeds a b c] [--fault-seeds a b c] [--bf16-seeds a b] \
        [--seconds 2]

- for every ``--seeds`` seed, a short run of the cell (the program's
  set-up, a window of ``--seconds``, the check): each compared number,
  the lower reading's material;
- for every ``--control-seeds`` seed, the control: the reference put in
  the program's place at the operand precision below the configuration's
  (the architecture's ``ROUND_CONTROL``; NeRF's bfloat16 gives scaled
  float8 e4m3), compared with the float32 reference as the program is:
  the upper reading;
- for every ``--fault-seeds`` seed of a training cell, half of the
  batch left out (the mean over the other half), planted in the
  reference put in the program's place;
- for every ``--bf16-seeds`` seed of a training cell, the reference at
  the configuration's own operand precision (``ROUND_OWN``) in the
  program's place: a second witness of what rounding alone does to a
  number.  A state left unchanged needs no run: its change reads 1.

One JSON line per reading on standard output.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def train_control(ctx, rnd=None, keep: int = 0) -> dict:
    """The reference at ``rnd`` (or on ``keep`` rays) in the program's
    place for the cell's first three updates, compared as the program's
    are; the reference is the cell's architecture's."""
    import torch

    from port_bench import arch
    from port_bench.harness import train
    from port_bench.harness.scenes import SCENES

    a, cfg, dev = arch.of(ctx.config), ctx.cfg, ctx.device
    spec = {**ctx.config["scene"], **(ctx.scene_overrides or {})}
    scene = SCENES[spec["kind"]](spec, ctx.seed, dev)
    sd = a.train_weights(cfg, torch.Generator(device=dev).manual_seed(
        ctx.seed), dev)
    items = a.first_items(cfg, scene)
    exact = a.reference_steps(sd, scene, cfg, items, dev)
    other = a.reference_steps(sd, scene, cfg, items, dev, rnd=rnd, keep=keep)
    return train.compare(other, exact, sd)


def render_control(ctx, frames=(0, 37)) -> dict:
    """The control's frames (the architecture's ``ROUND_CONTROL``
    operands, its own fine uniforms, as the program's are its own)
    against the float32 reference's; the control's rendered rays are
    those its own coarse pass keeps."""
    import torch

    from port_bench import arch
    from port_bench.harness import render

    a, cfg, dev = arch.of(ctx.config), ctx.cfg, ctx.device
    path = render.make_path(ctx)
    sd = render.field_state_dict(ctx)
    progs, refs, n_prog, n_ref = [], [], 0, 0
    for i in frames:
        pose = path["poses"][i % len(path["poses"])]
        rgb, n = a.reference_frame(sd, cfg, path["K"], path["hw"], pose,
                                   render.frame_seeds(ctx.seed, i), dev)
        refs.append(rgb)
        n_ref += n
        rgb, n = a.reference_frame(
            sd, cfg, path["K"], path["hw"], pose,
            render.frame_seeds(ctx.seed, i, render.FINE_STREAM + 1), dev,
            rnd=a.ROUND_CONTROL)
        progs.append(rgb)
        n_prog += n
    return render.compare(torch.stack(progs), torch.stack(refs), n_prog,
                          n_ref)


def main(argv=None) -> int:
    import torch

    from port_bench import arch
    from port_bench.harness.common import load_json
    from port_bench.run import make_ctx, run_cell

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--bf16-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    dev = torch.device("cuda", 0)
    workload = load_json("workloads", args.workload)
    kind = workload["kind"]
    a = arch.of(load_json("configs", workload["config"]))

    def emit(what, seed, numbers, **extra):
        print(json.dumps({"workload": args.workload, "reading": what,
                          "seed": seed, **numbers, **extra}), flush=True)

    for seed in args.seeds:
        ctx = make_ctx(args.workload, seed, args.seconds, False, dev,
                       time.perf_counter())
        out = run_cell(ctx)
        emit("program", seed, out["readings"],
             metrics={k: m["value"] for k, m in out["metrics"].items()},
             notes=out.get("notes", {}))
    for seed in args.control_seeds:
        ctx = make_ctx(args.workload, seed, 0, False, dev, 0.0)
        numbers = (train_control(ctx, rnd=a.ROUND_CONTROL) if kind == "train"
                   else render_control(ctx))
        emit("control_fp8", seed, numbers)
    for seed in args.bf16_seeds:
        ctx = make_ctx(args.workload, seed, 0, False, dev, 0.0)
        emit("reference_bf16", seed, train_control(ctx, rnd=a.ROUND_OWN))
    for seed in args.fault_seeds:
        ctx = make_ctx(args.workload, seed, 0, False, dev, 0.0)
        emit("fault_half_batch", seed,
             train_control(ctx, keep=ctx.cfg.N_rays // 2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
