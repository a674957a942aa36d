#!/usr/bin/env python3
"""One run of one benchmark cell of ``nerf_pytorch_paeng_tpu_torch``.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout: the cell's file ``port_bench/workloads/
<cell>.json`` names its configuration (``port_bench/configs/<name>.json``)
and its kind (``harness/<kind>.py``), which sets up, measures for
``--seconds`` and checks its output against the plain reference.  The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (with ``--trace 0`` the cell's
end-to-end metrics of ``BENCHMARK.json``; with ``--trace 1`` its
per-layer metrics, each read by ``port_bench/metrics/<metric>.py``),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
compared number beside its limit (also the last lines of standard error).

The run needs a CUDA device, as many as the cell asks for, and the
program beside this folder; it exits with another code than 0 and prints
no result without them, or if JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()   # set-up counts from here

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


@dataclasses.dataclass
class Ctx:
    """One run: the cell's files, the run's arguments, the program's
    configuration and the device."""
    name: str
    workload: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    cfg: object
    t_start: float
    scene_overrides: dict = None


def make_ctx(name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, nerf_overrides=None, scene_overrides=None,
             workload=None) -> Ctx:
    from port_bench.harness.common import load_json, nerf_config
    workload = workload or load_json("workloads", name)
    config = load_json("configs", workload["config"])
    # the program's seed: 32 bits of the run's, as its generators keep
    cfg = nerf_config(config, workload, seed & 0x7FFFFFFF, str(device),
                      nerf_overrides)
    return Ctx(name, workload, config, seed, seconds, trace, device, cfg,
               t_start, scene_overrides)


def run_cell(ctx: Ctx) -> dict:
    """The cell's kind run, then its metrics as ``BENCHMARK.json`` lists
    them for this cell -> the result (without the device record's name
    on the CPU)."""
    import importlib

    from port_bench.harness.common import load_benchmark, load_reader
    kind = importlib.import_module(f"port_bench.harness.{ctx.workload['kind']}")
    out = kind.run(ctx)
    bench = load_benchmark()
    metrics = {}
    if not ctx.trace:
        for m in bench["end_to_end"]:
            if ctx.name in m.get("workloads", [ctx.name]):
                metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                      "unit": m["unit"]}
    else:
        e2e = {m["name"] for m in bench["end_to_end"]
               if ctx.name in m.get("workloads", [ctx.name])}
        for m in bench["per_layer"]:
            if ctx.name not in m.get("workloads", [ctx.name]) \
                    or m["moves"] not in e2e:
                continue
            value = load_reader(m["name"])(out["rec"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out["metrics"] = metrics
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch
    from port_bench.harness.common import (device_record, forbidden_modules,
                                           load_json)
    workload = load_json("workloads", args.workload)
    chips = int(workload.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    ctx = make_ctx(args.workload, args.seed, args.seconds, bool(args.trace),
                   device, T_START, workload=workload)
    out = run_cell(ctx)
    found = forbidden_modules()
    if found:
        print(f"run.py: the run loaded {', '.join(found)}", file=sys.stderr)
        return 4
    checks = out["checks"]
    result = {"correct": checks.ok, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": out["metrics"],
              "device": device_record(device, chips,
                                      out["rec"]["memory_peak_bytes"])}
    if args.trace:
        tr = out["rec"].get("trace")
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = tr.breakdown()
    result["notes"] = out.get("notes", {})
    result["checks"] = checks.items
    for name, c in checks.items.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
