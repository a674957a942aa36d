"""What every cell shares: finding its files by name, the program's
configuration, the device record, the checks and the result line."""
from __future__ import annotations

import importlib.util
import json
import math
import statistics
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import torch

BENCH_DIR = Path(__file__).resolve().parents[1]
REPO_DIR = BENCH_DIR.parent
# compared whole, as top-level module names
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "nerf_pytorch_paeng_tpu")


def load_json(folder: str, name: str) -> dict:
    path = BENCH_DIR / folder / f"{name}.json"
    with open(path) as f:
        return json.load(f)


def load_benchmark() -> dict:
    with open(REPO_DIR / "BENCHMARK.json") as f:
        return json.load(f)


def load_reader(metric: str):
    """``metrics/<metric>.py``'s ``read``."""
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "port_bench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def nerf_config(config: dict, workload: dict, seed: int, device: str,
                overrides: Optional[dict] = None):
    """The program's ``NerfConfig``: the configuration file's settings,
    then the cell's, the run's seed and device, then ``overrides`` (the
    CPU tests' small sizes)."""
    from nerf_pytorch_paeng_tpu_torch.config import NerfConfig
    values = {**config["nerf"], **workload.get("nerf", {}),
              **(overrides or {})}
    values.update(seed=seed, device=device)
    return NerfConfig(**values).validate()


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Checks:
    """Numbers compared with their limits; a run is correct when every
    number is finite and at most its limit."""
    items: Dict[str, Dict[str, float]] = field(default_factory=dict)

    def add(self, name: str, value: float, limit: float) -> None:
        self.items[name] = {"value": float(value), "limit": float(limit)}

    @property
    def ok(self) -> bool:
        return bool(self.items) and all(
            math.isfinite(c["value"]) and c["value"] <= c["limit"]
            for c in self.items.values())


def quantile(values: List[float], q: int, n: int = 100) -> float:
    """The q-th of n quantiles (inclusive method)."""
    if len(values) == 1:
        return float(values[0])
    return float(statistics.quantiles(values, n=n, method="inclusive")[q - 1])


def device_record(device: torch.device, count: int, peak: int) -> dict:
    """``peak``: the program's peak, read before the check ran."""
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count, "memory_peak_bytes": int(peak)}


def splitmix64(x: int) -> int:
    """SplitMix64's finaliser: a 64-bit hash of ``x`` (the frames'
    seeds)."""
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


def relative_gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def leaf_norm_gaps(prog: Dict[str, torch.Tensor],
                   ref: Dict[str, torch.Tensor], keys: List[str]
                   ) -> Dict[str, float]:
    """Each leaf's gap between the program's norm and the reference's,
    over the larger of that leaf's reference norm and the median
    leaf's."""
    rn = {k: float(torch.linalg.norm(ref[k].double())) for k in keys}
    pn = {k: float(torch.linalg.norm(prog[k].double())) for k in keys}
    med = statistics.median(rn.values())
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keys}

