"""BENCHMARK.json and the files it names: every cell, configuration and
per-layer metric resolves by name, and names, units and texts keep to
the characters and lengths the benchmark's contract allows.

    python -m pytest port_bench/tests -q
"""
import importlib
import json
import re
from pathlib import Path

import pytest

from port_bench.harness.common import BENCH_DIR, REPO_DIR, load_reader

BENCH = json.loads((REPO_DIR / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _text_ok(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    assert BENCH["command"] == ["python3", "port_bench/run.py"]
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_run_seconds_fit_the_check_of_24_cells():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]]
                         + CELLS + [m["name"] for m in METRICS])
def test_names(name):
    assert NAME.match(name), name


def test_names_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    for cell in metric.get("workloads", []):
        assert cell in CELLS


@pytest.mark.parametrize("metric", BENCH["end_to_end"],
                         ids=lambda m: m["name"])
def test_end_to_end_bounds(metric):
    assert set(metric) <= {"name", "unit", "better", "bound", "source",
                           "workloads"}
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25


def test_every_cell_reports_setup_another_metric_and_a_layer():
    e2e = {m["name"]: m.get("workloads", CELLS) for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"] == CELLS
    for cell in CELLS:
        mine = {n for n, ws in e2e.items() if cell in ws}
        assert len(mine - {"setup_s"}) >= 1
        assert any(cell in m.get("workloads", CELLS)
                   and m["moves"] in mine for m in BENCH["per_layer"])


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_metric_resolves(metric):
    assert set(metric) <= {"name", "unit", "better", "source", "layer",
                           "moves", "workloads"}
    assert _text_ok(metric["layer"])
    moves = {m["name"]: m.get("workloads", CELLS)
             for m in BENCH["end_to_end"]}[metric["moves"]]
    for cell in metric.get("workloads", CELLS):
        assert cell in moves, (metric["name"], cell)
    assert callable(load_reader(metric["name"]))
    if "roofline" in metric["name"] or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_layers_spelled_alike():
    by_prefix = {}
    for m in BENCH["per_layer"]:
        by_prefix.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_prefix.values()), by_prefix


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1 and _text_ok(cell["why"])
    spec = json.loads((BENCH_DIR / "workloads"
                       / f"{cell['name']}.json").read_text())
    assert spec["config"] == cell["config"]
    assert spec["traffic"] == cell["traffic"]
    assert spec["chips"] == cell["chips"]
    assert spec["why"] == cell["why"]
    kind = importlib.import_module(f"port_bench.harness.{spec['kind']}")
    assert callable(kind.run)
    limits = spec["check"]["limits"]
    assert limits and set(limits) <= {
        "train": {"loss_gap", "grad_gap", "grad_gap_median",
                  "grad_noise_ratio", "change_gap", "change_gap_median"},
        "render": {"rgb_rmse", "rgb_max", "active_gap"}}[spec["kind"]]
    assert all(0 < v < 1 for v in limits.values())
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert pairs.count((cell["config"], cell["traffic"])) == 1


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_resolves(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert config["file"] == f"port_bench/configs/{config['name']}.json"
    spec = json.loads((REPO_DIR / config["file"]).read_text())
    assert spec["name"] == config["name"]
    assert spec["reduced"] == config["reduced"] == []
    assert _text_ok(config["source"]) and _text_ok(config["why"])
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])
    from nerf_pytorch_paeng_tpu_torch.config import NerfConfig
    NerfConfig(**spec["nerf"]).validate()


def test_files_are_named_from_names():
    for path in BENCH_DIR.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(REPO_DIR).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
