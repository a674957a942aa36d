"""BENCHMARK.json and the files it names: every cell, configuration and
per-layer metric resolves by name, and names, units and texts keep to
the characters and lengths the benchmark's contract allows.  A cell's
limits are the numbers its kind declares (``LIMIT_KEYS``), its
configuration's architecture gives what its kind takes (``ARCH_NEEDS``),
and a configuration's cuts (``reduced``) are those of ``BENCHMARK.json``,
each with its published value in the file.  ``check_cell`` and
``check_config`` are also held against stand-ins: a third kind, a cut
configuration, and what each must refuse.

    python -m pytest port_bench/tests -q
"""
import importlib
import json
import re
import sys
import types

import pytest

from port_bench import arch
from port_bench.harness.common import (BENCH_DIR, REPO_DIR, load_json,
                                       load_reader)

BENCH = json.loads((REPO_DIR / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
# a width may never be cut: hidden, intermediate, latent, state or
# projection sizes, head sizes, expansion factors, experts per token
WIDTH = re.compile(r"width|hidden|intermediate|latent|state|proj|head|"
                   r"expan|experts_per|_dim$|_rank$", re.IGNORECASE)
# a configuration file's keys that hold no setting
NOT_SETTINGS = ("name", "source", "about", "arch", "assumed", "published",
                "reduced")
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


def check_cell(cell: dict, spec: dict, bench: dict = BENCH) -> None:
    """A cell of ``bench`` against its workload file ``spec``: the same
    configuration, traffic, chips and why; a kind module whose
    ``LIMIT_KEYS`` hold every limit and whose ``ARCH_NEEDS`` the
    configuration's architecture gives."""
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1 and _text_ok(cell["why"])
    for key in ("config", "traffic", "chips", "why"):
        assert spec[key] == cell[key], key
    kind = importlib.import_module(f"port_bench.harness.{spec['kind']}")
    assert callable(kind.run)
    limits = spec["check"]["limits"]
    assert limits and set(limits) <= set(kind.LIMIT_KEYS), (
        sorted(limits), kind.LIMIT_KEYS)
    assert all(0 < v < 1 for v in limits.values())
    module = arch.of(load_json("configs", spec["config"]))
    missing = [n for n in kind.ARCH_NEEDS if not hasattr(module, n)]
    assert not missing, (module.__name__, missing)
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert pairs.count((cell["config"], cell["traffic"])) == 1


def _settings(spec: dict) -> dict:
    """Every key a configuration file sets, top-level groups and the keys
    inside them, each with the values it takes there."""
    out = {}
    for key, value in spec.items():
        if key in NOT_SETTINGS:
            continue
        out.setdefault(key, []).append(value)
        if isinstance(value, dict):
            for k, v in value.items():
                out.setdefault(k, []).append(v)
    return out


def check_config(config: dict, spec: dict, bench: dict = BENCH) -> None:
    """A configuration of ``bench`` against its file ``spec``: the same
    cuts, each a key the file sets, no width, with its published value
    (``published``) beside it; the architecture resolves; the program
    takes the settings."""
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert config["file"] == f"port_bench/configs/{config['name']}.json"
    assert spec["name"] == config["name"]
    assert spec["reduced"] == config["reduced"]
    assert len(config["reduced"]) <= 16
    settings, published = _settings(spec), spec.get("published", {})
    for key in config["reduced"]:
        assert NAME.match(key) and not WIDTH.search(key), key
        assert key in settings, key
        assert key in published, key
        assert any(v != published[key] for v in settings[key]), key
    assert _text_ok(config["source"]) and _text_ok(config["why"])
    assert any(w["config"] == config["name"] for w in bench["workloads"])
    arch.of(spec)
    from nerf_pytorch_paeng_tpu_torch.config import NerfConfig
    NerfConfig(**spec["nerf"]).validate()


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(cell):
    check_cell(cell, load_json("workloads", cell["name"]))


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_resolves(config):
    check_config(config, json.loads((REPO_DIR / config["file"]).read_text()))


# ------------------------------------------------------------ stand-ins

STAND_IN_CELL = {"name": "lego.stand_in", "config": "lego",
                 "traffic": "stand_in", "chips": 1,
                 "why": "a third kind of cell, declared by its module alone"}


@pytest.fixture
def third_kind(monkeypatch):
    """``harness/stand_in.py``, registered under its import name: a kind
    with limit keys of its own."""
    kind = types.ModuleType("port_bench.harness.stand_in")
    kind.run = lambda ctx: None
    kind.LIMIT_KEYS = ("psnr_gap",)
    kind.ARCH_NEEDS = ("render_field", "reference_frame")
    monkeypatch.setitem(sys.modules, kind.__name__, kind)
    spec = {**{k: STAND_IN_CELL[k] for k in ("config", "traffic", "chips",
                                             "why")},
            "kind": "stand_in", "check": {"limits": {"psnr_gap": 0.5}}}
    bench = {**BENCH, "workloads": BENCH["workloads"] + [STAND_IN_CELL]}
    return kind, spec, bench


def test_a_third_kind_declares_its_own_limits(third_kind):
    _, spec, bench = third_kind
    check_cell(STAND_IN_CELL, spec, bench)


@pytest.mark.parametrize("fault", ["undeclared_limit", "arch_lacks_a_name"])
def test_a_third_kind_is_refused(third_kind, fault):
    kind, spec, bench = third_kind
    if fault == "undeclared_limit":
        spec["check"]["limits"]["rgb_rmse"] = 0.01
    else:
        kind.ARCH_NEEDS += ("no_such_function",)
    with pytest.raises(AssertionError):
        check_cell(STAND_IN_CELL, spec, bench)


def _cut_config():
    """lego with its training views cut from 100 to 20, as a file and as
    ``BENCHMARK.json``'s entry, with a cell that uses it."""
    spec = json.loads((BENCH_DIR / "configs" / "lego.json").read_text())
    spec.update(name="lego_cut", reduced=["n_train"],
                published={"n_train": 100})
    spec["scene"] = {**spec["scene"], "n_train": 20}
    config = {"name": "lego_cut", "source": "https://arxiv.org/abs/2003.08934",
              "file": "port_bench/configs/lego_cut.json",
              "reduced": ["n_train"], "why": "lego with fewer views"}
    bench = {**BENCH, "workloads": BENCH["workloads"] + [
        {**STAND_IN_CELL, "name": "lego_cut.train", "config": "lego_cut"}]}
    return config, spec, bench


def test_a_cut_configuration_with_published_values():
    check_config(*_cut_config())


@pytest.mark.parametrize("fault", ["no_published_value",
                                   "differs_from_the_benchmark",
                                   "not_a_setting", "a_width",
                                   "published_as_set"])
def test_a_cut_configuration_is_refused(fault):
    config, spec, bench = _cut_config()
    if fault == "no_published_value":
        del spec["published"]
    elif fault == "differs_from_the_benchmark":
        config["reduced"] = []
    elif fault == "not_a_setting":
        config["reduced"] = spec["reduced"] = ["n_views"]
        spec["published"]["n_views"] = 20
    elif fault == "a_width":
        config["reduced"] = spec["reduced"] = ["netWidth"]
        spec["nerf"] = {**spec["nerf"], "netWidth": 128}
        spec["published"]["netWidth"] = 256
    else:
        spec["published"]["n_train"] = 20
    with pytest.raises(AssertionError):
        check_config(config, spec, bench)


def test_files_are_named_from_names():
    for path in BENCH_DIR.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(REPO_DIR).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
