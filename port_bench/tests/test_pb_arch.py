"""An architecture comes in through the resolver alone: a stand-in module,
registered under a new name as ``port_bench.arch.stand_in`` and named by
the configuration's ``"arch"``, runs a small train cell and a small
render cell through ``run.run_cell`` to their checks, with no edit to a
kind, to ``run.py`` or to the layout test.  The stand-in wraps
``arch/nerf.py`` and records what the kinds took from it.

    python -m pytest port_bench/tests -q
"""
import sys
import types

import pytest
import torch

from port_bench import arch
from port_bench.arch import nerf
from port_bench.harness import render, train
from port_bench.run import make_ctx, run_cell

NAME = "stand_in"
SMALL = {
    "lego.train": (dict(N_rays=256, N_samples_c=8, N_samples_f=8),
                   dict(H=32, W=32, n_train=3)),
    "fern.render": (dict(N_samples_c=16, N_samples_f=32),
                    dict(H=24, W=32, n_views=6, testskip=3)),
}
SEED = 2 ** 31 + 121


@pytest.fixture
def stand_in(monkeypatch):
    """``arch/stand_in.py``: NeRF's names, each call recorded."""
    calls = []
    module = types.ModuleType(f"{arch.__name__}.{NAME}")

    def recorded(name, fn):
        def call(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        return call
    for name in set(train.ARCH_NEEDS) | set(render.ARCH_NEEDS):
        value = getattr(nerf, name)
        setattr(module, name, recorded(name, value) if callable(value)
                and not name.startswith("ROUND") else value)
    monkeypatch.setitem(sys.modules, module.__name__, module)
    return calls


def _run(cell, name=None, seconds=1.5):
    nerf_small, scene = SMALL[cell]
    ctx = make_ctx(cell, SEED, seconds, False, torch.device("cpu"), 0.0,
                   nerf_overrides=nerf_small, scene_overrides=scene)
    if name:
        ctx.config = {**ctx.config, "arch": name}
    return run_cell(ctx)


def test_the_resolver_finds_a_registered_module(stand_in):
    assert arch.of({"arch": NAME}) is sys.modules[f"port_bench.arch.{NAME}"]
    assert arch.of({}) is nerf
    with pytest.raises(ValueError):
        arch.load("../nerf")


def test_a_train_cell_through_a_stand_in(stand_in):
    """The stand-in gives the same check numbers and record as NeRF's
    own module: the first three steps do not depend on the window."""
    own = _run("lego.train")
    got = _run("lego.train", NAME)
    assert set(stand_in) == {"train_weights", "TrainLoop",
                             "reference_steps", "train_counts"}
    assert got["checks"].ok, got["checks"].items
    assert got["checks"].items == own["checks"].items
    assert set(got["rec"]) == set(own["rec"])


def test_a_render_cell_through_a_stand_in(stand_in):
    # a window long enough for a frame to arrive on a loaded host
    got = _run("fern.render", NAME, seconds=4.0)
    assert set(stand_in) == {"render_field", "frame_renderer",
                             "reference_frame"}
    assert got["checks"].ok, got["checks"].items
    assert got["attempted"] >= 1
