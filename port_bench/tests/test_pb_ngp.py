"""The NGP cell on the CPU at a small size: ``ngp_lego.train`` resolves
through ``arch.of`` to ``arch/ngp.py``, runs through ``run.run_cell`` to
its check, the reference's steps agree with themselves and move under the
control's rounding and with fewer rays marched, and the new readers read
the record (the traced ones nothing, with no trace).

    python -m pytest port_bench/tests -q
"""
import time

import pytest
import torch

from port_bench import arch
from port_bench.arch import ngp
from port_bench.harness import train
from port_bench.harness.common import load_json, load_reader
from port_bench.harness.scenes import SCENES
from port_bench.run import make_ctx, run_cell

# float32: at these sizes bf16's rounding is a larger share of the gaps
# than the cell's limits, set at the published sizes, allow
SMALL = dict(N_rays=128, ngp_levels=4, ngp_log2_table=10, ngp_grid_res=16,
             ngp_budget=4096, compute_dtype="float32")
SCENE = dict(H=16, W=16, n_train=3)
SEED = 2 ** 31 + 977
READERS = ("mfu.train", "hash_roofline.train", "march_ms.train",
           "grid_update_ms.train", "ray_fit_share.train",
           "sample_fill_share.train")


def _ctx(seconds=1.5):
    return make_ctx("ngp_lego.train", SEED, seconds, False,
                    torch.device("cpu"), time.perf_counter(),
                    nerf_overrides=SMALL, scene_overrides=SCENE)


def test_the_cell_resolves_to_the_ngp_module():
    assert arch.of(load_json("configs", "ngp_lego")) is ngp
    assert all(hasattr(ngp, n) for n in train.ARCH_NEEDS)


def test_the_cell_runs_to_its_check_and_its_readers_read():
    out = run_cell(_ctx())
    assert out["checks"].ok, out["checks"].items
    rec = out["rec"]
    assert rec["arch"] == "ngp" and rec["steps"] >= 16
    w = rec["ngp_window"]
    assert w["rays_drawn"] == rec["steps"] * SMALL["N_rays"]
    assert 0 < w["rays_kept"] <= w["rays_drawn"]
    assert 0 < w["min_step_samples"] <= SMALL["ngp_budget"]
    values = {m: load_reader(m)(rec) for m in READERS}
    assert 0 < values["mfu.train"] < 1
    assert 0 < values["ray_fit_share.train"] <= 100
    assert 0 < values["sample_fill_share.train"] <= 100
    for m in ("hash_roofline.train", "march_ms.train",
              "grid_update_ms.train"):
        assert values[m] is None           # no trace on the CPU


@pytest.mark.parametrize("what", ["control", "few_rays"])
def test_the_reference_steps_move_under_a_fault(what):
    ctx = _ctx(0)
    cfg, dev = ctx.cfg, ctx.device
    scene = SCENES["blender"]({**ctx.config["scene"], **SCENE}, SEED, dev)
    sd = ngp.train_weights(cfg, torch.Generator().manual_seed(SEED), dev)
    items = ngp.first_items(cfg, scene)
    exact = ngp.reference_steps(sd, scene, cfg, items, dev)
    again = train.compare(ngp.reference_steps(sd, scene, cfg, items, dev),
                          exact, sd)
    assert again["grad_gap"] == 0 and again["change_gap"] == 0
    # (the budget keeps 5-7 of the 128 rays while the grid is full:
    # few_rays marches the first 4 alone)
    kw = (dict(rnd=ngp.ROUND_CONTROL) if what == "control"
          else dict(keep=4))
    moved = train.compare(ngp.reference_steps(sd, scene, cfg, items, dev,
                                              **kw), exact, sd)
    assert moved["grad_noise_ratio"] > again["grad_noise_ratio"]


def _trained_like(cfg, dev):
    """A program model whose field varies over the cube (tables drawn
    wide) and whose grid, after one update of every cell, is partly
    empty; rays [M, 3, 3] from a radius-4 shell towards the centre."""
    from nerf_pytorch_paeng_tpu_torch.models.ngp import (
        init_ngp, update_occupancy_grid)
    model = init_ngp(cfg, dev, seed=3)
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for t in model.tables:
            t.copy_(torch.randn(t.shape, generator=g) * 2.0)
        model.sigma_w1[0].mul_(5.0)          # sigma over many decades
    update_occupancy_grid(model, cfg, 0, torch.Generator().manual_seed(5))
    o = torch.randn(cfg.N_rays, 3, generator=g)
    o = 4.0 * o / o.norm(dim=1, keepdim=True)
    d = -o + 0.5 * torch.randn(cfg.N_rays, 3, generator=g)
    return model, torch.stack([o, d, torch.zeros_like(o)], 1)


@pytest.mark.parametrize("fault", [None, "decay", "threshold", "pick",
                                   "cut"])
def test_the_loop_check_holds_the_grid_and_the_marcher(fault, monkeypatch):
    """On the CPU (float32 both) the loop's check reads 0 where the
    program is sound, and each planted fault fails a limit."""
    from nerf_pytorch_paeng_tpu_torch.models import ngp as model_ngp
    from nerf_pytorch_paeng_tpu_torch.ops import ngp as ops_ngp
    cfg = _ctx(0).cfg
    model, rays = _trained_like(cfg, torch.device("cpu"))
    occupied = float(model.grid_bits.double().mean())
    assert 0.05 < occupied < 0.95
    if fault == "decay":
        monkeypatch.setattr(model_ngp, "GRID_DECAY", 0.9)
    elif fault == "threshold":          # under this grid's mean (~4e-4)
        monkeypatch.setattr(model_ngp, "GRID_THRESH", 1e-4)
    elif fault == "pick":
        monkeypatch.setattr(model_ngp, "occupied_pick",
                            lambda bits, u, fallback: fallback)
    elif fault == "cut":
        render = ops_ngp.render_rays_ngp

        def cut(*a):
            out = render(*a)
            k = out["kept"]
            out["kept"] = k & (torch.arange(k.shape[0]) < k.sum() - 1)
            return out
        monkeypatch.setattr(ops_ngp, "render_rays_ngp", cut)
    step = ngp.ref.GRID_WARMUP
    r = ngp.grid_march_readings(model, cfg, rays, step)
    over = [n for n, lim in ngp.GRID_CHECK_LIMITS.items() if r[n] > lim]
    if fault is None:
        assert r["march_kept_mismatch"] == r["march_samples_gap"] == 0
        assert r["grid_rule_mismatch"] == r["grid_decay_mismatch"] == 0
        assert r["grid_value_gap"] < 1e-5
        ngp.hold_grid_check(r)
    else:
        assert over, r
        with pytest.raises(RuntimeError):
            ngp.hold_grid_check(r)
