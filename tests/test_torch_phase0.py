"""Phase 0 of the culled renderer (``render_precull on`` off the ray
kernels: the plane route on K7/K8 and the plain route) against the JAX
package's ``_phase0`` and ``_phase1_block`` (``eval/frame.py``), and
within the port: the counterparts of the JAX package's
tests/test_precull.py.

Same numpy-seeded weights on both sides; deterministic sampling unless a
test says otherwise; an explicit support grid (the CPU's default is none).
The JAX side runs K7/K8 in Pallas interpret mode (float32) on the plane
route and its XLA route on the plain one.  The compact field
(``utils/synth.compact_field_params``, an L1 ball of radius 1.0, density
exactly 0 outside) has valid bounds on a 48^3 grid; random weights do not,
so where they render, ball bounds are injected (``renderer.set_support``
in the port, the JAX package's ``_support_for_eval`` patched).
Tolerances:
- frames against the JAX package's: by outlier fraction, as
  tests/test_torch_plain_route.py's ``test_plain_frames_match_jax`` (at
  most 0.2% of values beyond 2e-3 rgb / 5e-3 disp relative with the same
  floor, max 2e-2 / 8e-2, mean 1e-4);
- pre-cull on against off within the port: rgb 1e-5, disp 1e-4 (the JAX
  package's tests/test_precull.py);
- invalid bounds: the frame of the pre-cull off, bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_pytorch_paeng_tpu.config import NerfConfig as JaxConfig
from nerf_pytorch_paeng_tpu.eval import frame as jframe
from nerf_pytorch_paeng_tpu.models.nerf import NeRF as JaxNeRF
from nerf_pytorch_paeng_tpu_torch.config import NerfConfig
from nerf_pytorch_paeng_tpu_torch.eval import frame
from nerf_pytorch_paeng_tpu_torch.kernels import fused_mlp as fm
from nerf_pytorch_paeng_tpu_torch.models.nerf import NeRF
from nerf_pytorch_paeng_tpu_torch.ops.occupancy import (ray_hits_bounds,
                                                        segment_in_cube)
from nerf_pytorch_paeng_tpu_torch.ops.rays import get_rays
from nerf_pytorch_paeng_tpu_torch.utils.interop import \
    state_dict_from_jax_params
from nerf_pytorch_paeng_tpu_torch.utils.synth import (compact_field_params,
                                                      make_synth_scene)

from torch_port_util import np_nerf_params, to_jax

H = W = 16
CPU = torch.device("cpu")
FRAME_KW = dict(near=2.0, far=6.0, perturb=0.0, compute_dtype="float32",
                render_cull="auto", render_precull="on",
                render_precull_grid=48, chunk_rays=64)
# the routes off the ray kernels: the plane route at sample counts off the
# 8-sample rows, the plain route with use_pallas off
ROUTES = {"planes": dict(use_pallas=True, N_samples_c=12, N_samples_f=20),
          "plain": dict(use_pallas=False, N_samples_c=12, N_samples_f=20)}
FULL = dict(netDepth=8, netWidth=256, L_x=10, L_d=4)
# the JAX package's tests/test_precull.py ``_cfg`` architecture
TINY = dict(netDepth=4, netWidth=64, L_x=6, L_d=2)


def _cfgs(route="planes", arch=FULL, **kw):
    kw = {**FRAME_KW, **ROUTES[route], **arch, **kw}
    return JaxConfig(**kw), NerfConfig(device="cpu", **kw)


def _model(np_params, arch=FULL):
    model = NeRF(depth=arch["netDepth"], width=arch["netWidth"],
                 L_x=arch["L_x"], L_d=arch["L_d"])
    model.load_state_dict(state_dict_from_jax_params(np_params))
    return model


def _scene():
    _, K, poses = make_synth_scene(n_views=1, H=H, W=W)
    return K, poses[0]


def _ball(lib=torch):
    """The JAX package's mesh test's bounds: the cube +-1.5 and a sphere
    of radius 2, valid."""
    if lib is torch:
        return (torch.full((3,), -1.5), torch.full((3,), 1.5),
                torch.tensor([2.0]), torch.tensor([True]))
    return (jnp.full((3,), -1.5), jnp.full((3,), 1.5), jnp.asarray([2.0]),
            jnp.asarray([True]))


def _render(cfg, packed, pose, K, ball=False, generator=None, **kw):
    r = frame.make_frame_renderer(cfg, H, W, K, "cpu",
                                  stratified=generator is not None, **kw)
    if ball:
        r.set_support(packed, "coarse", _ball())
    rgb, disp = r(packed, torch.from_numpy(pose), generator)
    return rgb, disp, r


def _missed(cfg, pose, K, bounds) -> float:
    """The missed share phase 0 takes from the bounds: rays that miss
    them and whose segment stays in the grid's cube."""
    ro, rd = (t.reshape(-1, 3) for t in get_rays(H, W, K, torch.from_numpy(
        pose[:3, :4]).float()))
    hit = (ray_hits_bounds(ro, rd, *bounds, cfg.near, cfg.far)
           | ~segment_in_cube(ro, rd, frame._precull_half(cfg), cfg.near,
                              cfg.far))
    return float((~hit).float().mean())


def _bounds(cfg, packed):
    """The bounds the renderer builds: its route's coarse density."""
    sigma = frame._plane_fields(packed, cfg, frame._frame_route(cfg, False),
                                fm.fused_mlp_eval, fm.fused_mlp_sigma)[2]
    return frame._support_bounds(sigma, cfg, CPU)


def _outliers(name, ours, ref, tol, cap):
    diff = np.abs(ours - ref)
    frac_out = float((diff > tol + tol * np.abs(ref)).mean())
    assert frac_out < 2e-3, (name, frac_out)
    assert float(diff.max()) < cap, (name, float(diff.max()))
    assert float(diff.mean()) < 1e-4, (name, float(diff.mean()))


def _assert_on_is_off(on, off):
    assert float((on[0] - off[0]).abs().max()) <= 1e-5
    assert float((on[1] - off[1]).abs().max()) <= 1e-4


# ---------------------------------------------------------------- the switch


@pytest.mark.parametrize("grid", [0, 16])
@pytest.mark.parametrize("data_type", ["blender", "llff"])
@pytest.mark.parametrize("route", ["rays", "planes", "plain"])
@pytest.mark.parametrize("mode", ["auto", "on", "off"])
def test_use_precull_matches_jax(mode, route, data_type, grid):
    """The three states: off never, auto on the ray kernels only, on on
    every route; blender scenes with a grid only."""
    kw = dict(render_precull=mode, data_type=data_type,
              render_precull_grid=grid,
              **{"rays": dict(N_samples_c=8, N_samples_f=8),
                 "planes": dict(N_samples_c=8, N_samples_f=5),
                 "plain": dict(N_samples_c=8, N_samples_f=8,
                               use_pallas=False)}[route])
    jcfg, cfg = JaxConfig(**kw), NerfConfig(device="cpu", **kw)
    assert frame._use_rays_kernels(cfg) == (route == "rays")
    want = jframe._use_precull(jcfg)
    assert frame._use_precull(cfg, CPU) == want
    assert want == ((mode == "on" or (mode == "auto" and route == "rays"))
                    and data_type == "blender" and grid > 0)
    # gate-fine stays the ray kernels' (the JAX package's caller ands it)
    want_fine = jframe._use_gate_fine(jcfg) and jframe._use_rays_kernels(jcfg)
    assert frame._use_gate_fine(cfg, CPU) == want_fine


@pytest.mark.parametrize("route", ["planes", "plain"])
def test_auto_builds_no_grid_off_the_ray_kernels(route, monkeypatch):
    """``render_precull auto`` keeps its meaning off the ray kernels: no
    grid, the frame of the pre-cull off, no skipped share."""
    calls = []
    monkeypatch.setattr(frame, "support_bounds_from_sigma",
                        lambda *a, **kw: calls.append(1))
    _, cfg = _cfgs(route, render_precull="auto")
    K, pose = _scene()
    packed = fm.pack_nerf(_model(compact_field_params(r=1.0, k=20.0)), cfg)
    rgb, disp, r = _render(cfg, packed, pose, K)
    off = _render(dataclasses.replace(cfg, render_precull="off"), packed,
                  pose, K)
    assert not calls and r.stats[-1]["gate_frac_coarse"] is None
    assert torch.equal(rgb, off[0]) and torch.equal(disp, off[1])


# ------------------------------------------------- against the JAX package


def _jax_frame(jcfg, np_params, pose, K, arch=FULL):
    jr = jframe.make_frame_renderer(
        JaxNeRF(depth=arch["netDepth"], width=arch["netWidth"],
                L_x=arch["L_x"], L_d=arch["L_d"], compute_dtype=jnp.float32),
        jcfg, H, W, K, stratified=False)
    rgb, disp = jr(to_jax(np_params), jnp.asarray(pose[:3, :4]),
                   jax.random.PRNGKey(0))
    return np.asarray(rgb), np.asarray(disp)


@pytest.mark.parametrize("samples", [dict(N_samples_c=12, N_samples_f=20),
                                     dict(N_samples_c=8, N_samples_f=5)],
                         ids=["sc12", "sf5"])
def test_plane_frames_match_jax(samples):
    """The plane route with ``render_precull on`` on the compact field,
    each package's own 48^3 grid (K7): the port's frame against the JAX
    package's phase-0 frame, and most rays pre-culled."""
    jcfg, cfg = _cfgs("planes", **samples)
    assert jframe._use_precull(jcfg) and frame._use_precull(cfg, CPU)
    K, pose = _scene()
    np_params = compact_field_params(r=1.0, k=20.0)
    jrgb, jdisp = _jax_frame(jcfg, np_params, pose, K)
    packed = fm.pack_nerf(_model(np_params), cfg)
    rgb, disp, r = _render(cfg, packed, pose, K)
    assert r.route == "planes" and rgb.shape == (H, W, 3)
    _outliers("rgb", rgb.numpy(), jrgb, 2e-3, 2e-2)
    _outliers("disp", disp.numpy(), jdisp, 5e-3, 8e-2)
    st = r.stats[-1]
    assert float(st["gate_frac_coarse"]) > 0.2
    assert 0 < st["n_act"] < H * W and st["gate_frac_fine"] is None


@pytest.mark.parametrize("arch", ["tiny_ball", "full_grid"])
def test_plain_frames_match_jax(arch, monkeypatch):
    """The plain route (``use_pallas false``) against the JAX package's XLA
    route with ``render_precull on``: at 4x64 (the JAX package's
    ``_cfg``) random weights on injected ball bounds, at 8x256 the compact
    field on each package's own grid."""
    if arch == "tiny_ball":
        shape, np_params = TINY, np_nerf_params(40, depth=4, width=64,
                                                L_x=6, L_d=2)
        monkeypatch.setattr(jframe, "_support_for_eval",
                            lambda model, params, cfg, module="coarse":
                            (_ball(jnp), True))
    else:
        shape, np_params = FULL, compact_field_params(r=1.0, k=20.0)
    jcfg, cfg = _cfgs("plain", arch=shape, N_samples_c=16, N_samples_f=24)
    assert jframe._use_precull(jcfg) and frame._use_precull(cfg, CPU)
    K, pose = _scene()
    jrgb, jdisp = _jax_frame(jcfg, np_params, pose, K, shape)
    packed = fm.pack_nerf(_model(np_params, shape), cfg)
    rgb, disp, r = _render(cfg, packed, pose, K, ball=arch == "tiny_ball")
    assert r.route == "plain"
    _outliers("rgb", rgb.numpy(), jrgb, 2e-3, 2e-2)
    _outliers("disp", disp.numpy(), jdisp, 5e-3, 8e-2)
    missed = float(r.stats[-1]["gate_frac_coarse"])
    assert missed == pytest.approx(_missed(cfg, pose, K, _ball())
                                   if arch == "tiny_ball" else
                                   _missed(cfg, pose, K,
                                           _bounds(cfg, packed)[0]))
    assert missed > 0.2


# ------------------------------------------------------------ within the port


@pytest.mark.parametrize("stratified", [False, True],
                         ids=["perturb0", "perturb1"])
@pytest.mark.parametrize("route", ["planes", "plain"])
def test_precull_on_is_off(route, stratified):
    """The compact field (zero density outside its ball): the pre-culled
    frame is the frame of the pre-cull off, with the jitter and the fine
    uniforms on too (each ray keeps its row of the frame's draw); the
    skipped share is the missed share of the bounds the renderer built,
    above 0.2, and no more rays are active."""
    _, cfg = _cfgs(route, perturb=1.0 if stratified else 0.0)
    K, pose = _scene()
    packed = fm.pack_nerf(_model(compact_field_params(r=1.0, k=20.0)), cfg)

    def gen():
        return torch.Generator().manual_seed(3) if stratified else None
    rgb, disp, r = _render(cfg, packed, pose, K, generator=gen())
    off = _render(dataclasses.replace(cfg, render_precull="off"), packed,
                  pose, K, generator=gen())
    _assert_on_is_off((rgb, disp), off)
    st, st_off = r.stats[-1], off[2].stats[-1]
    bounds, valid = _bounds(cfg, packed)
    assert valid
    missed = _missed(cfg, pose, K, bounds)
    assert float(st["gate_frac_coarse"]) == pytest.approx(missed)
    assert missed > 0.2 and st_off["gate_frac_coarse"] is None
    assert st["n_act"] == st_off["n_act"] and st["blocks"] == st_off["blocks"]


@pytest.mark.parametrize("route", ["planes", "plain"])
def test_invalid_bounds_take_todays_path(route):
    """Random weights: their grid's bounds are invalid, so the renderer
    takes the path of the pre-cull off (the same bits, no skipped share);
    invalid bounds handed to ``set_support`` do the same."""
    _, cfg = _cfgs(route, render_precull_grid=16)
    K, pose = _scene()
    packed = fm.pack_nerf(_model(np_nerf_params(41)), cfg)
    assert not _bounds(cfg, packed)[1]
    off = _render(dataclasses.replace(cfg, render_precull="off"), packed,
                  pose, K)
    rgb, disp, r = _render(cfg, packed, pose, K)
    r.set_support(packed, "coarse", (*_ball()[:3], torch.tensor([False])))
    again = r(packed, torch.from_numpy(pose))
    for got in ((rgb, disp), again):
        assert torch.equal(got[0], off[0]) and torch.equal(got[1], off[1])
    assert all(s["gate_frac_coarse"] is None for s in r.stats)


def test_small_cube_costs_coverage_not_correctness():
    """A grid cube too small for the orbit's segments ([-2, 2]^3 against
    cameras at radius 4, far 6): the rays leaving it are never culled, so
    fewer rays are skipped, and the frame is still the frame of the
    pre-cull off."""
    _, cfg = _cfgs("planes", render_precull_halfside=2.0)
    K, pose = _scene()
    packed = fm.pack_nerf(_model(compact_field_params(r=1.0, k=20.0)), cfg)
    ro, rd = (t.reshape(-1, 3) for t in get_rays(H, W, K, torch.from_numpy(
        pose[:3, :4]).float()))
    assert not segment_in_cube(ro, rd, 2.0, 2.0, 6.0).all()
    rgb, disp, r = _render(cfg, packed, pose, K)
    _assert_on_is_off((rgb, disp), _render(
        dataclasses.replace(cfg, render_precull="off"), packed, pose, K))
    bounds, valid = _bounds(cfg, packed)
    assert valid
    missed = float(r.stats[-1]["gate_frac_coarse"])
    assert missed == pytest.approx(_missed(cfg, pose, K, bounds))
    wide = dataclasses.replace(cfg, render_precull_halfside=0.0)
    assert missed < float(_render(wide, packed, pose, K)[2]
                          .stats[-1]["gate_frac_coarse"])


def _counting(fn, calls, name):
    def call(x, *a, **kw):
        calls.append((name, x.shape[-1]))
        return fn(x, *a, **kw)
    return call


@pytest.mark.parametrize("route", ["planes", "plain"])
def test_grid_runs_once_per_weights(route, monkeypatch):
    """One grid per set of fields from ``pack_nerf`` (a new pack, a new
    grid; the plain route's modules are copies each time).  On the plane
    route K7 runs once for the grid, once per phase-1 block over its hit
    rays' samples, and K8 once per cover block; on the plain route no
    kernel runs."""
    grids = []
    real = frame.support_bounds_from_sigma
    monkeypatch.setattr(frame, "support_bounds_from_sigma",
                        lambda *a, **kw: grids.append(1) or real(*a, **kw))
    _, cfg = _cfgs(route, chunk_rays=32)
    K, pose = _scene()
    model = _model(compact_field_params(r=1.0, k=20.0))
    calls = []
    kw = dict(sigma_fn=_counting(fm.fused_mlp_sigma_rays, calls, "K3"),
              field_fn=_counting(fm.fused_mlp_eval_rays, calls, "K1"),
              points_fn=_counting(fm.fused_mlp_sigma, calls, "K7"),
              plane_fn=_counting(fm.fused_mlp_eval, calls, "K8"))
    r = frame.make_frame_renderer(cfg, H, W, K, "cpu", stratified=False,
                                  **kw)
    packed = fm.pack_nerf(model, cfg)
    n_c = cfg.N_samples_c
    for i in range(2):
        calls.clear()
        r(packed, torch.from_numpy(pose))
        assert len(grids) == 1
        if route == "plain":
            assert calls == []
            continue
        st = r.stats[-1]
        n_hit = round((1 - float(st["gate_frac_coarse"])) * H * W)
        cover = frame._greedy_cover(n_hit, r.sizes)
        assert 0 < n_hit < H * W and len(cover) >= 2
        want = ([("K7", 48 ** 3)] if i == 0 else []) + [
            ("K7", min(sz, H * W - pos) * n_c) for pos, sz in cover]
        assert calls[:len(want)] == want
        assert [c[0] for c in calls[len(want):]] == ["K8"] * st["blocks"]
    r(fm.pack_nerf(model, cfg), torch.from_numpy(pose))
    assert len(grids) == 2
