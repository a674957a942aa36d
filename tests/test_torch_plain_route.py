"""The plain-MLP route of the port (``use_pallas false`` and every
architecture outside the fused kernels' domain) against the JAX package's
XLA route (``use_pallas=False``), which runs no Pallas kernel.

Same numpy-seeded weights on both sides (``utils/interop``), and the JAX
package's draws injected into the port (``u_c``, ``u_f``, ``coords``).
Shapes: (a) 4x64 at L_x = L_d = 0, (b) 6x128 at L_x 5, L_d 2, (c) the
reference 8x256 at L_x 10, L_d 4 with ``use_pallas`` off.  Tolerances:
- field functions: float32 to 1e-5 (relative, with the same absolute
  floor), bfloat16 to 2e-2 (tests/test_torch_model.py's: a product can
  round to the other bf16 neighbour);
- chunking: ``chunked_apply`` gives the bits of one call for a function
  whose rows are computed apart; the MLP's products on the CPU's BLAS
  change their float32 sum order with the row count, so the chunked field
  is held to 1e-6 relative;
- train steps: each step's losses to 1e-4 relative and every parameter at
  the end to 2e-3 relative L2, as tests/test_torch_train_parity.py (the
  fine pass's inverse-CDF tie flips and ReLU-boundary points reach the
  weights through Adam);
- frames: a coarse-only frame to 1e-5; with a fine pass by outlier
  fraction (below 0.2% beyond the tolerance, max and mean capped), as
  tests/test_torch_frame.py.
"""
import dataclasses
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_pytorch_paeng_tpu.config import NerfConfig as JaxConfig
from nerf_pytorch_paeng_tpu.config import config_from_file as jax_config
from nerf_pytorch_paeng_tpu.eval import frame as jframe
from nerf_pytorch_paeng_tpu.models.nerf import NeRF as JaxNeRF
from nerf_pytorch_paeng_tpu.ops import render as jrender
from nerf_pytorch_paeng_tpu.ops.rays import sample_pixels as jax_pixels
from nerf_pytorch_paeng_tpu.train import precull as jprecull
from nerf_pytorch_paeng_tpu.train import step as jstep
from nerf_pytorch_paeng_tpu.train.state import TrainState as JaxState
from nerf_pytorch_paeng_tpu.train.state import make_optimizer as jax_adam
from nerf_pytorch_paeng_tpu_torch import driver
from nerf_pytorch_paeng_tpu_torch.config import (NerfConfig,
                                                 config_from_file,
                                                 load_config)
from nerf_pytorch_paeng_tpu_torch.eval import frame
from nerf_pytorch_paeng_tpu_torch.kernels import fused_mlp as fm
from nerf_pytorch_paeng_tpu_torch.models.nerf import NeRF
from nerf_pytorch_paeng_tpu_torch.ops import render
from nerf_pytorch_paeng_tpu_torch.train import TrainState, make_optimizer
from nerf_pytorch_paeng_tpu_torch.train.precull import train_precull_enabled
from nerf_pytorch_paeng_tpu_torch.train.schedule import schedule_from_cfg
from nerf_pytorch_paeng_tpu_torch.train.step import (make_image_train_step,
                                                     make_train_step,
                                                     step_route,
                                                     uses_ray_pair)
from nerf_pytorch_paeng_tpu_torch.utils.interop import \
    state_dict_from_jax_params
from nerf_pytorch_paeng_tpu_torch.utils.synth import (make_synth_scene,
                                                      save_as_blender_dataset)

from torch_port_util import np_nerf_params, to_jax

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPES = {"a": dict(netDepth=4, netWidth=64, L_x=0, L_d=0),
          "b": dict(netDepth=6, netWidth=128, L_x=5, L_d=2),
          "c": dict(netDepth=8, netWidth=256, L_x=10, L_d=4)}


def _np_params(seed, shape):
    s = SHAPES[shape]
    return np_nerf_params(seed, L_x=s["L_x"], L_d=s["L_d"],
                          depth=s["netDepth"], width=s["netWidth"])


def _model(params, shape):
    s = SHAPES[shape]
    model = NeRF(depth=s["netDepth"], width=s["netWidth"], L_x=s["L_x"],
                 L_d=s["L_d"])
    model.load_state_dict(state_dict_from_jax_params(params))
    return model


def _jax_model(shape, compute_dtype="float32"):
    s = SHAPES[shape]
    return JaxNeRF(depth=s["netDepth"], width=s["netWidth"], L_x=s["L_x"],
                   L_d=s["L_d"],
                   compute_dtype=(jnp.float32 if compute_dtype == "float32"
                                  else jnp.bfloat16))


def _cfgs(shape, **kw):
    kw = dict(use_pallas=False, **SHAPES[shape], **kw)
    return JaxConfig(**kw), NerfConfig(device="cpu", **kw)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# --------------------------------------------------------- field functions


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plain_fields_match_jax_xla_fields(shape, dtype):
    """``make_plain_field_fns`` against ``make_xla_field_fns`` on the same
    planes (a chunk size that does not divide P), both modules."""
    jcfg, cfg = _cfgs(shape, compute_dtype=dtype, chunk_pts=100)
    params = _np_params(1, shape)
    jfns = jrender.make_xla_field_fns(_jax_model(shape, dtype),
                                      to_jax(params), jcfg)
    fns = render.make_plain_field_fns(_model(params, shape), cfg)
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1.5, (3, 333)).astype(np.float32)
    d = rng.normal(0, 1, (3, 333)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == "float32"
           else dict(rtol=2e-2, atol=2e-2))
    for jfn, fn in zip(jfns, fns):
        want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(d)))
        got = fn(*_t(x, d))
        assert got.shape == (4, 333) and got.dtype == torch.float32
        np.testing.assert_allclose(got.detach().numpy(), want, **tol)


def test_chunked_apply_gives_one_calls_bits():
    """A chunk size that does not divide the rows, one chunk, and
    ``chunk_pts <= 0`` (one call) give the same bits for a function that
    computes each row apart; the plain field chunked at float32 stays
    within float32 noise of one call (the CPU's products change their sum
    order with the row count)."""
    x = torch.randn(1000, 6, generator=torch.Generator().manual_seed(3))

    def fn(v):
        return torch.sin(v) * v.pow(2).sum(-1, keepdim=True)

    want = fn(x)
    for chunk in (1, 7, 333, 999, 1000, 5000, 0, -1):
        assert torch.equal(render.chunked_apply(fn, x, chunk), want), chunk

    _, cfg = _cfgs("c", chunk_pts=0, compute_dtype="float32")
    model = _model(_np_params(4, "c"), "c")
    xp, dp = torch.randn(3, 1000), torch.randn(3, 1000)
    one = render.plain_field_fn(model.model_fine, cfg)(xp, dp)
    for chunk in (7, 333):
        got = render.plain_field_fn(
            model.model_fine, dataclasses.replace(cfg, chunk_pts=chunk))(xp, dp)
        assert _rel(got.detach(), one.detach()) <= 1e-6, chunk


def test_plain_fields_are_differentiable_and_run_no_kernel(monkeypatch):
    """The field's gradient reaches every parameter of its module, and no
    kernel wrapper is called on the way."""
    def never(*a, **kw):
        raise AssertionError("a kernel wrapper ran on the plain route")

    for name in ("fused_mlp_eval", "fused_mlp_sigma", "fused_mlp_eval_rays",
                 "fused_mlp_sigma_rays"):
        monkeypatch.setattr(fm, name, never)
    _, cfg = _cfgs("b")
    model = _model(_np_params(5, "b"), "b")
    coarse, _ = render.make_plain_field_fns(model, cfg)
    coarse(torch.randn(3, 50), torch.randn(3, 50)).square().sum().backward()
    for name, p in model.model_coarse.named_parameters():
        assert p.grad is not None and bool(p.grad.abs().sum() > 0), name
    assert all(p.grad is None for p in model.model_fine.parameters())


# ------------------------------------------------------------- train steps


def _draws(key, n, sc, sf):
    """The render's uniforms from ``key`` (``render_rays``' split)."""
    key_c, key_f = jax.random.split(key)
    return (torch.from_numpy(np.array(jax.random.uniform(key_c, (n, sc)))),
            torch.from_numpy(np.array(jax.random.uniform(key_f, (n, sf)))))


def _rays(seed, n):
    rng = np.random.default_rng(seed)
    o = (np.array([0.0, 0.0, 4.0]) + rng.normal(0, 0.1, (n, 3)))
    d = -o / 4.0 + rng.normal(0, 0.2, (n, 3))
    tgt = rng.uniform(0, 1, (n, 3))
    return [a.astype(np.float32) for a in (o, d, tgt)]


def _train_cfgs(shape, sc, sf, n_rays):
    return _cfgs(shape, compute_dtype="float32", N_rays=n_rays,
                 N_samples_c=sc, N_samples_f=sf, iter_N=10, iter_warmup=2,
                 precrop_frac=0.5)


def _states(jcfg, cfg, params, shape):
    tx = jax_adam(jcfg)
    jp = to_jax(params)
    model = _model(params, shape)
    return (tx, JaxState(jnp.zeros((), jnp.int32), jp, tx.init(jp)),
            TrainState(model, make_optimizer(model, cfg), 0))


def _compare_final(model, jparams):
    want = state_dict_from_jax_params(jax.device_get(jparams))
    for name, p in model.named_parameters():
        assert _rel(p.detach().numpy(), want[name].numpy()) <= 2e-3, name


@pytest.mark.parametrize("shape", ["a", "c"])
def test_global_batch_plain_trajectory_matches_jax(shape):
    """Three global-batch steps of 128 rays (a ray-kernel shape: the route
    is the config's alone) against the JAX XLA step + optax Adam."""
    jcfg, cfg = _train_cfgs(shape, 8, 8, 128)
    assert step_route(cfg, 128) == "plain" and not uses_ray_pair(cfg, 128)
    params = _np_params(30, shape)
    tx, jstate, state = _states(jcfg, cfg, params, shape)
    jax_step = jax.jit(jstep.make_train_step(_jax_model(shape), tx, jcfg))
    port_step = make_train_step(cfg, schedule_from_cfg(cfg))
    step_key = jax.random.PRNGKey(jcfg.seed + 3)
    for i in range(3):
        o, d, tgt = _rays(31 + i, 128)
        jstate, jm = jax_step(jstate, jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(tgt), step_key)
        u_c, u_f = _draws(jax.random.fold_in(step_key, i), 128, 8, 8)
        m = port_step(state, *_t(o, d, tgt), u_c=u_c, u_f=u_f)
        assert "gate_frac" not in m
        for k in ("loss", "loss_c", "loss_f", "psnr"):
            assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-4), (i, k)
    assert state.step == int(jstate.step) == 3
    _compare_final(state.model, jstate.params)


@pytest.mark.parametrize("shape,sc,sf", [("a", 6, 5), ("c", 8, 8)])
def test_per_image_plain_trajectory_matches_jax(shape, sc, sf):
    """Three per-image steps (the first two inside the precrop window),
    the JAX step's pixels and draws injected; shape (a) at 6+5 samples,
    off the kernels' 8-sample rows."""
    jcfg, cfg = _train_cfgs(shape, sc, sf, 128)
    params = _np_params(32, shape)
    images, K, poses = make_synth_scene(n_views=2, H=32, W=32)
    tx, jstate, state = _states(jcfg, cfg, params, shape)
    jax_step = jstep.make_image_train_step(_jax_model(shape), tx, jcfg, 32,
                                           32, K)
    port_step = make_image_train_step(cfg, schedule_from_cfg(cfg), 32, 32, K)
    step_key = jax.random.PRNGKey(jcfg.seed + 3)
    for i, (view, precrop) in enumerate([(0, True), (1, True), (0, False)]):
        img, pose = images[view], poses[view][:3, :4].astype(np.float32)
        jstate, jm = jax_step(jstate, jnp.asarray(img), jnp.asarray(pose),
                              step_key, precrop=precrop)
        key_px, key_render = jax.random.split(jax.random.fold_in(step_key, i))
        coords = jax_pixels(key_px, 32, 32, 128, precrop=precrop,
                            precrop_frac=cfg.precrop_frac)
        u_c, u_f = _draws(key_render, 128, sc, sf)
        m = port_step(state, *_t(img, pose), precrop=precrop,
                      coords=torch.from_numpy(np.array(coords)).long(),
                      u_c=u_c, u_f=u_f)
        for k in ("loss", "loss_c", "loss_f"):
            assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-4), (i, k)
    _compare_final(state.model, jstate.params)


# ------------------------------------------------------------------ frames

H = W = 16
FRAME_KW = dict(near=2.0, far=6.0, perturb=0.0, compute_dtype="float32")


def _outliers(name, ours, ref, tol, cap):
    diff = np.abs(ours - ref)
    frac_out = float((diff > tol + tol * np.abs(ref)).mean())
    assert frac_out < 2e-3, (name, frac_out)
    assert float(diff.max()) < cap, (name, float(diff.max()))
    assert float(diff.mean()) < 1e-4, (name, float(diff.mean()))


def _frames(shape, data_type="blender", **kw):
    """(port frame, JAX frame, port renderer) of one view of the synthetic
    scene through both packages' ``make_frame_renderer``, deterministic
    sampling, random seeded weights."""
    jcfg, cfg = _cfgs(shape, data_type=data_type, **{**FRAME_KW, **kw})
    params = _np_params(40, shape)
    _, K, poses = make_synth_scene(n_views=1, H=H, W=W)
    jr = jframe.make_frame_renderer(_jax_model(shape), jcfg, H, W, K,
                                    stratified=False)
    want = jr(to_jax(params), jnp.asarray(poses[0][:3, :4]),
              jax.random.PRNGKey(0))
    r = frame.make_frame_renderer(cfg, H, W, K, "cpu", stratified=False)
    got = r(fm.pack_nerf(_model(params, shape), cfg),
            torch.from_numpy(poses[0]))
    return got, want, r


@pytest.mark.parametrize("shape,cull,sc,sf", [
    ("a", "none", 8, 8), ("b", "none", 6, 5), ("a", "auto", 8, 8),
    ("b", "auto", 6, 5)])
def test_plain_frames_match_jax(shape, cull, sc, sf):
    """Both renderers at shapes (a) and (b), one on and one off the
    kernels' 8-sample rows; the culled one with a ray block of 64, so that
    its cover has several blocks and classes."""
    (rgb, disp), (jrgb, jdisp), r = _frames(
        shape, render_cull=cull, N_samples_c=sc, N_samples_f=sf,
        chunk_rays=64)
    assert r.route == "plain" and not r.rays_route
    assert rgb.shape == (H, W, 3) and rgb.dtype == torch.float32
    _outliers("rgb", rgb.numpy(), np.asarray(jrgb), 2e-3, 2e-2)
    _outliers("disp", disp.numpy(), np.asarray(jdisp), 5e-3, 8e-2)
    if cull == "auto":
        st = r.stats[-1]
        assert st["blocks"] >= 2 and st["n_act"] > 0
        assert st["gate_frac_coarse"] is None and st["gate_frac_fine"] is None
    else:
        assert r.launches_per_frame == 0


def test_plain_coarse_only_frame_matches_jax_strictly():
    """Without a fine pass the frame is the coarse field's composite,
    which no resample touches: 1e-5."""
    (rgb, disp), (jrgb, jdisp), r = _frames(
        "a", render_cull="none", N_samples_c=8, N_samples_f=0)
    assert r.route == "plain"
    np.testing.assert_allclose(rgb.numpy(), np.asarray(jrgb), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(disp.numpy(), np.asarray(jdisp), rtol=1e-5,
                               atol=1e-5)


def test_plain_llff_frame_matches_jax():
    """An LLFF config on the plain route: NDC rays (near 0, far 1)."""
    (rgb, disp), (jrgb, jdisp), r = _frames(
        "a", data_type="llff", render_cull="none", N_samples_c=8,
        N_samples_f=8, near=0.0, far=1.0)
    assert r.route == "plain"
    _outliers("rgb", rgb.numpy(), np.asarray(jrgb), 2e-3, 2e-2)
    _outliers("disp", disp.numpy(), np.asarray(jdisp), 5e-3, 8e-2)


def test_renderer_refuses_the_other_routes_fields():
    """No route hands over to another: a plain renderer given packed
    weights, or a kernel renderer given the plain route's modules,
    raises."""
    _, K, poses = make_synth_scene(n_views=1, H=8, W=8)
    _, plain = _cfgs("c", N_samples_c=8, N_samples_f=8)
    kern = dataclasses.replace(plain, use_pallas=True)
    model = _model(_np_params(41, "c"), "c")
    assert fm.pack_nerf(model, plain)["route"] == "plain"
    assert "route" not in fm.pack_nerf(model, kern)
    for cull in ("none", "auto"):
        for cfg, other in ((plain, kern), (kern, plain)):
            c = dataclasses.replace(cfg, render_cull=cull)
            r = frame.make_frame_renderer(c, 8, 8, K, "cpu")
            with pytest.raises(ValueError, match="route|modules|packed"):
                r(fm.pack_nerf(model, other), torch.from_numpy(poses[0]))


def test_pack_nerf_on_the_plain_route_copies_the_modules():
    """On the plain route ``pack_nerf`` hands over a copy of each module
    (the same weights, not the live ones); the kernels' packing still
    refuses the architecture."""
    _, cfg = _cfgs("a")
    model = _model(_np_params(42, "a"), "a")
    fields = fm.pack_nerf(model, cfg, device="cpu")
    for name, mlp in (("coarse", model.model_coarse),
                      ("fine", model.model_fine)):
        assert fields[name] is not mlp
        for (k, a), (_, b) in zip(fields[name].state_dict().items(),
                                  mlp.state_dict().items()):
            assert torch.equal(a, b) and a.data_ptr() != b.data_ptr(), k
    with pytest.raises(NotImplementedError):
        fm.pack_flat(model.model_fine, 0, 0)


# ----------------------------------------------------------------- routing

OUTSIDE = [dict(use_pallas=False), dict(netDepth=4), dict(netWidth=128),
           dict(L_x=0), dict(L_d=0), dict(L_x=11), dict(L_d=5)]


@pytest.mark.parametrize("kw", OUTSIDE, ids=lambda kw: "-".join(
    f"{k}{v}" for k, v in kw.items()))
def test_outside_the_kernels_domain_everything_routes_plain(kw):
    """``use_pallas`` off at the reference shape and every architecture
    outside the kernels' domain: the step (ray-kernel and plane shapes
    alike), both renderers and the pre-cull all take the plain route, as
    the JAX package's predicates say (``render_precull on`` pre-culls on
    the plain route too, as phase 0; gate-fine stays off)."""
    base = dict(N_samples_c=8, N_samples_f=8, render_precull_grid=16,
                train_precull="on", render_precull="on",
                render_gate_fine="on", N_rays=256)
    jcfg = JaxConfig(**{**base, **kw})
    cfg = NerfConfig(device="cpu", **{**base, **kw})
    cpu = torch.device("cpu")
    assert not jstep._supports_pallas_train(jcfg)
    assert not jframe._supports_pallas(jcfg)
    assert render.plain_route_reason(cfg) is not None
    for n in (256, 100):
        assert step_route(cfg, n) == "plain" and not uses_ray_pair(cfg, n)
        assert not render.supports_train_rays_kernels(cfg, n)
    assert not train_precull_enabled(cfg)
    assert not jprecull.train_precull_enabled(jcfg)
    assert not frame._use_rays_kernels(cfg)
    assert not jframe._use_rays_kernels(jcfg)
    assert frame._use_precull(cfg, cpu) == jframe._use_precull(jcfg)
    assert not frame._use_gate_fine(cfg, cpu)
    _, K, _ = make_synth_scene(n_views=1, H=8, W=8)
    for cull in ("none", "auto"):
        r = frame.make_frame_renderer(dataclasses.replace(cfg,
                                                          render_cull=cull),
                                      8, 8, K, "cpu")
        assert r.route == "plain" and not r.rays_route


@pytest.mark.parametrize("kw,n,route", [
    (dict(), 256, "rays"), (dict(use_rays_train=False), 256, "planes"),
    (dict(), 100, "planes"), (dict(N_samples_f=5), 256, "planes")])
def test_inside_the_kernels_domain_the_routes_stay(kw, n, route):
    """The reference shape with ``use_pallas`` on routes as before: the
    ray pair or the plane pair in the step, the ray kernels or the plane
    layout in the renderers, the pre-cull where it applied."""
    cfg = NerfConfig(device="cpu", **{
        **dict(N_samples_c=8, N_samples_f=8, render_precull_grid=16,
               train_precull="on", N_rays=n), **kw})
    assert render.plain_route_reason(cfg) is None
    assert step_route(cfg, n) == route
    assert train_precull_enabled(cfg) == (route == "rays")
    _, K, _ = make_synth_scene(n_views=1, H=8, W=8)
    r = frame.make_frame_renderer(dataclasses.replace(cfg, render_cull="none"),
                                  8, 8, K, "cpu")
    ray_frame = frame._use_rays_kernels(cfg)
    assert r.route == ("rays" if ray_frame else "planes")
    assert frame._use_precull(cfg, torch.device("cpu")) == ray_frame


@pytest.mark.parametrize("kw,reason", [
    (dict(use_pallas=False), "use_pallas false"),
    (dict(netDepth=4), "netDepth 4 != 8"),
    (dict(netWidth=128), "netWidth 128 != 256"),
    (dict(L_x=0), "L_x 0 outside 1..10"),
    (dict(L_d=0), "L_d 0 outside 1..4")])
def test_plain_route_reason_names_the_cause(kw, reason):
    assert render.plain_route_reason(NerfConfig(**kw)) == reason
    assert render.supports_kernels(NerfConfig())


# ------------------------------------------------------------ config, CLI


def test_use_pallas_parses_as_jax_does(tmp_path):
    """``use_pallas`` from a config file and from the command line, the
    JAX package's name, default and parsing."""
    assert NerfConfig().use_pallas is JaxConfig().use_pallas is True
    for text in ("false", "False", "0", "no", "true", "yes"):
        path = tmp_path / f"cfg_{text}.txt"
        path.write_text(f"use_pallas = {text}\nnetDepth = 4\n")
        ours, theirs = config_from_file(str(path)), jax_config(str(path))
        assert ours.use_pallas == theirs.use_pallas == (text in ("true", "yes"))
        assert ours.netDepth == theirs.netDepth == 4
    cfg = load_config(["--config", str(ROOT / "configs/blender/lego.txt"),
                       "--use_pallas", "false"])
    assert cfg.use_pallas is False


@pytest.fixture(scope="module")
def scene32(tmp_path_factory):
    root = tmp_path_factory.mktemp("plain32")
    save_as_blender_dataset(str(root), n_train=2, n_val=1, n_test=1,
                            H=32, W=32)
    return str(root)


def _args(data_root, log_dir, exp, *extra):
    return ["--config", str(ROOT / "configs/blender/lego.txt"),
            "--device", "cpu", "--data_root", data_root,
            "--log_dir", log_dir, "--exp_name", exp, "--iter_warmup", "0",
            "--N_rays", "128", "--N_samples_c", "8", "--N_samples_f", "8",
            "--idx_print", "0", "--idx_vis", "0", "--idx_test", "0",
            "--n_angle", "2", *extra]


@pytest.mark.parametrize("flags,reason", [
    (["--netDepth", "4", "--netWidth", "64", "--L_x", "0", "--L_d", "0"],
     "netDepth 4 != 8"),
    (["--use_pallas", "false", "--global_batch", "true"],
     "use_pallas false")], ids=["shape_a", "use_pallas_false"])
def test_cli_trains_evaluates_and_renders_on_the_plain_route(
        scene32, tmp_path, capsys, flags, reason):
    """The entry point on the CPU: 4 steps with the save, test and render
    hooks, then ``--eval_only`` and ``--render_only`` of the saved
    weights; the route is printed once a run."""
    logs = str(tmp_path / "logs")
    res = driver.main_worker(load_config(_args(
        scene32, logs, "plain", "--iter_N", "4", "--idx_save", "4",
        "--idx_test", "4", "--idx_render", "4", *flags)))
    out = capsys.readouterr().out
    assert out.count(">> field route:") == 1
    assert f">> field route: plain ({reason})" in out
    assert res["step"] == 4 and all(np.isfinite(res["loss"]))
    assert all(g is None for g in res["gate_frac"])
    exp = os.path.join(logs, "plain")
    assert os.path.isfile(os.path.join(exp, "plain_4.pth.tar"))
    for sub in ("test_result/_result.txt", "render_result/_rgb.gif"):
        assert os.path.isfile(os.path.join(exp, "plain_4", sub)), sub
    res = driver.main_worker(load_config(_args(
        scene32, logs, "plain", "--eval_only", "true", "--render_only",
        "true", "--testing_idx", "4", *flags)))
    assert len(res["psnr"]) == 1 and np.isfinite(res["psnr"][0])
    assert res["render"]["rgbs"].shape == (2, 32, 32, 3)
    assert np.isfinite(res["render"]["rgbs"]).all()
