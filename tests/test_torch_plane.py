"""The plane layout of the port against the JAX package's: K8's and K9's
plain versions (``fused_mlp_eval``, ``fused_mlp_bwd``), the K8+K9 autograd
pair, planar compositing, ``render_rays_from_cfg`` on the plane pair, both
train steps on the plane route, the plane branches of both frame
renderers, and the routing that picks the plane layout.

On the CPU the wrappers run their plain versions; the JAX side runs its
Pallas kernels in interpret mode, which computes in float32, as its own
tests do.  Same numpy-seeded weights, points and draws on both sides (the
JAX package's draws injected as ``u_c``/``u_f``).  Tolerances:
- K8: 1e-4 relative with an absolute floor (float32 sums in another
  order), as tests/test_torch_kernels.py;
- K9 and the pair: relative L2 per layer, 1e-5 between the port's own
  float32 paths and 5e-5 against the JAX package, with points whose ReLU
  input lies within 1e-5 of zero left out (their cotangents zeroed): two
  float32 forwards can put such a point on opposite sides of a ReLU, and
  its contribution then jumps (as in tests/test_torch_vjp.py);
- compositing: 1e-5 relative, 1e-6 absolute;
- renders and steps: the losses to 1e-5 and the coarse outputs to 1e-4,
  the fine outputs by outlier fraction (at most 2% of rays beyond 1e-4;
  inverse-CDF tie flips), the gradients per layer to cosine 0.999 and
  relative L2 2e-2 (coarse) or 5e-2 (fine; see
  ``test_render_rays_from_cfg_matches_jax``); trajectories as
  tests/test_torch_train_parity.py; frames as tests/test_torch_frame.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_pytorch_paeng_tpu.config import NerfConfig as JaxConfig
from nerf_pytorch_paeng_tpu.eval import frame as jframe
from nerf_pytorch_paeng_tpu.kernels import fused_mlp as jfm
from nerf_pytorch_paeng_tpu.kernels import fused_mlp_vjp as jfv
from nerf_pytorch_paeng_tpu.models.nerf import NeRF as JaxNeRF
from nerf_pytorch_paeng_tpu.ops import render as jrender
from nerf_pytorch_paeng_tpu.ops import volume as jvolume
from nerf_pytorch_paeng_tpu.ops.rays import sample_pixels as jax_pixels
from nerf_pytorch_paeng_tpu.train import precull as jprecull
from nerf_pytorch_paeng_tpu.train import step as jstep
from nerf_pytorch_paeng_tpu.train.state import TrainState as JaxState
from nerf_pytorch_paeng_tpu.train.state import make_optimizer as jax_adam
from nerf_pytorch_paeng_tpu_torch.config import NerfConfig
from nerf_pytorch_paeng_tpu_torch.eval import frame
from nerf_pytorch_paeng_tpu_torch.kernels import fused_mlp as fm
from nerf_pytorch_paeng_tpu_torch.kernels import fused_mlp_vjp as fv
from nerf_pytorch_paeng_tpu_torch.models.nerf import NeRF
from nerf_pytorch_paeng_tpu_torch.ops import render, volume
from nerf_pytorch_paeng_tpu_torch.ops.posenc import build_emb
from nerf_pytorch_paeng_tpu_torch.train import TrainState, make_optimizer
from nerf_pytorch_paeng_tpu_torch.train.precull import train_precull_enabled
from nerf_pytorch_paeng_tpu_torch.train.schedule import schedule_from_cfg
from nerf_pytorch_paeng_tpu_torch.train.step import (make_image_train_step,
                                                     make_train_step,
                                                     uses_ray_pair)
from nerf_pytorch_paeng_tpu_torch.utils.interop import \
    state_dict_from_jax_params
from nerf_pytorch_paeng_tpu_torch.utils.synth import (
    compact_field_params, compact_field_state_dict, make_synth_scene)

from torch_port_util import np_nerf_params, np_rays, to_jax

P = 384                     # points: three 128-point Pallas grid steps
TOL = dict(rtol=1e-4, atol=1e-4)
REL, REL_JAX, RELU_MARGIN = 1e-5, 5e-5, 1e-5


def _model(params):
    model = NeRF()
    model.load_state_dict(state_dict_from_jax_params(params))
    return model


def _planes(seed, n=P, d_scale=1.0):
    """Seeded position and unit direction planes [3, n] of blender-like
    samples, the directions scaled by ``d_scale``."""
    od, z = np_rays(np.random.default_rng(seed), n, 1)
    d = od[3:6] / np.linalg.norm(od[3:6], axis=0, keepdims=True)
    return ((od[0:3] + od[3:6] * z).astype(np.float32),
            (d * d_scale).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _fine_grads(mlp, dw, db):
    """Packed-layout gradients -> {state-dict key: gradient} through the
    VJP of the differentiable packing."""
    w, b = fm.pack_flat(mlp)
    params = dict(mlp.named_parameters())
    grads = torch.autograd.grad([w, b], list(params.values()),
                                grad_outputs=[dw, db])
    return {f"model_fine.{k}": g.numpy() for k, g in zip(params, grads)}


def _jax_fine(tree):
    """A JAX gradient tree of one module -> {model_fine.*: numpy}."""
    return {k: v.numpy() for k, v in state_dict_from_jax_params(
        {"coarse": tree, "fine": tree}).items() if k.startswith("model_fine")}


def _assert_grads_close(got, want, rel):
    assert set(got) == set(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        assert _rel(got[key], want[key]) <= rel, (key, _rel(got[key],
                                                            want[key]))


def _relu_margin(x, d, p):
    """[P]: the smallest |ReLU input| of each point's forward (trunk and
    view layer; d as given), float32 packed weights ``p``."""
    embx = build_emb(x.T, 10, fm.EMBX_ROWS)
    pre = embx @ p["w0"] + p["b0"]
    margin = pre.abs().min(-1).values
    for i in range(1, 8):
        pre = torch.relu(pre) @ p[f"w{i}" if i != 5 else "w5h"] + p[f"b{i}"]
        if i == 5:
            pre = pre + embx @ p["w5e"]
        margin = torch.minimum(margin, pre.abs().min(-1).values)
    feat = torch.relu(pre) @ p["wfeat"] + p["bfeat"]
    pre = (feat @ p["wvf"] + build_emb(d.T, 4, fm.EMBD_ROWS) @ p["wvd"]
           + p["bv"])
    return torch.minimum(margin, pre.abs().min(-1).values)


# ------------------------------------------------------------------- K8


@pytest.mark.parametrize("L_x,L_d,d_scale", [(10, 4, 1.0), (7, 3, 1.7)])
def test_eval_plain_matches_jax(L_x, L_d, d_scale):
    """K8's plain version against ``fused_mlp_eval(interpret=True)``: rows
    r, g, b, sigma (the JAX kernel's rows 0-3); directions are embedded as
    given on both sides (scaled ones included)."""
    params = np_nerf_params(0, L_x=L_x, L_d=L_d)
    model = NeRF(L_x=L_x, L_d=L_d)
    model.load_state_dict(state_dict_from_jax_params(params))
    packed = fm.pack_nerf_mlp_params(model.model_fine, L_x, L_d,
                                     dtype=torch.float32)
    x, d = _planes(1, d_scale=d_scale)
    want = np.asarray(jfm.fused_mlp_eval(
        jnp.asarray(x), jnp.asarray(d),
        jfm.pack_nerf_mlp_params(to_jax(params["fine"]), L_x=L_x, L_d=L_d),
        L_x=L_x, L_d=L_d, tile=128, interpret=True))
    got = fm.fused_mlp_eval(*_t(x, d), packed, L_x=L_x, L_d=L_d)
    assert got.shape == (4, P) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want[:4], **TOL)
    assert not want[4:].any()


def test_eval_wrapper_dispatch_and_checks():
    """bf16 outputs are the float32 result rounded; the CPU counts no
    launch; its sigma row is K7's plain sigma; bad planes are refused."""
    model = _model(np_nerf_params(2))
    packed = fm.pack_nerf_mlp_params(model.model_fine, dtype=torch.float32)
    x, d = _t(*_planes(3, n=200))
    before = fm.fused_mlp_eval.launches
    f32 = fm.fused_mlp_eval(x, d, packed)
    b16 = fm.fused_mlp_eval(x, d, packed, out_dtype=torch.bfloat16)
    assert fm.fused_mlp_eval.launches == before
    assert torch.equal(f32.to(torch.bfloat16), b16)
    assert torch.equal(f32[3], fm.fused_mlp_sigma(x, packed))
    for bad in ((x[:, :-1].contiguous(), d), (x.double(), d),
                (x, d.T.contiguous().T), (x[:2].contiguous(), d[:2])):
        with pytest.raises(ValueError):
            fm.fused_mlp_eval(*bad, packed)
    with pytest.raises(ValueError):
        fm.fused_mlp_eval(x, d, packed, L_d=5)


def test_flop_per_point():
    """A point's full field costs a sample's plus its own direction term
    (27 x 128 multiply-adds at L_d=4); its backward K2's count plus the
    same term."""
    assert fm.eval_flop_per_point(10, 4) == fm.eval_flop_per_sample(10) \
        + 2 * 27 * 128
    assert fm.bwd_flop_per_point(10, 4) == fm.bwd_flop_per_sample(10, 4) \
        + 6912


# ------------------------------------------------------------------- K9


def _bwd_setup(seed, n=P):
    params = np_nerf_params(seed)
    mlp = _model(params).model_fine
    packed = fm.pack_nerf_mlp_params(mlp, dtype=torch.float32)
    x, d = _planes(seed + 100, n)
    rng = np.random.default_rng(seed + 200)
    g4 = rng.normal(0, 1e-3, (4, n)).astype(np.float32)
    return params, mlp, packed, x, d, g4


def test_bwd_plain_matches_jax_bwd_call():
    """K9's plain version against ``_bwd_call(interpret=True)`` per layer,
    away from ReLU-boundary points."""
    params, mlp, packed, x, d, g4 = _bwd_setup(10)
    keep = (_relu_margin(*_t(x, d), packed) >= RELU_MARGIN).numpy()
    assert keep.mean() > 0.8                # ~10% dropped at this size
    g4 = np.where(keep[None], g4, 0.0).astype(np.float32)
    packed_j, unpack = jax.vjp(jfm.pack_nerf_mlp_params,
                               to_jax(params["fine"]))
    g8 = np.concatenate([g4, np.zeros((4, P), np.float32)])
    dpacked = jax.jit(lambda x, d, g: jfv._bwd_call(
        x, d, g, packed_j, 10, 4, 128, interpret=True))(
            jnp.asarray(x), jnp.asarray(d), jnp.asarray(g8))
    want = _jax_fine(unpack(dpacked)[0])
    dw, db = fv.fused_mlp_bwd(*_t(x, d, g4), packed)
    assert dw.dtype == db.dtype == torch.float32
    assert dw.shape == (fm.W_TOTAL,) and db.shape == (fm.B_TOTAL,)
    _assert_grads_close(_fine_grads(mlp, dw, db), want, REL_JAX)


def test_bwd_plain_matches_autograd_of_plain_forward():
    """float32: the hand-written chain is the derivative of K8's plain
    version, and splitting the points into chunks (the kernel's blocks)
    adds up to the whole."""
    _, mlp, packed, x, d, g4 = _bwd_setup(11)
    x, d, g4 = _t(x, d, g4)
    w, b = fm.pack_flat(mlp)
    fm.fused_mlp_eval_plain(x, d, fm._with_views(w, b)).backward(g4)
    want = {f"model_fine.{k}": p.grad.numpy()
            for k, p in mlp.named_parameters()}
    dw, db = fv.fused_mlp_bwd_plain(x, d, g4, packed)
    _assert_grads_close(_fine_grads(mlp, dw, db), want, REL)
    parts = fv.fused_mlp_bwd_plain(x, d, g4, packed, chunk=100)
    for got, whole in zip(parts, (dw, db)):
        assert _rel(got.numpy(), whole.numpy()) <= REL


def test_bwd_wrapper_checks_and_no_points():
    _, _, packed, x, d, g4 = _bwd_setup(12, n=64)
    x, d, g4 = _t(x, d, g4)
    before = fv.fused_mlp_bwd.launches
    fv.fused_mlp_bwd(x, d, g4, packed)
    assert fv.fused_mlp_bwd.launches == before
    for bad in (g4[:3].contiguous(), g4.double(), g4.T.contiguous().T,
                g4[:, :-1].contiguous()):
        with pytest.raises(ValueError):
            fv.fused_mlp_bwd(x, d, bad, packed)
    e = torch.empty(3, 0)
    dw, db = fv.fused_mlp_bwd(e, e, torch.empty(4, 0), packed)
    assert not dw.any() and not db.any()


def test_train_pair_matches_jax_grad():
    """``fused_mlp_train`` (K8 forward, K9 backward) under autograd: the
    outputs and the module's gradients of a loss over them against
    ``jax.grad`` through the JAX package's ``fused_mlp_train``, away from
    ReLU-boundary points; the planes get no gradient."""
    params, mlp, packed, x, d, c = _bwd_setup(13)
    keep = (_relu_margin(*_t(x, d), packed) >= RELU_MARGIN).numpy()
    c = np.where(keep[None], c, 0.0).astype(np.float32) * 1e3

    def jloss(p):
        out = jfv.fused_mlp_train(jfm.pack_nerf_mlp_params(p),
                                  jnp.asarray(x), jnp.asarray(d), tile=128,
                                  interpret=True)
        return jnp.sum(jnp.asarray(c) * jnp.tanh(out[:4])), out[:4]

    (_, jout), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        to_jax(params["fine"]))
    w, b = fm.pack_flat(mlp)
    xt, dt = _t(x, d)
    out = fv.fused_mlp_train(w, b, xt, dt, weight_dtype=torch.float32)
    assert out.shape == (4, P) and out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    torch.sum(torch.from_numpy(c) * torch.tanh(out)).backward()
    got = {f"model_fine.{k}": p.grad.numpy()
           for k, p in mlp.named_parameters()}
    _assert_grads_close(got, _jax_fine(jgrads), REL_JAX)
    assert xt.grad is None and dt.grad is None


# ---------------------------------------------------------- compositing


def test_planar_compositing_matches_jax():
    """``weights_from_sigma``, ``volume_render_planar`` and
    ``exclusive_cumprod`` against the JAX package's, and the planar
    composite equals the sample-major one on the transposed inputs."""
    rng = np.random.default_rng(20)
    n, s = 50, 13
    raw = rng.normal(0, 2, (4, n, s)).astype(np.float32)
    raw[3, :5] = -1.0                                    # empty rays: acc 0
    z = np.sort(rng.uniform(2, 6, (n, s)), -1).astype(np.float32)
    rd = rng.normal(0, 1, (n, 3)).astype(np.float32)
    tol = dict(rtol=1e-5, atol=1e-6)
    w = volume.weights_from_sigma(*_t(raw[3], z, rd))
    np.testing.assert_allclose(w.numpy(), np.asarray(jvolume.weights_from_sigma(
        jnp.asarray(raw[3]), jnp.asarray(z), jnp.asarray(rd))), **tol)
    got = volume.volume_render_planar(*_t(raw, z, rd))
    want = jvolume.volume_render_planar(jnp.asarray(raw), jnp.asarray(z),
                                        jnp.asarray(rd))
    for name in ("rgb", "disp", "acc", "weights", "depth"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   err_msg=name, **tol)
    assert not got.acc[:5].any() and not got.disp[:5].any()
    t = [torch.from_numpy(np.ascontiguousarray(a.T)) for a in raw]
    trans = volume.volume_render_rays_t(*t, torch.from_numpy(z.T), _t(rd)[0])
    for name in ("rgb", "disp", "acc", "depth"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   getattr(trans, name).numpy(), err_msg=name,
                                   **tol)
    xs = torch.rand(4, 6, dtype=torch.float64) + 0.5
    want = torch.cat([torch.ones(4, 1, dtype=torch.float64),
                      torch.cumprod(xs, -1)[:, :-1]], -1)
    assert torch.allclose(volume.exclusive_cumprod(xs), want)
    assert torch.allclose(volume.exclusive_cumprod(xs.T, 0), want.T)


# --------------------------------------------------------------- render


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


def test_render_rays_from_cfg_matches_jax():
    """``render_rays_from_cfg`` on the plane pair (100 rays, 8 + 5 samples:
    no ray-kernel shape) with the JAX package's draws: the losses and the
    coarse outputs strict, the fine outputs by outlier fraction, and the
    gradients that reach both modules per layer.  The coarse layers' bound
    is 2e-2 relative L2 (measured 1.2e-2 at w0, falling to 6e-4 at w7): a
    point whose ReLU input lies near zero flips between two float32
    forwards, which the JAX package's own interpret backward and its XLA
    autodiff show too (2.6e-3 at w0 on these inputs)."""
    kw = dict(compute_dtype="float32", N_samples_c=8, N_samples_f=5)
    jcfg, cfg = JaxConfig(**kw), NerfConfig(device="cpu", **kw)
    params = np_nerf_params(21)
    o, d, tgt = _rays(22, 100)
    key = jax.random.PRNGKey(23)

    def jloss(p):
        c, f = jrender.make_pallas_train_field_fns(p, jcfg)
        out = jrender.render_rays_from_cfg(c, f, jnp.asarray(o),
                                           jnp.asarray(d), key, jcfg)
        lc = jnp.mean((out.rgb_c - tgt) ** 2)
        lf = jnp.mean((out.rgb_f - tgt) ** 2)
        return lc + lf, (lc, lf, out.rgb_c, out.rgb_f)

    (_, (jlc, jlf, jrgb_c, jrgb_f)), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(to_jax(params))

    model = _model(params)
    coarse, fine = render.make_train_field_fns(model, cfg)
    u_c, u_f = _draws(key, 100, 8, 5)
    out = render.render_rays_from_cfg(coarse, fine, *_t(o, d), cfg, u_c=u_c,
                                      u_f=u_f)
    t = torch.from_numpy(tgt)
    lc, lf = (torch.mean((r - t) ** 2) for r in (out.rgb_c, out.rgb_f))
    (lc + lf).backward()
    assert lc.item() == pytest.approx(float(jlc), rel=1e-5)
    assert lf.item() == pytest.approx(float(jlf), rel=1e-5)
    np.testing.assert_allclose(out.rgb_c.detach().numpy(), np.asarray(jrgb_c),
                               **TOL)
    far = np.abs(out.rgb_f.detach().numpy() - np.asarray(jrgb_f)).max(-1)
    assert (far > 1e-4).mean() <= 0.02
    want = state_dict_from_jax_params(jgrads)
    for name, p in model.named_parameters():
        got, ref = p.grad.numpy(), want[name].numpy()
        rel = 2e-2 if name.startswith("model_coarse") else 5e-2
        assert _rel(got, ref) <= rel and _cos(got, ref) >= 0.999, name


def test_render_rays_draw_order_is_render_rays_trains():
    """The plane route takes a generator's draws as the ray route does
    (the coarse jitter, then the fine uniforms): the same render on either
    route sees the same depths, so the coarse outputs agree strictly and
    the fine ones up to tie flips."""
    cfg = NerfConfig(device="cpu", compute_dtype="float32", N_samples_c=8,
                     N_samples_f=8)
    model = _model(np_nerf_params(24))
    o, d, _ = _t(*_rays(25, 128))
    a = render.render_rays_train(model, o, d, cfg,
                                 torch.Generator().manual_seed(3))
    b = render.render_rays_from_cfg(*render.make_train_field_fns(model, cfg),
                                    o, d, cfg,
                                    generator=torch.Generator().manual_seed(3))
    np.testing.assert_allclose(a.rgb_c.detach().numpy(),
                               b.rgb_c.detach().numpy(), **TOL)
    far = (a.rgb_f - b.rgb_f).abs().max(-1).values.detach().numpy()
    assert (far > 1e-4).mean() <= 0.02


# ----------------------------------------------------------------- steps


def _cfgs(**kw):
    kw = dict(compute_dtype="float32", N_samples_c=8, N_samples_f=8,
              iter_N=10, iter_warmup=2, precrop_frac=0.5, **kw)
    return JaxConfig(**kw), NerfConfig(device="cpu", **kw)


def _states(jcfg, cfg, params):
    tx = jax_adam(jcfg)
    jp = to_jax(params)
    model = _model(params)
    return (tx, JaxState(jnp.zeros((), jnp.int32), jp, tx.init(jp)),
            TrainState(model, make_optimizer(model, cfg), 0))


def _compare_final(model, jparams):
    want = state_dict_from_jax_params(jax.device_get(jparams))
    for name, p in model.named_parameters():
        assert _rel(p.detach().numpy(), want[name].numpy()) <= 2e-3, name


def test_global_batch_plane_trajectory_matches_jax():
    """Three global-batch steps with ``use_rays_train`` off (128 rays, a
    ray-kernel shape): both packages take the plane pair."""
    jcfg, cfg = _cfgs(N_rays=128, use_rays_train=False)
    assert not uses_ray_pair(cfg, 128)
    params = np_nerf_params(30)
    tx, jstate, state = _states(jcfg, cfg, params)
    jax_step = jax.jit(jstep.make_train_step(None, tx, jcfg))
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
    _compare_final(state.model, jstate.params)


def test_per_image_plane_trajectory_matches_jax():
    """Two per-image steps at ``N_rays=100`` (not a multiple of 128: the
    plane route in both packages), the first inside the precrop window."""
    jcfg, cfg = _cfgs(N_rays=100)
    assert not uses_ray_pair(cfg, 100)
    params = np_nerf_params(32)
    images, K, poses = make_synth_scene(n_views=2, H=32, W=32)
    tx, jstate, state = _states(jcfg, cfg, params)
    jax_step = jstep.make_image_train_step(None, tx, jcfg, 32, 32, K)
    port_step = make_image_train_step(cfg, schedule_from_cfg(cfg), 32, 32, K)
    step_key = jax.random.PRNGKey(jcfg.seed + 3)
    for i, (view, precrop) in enumerate([(0, True), (1, False)]):
        img, pose = images[view], poses[view][:3, :4].astype(np.float32)
        jstate, jm = jax_step(jstate, jnp.asarray(img), jnp.asarray(pose),
                              step_key, precrop=precrop)
        key_px, key_render = jax.random.split(jax.random.fold_in(step_key, i))
        coords = jax_pixels(key_px, 32, 32, 100, precrop=precrop,
                            precrop_frac=cfg.precrop_frac)
        u_c, u_f = _draws(key_render, 100, 8, 8)
        m = port_step(state, *_t(img, pose), precrop=precrop,
                      coords=torch.from_numpy(np.array(coords)).long(),
                      u_c=u_c, u_f=u_f)
        for k in ("loss", "loss_c", "loss_f"):
            assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-4), (i, k)
    _compare_final(state.model, jstate.params)


def test_ray_and_plane_steps_agree():
    """The port's own A/B (the JAX package's tests/test_train.py
    counterpart): one global-batch step from the same state with the same
    draws on the ray pair and on the plane pair: the loss to float32
    association noise, the updated weights within its tolerance."""
    _, cfg = _cfgs(N_rays=128)
    params = np_nerf_params(33)
    o, d, tgt = _t(*_rays(34, 128))
    u_c, u_f = _draws(jax.random.PRNGKey(35), 128, 8, 8)
    out = {}
    for name, c in (("rays", cfg),
                    ("planes", dataclasses.replace(cfg, use_rays_train=False))):
        model = _model(params)
        state = TrainState(model, make_optimizer(model, c), 0)
        m = make_train_step(c, schedule_from_cfg(c))(state, o, d, tgt,
                                                     u_c=u_c, u_f=u_f)
        out[name] = (m, [p.detach().clone() for p in model.parameters()])
    (m1, p1), (m2, p2) = out["rays"], out["planes"]
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-4)
    for a, b in zip(p1, p2):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-2, atol=2e-4)


# ---------------------------------------------------------------- frames

H = W = 16
FRAME_KW = dict(netDepth=8, netWidth=256, L_x=10, L_d=4, near=2.0, far=6.0,
                perturb=0.0, compute_dtype="float32")


def _outliers(name, ours, ref, tol, cap):
    diff = np.abs(ours - ref)
    frac_out = float((diff > tol + tol * np.abs(ref)).mean())
    assert frac_out < 2e-3, (name, frac_out)
    assert float(diff.max()) < cap, (name, float(diff.max()))
    assert float(diff.mean()) < 1e-4, (name, float(diff.mean()))


@pytest.mark.parametrize("kw", [
    dict(N_samples_c=8, N_samples_f=0, render_cull="none"),    # coarse only
    dict(N_samples_c=8, N_samples_f=5, render_cull="none"),    # K7 + K8
    dict(N_samples_c=12, N_samples_f=20, render_cull="auto",   # culled
         chunk_rays=64)], ids=["dense_coarse_only", "dense_ragged",
                               "culled_ragged"])
def test_plane_frames_match_jax(kw):
    """The plane branches of both renderers against the JAX package's,
    deterministic sampling, float32 compute (bf16 logits, as both frame
    paths emit): random weights for the dense frames, the compact field
    (r = 1.0, most rays culled) for the culled one, whose 32 merged
    samples give two truncation classes."""
    culled = kw["render_cull"] == "auto"
    np_params = (compact_field_params(r=1.0, k=20.0) if culled
                 else np_nerf_params(40))
    _, K, poses = make_synth_scene(n_views=1, H=H, W=W)
    jcfg = JaxConfig(use_pallas=True, **FRAME_KW, **kw)
    jr = jframe.make_frame_renderer(JaxNeRF(compute_dtype=jnp.float32), jcfg,
                                    H, W, K, stratified=False)
    jrgb, jdisp = jr(to_jax(np_params), jnp.asarray(poses[0][:3, :4]),
                     jax.random.PRNGKey(0))

    cfg = NerfConfig(device="cpu", **FRAME_KW, **kw)
    model = NeRF()
    model.load_state_dict(compact_field_state_dict(r=1.0, k=20.0) if culled
                          else state_dict_from_jax_params(np_params))
    r = frame.make_frame_renderer(cfg, H, W, K, "cpu", stratified=False)
    assert not r.rays_route
    rgb, disp = r(fm.pack_nerf(model, cfg), torch.from_numpy(poses[0]))
    assert rgb.shape == (H, W, 3) and disp.shape == (H, W)
    _outliers("rgb", rgb.numpy(), np.asarray(jrgb), 2e-3, 2e-2)
    _outliers("disp", disp.numpy(), np.asarray(jdisp), 5e-3, 8e-2)
    if culled:
        st = r.stats[-1]
        assert 0 < st["n_act"] < H * W and st["blocks"] >= 2
        assert st["gate_frac_coarse"] is None and st["gate_frac_fine"] is None


def _counting(fn, calls, name):
    def call(*a, **kw):
        calls.append(name)
        return fn(*a, **kw)
    return call


@pytest.mark.parametrize("n_fine,cull", [(0, "auto"), (5, "none"),
                                         (5, "auto")])
def test_plane_frames_run_k7_and_k8_only(n_fine, cull):
    """The plane routes call K8 (and K7 for the coarse density where a
    fine pass exists) and never the ray kernels: the dense renderer one
    launch of each per block, the culled one K7 once and K8 once per cover
    block; the plain versions render the same frame."""
    cfg = NerfConfig(device="cpu", **FRAME_KW, N_samples_c=8,
                     N_samples_f=n_fine, render_cull=cull, chunk_rays=100)
    _, K, poses = make_synth_scene(n_views=1, H=H, W=W)
    packed = fm.pack_nerf(_model(np_nerf_params(41)), cfg)
    calls = []
    kw = dict(sigma_fn=_counting(fm.fused_mlp_sigma_rays, calls, "K3"),
              field_fn=_counting(fm.fused_mlp_eval_rays, calls, "K1"),
              points_fn=_counting(fm.fused_mlp_sigma, calls, "K7"),
              plane_fn=_counting(fm.fused_mlp_eval, calls, "K8"))
    r = frame.make_frame_renderer(cfg, H, W, K, "cpu", stratified=False, **kw)
    out = r(packed, torch.from_numpy(poses[0]))
    if hasattr(r, "stats"):
        assert calls == ["K7"] + ["K8"] * r.stats[-1]["blocks"]
    else:
        per = r.launches_per_frame
        assert per == 3
        assert sorted(calls) == sorted(["K8"] * per
                                       + ["K7"] * (per if n_fine else 0))
    plain = frame.make_frame_renderer(
        cfg, H, W, K, "cpu", stratified=False,
        points_fn=fm.fused_mlp_sigma_plain, plane_fn=fm.fused_mlp_eval_plain)
    for a, b in zip(out, plain(packed, torch.from_numpy(poses[0]))):
        assert torch.equal(a, b)


# --------------------------------------------------------------- routing


@pytest.mark.parametrize("kw,n", [
    (dict(), 256), (dict(use_rays_train=False), 256), (dict(), 100),
    (dict(N_samples_c=12), 256), (dict(N_samples_f=5), 256),
    (dict(N_samples_f=0), 256), (dict(N_samples_c=12, N_samples_f=0), 256)])
def test_routing_is_the_jax_packages(kw, n):
    """Each trigger of the plane layout routes as in the JAX package: the
    train step (``use_rays_train``, the ray count, the sample counts), the
    training pre-cull (off on every plane route, even when asked for), the
    frame renderers."""
    base = dict(N_samples_c=8, N_samples_f=8, render_precull_grid=16,
                train_precull="on", N_rays=n)
    jcfg = JaxConfig(**{**base, **kw})
    cfg = NerfConfig(device="cpu", **{**base, **kw})
    want = bool(jstep._supports_pallas_train(jcfg) and jcfg.use_rays_train
                and jrender.supports_train_rays_kernels(jcfg, n))
    assert uses_ray_pair(cfg, n) == want
    assert train_precull_enabled(cfg) == jprecull.train_precull_enabled(jcfg) \
        == want
    _, K, _ = make_synth_scene(n_views=1, H=8, W=8)
    for cull in ("none", "auto"):
        c, jc = (dataclasses.replace(x, render_cull=cull) for x in (cfg, jcfg))
        r = frame.make_frame_renderer(c, 8, 8, K, "cpu")
        n_fine = c.N_samples_f
        assert r.rays_route == (jframe._use_rays_kernels(jc) and n_fine > 0)
        assert hasattr(r, "stats") == (cull == "auto" and n_fine > 0)
        if not frame._use_rays_kernels(c):
            assert not frame._use_precull(c, torch.device("cpu"))
            assert not jframe._use_precull(jc)
