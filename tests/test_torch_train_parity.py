"""The port's training render and train steps against the JAX package's,
at float32 on the CPU.

Both sides get the same numpy-seeded weights and rays.  The JAX side runs
its ray-major kernel pair in Pallas interpret mode (float32, as its own
tests do); the port runs the plain versions with float32 weights
(``compute_dtype="float32"``).  Every random draw is the JAX package's,
taken from the keys its functions split (``render.py:320``,
``step.py:130, 234-235``) and injected into the port as pixel coordinates
and ``u_c`` / ``u_f``.

Tolerances:
- coarse pass: the losses to 1e-5 relative, each coarse layer's gradient
  to 1e-4 relative L2 (measured 4.6e-5: float32 sums in another order);
- fine pass: its depths come from the inverse CDF of the coarse weights,
  so they differ by float32 noise, and a fine point whose ReLU input lies
  that close to zero takes the other side on one of the two packages
  (measured: such points move the fine trunk's lower layers by up to
  2.2e-2).  Fine rays are held by outlier fraction (at most 2% of rays
  beyond 1e-4), fine gradients to 5e-2 relative L2 and cosine 0.999;
- trajectories: each step's loss to 1e-4 relative, and at the end every
  parameter tensor to 2e-3 relative L2 (measured up to 1.1e-3).  Adam
  divides each gradient by its own running size, so an element whose
  gradient is small moves by a full step whatever its relative error,
  and the fine pass's gradient differences above reach the weights.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_pytorch_paeng_tpu.config import NerfConfig as JaxConfig
from nerf_pytorch_paeng_tpu.ops.rays import sample_pixels as jax_pixels
from nerf_pytorch_paeng_tpu.ops.render import \
    render_rays_train as jax_render_train
from nerf_pytorch_paeng_tpu.train import step as jstep
from nerf_pytorch_paeng_tpu.train.state import TrainState as JaxState
from nerf_pytorch_paeng_tpu.train.state import make_optimizer as jax_adam
from nerf_pytorch_paeng_tpu_torch.config import NerfConfig
from nerf_pytorch_paeng_tpu_torch.models.nerf import NeRF
from nerf_pytorch_paeng_tpu_torch.ops.render import render_rays_train
from nerf_pytorch_paeng_tpu_torch.train import TrainState, make_optimizer
from nerf_pytorch_paeng_tpu_torch.train.schedule import schedule_from_cfg
from nerf_pytorch_paeng_tpu_torch.train.step import (make_image_train_step,
                                                     make_train_step)
from nerf_pytorch_paeng_tpu_torch.utils.interop import \
    state_dict_from_jax_params
from nerf_pytorch_paeng_tpu_torch.utils.synth import make_synth_scene

from torch_port_util import np_nerf_params, to_jax

N, SC, SF = 128, 8, 8
KW = dict(compute_dtype="float32", N_rays=N, N_samples_c=SC, N_samples_f=SF,
          iter_N=10, iter_warmup=2, precrop_frac=0.5)


def _cfgs(**over):
    return JaxConfig(**KW, **over), NerfConfig(device="cpu", **KW, **over)


def _model(params):
    model = NeRF()
    model.load_state_dict(state_dict_from_jax_params(params))
    return model


def _rays(seed, n=N):
    rng = np.random.default_rng(seed)
    o = (np.array([0.0, 0.0, 4.0]) + rng.normal(0, 0.1, (n, 3)))
    d = -o / 4.0 + rng.normal(0, 0.2, (n, 3))
    tgt = rng.uniform(0, 1, (n, 3))
    return [a.astype(np.float32) for a in (o, d, tgt)]


def _uniforms(key):
    """The render's draws from ``key`` (render_rays_train's split)."""
    key_c, key_f = jax.random.split(key)
    return (torch.from_numpy(np.array(jax.random.uniform(key_c, (N, SC)))),
            torch.from_numpy(np.array(jax.random.uniform(key_f, (N, SF)))))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def test_render_rays_train_loss_and_grads_match_jax():
    jcfg, cfg = _cfgs()
    params = np_nerf_params(0)
    o, d, tgt = _rays(1)
    key = jax.random.PRNGKey(2)

    def jax_loss(p):
        out = jax_render_train(p, jnp.asarray(o), jnp.asarray(d), key, jcfg)
        loss_c = jnp.mean((out.rgb_c - tgt) ** 2)
        loss_f = jnp.mean((out.rgb_f - tgt) ** 2)
        return loss_c + loss_f, (loss_c, loss_f, out.rgb_f)

    (_, (jlc, jlf, jrgb_f)), jgrads = jax.jit(jax.value_and_grad(
        jax_loss, has_aux=True))(to_jax(params))

    model = _model(params)
    u_c, u_f = _uniforms(key)
    out = render_rays_train(model, torch.from_numpy(o), torch.from_numpy(d),
                            cfg, u_c=u_c, u_f=u_f)
    assert out.rgb_c.shape == out.rgb_f.shape == (N, 3)
    t = torch.from_numpy(tgt)
    loss_c = torch.mean((out.rgb_c - t) ** 2)
    loss_f = torch.mean((out.rgb_f - t) ** 2)
    (loss_c + loss_f).backward()
    assert loss_c.item() == pytest.approx(float(jlc), rel=1e-5)
    assert loss_f.item() == pytest.approx(float(jlf), rel=1e-5)
    far = np.abs(out.rgb_f.detach().numpy() - np.asarray(jrgb_f)).max(-1)
    assert (far > 1e-4).mean() <= 0.02

    want = state_dict_from_jax_params(jgrads)
    for name, p in model.named_parameters():
        got, ref = p.grad.numpy(), want[name].numpy()
        if name.startswith("model_coarse"):
            assert _rel(got, ref) <= 1e-4, name
        else:
            assert _rel(got, ref) <= 5e-2 and _cos(got, ref) >= 0.999, name


def _jax_state(jcfg, params):
    tx = jax_adam(jcfg)
    jp = to_jax(params)
    return tx, JaxState(jnp.zeros((), jnp.int32), jp, tx.init(jp))


def _compare_final(model, jparams):
    want = state_dict_from_jax_params(jax.device_get(jparams))
    for name, p in model.named_parameters():
        assert _rel(p.detach().numpy(), want[name].numpy()) <= 2e-3, name


def test_global_batch_trajectory_matches_jax():
    """Four global-batch steps from the same weights on different batches:
    ``make_train_step`` + Adam under the schedule, both packages."""
    jcfg, cfg = _cfgs()
    params = np_nerf_params(3)
    tx, jstate = _jax_state(jcfg, params)
    jax_step = jax.jit(jstep.make_train_step(None, tx, jcfg))
    step_key = jax.random.PRNGKey(jcfg.seed + 3)

    model = _model(params)
    state = TrainState(model, make_optimizer(model, cfg), 0)
    port_step = make_train_step(cfg, schedule_from_cfg(cfg))
    for i in range(4):
        o, d, tgt = _rays(10 + i)
        jstate, jm = jax_step(jstate, jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(tgt), step_key)
        u_c, u_f = _uniforms(jax.random.fold_in(step_key, i))
        m = port_step(state, *(torch.from_numpy(a) for a in (o, d, tgt)),
                      u_c=u_c, u_f=u_f)
        for k in ("loss", "loss_c", "loss_f", "psnr"):
            assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-4), \
                (i, k)
    assert state.step == int(jstate.step) == 4
    _compare_final(model, jstate.params)


def test_per_image_trajectory_matches_jax():
    """Three per-image steps (the first two inside the precrop window):
    the JAX step draws the pixels and the jitter, the port gets the same
    coordinates and uniforms."""
    jcfg, cfg = _cfgs()
    params = np_nerf_params(4)
    images, K, poses = make_synth_scene(n_views=2, H=32, W=32)
    tx, jstate = _jax_state(jcfg, params)
    jax_step = jstep.make_image_train_step(None, tx, jcfg, 32, 32, K)
    step_key = jax.random.PRNGKey(jcfg.seed + 3)

    model = _model(params)
    state = TrainState(model, make_optimizer(model, cfg), 0)
    port_step = make_image_train_step(cfg, schedule_from_cfg(cfg), 32, 32, K)
    for i, (view, precrop) in enumerate([(0, True), (1, True), (0, False)]):
        img, pose = images[view], poses[view][:3, :4].astype(np.float32)
        jstate, jm = jax_step(jstate, jnp.asarray(img), jnp.asarray(pose),
                              step_key, precrop=precrop)
        key_px, key_render = jax.random.split(
            jax.random.fold_in(step_key, i))
        coords = jax_pixels(key_px, 32, 32, N, precrop=precrop,
                            precrop_frac=cfg.precrop_frac)
        u_c, u_f = _uniforms(key_render)
        m = port_step(state, torch.from_numpy(img), torch.from_numpy(pose),
                      precrop=precrop,
                      coords=torch.from_numpy(np.array(coords)).long(),
                      u_c=u_c, u_f=u_f)
        for k in ("loss", "loss_c", "loss_f"):
            assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-4), \
                (i, k)
    _compare_final(model, jstate.params)
