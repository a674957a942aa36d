"""The port's blob-field distillation (``utils/synth.fit_field_to_blob``)
against the JAX package's, with JAX's draws replayed.

The JAX fit draws each step's points from ``fold_in(key, i)`` split in
four (theta, u, v, depth); with ``uniform_frac`` > 0 the direction blur
from ``fold_in(kz, 2)`` and the two cubes and their directions from
``fold_in(kz, 1)`` split twice; the polish phase's step j from
``fold_in(key, n_steps + 7919 + j)`` split in two.  ``_jax_draws``
rebuilds that schedule with ``jax.random`` (the unit draws: the same bits
the JAX fit scales) and feeds it to the port through ``draws``.

Shapes: 4x64 at L_x 6, L_d 2 (the plain route, the JAX package's
embedding), soft and hard blobs, ``uniform_frac`` 0 and 0.25 (the latter
with its 40 polish steps), 256 ray points, 10 steps; and the reference
8x256 through the kernel pair's plain versions (K8/K9's), 128 points, 3
steps, float32 on both sides.

Tolerances: the final loss to 2e-4 relative (measured up to 5.4e-5);
every fitted tensor to 2e-2 relative L2 (measured up to 9.1e-3), and the
whole update (fitted minus initial weights) to 0.1 relative L2 (measured
0.021 at 4x64 with the polish, 0.043 at 8x256).  Adam divides each
gradient by its own running norm, so where a gradient is near zero a
float32 rounding apart (sum order, and at 8x256 the kernels' double-angle
embedding against the JAX fit's ``positional_encoding``, which differ
near the top frequency of L_x 10) moves that weight by up to 2 lr; the
fits are held by relative L2 (optax's ``adam`` and ``torch.optim.Adam``
agree in formula, not in rounding).  The same fit with draws one step
off lands at more than 0.3 (measured 0.47: the control, showing that the
replay is what makes the two agree).
"""
import jax
import numpy as np
import pytest
import torch

from nerf_pytorch_paeng_tpu.config import NerfConfig as JaxConfig
from nerf_pytorch_paeng_tpu.models import init_nerf as jax_init_nerf
from nerf_pytorch_paeng_tpu.utils.synth import \
    fit_field_to_blob as jax_fit_field_to_blob
from nerf_pytorch_paeng_tpu_torch.config import NerfConfig
from nerf_pytorch_paeng_tpu_torch.kernels import fused_mlp_vjp
from nerf_pytorch_paeng_tpu_torch.models.nerf import NeRF
from nerf_pytorch_paeng_tpu_torch.utils import synth
from nerf_pytorch_paeng_tpu_torch.utils.interop import \
    state_dict_from_jax_params

from torch_port_util import np_nerf_params, to_jax

SMALL = dict(depth=4, width=64, L_x=6, L_d=2)
FULL = dict(depth=8, width=256, L_x=10, L_d=4)
SOFT = dict(blob_amp=8.0, blob_hard_w=0.0)
HARD = dict(blob_amp=60.0, blob_hard_w=0.08)
LOSS_RTOL, TENSOR_RTOL, UPDATE_RTOL, CONTROL_MIN = 2e-4, 2e-2, 0.1, 0.3
F32 = NerfConfig(compute_dtype="float32")     # as the JAX models are built


def _jax_draws(key, n_steps: int, n_pts: int, uniform_frac: float,
               shift: int = 0):
    """``draws(i, phase)`` of the JAX fit's key schedule (``shift``: the
    main phase's draws ``shift`` steps off, the control)."""
    def draws(i, phase):
        if phase == "main":
            kt, ku, kv, kz = jax.random.split(
                jax.random.fold_in(key, i + shift), 4)
            out = dict(theta=jax.random.uniform(kt, (n_pts,)),
                       u=jax.random.uniform(ku, (n_pts,)),
                       v=jax.random.uniform(kv, (n_pts,)),
                       t=jax.random.uniform(kz, (n_pts,)))
            if uniform_frac > 0:
                n_uni = max(2, int(n_pts * uniform_frac))
                ku2, kd2 = jax.random.split(jax.random.fold_in(kz, 1))
                k_in, k_out = jax.random.split(ku2)
                out.update(
                    blur=jax.random.normal(jax.random.fold_in(kz, 2),
                                           (n_pts, 3)),
                    cube_in=jax.random.uniform(k_in, (n_uni // 2, 3)),
                    cube_out=jax.random.uniform(k_out,
                                                (n_uni - n_uni // 2, 3)),
                    udir=jax.random.normal(kd2, (n_uni, 3)))
        else:
            kb, ko = jax.random.split(
                jax.random.fold_in(key, n_steps + 7919 + i))
            out = dict(blob=jax.random.normal(kb, (n_pts, 3)),
                       cube=jax.random.uniform(ko, (3 * n_pts, 3)))
        return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}
    return draws


def _fits(shape, n_steps, n_pts, uniform_frac, blob, shift=0):
    """(JAX fit, port fit with the replayed draws, initial weights) as
    state dicts, and the two final losses."""
    params = np_nerf_params(0, L_x=shape["L_x"], L_d=shape["L_d"],
                            depth=shape["depth"], width=shape["width"])
    jcfg = JaxConfig(netDepth=shape["depth"], netWidth=shape["width"],
                     L_x=shape["L_x"], L_d=shape["L_d"],
                     compute_dtype="float32")
    jmodel, _ = jax_init_nerf(jcfg, jax.random.PRNGKey(0))
    kw = dict(n_steps=n_steps, n_pts=n_pts, L_x=shape["L_x"],
              L_d=shape["L_d"], uniform_frac=uniform_frac, **blob)
    key = jax.random.PRNGKey(1)
    jparams, jloss = jax_fit_field_to_blob(jmodel, to_jax(params), key, **kw)
    model = NeRF(shape["depth"], shape["width"], shape["L_x"], shape["L_d"])
    init = state_dict_from_jax_params(params)
    model.load_state_dict(init)
    sd, loss = synth.fit_field_to_blob(
        model, draws=_jax_draws(key, n_steps, n_pts, uniform_frac, shift),
        cfg=F32, lr_schedule="constant", **kw)
    for k, v in model.state_dict().items():      # the model is left alone
        assert torch.equal(v, init[k]), k
    want = state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                             jparams))
    return want, sd, init, jloss, loss


def _update_rel(got, want, init) -> float:
    a = torch.cat([(got[k] - init[k]).flatten() for k in want])
    b = torch.cat([(want[k] - init[k]).flatten() for k in want])
    return float((a - b).norm() / b.norm())


def _check(want, got, init, jloss, loss):
    assert abs(loss - jloss) <= LOSS_RTOL * abs(jloss), (loss, jloss)
    assert set(got) == set(want)
    for k in want:
        rel = float((got[k] - want[k]).norm() / want[k].norm())
        assert rel <= TENSOR_RTOL, (k, rel)
    assert _update_rel(got, want, init) <= UPDATE_RTOL


@pytest.mark.parametrize("uniform_frac", [0.0, 0.25])
@pytest.mark.parametrize("blob", [SOFT, HARD], ids=["soft", "hard"])
def test_fit_matches_jax_plain_route(blob, uniform_frac):
    _check(*_fits(SMALL, 10, 256, uniform_frac, blob))


def test_fit_matches_jax_through_the_kernel_pair(monkeypatch):
    """The reference 8x256 takes the plane pair (K8 forward, K9 backward;
    their plain versions on the CPU): 2 of each a step."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = fused_mlp_vjp.fused_mlp_eval, fused_mlp_vjp.fused_mlp_bwd

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped
    monkeypatch.setattr(fused_mlp_vjp, "fused_mlp_eval", count("fwd", fwd))
    monkeypatch.setattr(fused_mlp_vjp, "fused_mlp_bwd", count("bwd", bwd))
    _check(*_fits(FULL, 3, 128, 0.0, SOFT))
    assert calls == {"fwd": 6, "bwd": 6}


def test_replayed_draws_are_what_makes_the_fits_agree():
    want, got, init, _, _ = _fits(SMALL, 10, 256, 0.0, SOFT, shift=1)
    assert _update_rel(got, want, init) > CONTROL_MIN


def test_generator_fit_is_seeded():
    """Without ``draws`` the points come from the caller's generator: the
    same seed gives the same bits, another seed another fit; the loss
    returned is the last main step's, that of the weights before its
    update on that step's draws."""
    model = NeRF(4, 64, 6, 2)
    model.load_state_dict(state_dict_from_jax_params(
        np_nerf_params(0, L_x=6, L_d=2, depth=4, width=64)))
    kw = dict(n_steps=3, n_pts=64, L_x=6, L_d=2, uniform_frac=0.25, cfg=F32,
              lr_schedule="constant")
    runs = [synth.fit_field_to_blob(
        model, generator=torch.Generator().manual_seed(s), **kw)
        for s in (0, 0, 1)]
    assert runs[0][1] == runs[1][1]
    assert all(torch.equal(runs[0][0][k], runs[1][0][k]) for k in runs[0][0])
    assert any(not torch.equal(runs[0][0][k], runs[2][0][k])
               for k in runs[0][0])
    # the last main step's loss: two steps, then the third's draws
    g = torch.Generator().manual_seed(0)
    two, _ = synth.fit_field_to_blob(model, generator=g,
                                     **dict(kw, uniform_frac=0.0, n_steps=2))
    at = NeRF(4, 64, 6, 2)
    at.load_state_dict(two)
    pts, dirs = synth.orbit_ray_points(synth.orbit_draws(64, 0.0, g))
    want = synth.blob_fit_loss(synth.blob_fit_fields(at, F32, 6, 2), pts,
                               dirs)
    _, got = synth.fit_field_to_blob(model, generator=torch.Generator()
                                     .manual_seed(0),
                                     **dict(kw, uniform_frac=0.0))
    assert got == float(want.detach())


@pytest.mark.parametrize("n_steps,n_pol", [(10, 40), (300, 40),
                                           (1500, 187)])
def test_learning_rates(n_steps, n_pol):
    """``"constant"`` is the JAX function's rate throughout; ``"cosine"``
    decays the main phase from lr to a hundredth of it and holds the
    polish phase's travel (rate times steps) to the 40-step polish's."""
    lr = 2e-3
    assert synth.polish_steps(n_steps) == n_pol
    assert synth.fit_learning_rates(n_steps, lr, "constant") == (
        [lr] * n_steps, lr)
    main, polish = synth.fit_learning_rates(n_steps, lr)
    assert len(main) == n_steps
    assert main[0] == pytest.approx(lr, rel=1e-12)
    assert main[-1] == pytest.approx(synth.COSINE_FLOOR * lr, rel=1e-12)
    assert all(a >= b for a, b in zip(main, main[1:]))
    # a half cosine: symmetric about the mean of its two ends
    for a, b in zip(main, main[::-1]):
        assert a + b == pytest.approx((1 + synth.COSINE_FLOOR) * lr,
                                      rel=1e-12)
    assert polish * n_pol == pytest.approx(lr * 40, rel=1e-12)
    with pytest.raises(ValueError):
        synth.fit_learning_rates(n_steps, lr, "linear")


@pytest.mark.parametrize("schedule", ["constant", "cosine"])
def test_fit_steps_at_its_learning_rates(monkeypatch, schedule):
    """Each Adam step of the fit, main and polish, runs at the rate
    ``fit_learning_rates`` gives it."""
    seen = []
    adam_step = torch.optim.Adam.step

    def step(self, *a, **kw):
        seen.append(self.param_groups[0]["lr"])
        return adam_step(self, *a, **kw)
    monkeypatch.setattr(torch.optim.Adam, "step", step)
    model = NeRF(2, 32, 4, 2)
    synth.fit_field_to_blob(model, n_steps=5, n_pts=32, L_x=4, L_d=2,
                            uniform_frac=0.25, cfg=F32,
                            generator=torch.Generator().manual_seed(0),
                            lr_schedule=schedule)
    main, polish = synth.fit_learning_rates(5, 2e-3, schedule)
    assert seen == main + [polish] * synth.polish_steps(5)


def test_blob_field_is_the_scene_blob():
    """The ground truth is the synthetic scene's blob (``_density``,
    ``_color``) at its parameters, and the hard front its stated ramp."""
    pts = np.random.default_rng(2).normal(0, 1, (500, 3)).astype(np.float32)
    sig, raw_col = synth.blob_field(torch.from_numpy(pts), 0.6, 1.8, 8.0)
    np.testing.assert_allclose(sig.numpy(), synth._density(pts), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(torch.sigmoid(raw_col).numpy(),
                               synth._color(pts), rtol=1e-5, atol=1e-6)
    hard, _ = synth.blob_field(torch.from_numpy(pts), 0.6, 1.35, 60.0, 0.08)
    r = np.linalg.norm(pts, axis=-1)
    np.testing.assert_allclose(hard.numpy(),
                               60.0 * np.clip((1.35 - r) / 0.08, 0, 1),
                               rtol=1e-5, atol=1e-4)
    # the hinge: zero at or below -margin, linear and squared above
    raw = torch.tensor([-1.0, -0.5, 0.0, 1.0])
    empty = torch.zeros(4)
    np.testing.assert_allclose(
        synth.blob_sigma_loss(raw, empty, 0.5, 0.5, 8.0).numpy(),
        [0.0, 0.0, 0.25 + 0.25, 2.25 + 0.75])
