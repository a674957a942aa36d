"""Occupancy-gated training in the port (``train/precull.py``, the gated
passes of ``ops/render.render_rays_train``, K6's plain version in
``kernels/fused_mlp_vjp.py`` and the driver's refresh policy) against the
JAX package's, on the CPU.

Both sides get the same numpy-made inputs: the hand-built compact field
(``utils/synth.compact_field_params``, an L1 ball of radius 1.5, whose
support bounds are valid) or numpy-seeded random weights, rays from a
synthetic orbit camera plus a half of provable misses (rays from (4, 0, 0)
sweeping sideways), a support grid of 16^3 and 8+8 samples.  The JAX side
runs its Pallas kernels in interpret mode (float32), the port its plain
versions with float32 weights.

Tolerances: masks, plans, gates and decisions equal; bounds to 1e-6; the
estimator to 1e-6; K6 and the gated pair per layer as
tests/test_torch_vjp.py holds K2: 5e-5 relative L2 against JAX, points
with a ReLU input within 1e-4 of zero given zero cotangents (at these
4096 points a 1e-5 margin leaves enough flips to move w0 by 2e-3, the
ungated backward's too; 1e-4 keeps half the points); the gated render and the
2-step trajectory as tests/test_torch_train_parity.py holds the ungated
ones.  Within the port, the gated step's loss is the ungated one bit for
bit and its gradients agree to 1e-5 (the sum order differs).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_pytorch_paeng_tpu.config import NerfConfig as JaxConfig
from nerf_pytorch_paeng_tpu.kernels import fused_mlp as jfm
from nerf_pytorch_paeng_tpu.kernels import fused_mlp_vjp as jfv
from nerf_pytorch_paeng_tpu.ops import occupancy as jocc
from nerf_pytorch_paeng_tpu.ops import render as jrender
from nerf_pytorch_paeng_tpu.train import precull as jprecull
from nerf_pytorch_paeng_tpu_torch.config import NerfConfig
from nerf_pytorch_paeng_tpu_torch.kernels import fused_mlp as fm
from nerf_pytorch_paeng_tpu_torch.kernels import fused_mlp_vjp as fv
from nerf_pytorch_paeng_tpu_torch.models.nerf import NeRF
from nerf_pytorch_paeng_tpu_torch.ops import occupancy as occ
from nerf_pytorch_paeng_tpu_torch.ops import render
from nerf_pytorch_paeng_tpu_torch.train import precull
from nerf_pytorch_paeng_tpu_torch.utils.interop import \
    state_dict_from_jax_params
from nerf_pytorch_paeng_tpu_torch.utils.synth import (compact_field_params,
                                                      make_synth_scene)

from test_torch_vjp import (REL_JAX, _assert_grads_close, _module_grads,
                            _relu_margin)
from torch_port_util import np_nerf_params, np_rays, to_jax

N, SC, SF, GRID = 512, 8, 8, 16
KW = dict(netDepth=8, netWidth=256, L_x=10, L_d=4, N_samples_c=SC,
          N_samples_f=SF, near=2.0, far=6.0, N_rays=N, compute_dtype="float32",
          render_precull_grid=GRID, train_precull_tile=128, iter_N=10,
          iter_warmup=2)


def _cfgs(**over):
    kw = dict(KW, **over)
    return JaxConfig(use_pallas=True, **kw), NerfConfig(device="cpu", **kw)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-30))


def _batch(seed, n=N):
    """n rays: the first half through pixels of a synthetic orbit camera,
    the second half from (4, 0, 0) sweeping sideways (their [2, 6]
    segments stay in the cube of half-side 6 and never come within 4 of
    the origin: provable misses); random targets."""
    _, K, poses = make_synth_scene(n_views=1, H=32, W=32)
    o_img, d_img = map(np.asarray, _camera(K, poses[0], 32, 32))
    rng = np.random.default_rng(seed)
    pix = rng.choice(32 * 32, n // 2, replace=False)
    lat = 0.01 * rng.normal(size=(n // 2, 2))
    o_miss = np.broadcast_to([4.0, 0.0, 0.0], (n // 2, 3))
    d_miss = np.stack([np.zeros(n // 2), 0.5 + lat[:, 0], 0.3 + lat[:, 1]], -1)
    o = np.concatenate([o_img[pix], o_miss]).astype(np.float32)
    d = np.concatenate([d_img[pix], d_miss]).astype(np.float32)
    return o, d, rng.uniform(size=(n, 3)).astype(np.float32)


def _camera(K, pose, H, W):
    from nerf_pytorch_paeng_tpu_torch.ops.rays import get_rays
    ro, rd = get_rays(H, W, K, torch.from_numpy(pose[:3, :4]))
    return ro.reshape(-1, 3).numpy(), rd.reshape(-1, 3).numpy()


@pytest.fixture(scope="module")
def compact():
    """The compact field on both sides, its support bounds from both
    support programs (training cameras of a 3-view scene), and a batch."""
    jcfg, cfg = _cfgs()
    params = compact_field_params(r=1.5, k=20.0)
    model = NeRF()
    model.load_state_dict(state_dict_from_jax_params(params))
    _, K, poses = make_synth_scene(n_views=3, H=16, W=16)
    poses34 = poses[:, :3, :4]
    prog, half = precull.make_train_support_program(
        cfg, poses=poses34, K=K, hw=(16, 16), device="cpu")
    jprog, jhalf = jprecull.make_train_support_program(
        jcfg, poses=poses34, K=K, hw=(16, 16))
    bounds = prog(model)
    jbounds = jprog(to_jax(params))
    return dict(cfg=cfg, jcfg=jcfg, params=params, model=model, K=K,
                poses=poses34, bounds=bounds,
                jbounds=tuple(tuple(b) for b in jbounds), half=half,
                jhalf=jhalf, batch=_batch(0))


def test_frustum_union_mask_matches_jax():
    _, K, poses = make_synth_scene(n_views=3, H=16, W=16)
    for half, grid in ((6.0, 16), (6.0, 24), (4.5, 20)):
        got = occ.frustum_union_mask(poses, K, 16, 16, 2.0, 6.0, half, grid)
        want = np.asarray(jocc.frustum_union_mask(
            poses[:, :3, :4], K, 16, 16, 2.0, 6.0, half, grid))
        assert got.dtype == torch.bool and got.shape == (grid,) * 3
        assert 0 < want.mean() < 1
        np.testing.assert_array_equal(got.numpy(), want)


def test_support_program_matches_jax(compact):
    assert compact["half"] == compact["jhalf"] == 6.0
    for got, want in zip(compact["bounds"], compact["jbounds"]):
        lo, hi, r, valid = got
        assert bool(valid[0]) and bool(np.asarray(want[3])[0])
        for g, w in zip((lo, hi, r), want[:3]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-6)


def test_support_program_runs_k7_twice(compact):
    """Two grids per refresh (one per module) through ``points_fn``."""
    calls = []

    def points_fn(xp, p, L_x, out_dtype):
        calls.append(xp.shape[1])
        return fm.fused_mlp_sigma_plain(xp, p, L_x, out_dtype)

    prog, _ = precull.make_train_support_program(
        compact["cfg"], device="cpu", points_fn=points_fn)
    prog(compact["model"])
    assert calls == [GRID ** 3] * 2


@pytest.mark.parametrize("n,knob", [(4096, 0), (4096, 384), (4096, 640),
                                    (4096, 128), (256, 512), (384, 2048),
                                    (640, 512), (512, 0)])
def test_train_gate_tile_matches_jax(n, knob):
    jcfg, cfg = _cfgs(train_precull_tile=knob)
    base = render._train_rays_tile(n)
    assert base == jrender._train_rays_tile(n)
    got = render.train_gate_tile(cfg, n, base)
    assert got == jrender.train_gate_tile(jcfg, n, base)
    assert got % 128 == 0 and n % got == 0


def test_train_gate_plan_matches_jax(compact):
    o, d, _ = compact["batch"]
    bounds = compact["bounds"][0]
    t_lo, t_hi = render.train_support_intervals(*_t(o, d), bounds, 6.0, 2.0,
                                                6.0)
    jt_lo, jt_hi = jrender.train_support_intervals(
        jnp.asarray(o), jnp.asarray(d), compact["jbounds"][0], 6.0, 2.0, 6.0)
    np.testing.assert_array_equal(t_lo.numpy(), np.asarray(jt_lo))
    np.testing.assert_array_equal(t_hi.numpy(), np.asarray(jt_hi))
    rng = np.random.default_rng(3)
    zs = np.sort(rng.uniform(2.0, 6.0, (16, N)), 0).astype(np.float32)
    for tile in (128, 256):
        got = render.train_gate_plan(torch.from_numpy(zs), t_lo, t_hi, tile)
        want = jrender.train_gate_plan(jnp.asarray(zs), jt_lo, jt_hi, tile)
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert float(got[3]) == float(want[3])
        assert 0.2 < float(got[3]) < 1.0


def test_gate_frac_estimator_matches_jax(compact):
    """Equal to JAX's within 1e-6: on the half-miss batch well above the
    policy's floor; 0 under full-cube or invalid bounds."""
    o, d, _ = compact["batch"]
    jcfg, cfg = compact["jcfg"], compact["cfg"]
    est = precull.make_gate_frac_estimator(cfg)
    jest = jprecull.make_gate_frac_estimator(jcfg)
    full = (np.full(3, -6.0, np.float32), np.full(3, 6.0, np.float32),
            np.array([6.0 * np.sqrt(3.0)], np.float32), np.array([True]))
    inval = (*(b.numpy() for b in compact["bounds"][0][:3]),
             np.array([False]))
    for bc, bf in ((compact["bounds"][0], compact["bounds"][1]),
                   (full, full), (inval, inval)):
        bc = tuple(torch.as_tensor(np.asarray(b)) for b in bc)
        bf = tuple(torch.as_tensor(np.asarray(b)) for b in bf)
        got = float(est(bc, bf, *_t(o, d)))
        want = float(jest(tuple(jnp.asarray(b.numpy()) for b in bc),
                          tuple(jnp.asarray(b.numpy()) for b in bf),
                          jnp.asarray(o), jnp.asarray(d)))
        assert got == pytest.approx(want, abs=1e-6)
    assert float(est(*compact["bounds"], *_t(o, d))) > 0.2
    assert float(est(tuple(map(torch.as_tensor, full)),
                     tuple(map(torch.as_tensor, full)), *_t(o, d))) == 0.0


# ------------------------------------------------------------- K6 (plain)

KN, KS = 256, 16
RELU_MARGIN = 1e-4


def _kernel_inputs(seed):
    params = np_nerf_params(seed)
    model = NeRF()
    model.load_state_dict(state_dict_from_jax_params(params))
    rng = np.random.default_rng(seed + 100)
    od, z = np_rays(rng, KN, KS)
    cots = [rng.normal(0, 1e-3, (KS, KN)).astype(np.float32)
            for _ in range(4)]
    gate = np.array([1, 0, 0, 1], np.int32)   # tile 0 row 1, tile 1 row 0 off
    return params, model.model_fine, od, z, cots, gate


def _off_mask(gate, s=KS, n=KN):
    return ~fm.gate_mask(torch.from_numpy(gate), s, n).numpy()


def _jax_grads_tree(params, fn):
    """{state-dict key of model_fine: gradient} of ``fn(packed)`` -> the
    packed gradients, through the VJP of JAX's packing."""
    from nerf_pytorch_paeng_tpu_torch.utils.interop import \
        state_dict_from_jax_params as sd
    packed_j, unpack = jax.vjp(jfm.pack_nerf_mlp_params,
                               to_jax(params["fine"]))
    tree = unpack(fn(packed_j))[0]
    return {k: v.numpy() for k, v in sd({"coarse": tree, "fine": tree}).items()
            if k.startswith("model_fine")}


def test_gated_bwd_plain_matches_jax():
    """K6's plain version against ``_bwd_rays_call(gate=..., interpret=
    True)`` at (256 rays, 16 samples), tile 128, per layer."""
    params, mlp, od, z, cots, gate = _kernel_inputs(0)
    packed = fm.pack_nerf_mlp_params(mlp, dtype=torch.float32)
    keep = (_relu_margin(*_t(od, z), packed) >= RELU_MARGIN).numpy()
    cots = [np.where(keep, c, 0.0).astype(np.float32) for c in cots]
    want = _jax_grads_tree(params, lambda pj: jax.jit(
        lambda *a: jfv._bwd_rays_call(*a, pj, 10, 4, 128, interpret=True,
                                      gate=jnp.asarray(gate)))(
        jnp.asarray(od), jnp.asarray(z), *map(jnp.asarray, cots)))
    dw, db = fv.fused_mlp_bwd_rays(*_t(od, z, *cots), packed,
                                   gate=torch.from_numpy(gate))
    _assert_grads_close(_module_grads(mlp, dw, db), want, REL_JAX)


def test_gated_bwd_plain_all_on_and_zeroed_cotangents():
    """An all-on gate gives the ungated plain version's bits; a gated-off
    block adds what zeroed cotangents on its samples add (1e-5: the rows
    run on fewer points, in another sum order)."""
    _, mlp, od, z, cots, gate = _kernel_inputs(1)
    packed = fm.pack_nerf_mlp_params(mlp, dtype=torch.float32)
    od, z, *cots = _t(od, z, *cots)
    ungated = fv.fused_mlp_bwd_rays(od, z, *cots, packed)
    all_on = fv.fused_mlp_bwd_rays(od, z, *cots, packed,
                                   gate=torch.ones(4, dtype=torch.int32))
    assert all(torch.equal(a, b) for a, b in zip(all_on, ungated))
    off = torch.from_numpy(_off_mask(gate))
    gated = fv.fused_mlp_bwd_rays(od, z, *cots, packed,
                                  gate=torch.from_numpy(gate))
    zeroed = fv.fused_mlp_bwd_rays(
        od, z, *(c.masked_fill(off, 0.0) for c in cots), packed)
    for a, b in zip(gated, zeroed):
        assert _rel(a.numpy(), b.numpy()) <= 1e-5
    none = fv.fused_mlp_bwd_rays(od, z, *cots, packed,
                                 gate=torch.zeros(4, dtype=torch.int32))
    assert not any(bool(t.any()) for t in none)


def test_gated_pair_matches_jax():
    """``fused_mlp_train_rays(gate=)`` (K5 + K6) against JAX's gated pair:
    the forward's gated blocks exactly 0 on both sides, the rest to 1e-4;
    the module's gradients per layer."""
    params, mlp, od, z, cots, gate = _kernel_inputs(2)
    packed = fm.pack_nerf_mlp_params(mlp, dtype=torch.float32)
    keep = (_relu_margin(*_t(od, z), packed) >= RELU_MARGIN).numpy()
    cots = [np.where(keep, c, 0.0).astype(np.float32) for c in cots]
    off = _off_mask(gate)

    def jloss(pj):
        outs = jfv.fused_mlp_train_rays(pj, jnp.asarray(od), jnp.asarray(z),
                                        tile_rays=128, s_rows=8,
                                        interpret=True, gate=jnp.asarray(gate))
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots)), outs

    packed_j, unpack = jax.vjp(jfm.pack_nerf_mlp_params,
                               to_jax(params["fine"]))
    (_, jouts), dpacked = jax.value_and_grad(jloss, has_aux=True)(packed_j)
    tree = unpack(dpacked)[0]
    want = {k: v.numpy() for k, v in state_dict_from_jax_params(
        {"coarse": tree, "fine": tree}).items() if k.startswith("model_fine")}

    mlp.zero_grad(set_to_none=True)
    w, b = fm.pack_flat(mlp)
    outs = fv.fused_mlp_train_rays(w, b, *_t(od, z),
                                   weight_dtype=torch.float32,
                                   gate=torch.from_numpy(gate))
    torch.autograd.backward(outs, _t(*cots))
    got = {f"model_fine.{k}": p.grad for k, p in mlp.named_parameters()}
    for o, jo in zip(outs, jouts):
        o, jo = o.detach().numpy(), np.asarray(jo)
        assert not o[off].any() and not jo[off].any()
        np.testing.assert_allclose(o, jo, rtol=1e-4, atol=1e-4)
    _assert_grads_close(got, want, REL_JAX)


# --------------------------------------------- the gated render and step


def _uniforms(key, n=N):
    key_c, key_f = jax.random.split(key)
    return (torch.from_numpy(np.array(jax.random.uniform(key_c, (n, SC)))),
            torch.from_numpy(np.array(jax.random.uniform(key_f, (n, SF)))))


def test_gated_render_matches_jax(compact):
    """``render_rays_train(support=)``: the coarse pass to 1e-5, the fine
    rays by outlier fraction (at most 2% beyond 1e-4), ``gate_frac``
    equal."""
    o, d, _ = compact["batch"]
    key = jax.random.PRNGKey(5)
    jout = jrender.render_rays_train(
        to_jax(compact["params"]), jnp.asarray(o), jnp.asarray(d), key,
        compact["jcfg"], support=(*compact["jbounds"], 6.0))
    u_c, u_f = _uniforms(key)
    out = render.render_rays_train(compact["model"], *_t(o, d),
                                   compact["cfg"], u_c=u_c, u_f=u_f,
                                   support=(*compact["bounds"], 6.0))
    np.testing.assert_allclose(out.rgb_c.detach().numpy(),
                               np.asarray(jout.rgb_c), rtol=0, atol=1e-5)
    far = np.abs(out.rgb_f.detach().numpy() - np.asarray(jout.rgb_f)).max(-1)
    assert (far > 1e-4).mean() <= 0.02
    assert float(out.gate_frac) == pytest.approx(float(jout.gate_frac),
                                                 abs=1e-7)
    assert 0.2 < float(out.gate_frac) < 1.0


def test_gated_loss_bit_equal_grads_close(compact):
    """Within the port: the gated step's loss and metrics are the ungated
    ones bit for bit; the module's gradients agree to 1e-5."""
    from nerf_pytorch_paeng_tpu_torch.train.step import _loss_and_metrics

    o, d, tgt = _t(*compact["batch"])
    model = compact["model"]
    u_c, u_f = _uniforms(jax.random.PRNGKey(6))

    def run(support):
        model.zero_grad(set_to_none=True)
        loss, m = _loss_and_metrics(model, o, d, tgt, compact["cfg"],
                                    u_c=u_c, u_f=u_f, support=support)
        loss.backward()
        return loss, m, {k: p.grad.clone()
                         for k, p in model.named_parameters()}

    l_u, m_u, g_u = run(None)
    l_g, m_g, g_g = run((*compact["bounds"], 6.0))
    assert torch.equal(l_u, l_g)
    for k in m_u:
        assert torch.equal(m_u[k], m_g[k]), k
    assert "gate_frac" in m_g and "gate_frac" not in m_u
    for k in g_u:
        np.testing.assert_allclose(g_g[k].numpy(), g_u[k].numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def test_gated_trajectory_matches_jax(compact):
    """Two gated global-batch steps with Adam(1e-3) from the compact field:
    the JAX package's ``make_train_step(precull=True)`` with optax and the
    port's step with its own bounds; losses to 1e-4, the weights at the end
    to 2e-3 relative L2 (tests/test_torch_train_parity.py's tolerances)."""
    import optax

    from nerf_pytorch_paeng_tpu.train import step as jstep
    from nerf_pytorch_paeng_tpu.train.state import TrainState as JaxState
    from nerf_pytorch_paeng_tpu_torch.train import TrainState, make_optimizer
    from nerf_pytorch_paeng_tpu_torch.train.step import make_train_step

    o, d, tgt = compact["batch"]
    tx = optax.adam(1e-3)
    jp = to_jax(compact["params"])
    jstate = JaxState(jnp.zeros((), jnp.int32), jp, tx.init(jp))
    jax_step = jax.jit(jstep.make_train_step(None, tx, compact["jcfg"],
                                             precull=True))
    key = jax.random.PRNGKey(7)
    model = NeRF()
    model.load_state_dict(state_dict_from_jax_params(compact["params"]))
    state = TrainState(model, make_optimizer(model, compact["cfg"]), 0)
    step = make_train_step(compact["cfg"], lambda _: 1e-3)
    for i in range(2):
        jstate, jm = jax_step(jstate, jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(tgt), key, compact["jbounds"])
        u_c, u_f = _uniforms(jax.random.fold_in(key, i))
        m = step(state, *_t(o, d, tgt), u_c=u_c, u_f=u_f,
                 support=compact["bounds"])
        for k in ("loss", "loss_c", "loss_f"):
            assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-4), (i, k)
        assert float(m["gate_frac"]) == pytest.approx(float(jm["gate_frac"]),
                                                      abs=1e-7)
    want = state_dict_from_jax_params(jax.device_get(jstate.params))
    for name, p in model.named_parameters():
        assert _rel(p.detach().numpy(), want[name].numpy()) <= 2e-3, name


# ------------------------------------------------------------- the driver


def _driver_cfg(tmp_path, exp, **over):
    from nerf_pytorch_paeng_tpu_torch.utils.synth import \
        save_as_blender_dataset
    root = tmp_path / "data"
    if not root.exists():
        save_as_blender_dataset(str(root), n_train=3, n_val=1, n_test=1,
                                H=16, W=16)
    base = dict(KW, N_rays=128, train_precull_tile=0, global_batch=True,
                iter_warmup=0,
                bkg_white=True, idx_print=0, idx_vis=0, idx_test=0,
                idx_render=0, train_precull_min_gate=0.0)
    base.update(over)
    return NerfConfig(device="cpu", data_type="blender",
                      data_root=str(root), exp_name=exp,
                      log_dir=str(tmp_path / "logs"), **base).validate()


def _policy_rows(cfg):
    with open(os.path.join(cfg.logdir, cfg.exp_name,
                           "precull_policy.csv")) as f:
        lines = f.read().splitlines()
    assert lines[0] == "iter,bounds_valid,gate_frac_pred,gated"
    return [line.split(",") for line in lines[1:]]


def test_driver_policy_refresh_backoff(tmp_path, capsys):
    """From scratch the bounds are invalid (random density everywhere):
    every refresh declines, and with every=2, backoff_max=4 the refreshes
    fall at 1, 5, 13, 21, 29 (the JAX package's
    tests/test_train_precull.py::test_driver_policy_refresh_backoff)."""
    from nerf_pytorch_paeng_tpu_torch.driver import main_worker

    cfg = _driver_cfg(tmp_path, "backoff", iter_N=30, idx_save=0,
                      train_precull_every=2, train_precull_backoff_max=4)
    res = main_worker(cfg)
    rows = _policy_rows(cfg)
    assert [int(r[0]) for r in rows] == [1, 5, 13, 21, 29]
    assert all(r[1] == "0" and r[3] == "0" for r in rows)
    assert ">> train_precull -> ungated (bounds invalid) @ iter 1" in \
        capsys.readouterr().out
    assert res["gate_frac"] == [None] * 30


def test_driver_gating_policy(tmp_path, capsys):
    """Resumed from a checkpoint of the compact field (valid bounds) with
    min_gate 0, the first refresh decides GATED, the gated steps log
    ``gate_frac`` to metrics.csv, the decision rows go to the policy CSV,
    and a resume appends to it (the JAX package's
    ``test_driver_gating_policy``)."""
    import csv

    from nerf_pytorch_paeng_tpu_torch.driver import main_worker
    from nerf_pytorch_paeng_tpu_torch.train import (TrainState,
                                                    make_optimizer)
    from nerf_pytorch_paeng_tpu_torch.train.checkpoint import save_checkpoint

    cfg = _driver_cfg(tmp_path, "gated", iter_start=12, iter_N=16,
                      idx_save=16, idx_vis=1, train_precull_every=2)
    model = NeRF()
    model.load_state_dict(state_dict_from_jax_params(compact_field_params()))
    save_checkpoint(cfg.logdir, cfg.exp_name,
                    TrainState(model, make_optimizer(model, cfg), 12))
    res = main_worker(cfg)
    out = capsys.readouterr().out
    assert ">> train_precull on (refresh every 2 iters)" in out
    assert ">> train_precull -> GATED (predicted gate_frac" in out
    rows = _policy_rows(cfg)
    assert [r[0] for r in rows] == ["13", "15"]
    assert all(r[1] == "1" and r[3] == "1" for r in rows)
    assert all(g is not None and 0 <= g < 1 for g in res["gate_frac"])
    assert all(np.isfinite(res["loss"]))
    with open(os.path.join(cfg.logdir, cfg.exp_name, "metrics.csv")) as f:
        logged = list(csv.DictReader(f))
    assert [float(r["gate_frac"]) for r in logged] == pytest.approx(
        res["gate_frac"], abs=1e-6)
    # a resume appends to the trajectory; "off" neither gates nor writes
    main_worker(dataclasses.replace(cfg, iter_start=16, iter_N=17, idx_save=17))
    assert [r[0] for r in _policy_rows(cfg)] == ["13", "15", "17"]
    res = main_worker(dataclasses.replace(cfg, iter_start=17, iter_N=18,
                                          idx_save=18, train_precull="off"))
    assert res["gate_frac"] == [None] and len(_policy_rows(cfg)) == 3


def test_driver_warns_when_on_is_inapplicable(tmp_path, capsys):
    """An explicit "on" without a usable grid (grid 0 on the CPU) warns
    and trains ungated; "auto" falls back silently."""
    from nerf_pytorch_paeng_tpu_torch.driver import main_worker

    cfg = _driver_cfg(tmp_path, "warn", iter_N=1, idx_save=0,
                      render_precull_grid=0, train_precull="on")
    assert main_worker(cfg)["gate_frac"] == [None]
    assert "train_precull requested but inapplicable" in \
        capsys.readouterr().out
    main_worker(dataclasses.replace(cfg, train_precull="auto"))
    assert "train_precull" not in capsys.readouterr().out


def test_precull_switches_match_jax():
    """``train_precull_mode`` and ``train_precull_enabled`` decide as the
    JAX package's on the same configs."""
    for v in ("auto", "on", "off", "true", "0", "yes", "n"):
        jcfg, cfg = _cfgs(train_precull=v)
        assert precull.train_precull_mode(cfg) == \
            jprecull.train_precull_mode(jcfg), v
    for over in (dict(), dict(train_precull="off"), dict(data_type="llff"),
                 dict(N_samples_c=4, N_samples_f=4), dict(N_rays=200),
                 dict(render_precull_grid=0)):
        jcfg, cfg = _cfgs(**over)
        assert precull.train_precull_enabled(cfg) == \
            jprecull.train_precull_enabled(jcfg), over
    assert precull.train_precull_enabled(_cfgs()[1])
    assert precull.train_precull_mode(NerfConfig()) == "auto"
