"""The culled frame renderer of the port (eval/frame.py, render_cull="auto")
against the JAX package's: the gate and truncation helpers, the sample
classes and the phase-2 cover, the gated plain kernels (K4, K5) and the
points kernel (K7), the group-A/B row-gating setups of
tests/test_frame_rays.py through the port's ``_gated_sigma_t`` and
``_gated_fine_rays``, and one whole culled frame.

The JAX side runs its Pallas kernels in interpret mode (float32), with
``tile_rays=128`` where it gates, as the port's kernels do.  Tolerances:
index and boolean results must be equal; float32 kernel outputs 1e-4
(relative, with an absolute floor; the sums run in another order);
bf16-rounded outputs one bf16 step (2^-7 relative); the frames as
tests/test_torch_frame.py holds them (outlier fraction, max and mean)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_pytorch_paeng_tpu.config import NerfConfig as JaxConfig
from nerf_pytorch_paeng_tpu.eval import frame as jframe
from nerf_pytorch_paeng_tpu.kernels import fused_mlp as jfm
from nerf_pytorch_paeng_tpu.models.nerf import NeRF as JaxNeRF
from nerf_pytorch_paeng_tpu.ops import render as jrender
from nerf_pytorch_paeng_tpu_torch.config import NerfConfig
from nerf_pytorch_paeng_tpu_torch.eval import frame
from nerf_pytorch_paeng_tpu_torch.kernels import fused_mlp as fm
from nerf_pytorch_paeng_tpu_torch.models.nerf import NeRF
from nerf_pytorch_paeng_tpu_torch.ops import render
from nerf_pytorch_paeng_tpu_torch.ops.sampling import stratified_z_vals
from nerf_pytorch_paeng_tpu_torch.utils.interop import \
    state_dict_from_jax_params
from nerf_pytorch_paeng_tpu_torch.utils.synth import (
    compact_field_params, compact_field_state_dict, make_synth_scene)

from torch_port_util import np_nerf_params, np_rays, to_jax

TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-4)


def _act(seed, n, n_rows, p_miss=0.3):
    """Seeded row activity: contiguous spans, a share of rays with none."""
    rng = np.random.default_rng(seed)
    first = rng.integers(0, n_rows, n)
    last = np.minimum(first + rng.integers(0, n_rows, n), n_rows - 1)
    rows = np.arange(n_rows)
    act = (rows[None] >= first[:, None]) & (rows[None] <= last[:, None])
    act[rng.random(n) < p_miss] = False
    return act


@pytest.mark.parametrize("n,n_rows", [(300, 3), (256, 24), (1000, 8)])
def test_span_sort_matches_jax(n, n_rows):
    act = _act(n + n_rows, n, n_rows)
    order, inv = render.span_sort(torch.from_numpy(act))
    jorder, jinv = jrender.span_sort(jnp.asarray(act))
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))
    assert not act[order.numpy()][-1].any()          # misses sort last


@pytest.mark.parametrize("n,n_rows", [(300, 3), (256, 24), (129, 8)])
def test_tile_row_gate_matches_jax_padded(n, n_rows):
    """A ragged last tile is padded with inactive rays: the port's gate
    equals JAX's on the activity padded to whole tiles."""
    act = _act(7 + n, n, n_rows)
    act_s = act[render.span_sort(torch.from_numpy(act))[0].numpy()]
    gate, frac = render.tile_row_gate(torch.from_numpy(act_s))
    pad = -n % 128
    padded = np.concatenate([act_s, np.zeros((pad, n_rows), bool)])
    jgate, jfrac = jrender.tile_row_gate(jnp.asarray(padded), 128)
    assert gate.dtype == torch.int32
    assert gate.numel() == -(-n // 128) * n_rows
    np.testing.assert_array_equal(gate.numpy(), np.asarray(jgate))
    assert float(frac) == pytest.approx(float(jfrac), abs=1e-7)


def _coarse_stats(seed, m=96, sc=16, s_fine=24):
    """Seeded coarse depths, peaked compositing weights and sorted merged
    depths, as phase 1 and the resample give them."""
    rng = np.random.default_rng(seed)
    z_vals = np.sort(rng.uniform(2.0, 6.0, (m, sc)), -1).astype(np.float32)
    logits = rng.normal(0, 1, (m, sc)) * 4.0
    w = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    w *= rng.uniform(0.0, 1.0, (m, 1))                 # some rays mostly empty
    fine = rng.uniform(2.0, 6.0, (m, s_fine))
    z_all = np.sort(np.concatenate([z_vals, fine], -1), -1)
    return (z_vals, w.astype(np.float32), z_all.astype(np.float32))


@pytest.mark.parametrize("eps", [1e-3, 1e-2])
def test_truncation_bounds_match_jax(eps):
    _, w, _ = _coarse_stats(1)
    ks, kn = render.truncation_bounds(torch.from_numpy(w), eps)
    jks, jkn = jrender.truncation_bounds(jnp.asarray(w), eps)
    np.testing.assert_array_equal(ks.numpy(), np.asarray(jks))
    np.testing.assert_array_equal(kn.numpy(), np.asarray(jkn))
    assert bool((ks <= kn).all()) and int(kn.max()) <= w.shape[-1]


@pytest.mark.parametrize("n_keep,eps", [(32, 1e-3), (36, 1e-2), (40, 1e-3),
                                        (24, 0.0)])
def test_truncation_window_matches_jax(n_keep, eps):
    """The gather here and JAX's one-hot select plus re-sort pick the same
    samples: equal."""
    z_vals, w, z_all = _coarse_stats(2)
    got = render.truncation_window(torch.from_numpy(z_all),
                                   torch.from_numpy(z_vals),
                                   torch.from_numpy(w), n_keep, eps)
    want = jrender.truncation_window(jnp.asarray(z_all), jnp.asarray(z_vals),
                                     jnp.asarray(w), n_keep, eps)
    assert got.shape == (z_all.shape[0], n_keep)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("s_full,n_fine,eps", [(192, 128, 1e-3),
                                               (40, 24, 1e-3),
                                               (16, 8, 1e-3),
                                               (192, 128, 0.0)])
def test_trunc_classes_match_jax(s_full, n_fine, eps):
    assert frame._trunc_classes(s_full, n_fine, eps) == \
        jframe._trunc_classes(s_full, n_fine, eps)


def test_trunc_classes_lego():
    assert frame._trunc_classes(192, 128, 1e-3) == [144, 168, 192]


@pytest.mark.parametrize("n_act,sizes,want", [
    (24, [64, 32, 16, 8], [(0, 16), (16, 8)]),
    (100, [64, 32, 16, 8], [(0, 64), (64, 32), (96, 8)]),
    (0, [64, 32, 16, 8], []),
    (131072 * 2 + 5, [131072, 65536, 32768, 16384],
     [(0, 131072), (131072, 131072), (262144, 16384)])])
def test_greedy_cover(n_act, sizes, want):
    assert frame._greedy_cover(n_act, sizes) == want


def test_cover_takes_the_class_of_the_last_active_ray():
    """Rays sorted by need: classes [144, 168, 192] hold 50, 30 and 20 of
    100 active rays.  Each block runs the class of its last active ray,
    and the overhang past n_act is not counted."""
    cum = [50, 80, 100]
    blocks = frame._cover(100, cum, [64, 32, 16, 8], [144, 168, 192])
    assert blocks == [(0, 64, 168), (64, 32, 192), (96, 8, 192)]
    assert frame._cover(40, [40, 40, 40], [32, 16, 8], [144, 168, 192]) == \
        [(0, 32, 144), (32, 8, 144)]


def test_precull_switches():
    """Grid 0 is 128 on the card and off on the CPU; gating needs whole
    8-sample rows in both passes; "off" turns each gate off."""
    cfg = NerfConfig(device="cpu")
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert frame._precull_grid(cfg, cuda) == 128
    assert frame._precull_grid(cfg, cpu) == 0
    assert frame._use_precull(cfg, cuda) and not frame._use_precull(cfg, cpu)
    assert frame._use_gate_fine(cfg, cuda)
    assert frame._precull_half(cfg) == 6.0
    g48 = dataclasses.replace(cfg, render_precull_grid=48)
    assert frame._use_precull(g48, cpu) and frame._use_gate_fine(g48, cpu)
    for kw in (dict(N_samples_c=12), dict(N_samples_f=12),
               dict(render_precull="off")):
        assert not frame._use_precull(dataclasses.replace(g48, **kw), cpu)
    assert not frame._use_gate_fine(
        dataclasses.replace(g48, render_gate_fine="false"), cpu)
    assert not frame._use_rays_kernels(
        dataclasses.replace(g48, N_samples_f=12))


@pytest.mark.parametrize("name,value", [("render_cull", "dense"),
                                        ("render_precull", "maybe"),
                                        ("render_gate_fine", "sometimes")])
def test_render_knobs_are_checked(name, value):
    """The JAX package's checks on the render knobs: a bad value fails."""
    with pytest.raises(ValueError, match=name):
        dataclasses.replace(NerfConfig(), **{name: value}).validate()


def test_render_knobs_parse_like_jax():
    from nerf_pytorch_paeng_tpu.config import load_config as jax_load_config
    from nerf_pytorch_paeng_tpu_torch.config import load_config
    argv = ["--render_cull", "none", "--render_cull_tau", "0.01",
            "--render_trunc_eps", "0", "--render_precull", "off",
            "--render_precull_grid", "64", "--render_precull_halfside", "4.5",
            "--render_gate_fine", "false"]
    ours, theirs = load_config(argv), jax_load_config(argv)
    for name in ("render_cull", "render_cull_tau", "render_trunc_eps",
                 "render_precull", "render_precull_grid",
                 "render_precull_halfside", "render_gate_fine"):
        assert getattr(ours, name) == getattr(theirs, name), name


def test_row_envelopes_match_jax():
    for s in (8, 24, 64):
        lo, hi = frame._row_envelopes(2.0, 6.0, s, 8, "cpu")
        jlo, jhi = jframe._row_envelopes(2.0, 6.0, s, 8)
        np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
        np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))


def _packed(seed, module="fine"):
    params = np_nerf_params(seed)
    model = NeRF()
    model.load_state_dict(state_dict_from_jax_params(params))
    packed = fm.pack_nerf_mlp_params(getattr(model, f"model_{module}"),
                                     dtype=torch.float32)
    return packed, jfm.pack_nerf_mlp_params(to_jax(params[module]))


def _gate(seed, n, s):
    g = np.random.default_rng(seed).random(-(-n // 128) * (s // 8)) < 0.5
    return g.astype(np.int32)


def test_gated_sigma_plain_matches_jax():
    """K4's plain version against ``_sigma_rays_kernel_gated`` at (256
    rays, 24 samples), tile 128: gated blocks exactly 0 on both sides."""
    packed, jpacked = _packed(30)
    od, z = np_rays(np.random.default_rng(31), 256, 24)
    gate = _gate(32, 256, 24)
    got = fm.fused_mlp_sigma_rays(torch.from_numpy(od), torch.from_numpy(z),
                                  packed, gate=torch.from_numpy(gate))
    want = np.asarray(jfm.fused_mlp_sigma_rays(
        jnp.asarray(od), jnp.asarray(z), jpacked, tile_rays=128,
        interpret=True, gate=jnp.asarray(gate)))
    on = fm.gate_mask(torch.from_numpy(gate), 24, 256).numpy()
    assert 0 < on.mean() < 1
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert not got.numpy()[~on].any() and not want[~on].any()


def test_gated_eval_plain_matches_jax():
    """K5's plain version against ``_eval_rays_kernel_gated``: all four
    outputs."""
    packed, jpacked = _packed(33)
    od, z = np_rays(np.random.default_rng(34), 256, 24)
    gate = _gate(35, 256, 24)
    got = fm.fused_mlp_eval_rays(torch.from_numpy(od), torch.from_numpy(z),
                                 packed, gate=torch.from_numpy(gate))
    want = jfm.fused_mlp_eval_rays(
        jnp.asarray(od), jnp.asarray(z), jpacked, tile_rays=128,
        interpret=True, gate=jnp.asarray(gate))
    on = fm.gate_mask(torch.from_numpy(gate), 24, 256).numpy()
    for name, g, w in zip("rgbs", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)
        assert not g.numpy()[~on].any(), name


def test_gated_plain_is_ungated_where_on():
    """The gate only zeroes: where it is on, the gated plain versions give
    the ungated bits, with a ragged last tile."""
    packed, _ = _packed(36)
    od, z = map(torch.from_numpy, np_rays(np.random.default_rng(37), 200, 16))
    gate = torch.from_numpy(_gate(38, 200, 16))
    on = fm.gate_mask(gate, 16, 200)
    a = fm.fused_mlp_sigma_rays(od, z, packed, gate=gate)
    b = fm.fused_mlp_sigma_rays(od, z, packed)
    assert torch.equal(a[on], b[on]) and not a[~on].any()
    for x, y in zip(fm.fused_mlp_eval_rays(od, z, packed, gate=gate),
                    fm.fused_mlp_eval_rays(od, z, packed)):
        assert torch.equal(x[on], y[on]) and not x[~on].any()


@pytest.mark.parametrize("L_x", [10, 6])
def test_points_plain_matches_jax(L_x):
    """K7's plain version against ``_mlp_sigma_kernel``'s row 0 (the
    8-row padding is the TPU's layout)."""
    params = np_nerf_params(40, L_x=L_x)
    model = NeRF(L_x=L_x)
    model.load_state_dict(state_dict_from_jax_params(params))
    packed = fm.pack_nerf_mlp_params(model.model_coarse, L_x=L_x,
                                     dtype=torch.float32)
    x = np.random.default_rng(41).uniform(-2, 2, (3, 512)).astype(np.float32)
    got = fm.fused_mlp_sigma(torch.from_numpy(x), packed, L_x=L_x)
    want = jfm.fused_mlp_sigma(
        jnp.asarray(x), jfm.pack_nerf_mlp_params(to_jax(params["coarse"]),
                                                 L_x=L_x),
        L_x=L_x, tile=512, interpret=True)
    assert got.shape == (512,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[0], **TOL)
    # the points kernel is the sigma kernel at one sample of depth 0
    od = np.concatenate([x, np.ones((3, 512)), np.zeros((2, 512))]) \
        .astype(np.float32)
    k3 = fm.fused_mlp_sigma_rays(torch.from_numpy(od),
                                 torch.zeros(1, 512), packed, L_x=L_x)
    assert torch.equal(got, k3[0])


# ------------------------------------------- group A/B row gating (frame_rays)

M_AB, S_AB = 256, 24


def _ab_rays():
    """Group A (first half) passes straight through a box/sphere around the
    origin: support interval [3.5, 4.5], the middle of 3 rows; group B
    starts at z=8, so its t=2 end lies outside the half=5 cube: never
    gated."""
    oz = np.where(np.arange(M_AB) < M_AB // 2, 4.0, 8.0)
    o = np.stack([np.zeros(M_AB), np.zeros(M_AB), oz], -1).astype(np.float32)
    d = np.broadcast_to(np.array([0.0, 0.0, -1.0], np.float32),
                        (M_AB, 3)).copy()
    bounds = (np.array([-0.5] * 3, np.float32), np.array([0.5] * 3, np.float32),
              np.array([0.9], np.float32), np.array([True]))
    return o, d, bounds


def _ab_check(got, ungated):
    a = np.arange(M_AB) < M_AB // 2
    np.testing.assert_array_equal(got[:, ~a], ungated[:, ~a])    # B whole
    np.testing.assert_array_equal(got[8:16, a], ungated[8:16, a])
    assert not got[:8, a].any() and not got[16:, a].any()        # A gated
    assert ungated[:8, a].any() and ungated[16:, a].any()


def test_gated_sigma_row_gating_matches_jax():
    packed, jpacked = _packed(42, "coarse")
    o, d, b = _ab_rays()
    z = stratified_z_vals(M_AB, 2.0, 6.0, S_AB, perturb=True,
                          generator=torch.Generator().manual_seed(7))
    to = lambda x: torch.from_numpy(x)                           # noqa: E731
    got, gate = frame._gated_sigma_t(packed, to(o), to(d), z,
                                     tuple(map(to, b)), 5.0, 2.0, 6.0, 10)
    ungated = fm.fused_mlp_sigma_rays(render.pack_od(to(o), to(d)),
                                      z.T.contiguous(), packed,
                                      out_dtype=torch.bfloat16)
    _ab_check(got.float().numpy(), ungated.float().numpy())
    assert gate.tolist() == [1, 1, 1, 0, 1, 0]      # B sorts first (span 0-2)
    want = jframe._gated_sigma_t(
        jpacked, jnp.asarray(o), jnp.asarray(d), jnp.asarray(z.numpy()),
        tuple(map(jnp.asarray, b)), 128, M_AB, 5.0, 2.0, 6.0, 10, True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               **BF16_TOL)


def test_gated_fine_rays_row_gating_matches_jax():
    packed, jpacked = _packed(43, "fine")
    o, d, b = _ab_rays()
    z_all = torch.linspace(2.0, 6.0, S_AB).expand(M_AB, S_AB).contiguous()
    to = lambda x: torch.from_numpy(x)                           # noqa: E731
    got, gate = frame._gated_fine_rays(packed, to(o), to(d), z_all,
                                       tuple(map(to, b)), 5.0, 2.0, 6.0,
                                       10, 4)
    ungated = fm.fused_mlp_eval_rays(render.pack_od(to(o), to(d)),
                                     z_all.T.contiguous(), packed,
                                     out_dtype=torch.bfloat16)
    want = jframe._gated_fine_rays(
        jpacked, jnp.asarray(o), jnp.asarray(d), jnp.asarray(z_all.numpy()),
        tuple(map(jnp.asarray, b)), 128, M_AB, 5.0, 2.0, 6.0, 10, 4, True)
    assert gate.tolist() == [1, 1, 1, 0, 1, 0]
    for g, u, w in zip(got, ungated, want):
        _ab_check(g.float().numpy(), u.float().numpy())
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w).astype(np.float32),
                                   **BF16_TOL)


# ------------------------------------------------------ the slice: one frame

H = W = 16
FRAME_KW = dict(netDepth=8, netWidth=256, L_x=10, L_d=4, N_samples_c=16,
                N_samples_f=24, near=2.0, far=6.0, perturb=0.0,
                compute_dtype="float32", chunk_rays=64,
                render_precull_grid=48)


def _outliers(name, ours, ref, tol, cap):
    diff = np.abs(ours - ref)
    frac_out = float((diff > tol + tol * np.abs(ref)).mean())
    assert frac_out < 2e-3, (name, frac_out)
    assert float(diff.max()) < cap, (name, float(diff.max()))
    assert float(diff.mean()) < 1e-4, (name, float(diff.mean()))


@pytest.fixture(scope="module")
def compact_scene():
    """The r=1.0 compact field at G=48: valid bounds of +-1, which only a
    quarter of the 16x16 frame's rays hit, so whole tiles are misses."""
    _, K, poses = make_synth_scene(n_views=2, H=H, W=W)
    model = NeRF()
    model.load_state_dict(compact_field_state_dict(r=1.0, k=20.0))
    cfg = NerfConfig(device="cpu", **FRAME_KW)
    jcfg = JaxConfig(use_pallas=True, render_cull="auto", **FRAME_KW)
    jr = jframe.make_frame_renderer(JaxNeRF(compute_dtype=jnp.float32), jcfg,
                                    H, W, K, stratified=False)
    jrgb, jdisp = jr(to_jax(compact_field_params(r=1.0, k=20.0)),
                     jnp.asarray(poses[0][:3, :4]), jax.random.PRNGKey(0))
    return cfg, model, K, poses[0], np.asarray(jrgb), np.asarray(jdisp)


def test_culled_frame_matches_jax(compact_scene):
    cfg, model, K, pose, jrgb, jdisp = compact_scene
    r = frame.make_frame_renderer(cfg, H, W, K, "cpu", stratified=False)
    rgb, disp = r(fm.pack_nerf(model, cfg), torch.from_numpy(pose))
    assert rgb.shape == (H, W, 3) and disp.shape == (H, W)
    _outliers("rgb", rgb.numpy(), jrgb, 2e-3, 2e-2)
    _outliers("disp", disp.numpy(), jdisp, 5e-3, 8e-2)
    st = r.stats[-1]
    assert 0 < st["n_act"] < H * W and st["blocks"] >= 2
    assert float(st["gate_frac_coarse"]) > 0
    assert st["gate_frac_fine"] is not None


def test_culled_frame_gates_change_nothing(compact_scene):
    """Gated samples carry zero weight: the frame with the pre-cull and
    gate-fine equals the frame with both off (1e-5)."""
    cfg, model, K, pose, _, _ = compact_scene
    packed = fm.pack_nerf(model, cfg)
    c2w = torch.from_numpy(pose)
    gated = frame.make_frame_renderer(cfg, H, W, K, "cpu", stratified=False)
    plain = frame.make_frame_renderer(
        dataclasses.replace(cfg, render_precull="off",
                            render_gate_fine="off"),
        H, W, K, "cpu", stratified=False)
    for a, b in zip(gated(packed, c2w), plain(packed, c2w)):
        assert float((a - b).abs().max()) <= 1e-5
    assert plain.stats[-1]["gate_frac_coarse"] is None
    assert plain.stats[-1]["n_act"] == gated.stats[-1]["n_act"]


def test_support_grid_runs_once_per_weights(compact_scene):
    """The bounds are computed once per set of packed weights (K7 twice:
    the coarse and the fine grid), then served from the renderer's cache;
    a new set of packed weights builds its own grids."""
    cfg, model, K, pose, _, _ = compact_scene
    calls = []

    def points_fn(xp, packed, L_x, out_dtype):
        calls.append(xp.shape[1])
        return fm.fused_mlp_sigma_plain(xp, packed, L_x, out_dtype)

    packed = fm.pack_nerf(model, cfg)
    r = frame.make_frame_renderer(cfg, H, W, K, "cpu", stratified=False,
                                  points_fn=points_fn)
    for _ in range(2):
        r(packed, torch.from_numpy(pose))
    assert calls == [48 ** 3, 48 ** 3]
    r(fm.pack_nerf(model, cfg), torch.from_numpy(pose))
    assert calls == [48 ** 3] * 4


def test_route_follows_render_cull(compact_scene):
    cfg, _, K, _, _, _ = compact_scene
    culled = frame.make_frame_renderer(cfg, H, W, K, "cpu")
    dense = frame.make_frame_renderer(
        dataclasses.replace(cfg, render_cull="none"), H, W, K, "cpu")
    assert hasattr(culled, "stats") and not hasattr(culled,
                                                    "launches_per_frame")
    assert dense.launches_per_frame == -(-H * W // 64)
    assert culled.sizes == [64, 32, 16, 8]
