"""Instant-NGP on the port, on the CPU at small sizes, against the plain
reference of the benchmark (``port_bench/reference/ngp.py``: float32
torch that imports nothing of the program): the hash encoding forward and
backward, the marcher's kept samples and dropped rays, the occupancy
grid's update, one whole step's loss and gradients, ``driver.train`` with
a checkpoint's save and resume, a frame, and the fused MLPs' plain twin
and route.

Small sizes: 4 levels (two dense, two hashed), tables of 2^10 entries,
a 16^3 grid, 64 rays, 128 lattice steps, budgets of a few thousand
samples.  On the CPU the kernels' plain twins run, so most comparisons
are of float32 sums in another order (1e-5) and the marcher's samples
are equal bit for bit (both round op by op).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from nerf_pytorch_paeng_tpu_torch.config import NerfConfig, load_config
from nerf_pytorch_paeng_tpu_torch.kernels import hash_grid as hg
from nerf_pytorch_paeng_tpu_torch.kernels import ngp_march as nm
from nerf_pytorch_paeng_tpu_torch.kernels import ngp_mlp as nmlp
from nerf_pytorch_paeng_tpu_torch.models import ngp
from nerf_pytorch_paeng_tpu_torch.ops.ngp import (make_ngp_frame_renderer,
                                                  ngp_loss, render_rays_ngp)
from port_bench.reference import ngp as ref

CONFIG = os.path.join(os.path.dirname(__file__), os.pardir,
                      "nerf_pytorch_paeng_tpu_torch", "configs",
                      "blender_lego_ngp.txt")
SMALL = dict(arch="ngp", device="cpu", compute_dtype="float32",
             iter_warmup=0, N_rays=64, ngp_levels=4, ngp_log2_table=13,
             ngp_grid_res=16, ngp_budget=4096)


@pytest.fixture(autouse=True)
def one_thread():
    """Small tensors run fastest on one thread beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    return NerfConfig(**{**SMALL, **kw}).validate()


def _model(cfg, seed=0, scale=1e4):
    """A fresh NGP whose tables are scaled to features of order 1."""
    model = ngp.init_ngp(cfg, "cpu", seed=seed)
    with torch.no_grad():
        for t in model.tables:
            t.mul_(scale)
    return model


def _params(model):
    return {k: v.detach().clone() for k, v in model.named_parameters()}


def _ref_levels(cfg):
    return ref.levels(cfg.ngp_levels, cfg.ngp_log2_table, ref.N_MIN,
                      ref.N_MAX)


def _rays(n, seed):
    g = torch.Generator().manual_seed(seed)
    c = torch.randn(n, 3, generator=g)
    c = 4.0 * c / c.norm(dim=1, keepdim=True)
    return c, -c + 0.8 * torch.randn(n, 3, generator=g)


def _march_kw(cfg):
    return dict(steps=nm.MAX_STEPS, grid=cfg.ngp_grid_res)


def test_published_levels_and_sizes():
    cfg = load_config(["--config", CONFIG, "--device", "cpu"])
    lv = ngp.hash_levels(cfg)
    assert [s for _, s, _ in lv[:5]] == [4913, 12167, 29791, 79507, 205379]
    assert all(not d and s == 2 ** 19 for _, s, d in lv[5:])
    assert [r for r, _, _ in lv][::5] == [16, 80, 406, 2048]
    assert sum(s for _, s, _ in lv) * 2 == 12_197_850
    assert lv == _ref_levels(cfg)
    model = ngp.NGP(cfg)
    macs = sum(w.numel() for w in model.mlp_parameters())
    assert macs == 9408
    with pytest.raises(ValueError):
        dataclasses.replace(cfg, global_batch=False).validate()


def test_encoding_forward_and_backward_match_the_reference():
    cfg = _cfg()
    lv = ngp.hash_levels(cfg)
    assert {d for _, _, d in lv} == {True, False}
    model = _model(cfg, seed=1)
    g = torch.Generator().manual_seed(2)
    x = torch.rand(500, 3, generator=g)
    x[:40] = torch.randint(0, 33, (40, 3), generator=g) / 32.0  # lattice
    x[40:50] = 1.0
    x[50:60, 0] = 1.0
    tables = list(model.tables)
    got = hg.hash_encode(x, tables, lv)
    p = _params(model)
    want = ref.encode(p, lv, x)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    dout = torch.randn(500, 2 * len(lv), generator=g)
    g_got = torch.autograd.grad(got, tables, dout)
    leaves = {k: v.requires_grad_(True) for k, v in p.items()}
    g_want = torch.autograd.grad(ref.encode(leaves, lv, x), [
        leaves[f"tables.{l}"] for l in range(len(lv))], dout)
    for a, b in zip(g_got, g_want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    # points past n_valid: zero features, no gradient
    n_valid = torch.tensor([450], dtype=torch.int32)
    cut = hg.hash_encode(x, tables, lv, n_valid)
    assert torch.equal(cut[450:], torch.zeros_like(cut[450:]))
    torch.testing.assert_close(cut[:450], got[:450])


@pytest.mark.parametrize("budget", [1 << 20, 1000])
def test_marcher_kept_samples_and_dropped_rays(budget):
    cfg = _cfg(ngp_budget=budget)
    o, d = _rays(64, 3)
    g = torch.Generator().manual_seed(4)
    u = torch.rand(64, generator=g)
    bits = (torch.rand(16 ** 3, generator=g) < 0.4).to(torch.uint8)
    m = nm.march(o, d, u, bits, nm.MarchParams.from_cfg(cfg))
    lat = ref.lattice(o, d, u, bits, budget=float(budget), **_march_kw(cfg))
    kept = lat["kept"]
    assert torch.equal(m.counts.long(), lat["count"])
    assert int(m.stats[0]) == int(kept.sum())
    if budget < 1 << 20:
        assert 0 < int(kept.sum()) < 64     # some rays dropped, in order
        assert not kept[int(kept.sum()):].any()
    sel = lat["occ"] & kept[:, None]
    n = int(sel.sum())
    assert int(m.stats[1]) == n
    assert torch.equal(m.pos[:n], lat["x"][sel])
    assert torch.equal(m.ts[:n], lat["t"][sel])
    rays = torch.arange(64)[:, None].expand(64, nm.MAX_STEPS)[sel]
    assert torch.equal(m.ray_idx[:n].long(), rays)


def test_grid_update_values_and_bitfield():
    cfg = _cfg()                 # sigma dt under 0.01: the mean
    model = _model(cfg, seed=5, scale=3e3)
    p = _params(model)
    lv = _ref_levels(cfg)
    values = torch.zeros(16 ** 3)
    bits = torch.ones(16 ** 3, dtype=torch.uint8)
    w = ngp.GRID_WARMUP                      # all cells, then half of them
    for step in (w - 16, w, w + 16):
        ngp.update_occupancy_grid(model, cfg, step,
                                  torch.Generator().manual_seed(step))
        bits = ref.grid_update(
            p, lv, values, bits, step, cfg.ngp_grid_res, nm.MAX_STEPS, w,
            torch.Generator().manual_seed(step))
        torch.testing.assert_close(model.grid_values, values, rtol=1e-5,
                                   atol=1e-9)
        assert torch.equal(model.grid_bits, bits)
    assert 0 < int(bits.sum()) < 16 ** 3


def test_one_step_loss_and_gradients_match_the_reference():
    cfg = _cfg(ngp_budget=1000)
    model = _model(cfg, seed=6, scale=3e3)
    o, d = _rays(64, 7)
    g = torch.Generator().manual_seed(8)
    u = torch.rand(64, generator=g)
    target = torch.rand(64, 3, generator=g)
    with torch.no_grad():
        model.grid_bits.copy_((torch.rand(16 ** 3, generator=g) < 0.5).to(
            torch.uint8))
    out = render_rays_ngp(model, o, d, u, nm.MarchParams.from_cfg(cfg))
    loss = ngp_loss(out, target)
    names = [n for n, _ in model.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(
        model.parameters()))))
    lat = ref.lattice(o, d, u, model.grid_bits, budget=1000.0,
                      **_march_kw(cfg))
    k = int(lat["kept"].sum())
    assert 1 < k < 64
    assert torch.equal(out["kept"], lat["kept"])
    l_ref, g_ref = ref.loss_and_grads(
        _params(model), _ref_levels(cfg), o[:k], d[:k], u[:k], target[:k],
        model.grid_bits, **_march_kw(cfg))
    torch.testing.assert_close(loss.detach(), l_ref, rtol=1e-5, atol=0)
    for name in names:
        torch.testing.assert_close(grads[name], g_ref[name], rtol=1e-4,
                                   atol=1e-7)


def _scene(tmp_path):
    from nerf_pytorch_paeng_tpu_torch.utils.synth import \
        save_as_blender_dataset
    root = tmp_path / "scene"
    save_as_blender_dataset(str(root), n_train=2, n_val=1, n_test=1, H=32,
                            W=32)
    return str(root)


def _run(root, logs, *extra):
    from nerf_pytorch_paeng_tpu_torch.driver import main_worker
    args = ["--config", CONFIG, "--device", "cpu", "--data_root", root,
            "--log_dir", logs, "--compute_dtype", "float32",
            "--idx_print", "0", "--idx_vis", "0", "--idx_test", "0",
            "--idx_render", "0", "--scan_chunk", "4"]
    for k, v in SMALL.items():
        if k not in ("arch", "device", "compute_dtype"):
            args += [f"--{k}", str(v)]
    return main_worker(load_config(args + list(extra)))


def test_driver_trains_saves_and_resumes_exactly(tmp_path):
    root, logs = _scene(tmp_path), str(tmp_path / "logs")
    whole = _run(root, logs + "a", "--iter_N", "24", "--idx_save", "24")
    part = _run(root, logs + "b", "--iter_N", "16", "--idx_save", "16")
    rest = _run(root, logs + "b", "--iter_N", "24", "--idx_save", "24",
                "--iter_start", "-1")
    assert whole["chunks"] == [4] * 6 and part["chunks"] == [4] * 4
    assert whole["loss"][16:] == rest["loss"]
    exp = "blender_lego_ngp"
    a = torch.load(os.path.join(logs + "a", exp, f"{exp}_24.pth.tar"),
                   weights_only=True)
    b = torch.load(os.path.join(logs + "b", exp, f"{exp}_24.pth.tar"),
                   weights_only=True)
    assert a["idx"] == b["idx"] == 24
    sd_a, sd_b = a["model_state_dict"], b["model_state_dict"]
    assert {"grid_values", "grid_bits", "tables.0", "color_w2"} <= set(sd_a)
    for key in sd_a:
        assert torch.equal(sd_a[key], sd_b[key]), key
    # the grid was updated (after step 16, in the resumed run) and
    # thresholded
    assert float(sd_a["grid_values"].max()) > 0
    # --eval_only renders the checkpoint through the NGP frame renderer
    res = _run(root, logs + "a", "--eval_only", "true", "--testing_idx", "24")
    assert len(res["psnr"]) == 1 and np.isfinite(res["psnr"][0])


def test_frame_matches_the_reference():
    cfg = _cfg()
    model = _model(cfg, seed=9, scale=3e3)
    with torch.no_grad():
        model.grid_bits.copy_((torch.rand(
            16 ** 3, generator=torch.Generator().manual_seed(10)) < 0.6).to(
                torch.uint8))
    H = W = 8
    K = np.array([[10.0, 0, 4.0], [0, 10.0, 4.0], [0, 0, 1]], np.float32)
    from nerf_pytorch_paeng_tpu_torch.data.render_pose import get_render_pose
    c2w = get_render_pose(n_angle=3, single_angle=-1, phi=-30.0, nf=4.0)[1]
    render = make_ngp_frame_renderer(cfg, H, W, K, "cpu", block_rays=24)
    rgb, disp = render(model, c2w)
    from nerf_pytorch_paeng_tpu_torch.ops.rays import get_rays
    o, d = get_rays(H, W, torch.as_tensor(K), torch.as_tensor(
        np.asarray(c2w)[:3, :4], dtype=torch.float32))
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    want = ref.render(_params(model), _ref_levels(cfg), o, d,
                      torch.full((H * W,), 0.5), model.grid_bits,
                      **_march_kw(cfg))
    assert bool(want["kept"].all()) and float(want["acc"].max()) > 0.05
    torch.testing.assert_close(rgb.reshape(-1, 3), want["rgb"], atol=1e-5,
                               rtol=1e-5)
    torch.testing.assert_close(disp.reshape(-1), torch.where(
        want["acc"] > 0, want["acc"] / want["depth"].clamp(min=1e-10),
        torch.zeros_like(want["acc"])), atol=1e-4, rtol=1e-4)


# ------------------------------------------------- the fused MLPs' twin
#
# ``kernels/ngp_mlp``: on the card both MLPs are one forward and one
# backward kernel; on the CPU its wrapper runs the plain twin, which
# repeats the kernels' arithmetic (bf16 operands, float32 sums).  At
# float32 the twin is the reference's MLP.


def _mlp_inputs(n, seed, model):
    g = torch.Generator().manual_seed(seed)
    feat = torch.randn(n, model.sigma_w0.shape[1], generator=g)
    sh = nm.sh_encode(torch.nn.functional.normalize(
        torch.randn(n, 3, generator=g), dim=1))
    weights = [w.detach().clone().requires_grad_(True)
               for w in model.mlp_parameters()]
    return feat.requires_grad_(True), sh, weights


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_field_keeps_the_torch_mlps_on_the_cpu(compute_dtype, monkeypatch):
    """``NGP.field`` takes the fused MLPs only for CUDA tensors at bf16:
    on the CPU, at either dtype, it runs ``density_mlp`` and
    ``color_mlp``."""
    cfg = _cfg(compute_dtype=compute_dtype)
    model = _model(cfg, seed=11)

    def refuse(*a, **k):
        raise AssertionError("the fused MLPs' wrapper was called")

    monkeypatch.setattr(ngp, "ngp_mlp", refuse)
    g = torch.Generator().manual_seed(12)
    pos = torch.rand(50, 3, generator=g)
    sh = nm.sh_encode(torch.nn.functional.normalize(
        torch.randn(50, 3, generator=g), dim=1))
    sigma, rgb = model.field(pos, sh)
    s_want, z = model.density_mlp(model.encode(pos))
    assert torch.equal(sigma, s_want)
    assert torch.equal(rgb, model.color_mlp(z, sh))


def _bad_mlp_args(case):
    """(feat, sh, weights, n_valid) with one thing wrong."""
    model = _model(_cfg(), seed=13)
    feat, sh, weights = _mlp_inputs(8, 14, model)
    feat = feat.detach()
    n_valid = None
    if case == "feat_dtype":
        feat = feat.double()
    elif case == "feat_width":
        feat = feat[:, :7]
    elif case == "sh_rows":
        sh = sh[:7]
    elif case == "weight_shape":
        weights[3] = weights[3][:, :63]
    elif case == "weight_dtype":
        weights[0] = weights[0].to(torch.bfloat16)
    elif case == "weight_count":
        weights = weights[:4]
    elif case == "n_valid_dtype":
        n_valid = torch.tensor([4])
    elif case == "n_valid_size":
        n_valid = torch.tensor([4, 4], dtype=torch.int32)
    elif case == "mixed_devices":
        sh = sh.to("meta")
    elif case == "other_device":
        feat, sh = feat.to("meta"), sh.to("meta")
        weights = [w.detach().to("meta") for w in weights]
    return feat, sh, weights, n_valid


@pytest.mark.parametrize("case", [
    "feat_dtype", "feat_width", "sh_rows", "weight_shape", "weight_dtype",
    "weight_count", "n_valid_dtype", "n_valid_size", "mixed_devices",
    "other_device"])
def test_mlp_wrapper_refuses_what_the_kernels_do_not_take(case):
    feat, sh, weights, n_valid = _bad_mlp_args(case)
    with pytest.raises((ValueError, RuntimeError)):
        nmlp.ngp_mlp(feat, sh, weights, n_valid)


@pytest.mark.parametrize("levels,n_valid", [(16, None), (16, 37), (4, 37)])
def test_mlp_plain_twin_matches_the_reference_at_float32(levels, n_valid):
    """The twin at float32 (no rounding): sigma, rgb, d_feat and the five
    weights' gradients against the reference's MLP under autograd, at the
    published 16 levels and at 4; rows at or past ``n_valid`` give 0 and
    add nothing to the weights' gradients."""
    model = _model(_cfg(ngp_levels=levels), seed=15)
    n = 64
    feat, sh, weights = _mlp_inputs(n, 16, model)
    nv = None if n_valid is None else torch.tensor([n_valid],
                                                   dtype=torch.int32)
    sigma, rgb = nmlp.ngp_mlp_plain(feat, sh, weights, nv, rnd=nmlp.identity)
    g = torch.Generator().manual_seed(17)
    g_sigma, g_rgb = torch.randn(n, generator=g), torch.randn(n, 3,
                                                              generator=g)
    got = torch.autograd.grad((sigma * g_sigma).sum() + (rgb * g_rgb).sum(),
                              [feat, *weights])
    k = n if n_valid is None else n_valid
    p = dict(zip(ngp.MLP_WEIGHTS, weights))
    feat_r = feat.detach()[:k].clone().requires_grad_(True)
    s_ref, z = ref.density(p, feat_r)
    rgb_ref = ref.color(p, z, sh[:k])
    want = torch.autograd.grad(
        (s_ref * g_sigma[:k]).sum() + (rgb_ref * g_rgb[:k]).sum(),
        [feat_r, *weights])
    torch.testing.assert_close(sigma[:k], s_ref, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(rgb[:k], rgb_ref, rtol=1e-5, atol=1e-6)
    assert not sigma[k:].any() and not rgb[k:].any()
    torch.testing.assert_close(got[0][:k], want[0], rtol=1e-4, atol=1e-6)
    assert not got[0][k:].any()
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_mlp_plain_twin_at_bf16_is_near_the_torch_path():
    """On the CPU the wrapper runs the twin (bf16 operands, float32 sums),
    which rounds where the bf16 ``torch.mm`` path does but keeps z_0, the
    outputs and the weights' gradients in float32: within bf16's rounding
    of that path, forward and backward."""
    cfg = _cfg(compute_dtype="bfloat16", ngp_levels=16)
    model = _model(cfg, seed=18)
    n = 256
    feat, sh, weights = _mlp_inputs(n, 19, model)
    sigma, rgb = nmlp.ngp_mlp(feat, sh, weights)
    s2, r2 = nmlp.ngp_mlp_plain(feat, sh, weights)
    assert torch.equal(sigma, s2) and torch.equal(rgb, r2)
    g = torch.Generator().manual_seed(20)
    g_sigma, g_rgb = torch.randn(n, generator=g), torch.randn(n, 3,
                                                              generator=g)
    got = torch.autograd.grad((sigma * g_sigma).sum() + (rgb * g_rgb).sum(),
                              [feat, *weights])
    for p, w in zip(model.mlp_parameters(), weights):
        with torch.no_grad():
            p.copy_(w)
    feat_t = feat.detach().clone().requires_grad_(True)
    s_t, z = model.density_mlp(feat_t)
    rgb_t = model.color_mlp(z, sh)
    want = torch.autograd.grad(
        (s_t * g_sigma).sum() + (rgb_t * g_rgb).sum(),
        [feat_t, *model.mlp_parameters()])
    torch.testing.assert_close(sigma, s_t, rtol=2e-2, atol=1e-3)
    torch.testing.assert_close(rgb, rgb_t, rtol=2e-2, atol=2e-3)
    for a, b in zip(got, want):
        err = float((a - b).norm() / b.norm())
        assert err < 2e-2, err
