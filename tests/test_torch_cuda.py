"""The port's CUDA kernels on the card, against their plain versions, one
full-width training step, and the culled frame with and without gates.

Every test here is marked ``cuda`` and skips without a GPU (the kernels
have no CPU mode; the CPU tests hold the plain versions against the JAX
package).  This file imports nothing of JAX, so it runs on a machine
that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: both sides use bf16 operands with float32 accumulation, but
the sums run in another order, so an activation can round to the other
bf16 neighbour and carry that through the remaining layers: 5e-2 max and
1e-2 relative L2 on logits of order 1 (as chip_smoke.py).  The backward
kernel's gradients are held per packed tensor to a cosine of at least
0.999 and 1e-2 relative L2, or three times the distance between the plain
version on the card and on the CPU where that is more (``_grads_close``).
"""
import os

import numpy as np
import pytest
import torch

from nerf_pytorch_paeng_tpu_torch.config import NerfConfig
from nerf_pytorch_paeng_tpu_torch.eval.frame import make_frame_renderer
from nerf_pytorch_paeng_tpu_torch.kernels import fused_mlp as fm
from nerf_pytorch_paeng_tpu_torch.kernels import fused_mlp_vjp as fv
from nerf_pytorch_paeng_tpu_torch.models.nerf import NeRF, init_nerf
from nerf_pytorch_paeng_tpu_torch.utils.interop import \
    state_dict_from_jax_params
from nerf_pytorch_paeng_tpu_torch.utils.synth import (
    compact_field_state_dict, make_synth_scene)

from torch_port_util import np_nerf_params, np_rays

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions: fp32
    return torch.device("cuda")


def _packed(seed, dev, L_x=10, L_d=4, dtype=torch.bfloat16):
    model = NeRF(L_x=L_x, L_d=L_d)
    model.load_state_dict(state_dict_from_jax_params(
        np_nerf_params(seed, L_x=L_x, L_d=L_d)))
    return fm.pack_nerf_mlp_params(model.model_fine.to(dev), L_x, L_d,
                                   dtype=dtype)


def _inputs(seed, n, s, dev):
    od, z = np_rays(np.random.default_rng(seed), n, s)
    return torch.from_numpy(od).to(dev), torch.from_numpy(z).to(dev)


def _close(got, want):
    got, want = got.float(), want.float()
    assert float((got - want).abs().max()) < 5e-2
    assert float((got - want).norm() / want.norm()) < 1e-2


@pytest.mark.parametrize("n,s", [(128, 8), (1000, 8), (4096, 64), (300, 3)] + [
    (n, s) for n in (1, 129, 4096) for s in (1, 3, 64, 192)
    if (n, s) != (4096, 64)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain(dev, n, s, out_dtype):
    """Ragged ray counts (the kernels mask the edge) and any sample count:
    the persistent walk's edges, from one unit (a block of one ray at one
    sample) to more units than blocks."""
    p = _packed(0, dev)
    od, z = _inputs(1, n, s, dev)
    k3 = fm.fused_mlp_sigma_rays(od, z, p, out_dtype=out_dtype)
    k1 = fm.fused_mlp_eval_rays(od, z, p, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert k3.dtype == out_dtype and k3.shape == (s, n)
    _close(k3, fm.fused_mlp_sigma_rays_plain(od, z, p, out_dtype=out_dtype))
    for a, b in zip(k1, fm.fused_mlp_eval_rays_plain(od, z, p,
                                                     out_dtype=out_dtype)):
        assert a.shape == (s, n)
        _close(a, b)


@pytest.mark.parametrize("L_x,L_d", [(5, 2), (10, 1), (1, 4)])
def test_kernels_short_encodings(dev, L_x, L_d):
    p = _packed(2, dev, L_x, L_d)
    od, z = _inputs(3, 512, 16, dev)
    _close(fm.fused_mlp_sigma_rays(od, z, p, L_x=L_x),
           fm.fused_mlp_sigma_rays_plain(od, z, p, L_x=L_x))
    for a, b in zip(fm.fused_mlp_eval_rays(od, z, p, L_x=L_x, L_d=L_d),
                    fm.fused_mlp_eval_rays_plain(od, z, p, L_x=L_x, L_d=L_d)):
        _close(a, b)


def test_sigma_kernel_agrees_with_eval_kernels_sigma(dev):
    """K3 and K1 run the same trunk and density head (csrc/hopper_mlp.cuh
    and rays_walk): the same bits."""
    p = _packed(4, dev)
    od, z = _inputs(5, 2048, 16, dev)
    for out_dtype in (torch.float32, torch.bfloat16):
        assert torch.equal(
            fm.fused_mlp_sigma_rays(od, z, p, out_dtype=out_dtype),
            fm.fused_mlp_eval_rays(od, z, p, out_dtype=out_dtype)[3])


@pytest.mark.parametrize("gated", [False, True])
def test_ray_kernels_are_deterministic(dev, gated):
    """No atomics and a fixed walk: two launches give the same bits."""
    p = _packed(4, dev)
    n, s = 1000, 64
    od, z = _inputs(5, n, s, dev)
    gate = _gate("mixed", n, s, dev) if gated else None
    for fn in (fm.fused_mlp_sigma_rays, fm.fused_mlp_eval_rays):
        a, b = fn(od, z, p, gate=gate), fn(od, z, p, gate=gate)
        a, b = (x if isinstance(x, tuple) else (x,) for x in (a, b))
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_launch_counters(dev):
    p = _packed(6, dev)
    od, z = _inputs(7, 256, 8, dev)
    a, b = fm.fused_mlp_sigma_rays.launches, fm.fused_mlp_eval_rays.launches
    fm.fused_mlp_sigma_rays(od, z, p)
    fm.fused_mlp_eval_rays(od, z, p)
    fm.fused_mlp_eval_rays(od, z, p)
    fm.fused_mlp_sigma_rays_plain(od, z, p)        # the plain ones don't count
    assert fm.fused_mlp_sigma_rays.launches == a + 1
    assert fm.fused_mlp_eval_rays.launches == b + 2


def test_wrapper_raises_instead_of_falling_back(dev):
    p32 = _packed(8, dev, dtype=torch.float32)
    od, z = _inputs(9, 64, 8, dev)
    with pytest.raises(ValueError):
        fm.fused_mlp_sigma_rays(od, z, p32)
    with pytest.raises(ValueError):
        fm.fused_mlp_eval_rays(od, z.cpu(), _packed(8, dev))


def test_frame_kernels_vs_plain(dev):
    """A whole 64x64 frame at 64+128 samples through the kernels and
    through the plain versions, same draws: >= 35 dB apart at most
    (inverse-CDF tie flips keep it from bit-exact); the dense renderer."""
    cfg = NerfConfig(render_cull="none")
    H = W = 64
    _, K, poses = make_synth_scene(n_views=1, H=H, W=W)
    packed = fm.pack_nerf(init_nerf(cfg, seed=0, device=dev), cfg)
    out = {}
    for name, kw in (("k", {}), ("p", dict(
            sigma_fn=fm.fused_mlp_sigma_rays_plain,
            field_fn=fm.fused_mlp_eval_rays_plain))):
        render = make_frame_renderer(cfg, H, W, K, dev, block_rays=1500, **kw)
        out[name] = render(packed, torch.from_numpy(poses[0]),
                           torch.Generator(dev).manual_seed(0))
    mse = float(torch.mean((out["k"][0] - out["p"][0]) ** 2))
    assert -10 * np.log10(max(mse, 1e-20)) >= 35.0
    assert bool(torch.isfinite(out["k"][1]).all())


def _cotangents(seed, s, n, dev):
    g = torch.Generator(dev).manual_seed(seed)
    return [torch.randn(s, n, generator=g, device=dev) * 1e-3
            for _ in range(4)]


def _rel_cos(got, want):
    """{packed tensor: (relative L2, cosine)} of two (dw, db) pairs."""
    got, want = fm._with_views(*got), fm._with_views(*want)
    out = {}
    for name in got:
        if name in ("w", "b"):
            continue
        a, b = got[name].double().flatten().cpu(), want[name].double().flatten().cpu()
        if float(b.norm()) == 0.0:
            assert float(a.norm()) == 0.0, name
            continue
        out[name] = (float((a - b).norm() / b.norm()),
                     float(a @ b / (a.norm() * b.norm())))
    return out


def _grads_close(got, want, other):
    """Per packed tensor: relative L2 at most 1e-2, or three times the
    distance between ``want`` and ``other`` (the same plain computation
    summed in another order, on the CPU) where that floor is higher;
    cosine at least 0.999.  The floor is needed where a bf16 rounding that
    flips with the summation order travels down the chain (w0-w4 with
    random cotangents: floor up to 2.7e-2).  The kernel's distance is
    another draw of the same noise; at 1024 points it came to 2.2 times
    the floor."""
    floor = _rel_cos(other, want)
    for name, (rel, cos) in _rel_cos(got, want).items():
        assert rel <= max(1e-2, 3 * floor[name][0]) and cos >= 0.999, \
            (name, rel, cos, floor[name])


def _on_cpu(p):
    return fm._with_views(p["w"].cpu(), p["b"].cpu())


def _plain_both(od, z, gout, p):
    """The plain backward on the card and on the CPU."""
    want = fv.fused_mlp_bwd_rays_plain(od, z, *gout, p)
    other = fv.fused_mlp_bwd_rays_plain(od.cpu(), z.cpu(),
                                        *(g.cpu() for g in gout), _on_cpu(p))
    return want, other


@pytest.mark.parametrize("n,s", [(128, 8), (300, 8), (4096, 64)])
def test_bwd_kernel_matches_plain(dev, n, s):
    """Ragged ray counts included: rays past N contribute nothing."""
    p = _packed(10, dev)
    od, z = _inputs(11, n, s, dev)
    gout = _cotangents(12, s, n, dev)
    got = fv.fused_mlp_bwd_rays(od, z, *gout, p)
    torch.cuda.synchronize()
    assert got[0].shape == (fm.W_TOTAL,) and got[1].shape == (fm.B_TOTAL,)
    _grads_close(got, *_plain_both(od, z, gout, p))


def test_bwd_kernel_ragged_rays_match_plain(dev):
    """1000 rays (not a multiple of the 128-ray tile) x 64 samples: the
    launch gives the bits of the same rays padded to 1024 with zero
    cotangents (the chain tiles and the weight-gradient launch's TMA boxes
    end at the ragged edge, and its dummy rays add exact zeros), and is
    within ``_grads_close`` of the plain version under cotangents shaped
    like a training loss's (``_loss_cotangents``)."""
    p = _packed(40, dev)
    od, z = _inputs(41, 1024, 64, dev)
    gout = _loss_cotangents(fm.fused_mlp_eval_rays(od, z, p), 42, dev)
    pad = [g.clone() for g in gout]
    for g in pad:
        g[:, 1000:] = 0.0
    od_r, z_r = od[:, :1000].contiguous(), z[:, :1000].contiguous()
    gout_r = [g[:, :1000].contiguous() for g in gout]
    got = fv.fused_mlp_bwd_rays(od_r, z_r, *gout_r, p)
    padded = fv.fused_mlp_bwd_rays(od, z, *pad, p)
    torch.cuda.synchronize()
    assert torch.equal(got[0], padded[0]) and torch.equal(got[1], padded[1])
    _grads_close(got, *_plain_both(od_r, z_r, gout_r, p))


def _loss_cotangents(outs, seed, dev):
    """d/d logit of a mean squared error of sigmoid(logit) against a seeded
    per-ray target (chip_smoke.py's ``loss_like_cotangents``)."""
    g = torch.Generator(dev).manual_seed(seed)
    s, n = outs[0].shape
    tgt = torch.rand(4, n, generator=g, device=dev)
    return [((torch.sigmoid(o) - tgt[i]) * torch.sigmoid(o)
             * (1 - torch.sigmoid(o)) * (2.0 / (n * s))).contiguous()
            for i, o in enumerate(outs)]


def test_bwd_kernel_is_deterministic(dev):
    """No atomics: two launches on the same inputs give the same bits
    (more than one chunk of points, so the partials' order is pinned)."""
    p = _packed(13, dev)
    od, z = _inputs(14, 4096, 40, dev)
    gout = _cotangents(15, 40, 4096, dev)
    a = fv.fused_mlp_bwd_rays(od, z, *gout, p)
    b = fv.fused_mlp_bwd_rays(od, z, *gout, p)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_bwd_workspace_holds_no_transposed_weights(dev):
    """The chain launch reads the packed weights as they are (TMA boxes,
    K-major wgmma operands for g W^T): the workspace is the stash of one
    chunk (131,072 points x 4832 values), the two float32 partials and the
    gate's list, and the stash is its only bf16 buffer."""
    ws = fv._workspace(fv._library(), 4096, 64, dev)
    assert len(ws) == 4
    bf16 = [t for t in ws[:3] if t.dtype == torch.bfloat16]
    assert len(bf16) == 1 and bf16[0].numel() == 131072 * 4832


def test_bwd_plan_matches_workspace_and_weights(dev):
    """``bwd_plan`` reports the kernel's own chunking and layout: the
    stash of one chunk is the workspace's bf16 buffer, the partials match
    its chunks and splits, the weight-gradient products are the packed
    weights below wdens in their packed order, and the weight-gradient
    launch reads every stashed value."""
    lib = fv._library()
    for n, s in ((4096, 64), (1000, 8), (4096, 192)):
        plan = fv.bwd_plan(n, s)
        stash, part1, part2, n_list = fv._workspace(lib, n, s, dev)
        assert stash.numel() == plan["chunk_points"] * plan["stash_per_point"]
        assert plan["chunks"] * plan["chunk_points"] >= -(-n // 128) * 128 * s
        assert part2.numel() == (plan["chunks"] * plan["nsplit"]
                                 * fm.W_OFFSETS["wdens"])
        assert n_list == -(-n // 128) * s + 1
    layout = dict(fm._W_LAYOUT)
    order = ("w0", "w1", "w2", "w3", "w4", "w5e", "w5h", "w6", "w7",
             "wfeat", "wvf", "wvd")
    assert plan["wgrad_jobs"] == tuple(layout[k] for k in order)
    assert plan["wgrad_read_per_point"] == plan["stash_per_point"]


@pytest.mark.parametrize("route,n,s", [("rays", 4096, 64), ("rays", 1000, 8),
                                       ("points", 4096, 1)])
def test_bwd_stash_is_written_whole(dev, monkeypatch, route, n, s):
    """The chain launch's TMA stores fill every stash value the weight-
    gradient launch reads: a stash filled with NaN before each launch holds
    none after it (a store box that missed rows, or the 32-column embd
    array, would leave NaN there and in dw), and two launches give the
    same bits.  At these shapes the last chunk is full, so every row of
    the stash is read."""
    plan = fv.bwd_plan(n, s)
    assert plan["wgrad_read_per_point"] == plan["stash_per_point"]
    tiles = -(-n // 128) * s
    assert tiles * 128 == plan["chunks"] * plan["chunk_points"]
    stashes = []
    workspace = fv._workspace

    def nan_workspace(lib, n_, s_, dev_):
        ws = workspace(lib, n_, s_, dev_)
        ws[0].fill_(float("nan"))
        stashes.append(ws[0])
        return ws

    monkeypatch.setattr(fv, "_workspace", nan_workspace)
    p = _packed(50, dev)
    if route == "rays":
        od, z = _inputs(51, n, s, dev)
        gout = _cotangents(52, s, n, dev)
        run = lambda: fv.fused_mlp_bwd_rays(od, z, *gout, p)  # noqa: E731
    else:
        g = torch.Generator(dev).manual_seed(51)
        x = torch.randn(3, n, generator=g, device=dev)
        d = torch.randn(3, n, generator=g, device=dev)
        g4 = torch.randn(4, n, generator=g, device=dev) * 1e-3
        run = lambda: fv.fused_mlp_bwd(x, d, g4, p)  # noqa: E731
    a, b = run(), run()
    torch.cuda.synchronize()
    assert len(stashes) == 2
    for stash in stashes:
        assert stash.numel() == plan["chunk_points"] * plan["stash_per_point"]
        assert bool(torch.isfinite(stash).all())
    assert bool(torch.isfinite(a[0]).all()) and bool(torch.isfinite(a[1]).all())
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_bwd_launch_counter(dev):
    p = _packed(16, dev)
    od, z = _inputs(17, 128, 8, dev)
    gout = _cotangents(18, 8, 128, dev)
    before = fv.fused_mlp_bwd_rays.launches
    fv.fused_mlp_bwd_rays(od, z, *gout, p)
    fv.fused_mlp_bwd_rays_plain(od, z, *gout, p)
    assert fv.fused_mlp_bwd_rays.launches == before + 1


def test_bwd_wrapper_raises_instead_of_falling_back(dev):
    p = _packed(16, dev)
    od, z = _inputs(17, 128, 8, dev)
    gout = _cotangents(18, 8, 128, dev)
    with pytest.raises(ValueError):
        fv.fused_mlp_bwd_rays(od, z, *gout, _packed(16, dev, dtype=torch.float32))
    with pytest.raises(ValueError):
        fv.fused_mlp_bwd_rays(od, z, *gout[:3], gout[3].cpu(), p)


def test_train_pair_matches_autograd_of_plain(dev):
    """The K1+K2 pair's gradients against autograd through the plain
    forward with the same bf16 weights, on the card (floor: the same
    autograd on the CPU)."""
    model = NeRF()
    model.load_state_dict(state_dict_from_jax_params(np_nerf_params(19)))
    w, b = fm.pack_flat(model.model_fine.to(dev))
    w, b = w.detach(), b.detach()
    od, z = _inputs(20, 512, 16, dev)
    gout = _cotangents(21, 16, 512, dev)

    def grads(fn, device=dev):
        wl = w.to(device).clone().requires_grad_()
        bl = b.to(device).clone().requires_grad_()
        outs = fn(wl, bl)
        torch.autograd.backward(outs, [g.to(device) for g in gout])
        return wl.grad, bl.grad

    def plain(wl, bl):
        return fm.fused_mlp_eval_rays_plain(
            od.to(wl.device), z.to(wl.device),
            fm._with_views(wl.to(torch.bfloat16), bl))

    before = (fm.fused_mlp_eval_rays.launches, fv.fused_mlp_bwd_rays.launches)
    got = grads(lambda wl, bl: fv.fused_mlp_train_rays(wl, bl, od, z))
    assert (fm.fused_mlp_eval_rays.launches,
            fv.fused_mlp_bwd_rays.launches) == (before[0] + 1, before[1] + 1)
    assert got[0].dtype == got[1].dtype == torch.float32
    _grads_close(got, grads(plain), grads(plain, torch.device("cpu")))


def test_full_width_training_step(dev):
    """One per-image step of the lego configuration (8x256, 4096 rays,
    64+128 samples) on the card: finite loss, both passes through K1 and
    K2, every parameter moved."""
    from nerf_pytorch_paeng_tpu_torch.train import create_train_state
    from nerf_pytorch_paeng_tpu_torch.train.schedule import schedule_from_cfg
    from nerf_pytorch_paeng_tpu_torch.train.step import make_image_train_step

    cfg = NerfConfig(N_rays=4096, N_samples_c=64, N_samples_f=128,
                     iter_warmup=0, iter_N=10)
    images, K, poses = make_synth_scene(n_views=1, H=64, W=64)
    state = create_train_state(cfg, dev)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    step = make_image_train_step(cfg, schedule_from_cfg(cfg), 64, 64, K)
    launches = (fm.fused_mlp_eval_rays.launches, fv.fused_mlp_bwd_rays.launches)
    m = step(state, torch.from_numpy(images[0]).to(dev),
             torch.from_numpy(poses[0][:3, :4]).to(dev))
    torch.cuda.synchronize()
    assert np.isfinite(float(m["loss"])) and state.step == 1
    assert (fm.fused_mlp_eval_rays.launches - launches[0],
            fv.fused_mlp_bwd_rays.launches - launches[1]) == (2, 2)
    for k, v in state.model.state_dict().items():     # Adam's first step
        assert float((v != before[k]).float().mean()) > 0.5, k


@pytest.mark.parametrize("what", ["train_step", "eval_frame"])
def test_float32_compute_dtype_equals_bf16_on_the_card(dev, what):
    """``--compute_dtype float32`` on the card: the kernels get bf16 packed
    weights at either compute dtype (``fm.kernel_weight_dtype``), so a
    lego-config training step (8x256, 4096 rays, 64+128 samples) and a
    64x64 ``--eval_only`` frame (the dense renderer) run and equal the
    bfloat16 runs bit for bit."""
    from nerf_pytorch_paeng_tpu_torch.train import create_train_state
    from nerf_pytorch_paeng_tpu_torch.train.schedule import schedule_from_cfg
    from nerf_pytorch_paeng_tpu_torch.train.step import make_image_train_step

    H = W = 64
    images, K, poses = make_synth_scene(n_views=1, H=H, W=W)
    out = {}
    for dtype in ("bfloat16", "float32"):
        if what == "train_step":
            cfg = NerfConfig(N_rays=4096, N_samples_c=64, N_samples_f=128,
                             iter_warmup=0, iter_N=10, compute_dtype=dtype)
            state = create_train_state(cfg, dev)
            step = make_image_train_step(cfg, schedule_from_cfg(cfg), H, W, K)
            m = step(state, torch.from_numpy(images[0]).to(dev),
                     torch.from_numpy(poses[0][:3, :4]).to(dev))
            out[dtype] = [m["loss"]] + [v.detach().clone() for v in
                                        state.model.state_dict().values()]
        else:
            cfg = NerfConfig(render_cull="none", compute_dtype=dtype)
            packed = fm.pack_nerf(init_nerf(cfg, seed=0, device=dev), cfg)
            assert packed["fine"]["w"].dtype == torch.bfloat16
            render = make_frame_renderer(cfg, H, W, K, dev, block_rays=1500)
            out[dtype] = list(render(packed, torch.from_numpy(poses[0]),
                                     torch.Generator(dev).manual_seed(0)))
    torch.cuda.synchronize()
    assert np.isfinite(float(out["float32"][0].float().mean()))
    assert all(torch.equal(a, b) for a, b in zip(out["bfloat16"],
                                                 out["float32"]))


def _gate(kind, n, s, dev, seed=22):
    """A tile-major (128-ray tile, 8-sample row) gate: all off, all on, one
    entry on (the last tile's last row), or about half on (seeded)."""
    size = -(-n // 128) * (s // 8)
    if kind == "off":
        g = np.zeros(size)
    elif kind == "on":
        g = np.ones(size)
    elif kind == "one":
        g = np.zeros(size)
        g[-1] = 1
    else:
        g = np.random.default_rng(seed).random(size) < 0.5
    return torch.as_tensor(g, dtype=torch.int32, device=dev)


@pytest.mark.parametrize("kind,n,s", [("off", 512, 16), ("on", 512, 16),
                                      ("mixed", 4096, 64),
                                      ("mixed", 1000, 24),
                                      ("mixed", 300, 192),
                                      ("off", 4096, 192), ("on", 4096, 192),
                                      ("one", 129, 64), ("one", 4096, 192),
                                      ("mixed", 1, 8), ("mixed", 4096, 192)])
def test_gated_kernels_match_plain(dev, kind, n, s):
    """K4 and K5: gated blocks exactly 0, active blocks bit-equal to the
    ungated kernel (an all-on gate gives K3's and K1's bits) and within the
    kernel tolerance of the gated plain version; ragged ray counts (a
    partial last tile) included, and a gate with one entry on, whose
    8 units go to 8 of the walk's blocks."""
    p = _packed(23, dev)
    od, z = _inputs(24, n, s, dev)
    gate = _gate(kind, n, s, dev)
    on = fm.gate_mask(gate, s, n)
    k4 = fm.fused_mlp_sigma_rays(od, z, p, out_dtype=torch.bfloat16,
                                 gate=gate)
    k3 = fm.fused_mlp_sigma_rays(od, z, p, out_dtype=torch.bfloat16)
    k5 = fm.fused_mlp_eval_rays(od, z, p, out_dtype=torch.bfloat16, gate=gate)
    k1 = fm.fused_mlp_eval_rays(od, z, p, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    plain4 = fm.fused_mlp_sigma_rays_plain(od, z, p, out_dtype=torch.bfloat16,
                                           gate=gate)
    plain5 = fm.fused_mlp_eval_rays_plain(od, z, p, out_dtype=torch.bfloat16,
                                          gate=gate)
    for got, ungated, plain in ((k4, k3, plain4),
                                *zip(k5, k1, plain5)):
        assert not got[~on].any()
        assert torch.equal(got[on], ungated[on])
        if kind != "off":
            _close(got, plain)


def test_gated_launch_counts_once(dev):
    p = _packed(25, dev)
    od, z = _inputs(26, 256, 16, dev)
    gate = _gate("mixed", 256, 16, dev)
    counters = [getattr(fn, name)
                for fn in (fm.fused_mlp_sigma_rays, fm.fused_mlp_eval_rays)
                for name in ("launches", "gated_launches")]
    fm.fused_mlp_sigma_rays(od, z, p, gate=gate)
    fm.fused_mlp_eval_rays(od, z, p, gate=gate)
    fm.fused_mlp_eval_rays_plain(od, z, p, gate=gate)
    assert [getattr(fn, name)
            for fn in (fm.fused_mlp_sigma_rays, fm.fused_mlp_eval_rays)
            for name in ("launches", "gated_launches")] == [
        counters[0], counters[1] + 1, counters[2], counters[3] + 1]


def test_gated_wrapper_rejects_bad_gates(dev):
    p = _packed(25, dev)
    od, z = _inputs(26, 256, 16, dev)
    for bad in (_gate("on", 256, 16, dev)[:-1],
                _gate("on", 256, 16, dev).long(),
                _gate("on", 256, 16, dev).cpu()):
        with pytest.raises(ValueError):
            fm.fused_mlp_sigma_rays(od, z, p, gate=bad)
        with pytest.raises(ValueError):
            fm.fused_mlp_eval_rays(od, z, p, gate=bad)
    od, z = _inputs(26, 256, 12, dev)           # S not a multiple of 8
    with pytest.raises(ValueError):
        fm.fused_mlp_sigma_rays(od, z, p, gate=_gate("on", 256, 8, dev))


@pytest.mark.parametrize("n_pts", [128, 100_003, 2 ** 18])
def test_points_kernel_matches_plain(dev, n_pts):
    """K7 on a plane of points (ragged counts included) against its plain
    version, and the points kernel's sigma against K3's at depth 0: bit for
    bit, since both run the one walk (rays_walk) and x = o + d 0 = o."""
    p = _packed(27, dev)
    g = torch.Generator(dev).manual_seed(28)
    x = (torch.rand(3, n_pts, generator=g, device=dev) * 4 - 2).contiguous()
    before = fm.fused_mlp_sigma.launches
    got = fm.fused_mlp_sigma(x, p)
    torch.cuda.synchronize()
    assert fm.fused_mlp_sigma.launches == before + 1
    assert got.shape == (n_pts,) and got.dtype == torch.float32
    _close(got, fm.fused_mlp_sigma_plain(x, p))
    od = torch.cat([x, torch.zeros(5, n_pts, device=dev)]).contiguous()
    od[3] = 1.0
    k3 = fm.fused_mlp_sigma_rays(od, torch.zeros(1, n_pts, device=dev), p)
    assert torch.equal(got, k3[0])


def test_culled_frame_gates_change_nothing(dev):
    """The culled frame on the compact field at 96x96 (64+128 samples):
    with the pre-cull and gate-fine on it equals the frame with both off
    (gated samples carry zero weight), the gates engaged, and the frame is
    close to the dense exact one."""
    import dataclasses
    H = W = 96
    K = np.array([[1.39 * W, 0, W / 2], [0, 1.39 * W, H / 2], [0, 0, 1]],
                 np.float32)
    from nerf_pytorch_paeng_tpu_torch.data.render_pose import get_render_pose
    model = NeRF()
    model.load_state_dict(compact_field_state_dict(r=1.5, k=20.0))
    cfg = NerfConfig(perturb=0.0)
    packed = fm.pack_nerf(model.to(dev), cfg)
    pose = torch.from_numpy(get_render_pose(12)[5])
    frames = {}
    for name, kw in (("gated", {}),
                     ("ungated", dict(render_precull="off",
                                      render_gate_fine="off")),
                     ("dense", dict(render_cull="none"))):
        render = make_frame_renderer(dataclasses.replace(cfg, **kw), H, W, K,
                                     dev, stratified=False)
        frames[name] = render(packed, pose)
        if name == "gated":
            st = render.stats[-1]
            assert 0 < st["n_act"] < H * W
            assert float(st["gate_frac_coarse"]) > 0
            assert float(st["gate_frac_fine"]) > 0
    for a, b in zip(frames["gated"], frames["ungated"]):
        assert float((a - b).abs().max()) <= 1e-5
    mse = float(torch.mean((frames["gated"][0] - frames["dense"][0]) ** 2))
    assert -10 * np.log10(max(mse, 1e-20)) >= 40.0


def _planes(seed, n_pts, dev):
    """Seeded position and unit direction planes [3, P] of blender-like
    samples (rays through the scene centre at depths in [2, 6])."""
    od, z = _inputs(seed, n_pts, 1, dev)
    d = od[3:6] / od[3:6].norm(dim=0, keepdim=True)
    return (od[0:3] + od[3:6] * z).contiguous(), d.contiguous()


@pytest.mark.parametrize("n_pts", [128, 1000, 100_003])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_plane_kernel_matches_plain(dev, n_pts, out_dtype):
    """K8 against its plain version, ragged point counts included; its
    sigma row is K7's sigma on the same positions (the trunk is the same
    code, so the rows cannot be out of order)."""
    p = _packed(40, dev)
    x, d = _planes(41, n_pts, dev)
    before = fm.fused_mlp_eval.launches
    got = fm.fused_mlp_eval(x, d, p, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert fm.fused_mlp_eval.launches == before + 1
    assert got.shape == (4, n_pts) and got.dtype == out_dtype
    _close(got, fm.fused_mlp_eval_plain(x, d, p, out_dtype=out_dtype))
    assert torch.equal(got[3], fm.fused_mlp_sigma(x, p, out_dtype=out_dtype))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_plane_kernel_sigma_equals_ray_kernel_at_depth_0(dev, out_dtype):
    """K8's sigma row against K1's sigma with the same positions as
    origins, unit directions and depth 0: bit for bit (one trunk and
    density head code; x = o + d 0 = o)."""
    p = _packed(50, dev)
    n_pts = 4096 * 3 + 5
    x, d = _planes(51, n_pts, dev)
    od = torch.cat([x, d, torch.zeros(2, n_pts, device=dev)]).contiguous()
    k1 = fm.fused_mlp_eval_rays(od, torch.zeros(1, n_pts, device=dev), p,
                                out_dtype=out_dtype)
    got = fm.fused_mlp_eval(x, d, p, out_dtype=out_dtype)
    assert torch.equal(got[3], k1[3][0])


@pytest.mark.parametrize("n_pts", [1, 127, 132 * 128 + 1, 132 * 128 * 5 + 3])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_points_kernels_walk_edges(dev, n_pts, out_dtype):
    """K8 and K7 on the persistent walk at its edges: a lone point, one
    ragged unit, one unit more than the card has SMs, several units a
    block: finite, within the kernel tolerance of their plain versions,
    two launches bit-equal."""
    p = _packed(52, dev)
    x, d = _planes(53, n_pts, dev)
    k8 = fm.fused_mlp_eval(x, d, p, out_dtype=out_dtype)
    k7 = fm.fused_mlp_sigma(x, p, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert k8.shape == (4, n_pts) and k7.shape == (n_pts,)
    assert bool(torch.isfinite(k8.float()).all())
    assert bool(torch.isfinite(k7.float()).all())
    _close(k8, fm.fused_mlp_eval_plain(x, d, p, out_dtype=out_dtype))
    _close(k7, fm.fused_mlp_sigma_plain(x, p, out_dtype=out_dtype))
    assert torch.equal(k8, fm.fused_mlp_eval(x, d, p, out_dtype=out_dtype))
    assert torch.equal(k7, fm.fused_mlp_sigma(x, p, out_dtype=out_dtype))
    assert torch.equal(k8[3], k7)


def test_plane_kernel_takes_directions_as_given(dev):
    """K8 embeds d as given: scaling d changes the colour rows, as in its
    plain version (a kernel that normalised d would not move)."""
    p = _packed(42, dev)
    x, d = _planes(43, 512, dev)
    a = fm.fused_mlp_eval(x, d, p)
    b = fm.fused_mlp_eval(x, (2 * d).contiguous(), p)
    _close(b, fm.fused_mlp_eval_plain(x, (2 * d).contiguous(), p))
    assert torch.equal(a[3], b[3]) and not torch.equal(a[:3], b[:3])


@pytest.mark.parametrize("n_pts", [128, 300, 4096 * 8 + 77])
def test_plane_bwd_kernel_matches_plain(dev, n_pts):
    """K9 against its plain version (``_grads_close``), ragged point counts
    included: points past P contribute nothing."""
    p = _packed(44, dev)
    x, d = _planes(45, n_pts, dev)
    g4 = torch.cat(_cotangents(46, 1, n_pts, dev)).contiguous()
    before = fv.fused_mlp_bwd.launches
    got = fv.fused_mlp_bwd(x, d, g4, p)
    torch.cuda.synchronize()
    assert fv.fused_mlp_bwd.launches == before + 1
    want = fv.fused_mlp_bwd_plain(x, d, g4, p)
    other = fv.fused_mlp_bwd_plain(x.cpu(), d.cpu(), g4.cpu(), _on_cpu(p))
    _grads_close(got, want, other)


def test_plane_bwd_kernel_is_deterministic_and_empty(dev):
    """Two launches over more than one chunk of points give the same bits;
    no points give zero gradients."""
    p = _packed(47, dev)
    x, d = _planes(48, 4096 * 40, dev)
    g4 = torch.cat(_cotangents(49, 1, 4096 * 40, dev)).contiguous()
    a = fv.fused_mlp_bwd(x, d, g4, p)
    b = fv.fused_mlp_bwd(x, d, g4, p)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    e = torch.empty(3, 0, device=dev)
    dw, db = fv.fused_mlp_bwd(e, e, torch.empty(4, 0, device=dev), p)
    assert not dw.any() and not db.any()


def test_plane_train_pair_matches_autograd_of_plain(dev):
    """The K8+K9 pair's gradients against autograd through K8's plain
    version with the same bf16 weights (floor: the same on the CPU).  The
    cotangents are bf16 values: K9 rounds them to bf16, as the TPU kernel
    does, and autograd does not (at 3000 points of zero-mean cotangents
    that rounding alone moves bdens, a plain sum of them, by 2%)."""
    model = NeRF()
    model.load_state_dict(state_dict_from_jax_params(np_nerf_params(50)))
    w, b = fm.pack_flat(model.model_fine.to(dev))
    w, b = w.detach(), b.detach()
    x, d = _planes(51, 3000, dev)
    g4 = torch.cat(_cotangents(52, 1, 3000, dev)).bfloat16().float()

    def grads(fn, device=dev):
        wl = w.to(device).clone().requires_grad_()
        bl = b.to(device).clone().requires_grad_()
        fn(wl, bl).backward(g4.to(device))
        return wl.grad, bl.grad

    def plain(wl, bl):
        return fm.fused_mlp_eval_plain(x.to(wl.device), d.to(wl.device),
                                       fm._with_views(wl.to(torch.bfloat16),
                                                      bl))

    before = (fm.fused_mlp_eval.launches, fv.fused_mlp_bwd.launches)
    got = grads(lambda wl, bl: fv.fused_mlp_train(wl, bl, x, d))
    assert (fm.fused_mlp_eval.launches,
            fv.fused_mlp_bwd.launches) == (before[0] + 1, before[1] + 1)
    _grads_close(got, grads(plain), grads(plain, torch.device("cpu")))


@pytest.mark.parametrize("kw", [dict(use_rays_train=False),
                                dict(N_rays=4000)])
def test_plane_full_width_training_step(dev, kw):
    """One per-image lego step on the plane route (``use_rays_train`` off,
    or a ray count the ray pair does not take): finite loss, both passes
    through K8 and K9, none through K1 and K2."""
    from nerf_pytorch_paeng_tpu_torch.train import create_train_state
    from nerf_pytorch_paeng_tpu_torch.train.schedule import schedule_from_cfg
    from nerf_pytorch_paeng_tpu_torch.train.step import make_image_train_step

    cfg = NerfConfig(**{**dict(N_rays=4096, N_samples_c=64, N_samples_f=128,
                               iter_warmup=0, iter_N=10), **kw})
    images, K, poses = make_synth_scene(n_views=1, H=64, W=64)
    state = create_train_state(cfg, dev)
    step = make_image_train_step(cfg, schedule_from_cfg(cfg), 64, 64, K)
    counters = (fm.fused_mlp_eval, fv.fused_mlp_bwd, fm.fused_mlp_eval_rays,
                fv.fused_mlp_bwd_rays)
    before = [c.launches for c in counters]
    m = step(state, torch.from_numpy(images[0]).to(dev),
             torch.from_numpy(poses[0][:3, :4]).to(dev))
    torch.cuda.synchronize()
    assert np.isfinite(float(m["loss"])) and state.step == 1
    assert [c.launches - n for c, n in zip(counters, before)] == [2, 2, 0, 0]


@pytest.mark.parametrize("n,s", [(4096, 64), (300, 16)])
def test_gated_bwd_kernel_matches_plain(dev, n, s):
    """K6: an all-on gate gives K2's bits, an all-off gate zero gradients,
    a half-on gate its gated plain version's gradients (``_grads_close``),
    a ragged last tile included."""
    p = _packed(30, dev)
    od, z = _inputs(31, n, s, dev)
    gout = _cotangents(32, s, n, dev)
    k2 = fv.fused_mlp_bwd_rays(od, z, *gout, p)
    on = fv.fused_mlp_bwd_rays(od, z, *gout, p, gate=_gate("on", n, s, dev))
    off = fv.fused_mlp_bwd_rays(od, z, *gout, p, gate=_gate("off", n, s, dev))
    gate = _gate("mixed", n, s, dev, seed=33)
    got = fv.fused_mlp_bwd_rays(od, z, *gout, p, gate=gate)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(on, k2))
    assert not any(bool(t.any()) for t in off)
    want = fv.fused_mlp_bwd_rays_plain(od, z, *gout, p, gate=gate)
    other = fv.fused_mlp_bwd_rays_plain(od.cpu(), z.cpu(),
                                        *(g.cpu() for g in gout), _on_cpu(p),
                                        gate=gate.cpu())
    _grads_close(got, want, other)


def test_gated_bwd_kernel_is_deterministic_and_counted(dev):
    """Two launches at a half-on gate give the same bits (more than one
    chunk of points); each counts one gated launch and no K2 launch."""
    p = _packed(34, dev)
    od, z = _inputs(35, 4096, 40, dev)
    gout = _cotangents(36, 40, 4096, dev)
    gate = _gate("mixed", 4096, 40, dev, seed=37)
    before = (fv.fused_mlp_bwd_rays.launches,
              fv.fused_mlp_bwd_rays.gated_launches)
    a = fv.fused_mlp_bwd_rays(od, z, *gout, p, gate=gate)
    b = fv.fused_mlp_bwd_rays(od, z, *gout, p, gate=gate)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert (fv.fused_mlp_bwd_rays.launches,
            fv.fused_mlp_bwd_rays.gated_launches) == (before[0],
                                                      before[1] + 2)


def test_gated_bwd_kernel_over_chunks(dev):
    """K6 at a half-on gate over more than one chunk of active points
    (4096 rays x 96 samples: 3072 chain tiles, about half on, against
    1024 tiles (131,072 points) a chunk): two launches bit-equal, and
    within ``_grads_close`` of the gated plain version."""
    p = _packed(43, dev)
    n, s = 4096, 96
    od, z = _inputs(44, n, s, dev)
    gout = _cotangents(45, s, n, dev)
    gate = _gate("mixed", n, s, dev, seed=46)
    assert int(gate.sum()) * 8 > 1024      # a gate entry is 8 chain tiles
    a = fv.fused_mlp_bwd_rays(od, z, *gout, p, gate=gate)
    b = fv.fused_mlp_bwd_rays(od, z, *gout, p, gate=gate)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    want = fv.fused_mlp_bwd_rays_plain(od, z, *gout, p, gate=gate)
    other = fv.fused_mlp_bwd_rays_plain(od.cpu(), z.cpu(),
                                        *(g.cpu() for g in gout), _on_cpu(p),
                                        gate=gate.cpu())
    _grads_close(a, want, other)


def test_gated_full_width_training_step(dev):
    """One per-image step of the lego configuration on the compact field,
    gated by its support bounds (the 128^3 grid over the training camera's
    frustum), against the same step ungated from the same state: the loss
    bit-equal, both passes through K5 and K6, every update within two
    learning rates of the ungated one (Adam's first step moves a weight by
    about lr times its gradient's sign; the sum order differs)."""
    from nerf_pytorch_paeng_tpu_torch.train import TrainState, make_optimizer
    from nerf_pytorch_paeng_tpu_torch.train.precull import \
        make_train_support_program
    from nerf_pytorch_paeng_tpu_torch.train.schedule import schedule_from_cfg
    from nerf_pytorch_paeng_tpu_torch.train.step import make_image_train_step

    cfg = NerfConfig(N_rays=4096, N_samples_c=64, N_samples_f=128,
                     iter_warmup=0, iter_N=10)
    images, K, poses = make_synth_scene(n_views=1, H=64, W=64)
    img = torch.from_numpy(images[0]).to(dev)
    pose = torch.from_numpy(poses[0][:3, :4]).to(dev)

    def state():
        model = NeRF()
        model.load_state_dict(compact_field_state_dict(r=1.5, k=20.0))
        model.to(dev)
        return TrainState(model, make_optimizer(model, cfg), 0)

    st_u, st_g = state(), state()
    w0 = torch.cat([p.detach().flatten().clone()
                    for p in st_g.model.parameters()])
    prog, _ = make_train_support_program(cfg, poses=poses[:1], K=K,
                                         hw=(64, 64), device=dev)
    support = prog(st_g.model)
    assert bool(support[0][3][0]) and bool(support[1][3][0])
    step = make_image_train_step(cfg, schedule_from_cfg(cfg), 64, 64, K)
    m_u = step(st_u, img, pose)
    counts = (fm.fused_mlp_eval_rays.gated_launches,
              fv.fused_mlp_bwd_rays.gated_launches)
    m_g = step(st_g, img, pose, support=support)
    torch.cuda.synchronize()
    assert (fm.fused_mlp_eval_rays.gated_launches - counts[0],
            fv.fused_mlp_bwd_rays.gated_launches - counts[1]) == (2, 2)
    assert torch.equal(m_u["loss"], m_g["loss"])
    assert 0.0 < float(m_g["gate_frac"]) < 1.0
    du, dg = (torch.cat([p.detach().flatten() for p in st.model.parameters()])
              - w0 for st in (st_u, st_g))
    assert float((du - dg).abs().max()) <= 2 * cfg.lr * (1 + 1e-3)


# ------------------------------------------------------ the LLFF (NDC) path


def _llff_capture(tmp_path, H, W):
    """A 2-view synthetic forward-facing capture through the LLFF loader:
    (images, K, extrinsics)."""
    from nerf_pytorch_paeng_tpu_torch.data import load_llff
    from nerf_pytorch_paeng_tpu_torch.utils.synth import save_as_llff_dataset
    save_as_llff_dataset(str(tmp_path), n_views=2, H=H, W=W, n_samples=16)
    images, (K, ext), _, _, _ = load_llff(str(tmp_path), testskip=2)
    return images, K, ext


def test_llff_training_step_on_ndc_rays(dev, tmp_path):
    """One global-pool step of fern's configuration (8x256, 4096 rays,
    64+128 samples, NDC with near 0 and far 1) on the card: K1 and K2
    twice, finite loss; then K1 (float32) and K2 on that batch's NDC rays
    against their plain versions."""
    from nerf_pytorch_paeng_tpu_torch.ops.render import maybe_ndc, pack_od
    from nerf_pytorch_paeng_tpu_torch.ops.sampling import stratified_z_vals
    from nerf_pytorch_paeng_tpu_torch.train import (build_ray_pool,
                                                    create_train_state)
    from nerf_pytorch_paeng_tpu_torch.train.schedule import schedule_from_cfg
    from nerf_pytorch_paeng_tpu_torch.train.step import make_train_step

    H, W = 64, 96
    images, K, ext = _llff_capture(tmp_path, H, W)
    cfg = NerfConfig(data_type="llff", near=0.0, far=1.0, N_rays=4096,
                     N_samples_c=64, N_samples_f=128, iter_warmup=0,
                     iter_N=10)
    g = torch.Generator(dev).manual_seed(0)
    pool = build_ray_pool(images, K, ext, np.arange(2), g, dev)[:4096]
    o, d, rgb = (pool[:, k].contiguous() for k in range(3))
    state = create_train_state(cfg, dev)
    step = make_train_step(cfg, schedule_from_cfg(cfg), H, W, float(K[0, 0]))
    launches = (fm.fused_mlp_eval_rays.launches, fv.fused_mlp_bwd_rays.launches)
    m = step(state, o, d, rgb)
    torch.cuda.synchronize()
    assert np.isfinite(float(m["loss"])) and state.step == 1
    assert (fm.fused_mlp_eval_rays.launches - launches[0],
            fv.fused_mlp_bwd_rays.launches - launches[1]) == (2, 2)

    no, nd = maybe_ndc(o, d, H, W, float(K[0, 0]), "llff")
    z = stratified_z_vals(4096, 0.0, 1.0, 192, perturb=True, generator=g,
                          device=dev).T.contiguous()
    od = pack_od(no, nd)
    p = _packed(50, dev)
    outs = fm.fused_mlp_eval_rays(od, z, p)
    for a, b in zip(outs, fm.fused_mlp_eval_rays_plain(od, z, p)):
        _close(a, b)
    gout = _loss_cotangents(outs, 51, dev)
    got = fv.fused_mlp_bwd_rays(od, z, *gout, p)
    again = fv.fused_mlp_bwd_rays(od, z, *gout, p)
    torch.cuda.synchronize()
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    _grads_close(got, *_plain_both(od, z, gout, p))


def test_llff_frame_ragged_tail_kernels_vs_plain(dev, tmp_path):
    """A 378x504 LLFF frame (fern's downsample-8 size) through the dense
    renderer: two blocks, 131072 rays and a ragged 59440 (not a multiple
    of 128).  The frame through the kernels and through the plain versions
    (same draws) >= 35 dB apart at most, and K3 and K1 on the ragged
    block's own NDC inputs against their plain versions."""
    H, W = 378, 504
    _, K, ext = _llff_capture(tmp_path, H, W)
    cfg = NerfConfig(data_type="llff", near=0.0, far=1.0, render_cull="none")
    packed = fm.pack_nerf(init_nerf(cfg, seed=0, device=dev), cfg)
    calls = []

    def keep(fn):
        def call(od, z, p, **kw):
            calls.append((od, z))
            return fn(od, z, p, **kw)
        return call

    out = {}
    for name, kw in (("k", dict(sigma_fn=keep(fm.fused_mlp_sigma_rays),
                                field_fn=keep(fm.fused_mlp_eval_rays))),
                     ("p", dict(sigma_fn=fm.fused_mlp_sigma_rays_plain,
                                field_fn=fm.fused_mlp_eval_rays_plain))):
        render = make_frame_renderer(cfg, H, W, K, dev, **kw)
        out[name] = render(packed, torch.from_numpy(ext[0]),
                           torch.Generator(dev).manual_seed(0))
    assert render.launches_per_frame == 2
    mse = float(torch.mean((out["k"][0] - out["p"][0]) ** 2))
    assert -10 * np.log10(max(mse, 1e-20)) >= 35.0
    assert bool(torch.isfinite(out["k"][1]).all())
    assert sorted(z.shape[1] for _, z in calls) == [59440, 59440, 131072,
                                                    131072]
    for od, z in calls:
        if z.shape[1] != 59440:
            continue
        if z.shape[0] == cfg.N_samples_c:
            _close(fm.fused_mlp_sigma_rays(od, z, packed["coarse"],
                                           out_dtype=torch.bfloat16),
                   fm.fused_mlp_sigma_rays_plain(od, z, packed["coarse"],
                                                 out_dtype=torch.bfloat16))
        else:
            for a, b in zip(
                    fm.fused_mlp_eval_rays(od, z, packed["fine"],
                                           out_dtype=torch.bfloat16),
                    fm.fused_mlp_eval_rays_plain(od, z, packed["fine"],
                                                 out_dtype=torch.bfloat16)):
                _close(a, b)


# ---------------------------------------------------- the plain-MLP route

PLAIN_SHAPES = {"a": dict(netDepth=4, netWidth=64, L_x=0, L_d=0),
                "c": dict(netDepth=8, netWidth=256, L_x=10, L_d=4)}


def _all_launches():
    """Every kernel wrapper's launch counters, in one tuple."""
    from nerf_pytorch_paeng_tpu_torch.kernels import launch_counts
    return launch_counts()


def _plain_cfg(shape, **kw):
    return NerfConfig(**{**dict(use_pallas=False, N_rays=1024,
                                N_samples_c=16, N_samples_f=16,
                                iter_warmup=0, iter_N=10, perturb=0.0),
                         **PLAIN_SHAPES[shape], **kw})


@pytest.mark.parametrize("shape", sorted(PLAIN_SHAPES))
def test_plain_route_step_on_the_card_matches_the_cpu(dev, shape):
    """One per-image step on the plain route (bf16 compute, TF32 forward
    products) from the same weights with the same pixels and draws on the
    card and on the CPU: the losses within 1e-3 relative, every update
    within two learning rates (Adam's first step moves a weight by about
    lr times its gradient's sign, and a bf16 rounding can flip a tiny
    gradient's sign); no kernel launched."""
    from nerf_pytorch_paeng_tpu_torch.train import TrainState, make_optimizer
    from nerf_pytorch_paeng_tpu_torch.train.schedule import schedule_from_cfg
    from nerf_pytorch_paeng_tpu_torch.train.step import make_image_train_step

    cfg = _plain_cfg(shape)
    images, K, poses = make_synth_scene(n_views=1, H=64, W=64)
    g = torch.Generator().manual_seed(60)
    coords = torch.randint(0, 64, (cfg.N_rays, 2), generator=g)
    u_c = torch.rand(cfg.N_rays, cfg.N_samples_c, generator=g)
    u_f = torch.rand(cfg.N_rays, cfg.N_samples_f, generator=g)
    out = []
    before = _all_launches()
    for where in (dev, torch.device("cpu")):
        model = init_nerf(cfg, seed=61, device=where)
        state = TrainState(model, make_optimizer(model, cfg), 0)
        w0 = torch.cat([p.detach().flatten().cpu().clone()
                        for p in model.parameters()])
        step = make_image_train_step(cfg, schedule_from_cfg(cfg), 64, 64, K)
        m = step(state, torch.from_numpy(images[0]).to(where),
                 torch.from_numpy(poses[0][:3, :4]).to(where),
                 coords=coords.to(where), u_c=u_c.to(where),
                 u_f=u_f.to(where))
        out.append((float(m["loss"]), torch.cat(
            [p.detach().flatten().cpu() for p in model.parameters()]) - w0))
    assert _all_launches() == before
    (loss_d, du_d), (loss_c, du_c) = out
    assert np.isfinite(loss_d) and loss_d == pytest.approx(loss_c, rel=1e-3)
    assert float((du_d - du_c).abs().max()) <= 2 * cfg.lr * (1 + 1e-3)


@pytest.mark.parametrize("shape", sorted(PLAIN_SHAPES))
@pytest.mark.parametrize("cull", ["none", "auto"])
def test_plain_route_frame_on_the_card_matches_the_cpu(dev, shape, cull):
    """A 32x32 frame of random weights through both renderers' plain
    branches on the card and on the CPU, deterministic sampling: at least
    35 dB apart (the kernels-vs-plain limit: bf16 activations rounded
    after sums in another order); no kernel launched."""
    from nerf_pytorch_paeng_tpu_torch.eval.frame import make_frame_renderer

    cfg = _plain_cfg(shape, render_cull=cull)
    _, K, poses = make_synth_scene(n_views=1, H=32, W=32)
    model = init_nerf(cfg, seed=62, device="cpu")
    before = _all_launches()
    frames = []
    for where in (dev, torch.device("cpu")):
        r = make_frame_renderer(cfg, 32, 32, K, where, stratified=False)
        assert r.route == "plain"
        rgb, disp = r(fm.pack_nerf(model, cfg, device=where),
                      torch.from_numpy(poses[0]))
        frames.append(rgb.float().cpu())
        assert bool(torch.isfinite(rgb).all() and torch.isfinite(disp).all())
    torch.cuda.synchronize()
    assert _all_launches() == before
    mse = float(torch.mean((frames[0] - frames[1]) ** 2))
    assert mse == 0.0 or -10 * np.log10(mse) >= 35.0


def test_reference_shape_with_use_pallas_still_launches_kernels(dev):
    """The same reference-shape step and dense frame with ``use_pallas``
    on: K1/K2 twice a step, K3/K1 once a frame block."""
    from nerf_pytorch_paeng_tpu_torch.train import create_train_state
    from nerf_pytorch_paeng_tpu_torch.train.schedule import schedule_from_cfg
    from nerf_pytorch_paeng_tpu_torch.train.step import make_image_train_step

    cfg = _plain_cfg("c", use_pallas=True, render_cull="none")
    images, K, poses = make_synth_scene(n_views=1, H=64, W=64)
    state = create_train_state(cfg, dev)
    step = make_image_train_step(cfg, schedule_from_cfg(cfg), 64, 64, K)
    before = (fm.fused_mlp_eval_rays.launches, fv.fused_mlp_bwd_rays.launches,
              fm.fused_mlp_sigma_rays.launches)
    step(state, torch.from_numpy(images[0]).to(dev),
         torch.from_numpy(poses[0][:3, :4]).to(dev))
    r = make_frame_renderer(cfg, 32, 32, K, dev, stratified=False)
    assert r.route == "rays"
    r(fm.pack_nerf(state.model, cfg), torch.from_numpy(poses[0]))
    torch.cuda.synchronize()
    assert (fm.fused_mlp_eval_rays.launches - before[0],
            fv.fused_mlp_bwd_rays.launches - before[1],
            fm.fused_mlp_sigma_rays.launches - before[2]) == (3, 2, 1)


def test_lpips_on_the_card_matches_the_cpu(dev):
    """The LPIPS graph on the card (float32, TF32 off) against the CPU on
    seeded random weights: 1e-4 relative."""
    from nerf_pytorch_paeng_tpu_torch.eval.metrics import (load_lpips_params,
                                                           lpips_tensor)
    from nerf_pytorch_paeng_tpu_torch.utils.synth import (
        random_lpips_params, save_lpips_params)

    import tempfile
    with tempfile.TemporaryDirectory() as d:
        path = save_lpips_params(f"{d}/vgg.npz", random_lpips_params(0))
        on_card, on_cpu = (load_lpips_params(path, x) for x in (dev, "cpu"))
    rng = np.random.default_rng(0)
    gt = rng.uniform(0, 1, (123, 157, 3)).astype(np.float32)
    pred = np.clip(gt + rng.normal(0, 0.1, gt.shape), 0, 1).astype(np.float32)
    flag = torch.backends.cudnn.allow_tf32
    got = lpips_tensor(torch.from_numpy(pred), torch.from_numpy(gt), on_card)
    want = lpips_tensor(torch.from_numpy(pred), torch.from_numpy(gt), on_cpu)
    assert got.device.type == "cuda"
    assert float(got) == pytest.approx(float(want), rel=1e-4)
    assert torch.backends.cudnn.allow_tf32 == flag    # given back


@pytest.mark.parametrize("mode", ["global", "image"])
def test_nccl_world_one_step_is_the_plain_step(dev, mode, monkeypatch):
    """A launch of one rank over NCCL runs every collective of the step:
    two full-width lego steps, their metrics and weights bit-equal to the
    same steps without a process group."""
    from nerf_pytorch_paeng_tpu_torch import parallel
    from nerf_pytorch_paeng_tpu_torch.train import create_train_state
    from nerf_pytorch_paeng_tpu_torch.train.schedule import schedule_from_cfg
    from nerf_pytorch_paeng_tpu_torch.train.step import (
        make_image_train_step, make_train_step)

    cfg = NerfConfig(N_rays=4096, N_samples_c=64, N_samples_f=128,
                     iter_warmup=0, iter_N=10)
    images, K, poses = make_synth_scene(n_views=1, H=64, W=64)
    img = torch.from_numpy(images[0]).to(dev)
    pose = torch.from_numpy(poses[0][:3, :4]).to(dev)
    rng = np.random.default_rng(0)
    batch = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
        np.array([0.0, 0.0, 4.0]) + rng.normal(0, 0.1, (4096, 3)),
        rng.normal(0, 0.3, (4096, 3)) - np.array([0.0, 0.0, 1.0]),
        rng.uniform(0, 1, (4096, 3)))]

    def run():
        state = create_train_state(cfg, dev)
        if mode == "global":
            step = make_train_step(cfg, schedule_from_cfg(cfg))
            ms = [step(state, *batch) for _ in range(2)]
        else:
            step = make_image_train_step(cfg, schedule_from_cfg(cfg), 64, 64,
                                         K)
            ms = [step(state, img, pose) for _ in range(2)]
        return ([{k: float(v) for k, v in m.items()} for m in ms],
                state.model.state_dict())

    plain = run()
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                     MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(parallel.free_port())).items():
        monkeypatch.setenv(k, v)
    _, made = parallel.maybe_initialize_distributed("cuda")
    try:
        assert made and torch.distributed.get_backend() == "nccl"
        launched = run()
    finally:
        parallel.destroy()
    assert launched[0] == plain[0]
    for k, v in plain[1].items():
        assert torch.equal(launched[1][k], v), k


# ------------------------------------------------ the sample-sharded path


@pytest.mark.parametrize("n_sh,idx,s", [(2, 0, 64), (2, 1, 192), (4, 3, 192)])
def test_plane_kernel_on_a_sample_sharded_slice(dev, n_sh, idx, s):
    """K8 on the planes one rank of the sample-sharded frame builds
    (``parallel/sp.py``: its contiguous ``s / n_sh`` columns of every
    ray's sorted depths, unit directions), bf16 logits as on that path,
    against its plain version."""
    from nerf_pytorch_paeng_tpu_torch.ops.render import (direction_plane,
                                                         position_plane)
    p = _packed(3, dev)
    od, z = _inputs(4, 1000, s, dev)
    k = s // n_sh
    z_local = z.T[:, idx * k:(idx + 1) * k].contiguous()
    o, d = od[0:3].T, od[3:6].T
    x = position_plane(o, d, z_local)
    dp = direction_plane(d / d.norm(dim=-1, keepdim=True), k)
    got = fm.fused_mlp_eval(x, dp, p, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert got.shape == (4, 1000 * k)
    _close(got, fm.fused_mlp_eval_plain(x, dp, p, out_dtype=torch.bfloat16))


def test_associative_scan_on_the_card(dev):
    """The log-space exclusive product on the card against the cumprod
    form there, one sample of one ray fully opaque (the clamp's case):
    1e-4 relative, 1e-7 absolute (float32 prefix sums of 64 logs)."""
    from nerf_pytorch_paeng_tpu_torch.ops import volume
    g = torch.Generator(dev).manual_seed(5)
    alpha = 1.0 - torch.exp(-torch.rand(4096, 64, generator=g, device=dev))
    alpha[7, 9] = 1.0
    x = 1.0 - alpha + 1e-10
    got = volume.exclusive_cumprod(x, -1, scan_impl="associative")
    want = volume.exclusive_cumprod(x, -1)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-7)


# ------------------------------------ scan_chunk: CUDA graphs of the step


def _staged_run(dev, kind, replay, steps=6, resume=None):
    """``steps`` lego-width per-image steps (64x64 views, 4096 rays,
    64+128 samples) through ``train/chunk.StagedSteps``, one chunk:
    replayed from a CUDA graph (after its warm-up steps) or eager.  kind:
    "rays" (K1/K2), "gated" (K5/K6 on the compact field's bounds),
    "planes" (K8/K9), "plain" (no kernel).  ``resume`` (logdir, exp,
    step): the state is restored from that checkpoint first, as the
    driver's ``iter_start`` does.  Returns (state, slab, staged, the
    launch counters' change)."""
    from nerf_pytorch_paeng_tpu_torch.kernels import launch_counts
    from nerf_pytorch_paeng_tpu_torch.train import TrainState, make_optimizer
    from nerf_pytorch_paeng_tpu_torch.train.chunk import StagedSteps
    from nerf_pytorch_paeng_tpu_torch.train.precull import \
        make_train_support_program
    from nerf_pytorch_paeng_tpu_torch.train.schedule import schedule_from_cfg

    over = {"planes": dict(use_rays_train=False),
            "plain": dict(use_pallas=False)}.get(kind, {})
    cfg = NerfConfig(N_rays=4096, N_samples_c=64, N_samples_f=128,
                     iter_warmup=0, iter_N=100, **over)
    images, K, poses = make_synth_scene(n_views=2, H=64, W=64)
    model = NeRF()
    if kind == "gated":
        model.load_state_dict(compact_field_state_dict(r=1.5, k=20.0))
    else:
        model.load_state_dict(init_nerf(cfg, seed=3, device=dev).state_dict())
    model.to(dev)
    state = TrainState(model, make_optimizer(model, cfg), 0)
    if resume is not None:
        from nerf_pytorch_paeng_tpu_torch.train import checkpoint as ckpt
        ckpt.restore_checkpoint(*resume, state)
    staged = StagedSteps(
        cfg, state, schedule_from_cfg(cfg), dev, 64, 64, K,
        images=torch.from_numpy(images).to(dev),
        poses=torch.from_numpy(poses[:, :3, :4]).to(dev), graphs=True)
    if kind == "gated":
        prog, _ = make_train_support_program(cfg, poses=poses[:, :3, :4],
                                             K=K, hw=(64, 64), device=dev)
        staged.set_support(prog(model))
    before = launch_counts()
    slab = staged.run([j % 2 for j in range(steps)], gated=kind == "gated",
                      replay=replay)
    torch.cuda.synchronize()
    launched = tuple(b - a for a, b in zip(before, launch_counts()))
    return state, slab, staged, launched


@pytest.mark.parametrize("kind", ["rays", "gated", "planes", "plain"])
def test_captured_steps_equal_eager_steps(dev, kind):
    """Six steps replayed from a CUDA graph (two eager warm-up steps of the
    trajectory, one capture, four replays) against the same six steps run
    eagerly: losses, weights and Adam's state bit-equal, and the launch
    counters moved alike (each replay adds the launches its capture
    recorded)."""
    eager, slab_e, st_e, launched_e = _staged_run(dev, kind, replay=False)
    graph, slab_g, st_g, launched_g = _staged_run(dev, kind, replay=True)
    assert (st_e.captures, st_e.replays) == (0, 0)
    assert (st_g.captures, st_g.replays) == (1, 4)
    # bit-equal metric rows (gate_frac is nan in both where ungated)
    torch.testing.assert_close(slab_g, slab_e, rtol=0, atol=0, equal_nan=True)
    assert bool(torch.isfinite(slab_g[:, st_g.keys.index("loss")]).all())
    if kind == "gated":
        assert bool((slab_g[:, st_g.keys.index("gate_frac")] > 0).all())
    for a, b in zip(eager.model.parameters(), graph.model.parameters()):
        assert torch.equal(a, b)
    sa, sb = (s.optimizer.state_dict()["state"] for s in (eager, graph))
    for i in sa:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)
    assert launched_e == launched_g
    assert (sum(launched_g) == 0) == (kind == "plain")


def _non_capturable_checkpoint(logdir, writer):
    """A lego-width checkpoint at update 2 whose Adam groups say
    ``capturable`` False: written by two port steps on the CPU
    ("port_cpu"), or those weights and moments in the layout of the JAX
    package's exporter ("jax_export": ``utils/interop.py``'s
    ``reference_checkpoint_from_train_state``, float64 step scalars and
    the reference's hyper-parameters, ``foreach`` None).  Returns the
    exp name."""
    from nerf_pytorch_paeng_tpu_torch.train import checkpoint as ckpt
    from nerf_pytorch_paeng_tpu_torch.train import create_train_state
    from nerf_pytorch_paeng_tpu_torch.train.schedule import schedule_from_cfg
    from nerf_pytorch_paeng_tpu_torch.train.step import make_train_step

    cfg = NerfConfig(device="cpu", N_rays=32, N_samples_c=8, N_samples_f=8,
                     iter_warmup=0, iter_N=100)
    state = create_train_state(cfg, "cpu")
    step = make_train_step(cfg, schedule_from_cfg(cfg))
    g = torch.Generator().manual_seed(13)
    for _ in range(2):
        o = torch.randn(32, 3, generator=g) * 0.1 + torch.tensor([0, 0, 4.0])
        d = -o / 4 + torch.randn(32, 3, generator=g) * 0.2
        step(state, o, d, torch.rand(32, 3, generator=g))
    path = ckpt.save_checkpoint(logdir, "port_cpu", state)
    if writer == "port_cpu":
        return "port_cpu"
    file = torch.load(path, weights_only=True)
    osd = file["optimizer_state_dict"]
    n = len(osd["state"])
    file["optimizer_state_dict"] = {
        "state": {i: {"step": torch.tensor(2.0, dtype=torch.float64),
                      "exp_avg": osd["state"][i]["exp_avg"],
                      "exp_avg_sq": osd["state"][i]["exp_avg_sq"]}
                  for i in range(n)},
        "param_groups": [{
            "params": list(range(n)), "lr": 5e-4, "betas": (0.9, 0.999),
            "eps": 1e-8, "weight_decay": 0, "amsgrad": False,
            "maximize": False, "foreach": None, "capturable": False,
            "differentiable": False, "fused": None}]}
    os.makedirs(os.path.join(logdir, "jax_export"))
    torch.save(file, ckpt.checkpoint_path(logdir, "jax_export", 2))
    return "jax_export"


@pytest.mark.parametrize("writer", ["port_cpu", "jax_export"])
def test_resume_on_the_card_from_a_non_capturable_checkpoint(dev, tmp_path,
                                                             writer):
    """A checkpoint whose optimizer is not capturable (``writer``: a port
    run on the CPU, or the JAX package's export layout) resumed into the
    card's capturable Adam (``train/checkpoint._load_optimizer``) and run
    six ray steps at ``--scan_chunk 1`` (eager) and from a CUDA graph (the
    default 16: two warm-up steps, a capture, four replays): both run,
    stay capturable, and agree bit for bit; finite losses."""
    exp = _non_capturable_checkpoint(str(tmp_path), writer)
    runs = [_staged_run(dev, "rays", replay, resume=(str(tmp_path), exp, 2))
            for replay in (False, True)]
    (eager, slab_e, _, _), (graph, slab_g, st_g, _) = runs
    assert st_g.replays == 4
    for st in (eager, graph):
        assert st.step == 8
        assert all(g["capturable"] for g in st.optimizer.param_groups)
    torch.testing.assert_close(slab_g, slab_e, rtol=0, atol=0, equal_nan=True)
    assert bool(torch.isfinite(slab_g[:, st_g.keys.index("loss")]).all())
    for a, b in zip(eager.model.parameters(), graph.model.parameters()):
        assert torch.equal(a, b)
    sa, sb = (s.optimizer.state_dict()["state"] for s in (eager, graph))
    for i in sa:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)


# ------------------------------------------------------------ Instant-NGP
#
# The hash encoding's backward adds each corner's contribution by float32
# atomics, in an order that changes from launch to launch: its gradients
# are held to 1e-5 relative L2 of the plain version's (the sums of a few
# hundred float32 terms in another order), not bit for bit.  The marcher
# rounds op by op as its plain version does: the same samples exactly.


def _ngp_cfg(**kw):
    return NerfConfig(**{**dict(arch="ngp", compute_dtype="bfloat16",
                                iter_warmup=0, iter_N=1000, lr=1e-2), **kw})


def _orbit_rays(n, seed, dev):
    """n world rays from cameras at radius 4 towards the blob."""
    g = torch.Generator().manual_seed(seed)
    c = torch.randn(n, 3, generator=g)
    c = 4.0 * c / c.norm(dim=1, keepdim=True)
    d = -c + 0.9 * torch.randn(n, 3, generator=g)
    return c.to(dev), d.to(dev)


def test_ngp_hash_kernels_match_plain(dev):
    from nerf_pytorch_paeng_tpu_torch.kernels import hash_grid as hg
    from nerf_pytorch_paeng_tpu_torch.models.ngp import NGP
    cfg = _ngp_cfg()
    model = NGP(cfg).to(dev).reset_parameters(
        torch.Generator(device=dev).manual_seed(3))
    with torch.no_grad():                    # features of order 1
        for t in model.tables:
            t.mul_(1e4)
    n = 1 << 18
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.rand((n, 3), generator=g, device=dev)
    x[:64] = torch.randint(0, 17, (64, 3), generator=g, device=dev) / 16.0
    x[64:128] = 1.0
    # samples along rays, in order: the coarse levels' runs of lanes that
    # share an entry (the backward adds each run once)
    o, d = _orbit_rays(64, 12, dev)
    t = torch.linspace(0.0, 3.0, 256, device=dev)
    along = (o[:, None, :] + t[None, :, None] * d[:, None, :]) * 0.33 + 0.5
    x[128:128 + 64 * 256] = along.reshape(-1, 3).clamp(0.0, 1.0)
    tables = list(model.tables)
    n_valid = torch.tensor([n - 1000], dtype=torch.int32, device=dev)
    got = hg.hash_encode(x, tables, model.levels, n_valid)
    want = hg.hash_encode_plain(x, tables, model.levels, n_valid)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert hg.hash_encode.launches >= 1
    dout = torch.randn(n, 32, generator=g, device=dev)
    gk = torch.autograd.grad(got, tables, dout)
    gp = torch.autograd.grad(want, tables, dout)
    for a, b in zip(gk, gp):
        err = float((a - b).norm() / b.norm().clamp(min=1e-30))
        assert err < 1e-5, err


def test_ngp_marcher_kernels_match_plain(dev):
    from nerf_pytorch_paeng_tpu_torch.kernels import ngp_march as nm
    cfg = _ngp_cfg()
    o, d = _orbit_rays(4096, 5, dev)
    g = torch.Generator(device=dev).manual_seed(6)
    u = torch.rand(4096, generator=g, device=dev)
    bits = (torch.rand(128 ** 3, generator=g, device=dev) < 0.3).to(
        torch.uint8)
    p = nm.MarchParams.from_cfg(cfg)
    got, want = nm.march(o, d, u, bits, p), nm.march_plain(o, d, u, bits, p)
    for name in ("counts", "offsets", "stats"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    n = int(want.stats[1])
    assert 0 < int(want.stats[0]) < 4096 and n <= p.budget
    assert torch.equal(got.ray_idx[:n], want.ray_idx[:n])
    assert torch.equal(got.pos[:n], want.pos[:n])
    assert torch.equal(got.ts[:n], want.ts[:n])
    torch.testing.assert_close(got.sh[:n], want.sh[:n], atol=1e-7, rtol=0)


def test_ngp_composite_kernels_match_plain(dev):
    from nerf_pytorch_paeng_tpu_torch.kernels import ngp_march as nm
    from nerf_pytorch_paeng_tpu_torch.ops.ngp import composite
    cfg = _ngp_cfg()
    o, d = _orbit_rays(4096, 7, dev)
    g = torch.Generator(device=dev).manual_seed(8)
    bits = (torch.rand(128 ** 3, generator=g, device=dev) < 0.5).to(
        torch.uint8)
    p = nm.MarchParams.from_cfg(cfg)
    m = nm.march(o, d, torch.rand(4096, generator=g, device=dev), bits, p)
    sigma = (torch.rand(p.budget, generator=g, device=dev) * 200.0
             ).requires_grad_(True)
    rgb = torch.rand((p.budget, 3), generator=g, device=dev
                     ).requires_grad_(True)
    got = composite(sigma, rgb, m.counts, m.offsets, p)
    want = nm.composite_plain(sigma, rgb, m.counts, m.offsets, p)[0]
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-5)
    gout = torch.randn(4096, 3, generator=g, device=dev)
    gk = torch.autograd.grad(got, (sigma, rgb), gout)
    gp = torch.autograd.grad(want, (sigma, rgb), gout)
    for a, b in zip(gk, gp):
        err = float((a - b).norm() / b.norm())
        assert err < 1e-4, err


def test_ngp_grid_update_and_marcher_match_the_reference(dev):
    """At the published sizes, on a grid after an update of every cell
    (a field whose density spans many decades, so that it is partly
    empty): one update of half the cells against the reference's from the
    same state and draws, and the step's marcher on the grid it leaves
    against the reference's lattice, within the benchmark's limits
    (``port_bench/arch/ngp.GRID_CHECK_LIMITS``): the marcher's kept rays
    and samples exactly."""
    from nerf_pytorch_paeng_tpu_torch.models.ngp import (
        GRID_WARMUP, init_ngp, update_occupancy_grid)
    from port_bench.arch import ngp as arch_ngp
    cfg = _ngp_cfg()
    model = init_ngp(cfg, dev, seed=1)
    g = torch.Generator(device=dev).manual_seed(2)
    with torch.no_grad():
        for t in model.tables:
            t.copy_(torch.randn(t.shape, generator=g, device=dev) * 2.0)
        model.sigma_w1[0].mul_(5.0)
    update_occupancy_grid(model, cfg, 0,
                          torch.Generator(device=dev).manual_seed(3))
    occupied = float(model.grid_bits.double().mean())
    assert 0.05 < occupied < 0.95, occupied
    o, d = _orbit_rays(4096, 11, dev)
    rays = torch.stack([o, d, torch.zeros_like(o)], 1)
    r = arch_ngp.grid_march_readings(model, cfg, rays, GRID_WARMUP)
    assert r["march_kept_mismatch"] == r["march_samples_gap"] == 0, r
    arch_ngp.hold_grid_check(r)


def test_ngp_captured_steps_equal_eager_steps(dev):
    """A chunk of 16 NGP steps replayed from a CUDA graph (after its two
    eager steps) against 16 eager steps from the same state: the same
    losses within the atomics' tolerance."""
    from nerf_pytorch_paeng_tpu_torch.models.ngp import init_ngp
    from nerf_pytorch_paeng_tpu_torch.train.batching import RayPool
    from nerf_pytorch_paeng_tpu_torch.train.chunk import StagedSteps
    from nerf_pytorch_paeng_tpu_torch.train.schedule import schedule_from_cfg
    from nerf_pytorch_paeng_tpu_torch.train.state import (TrainState,
                                                          make_optimizer)
    cfg = _ngp_cfg(N_rays=4096)
    o, d = _orbit_rays(1 << 16, 9, dev)
    pool = torch.stack([o, d, torch.rand_like(o)], 1)
    losses, counts = [], []
    for graphs in (False, True):
        model = init_ngp(cfg, dev, seed=1)
        st = TrainState(model, make_optimizer(model, cfg), 0)
        steps = StagedSteps(cfg, st, schedule_from_cfg(cfg), dev, 8, 8,
                            np.eye(3), pool=RayPool(pool.clone(), None),
                            graphs=graphs)
        slab = steps.run([4096 * k for k in range(16)], replay=graphs)
        losses.append(slab[:, steps.keys.index("loss")].cpu())
        counts.append(steps.counters.t.cpu())
        assert steps.replays == (14 if graphs else 0)
        steps.close()
    torch.testing.assert_close(losses[1], losses[0], rtol=2e-3, atol=0)
    torch.testing.assert_close(counts[1][:3], counts[0][:3], rtol=1e-2,
                               atol=0)
