"""The port's CUDA kernels on the card, against their plain versions, and
one full-width training step.

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
from nerf_pytorch_paeng_tpu_torch.utils.synth import make_synth_scene

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


@pytest.mark.parametrize("n,s", [(128, 8), (1000, 8), (4096, 64), (300, 3)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain(dev, n, s, out_dtype):
    """Ragged ray counts (the kernels mask the edge) and any sample count."""
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
    p = _packed(4, dev)
    od, z = _inputs(5, 2048, 16, dev)
    _close(fm.fused_mlp_sigma_rays(od, z, p), fm.fused_mlp_eval_rays(od, z, p)[3])


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
    (inverse-CDF tie flips keep it from bit-exact)."""
    cfg = NerfConfig()
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


def test_bwd_kernel_is_deterministic(dev):
    """No atomics: two launches on the same inputs give the same bits
    (more than one chunk of points, so the partials' order is pinned)."""
    p = _packed(13, dev)
    od, z = _inputs(14, 4096, 40, dev)
    gout = _cotangents(15, 40, 4096, dev)
    a = fv.fused_mlp_bwd_rays(od, z, *gout, p)
    b = fv.fused_mlp_bwd_rays(od, z, *gout, p)
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
