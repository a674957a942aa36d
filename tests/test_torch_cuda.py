"""The port's CUDA kernels on the card, against their plain versions.

Every test here is marked ``cuda`` and skips without a GPU (the kernels
have no CPU mode; the CPU tests hold the plain versions against the JAX
package).  This file imports nothing of JAX, so it runs on a machine
that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: both sides use bf16 operands with float32 accumulation, but
the sums run in another order, so an activation can round to the other
bf16 neighbour and carry that through the remaining layers: 5e-2 max and
1e-2 relative L2 on logits of order 1 (as chip_smoke.py).
"""
import numpy as np
import pytest
import torch

from nerf_pytorch_paeng_tpu_torch.config import NerfConfig
from nerf_pytorch_paeng_tpu_torch.eval.frame import make_frame_renderer
from nerf_pytorch_paeng_tpu_torch.kernels import fused_mlp as fm
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
