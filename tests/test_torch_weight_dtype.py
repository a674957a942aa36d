"""The type the fused kernels see the packed weights in
(``kernels/fused_mlp.kernel_weight_dtype``), against the JAX package.

The JAX package packs float32 weights whatever ``compute_dtype`` says
(``eval/frame.py::_pack_program``, ``ops/render.py``'s training pass); its
kernels compute in bf16 on the TPU and in float32 in interpret mode.  The
port's CUDA kernels take bf16 only, so a CUDA device gets bf16 weights at
either ``compute_dtype``; on the CPU the plain versions keep the config's
type, and at ``float32`` they reproduce the JAX package's interpret mode.
These tests need no card: the choice takes the device, and a ``cuda``
device object exists without one.
"""
import numpy as np
import pytest
import torch

from nerf_pytorch_paeng_tpu.kernels import fused_mlp as jfm
from nerf_pytorch_paeng_tpu_torch.config import NerfConfig
from nerf_pytorch_paeng_tpu_torch.kernels import fused_mlp as fm
from nerf_pytorch_paeng_tpu_torch.kernels import fused_mlp_vjp as fv
from nerf_pytorch_paeng_tpu_torch.models.nerf import NeRF
from nerf_pytorch_paeng_tpu_torch.train import create_train_state
from nerf_pytorch_paeng_tpu_torch.train.schedule import schedule_from_cfg
from nerf_pytorch_paeng_tpu_torch.train.step import make_train_step
from nerf_pytorch_paeng_tpu_torch.utils.interop import \
    state_dict_from_jax_params

from torch_port_util import np_nerf_params, to_jax


@pytest.mark.parametrize("compute_dtype,device,want", [
    ("float32", "cpu", torch.float32),
    ("bfloat16", "cpu", torch.bfloat16),
    ("float32", "cuda", torch.bfloat16),
    ("bfloat16", "cuda", torch.bfloat16),
    ("float32", torch.device("cuda", 0), torch.bfloat16),
])
def test_kernel_weight_dtype_takes_the_device(compute_dtype, device, want):
    assert fm.kernel_weight_dtype(compute_dtype, device) == want


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_cpu_pack_nerf_follows_compute_dtype_and_matches_jax(compute_dtype):
    """On the CPU ``pack_nerf`` packs in the config's type; at float32 the
    values are the JAX package's float32 packing exactly, at bf16 its
    packing rounded once."""
    params = np_nerf_params(3)
    model = NeRF()
    model.load_state_dict(state_dict_from_jax_params(params))
    cfg = NerfConfig(compute_dtype=compute_dtype)
    packed = fm.pack_nerf(model, cfg)
    want = (torch.float32 if compute_dtype == "float32" else torch.bfloat16)
    for key in ("coarse", "fine"):
        p = packed[key]
        assert p["w"].dtype == want and p["b"].dtype == torch.float32
        jp = jfm.pack_nerf_mlp_params(to_jax(params[key]))
        assert np.asarray(jp["w1"]).dtype == np.float32
        for name in ("w0", "w1", "w5e", "wvd", "wfeat", "b0", "bv"):
            ref = torch.from_numpy(np.array(jp[name]))  # [out, in]
            ref = ref.T if name[0] == "w" else ref[:, 0]
            np.testing.assert_array_equal(
                p[name].float().numpy(),
                ref.to(p[name].dtype).float().numpy())


@pytest.mark.parametrize("pair,n", [("fused_mlp_train_rays", 128),
                                    ("fused_mlp_train", 100)])
def test_cpu_training_step_at_float32_sees_float32_weights(monkeypatch, pair,
                                                           n):
    """A CPU training step at ``compute_dtype float32`` hands both passes
    float32 weights (the plain versions' float32 route), on the ray pair
    and on the plane pair (taken for a ray count off the 128-ray tile)."""
    seen = []
    fn = getattr(fv, pair)

    def spy(*a):
        seen.append(a[-1])
        return fn(*a)

    monkeypatch.setattr(fv, pair, spy)
    cfg = NerfConfig(device="cpu", N_samples_c=8, N_samples_f=8,
                     compute_dtype="float32", iter_N=10, iter_warmup=0)
    state = create_train_state(cfg, "cpu")
    g = torch.Generator().manual_seed(0)
    o = torch.tensor([0.0, 0.0, 4.0]) + 0.1 * torch.randn(n, 3, generator=g)
    d = -o / 4.0 + 0.1 * torch.randn(n, 3, generator=g)
    m = make_train_step(cfg, schedule_from_cfg(cfg))(
        state, o, d, torch.rand(n, 3, generator=g))
    assert bool(torch.isfinite(m["loss"]))
    assert seen == [torch.float32, torch.float32]
