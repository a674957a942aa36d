"""The fused-MLP wrappers (kernels/fused_mlp.py) against the JAX package's
Pallas kernels.

On the CPU the wrappers run their plain versions; the JAX side runs its
Pallas kernels in interpret mode, which computes in float32
(fused_mlp.py:337, :519), as the JAX package's own tests do.  Same
numpy-seeded weights and rays on both sides; the sums run in another
order, so the tolerance is 1e-4 (relative, with a matching absolute floor
for logits near 0).

The kernels themselves need the card: tests/test_torch_cuda.py holds
them against these plain versions there.
"""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_pytorch_paeng_tpu.kernels import fused_mlp as jfm
from nerf_pytorch_paeng_tpu_torch.kernels import fused_mlp as fm
from nerf_pytorch_paeng_tpu_torch.models.nerf import NeRF
from nerf_pytorch_paeng_tpu_torch.utils.interop import \
    state_dict_from_jax_params

from torch_port_util import np_nerf_params, np_rays, to_jax

N, S = 256, 16
TOL = dict(rtol=1e-4, atol=1e-4)


def _setup(seed, L_x=10, L_d=4, dtype=torch.float32, n=N, s=S):
    params = np_nerf_params(seed, L_x=L_x, L_d=L_d)
    model = NeRF(L_x=L_x, L_d=L_d)
    model.load_state_dict(state_dict_from_jax_params(params))
    packed = fm.pack_nerf_mlp_params(model.model_fine, L_x, L_d, dtype=dtype)
    od, z = np_rays(np.random.default_rng(seed + 100), n, s)
    return params, packed, od, z


@pytest.mark.parametrize("L_x", [10, 5])
def test_sigma_rays_matches_jax(L_x):
    params, packed, od, z = _setup(0, L_x=L_x)
    want = np.asarray(jfm.fused_mlp_sigma_rays(
        jnp.asarray(od), jnp.asarray(z),
        jfm.pack_nerf_mlp_params(to_jax(params["fine"]), L_x=L_x),
        L_x=L_x, tile_rays=N, interpret=True))
    got = fm.fused_mlp_sigma_rays(torch.from_numpy(od), torch.from_numpy(z),
                                  packed, L_x=L_x)
    assert got.shape == (S, N) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("L_x,L_d", [(10, 4), (7, 3)])
def test_eval_rays_matches_jax(L_x, L_d):
    params, packed, od, z = _setup(1, L_x=L_x, L_d=L_d)
    want = jfm.fused_mlp_eval_rays(
        jnp.asarray(od), jnp.asarray(z),
        jfm.pack_nerf_mlp_params(to_jax(params["fine"]), L_x=L_x, L_d=L_d),
        L_x=L_x, L_d=L_d, tile_rays=N, interpret=True)
    got = fm.fused_mlp_eval_rays(torch.from_numpy(od), torch.from_numpy(z),
                                 packed, L_x=L_x, L_d=L_d)
    for name, g, w in zip("rgbs", got, want):
        assert g.shape == (S, N), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)


def test_bf16_out_dtype_rounds_float32_result():
    _, packed, od, z = _setup(2)
    od, z = torch.from_numpy(od), torch.from_numpy(z)
    f32 = fm.fused_mlp_eval_rays(od, z, packed)
    b16 = fm.fused_mlp_eval_rays(od, z, packed, out_dtype=torch.bfloat16)
    for a, b in zip(f32, b16):
        assert b.dtype == torch.bfloat16
        assert torch.equal(a.to(torch.bfloat16), b)


def test_plain_bf16_weights_stay_close_to_fp32():
    """The card's arithmetic (bf16 operands, float32 accumulation) against
    float32 on the same inputs: the bf16 error budget chip_smoke.py's
    kernel tolerance is set from."""
    params, p32, od, z = _setup(3)
    model = NeRF()
    model.load_state_dict(state_dict_from_jax_params(params))
    p16 = fm.pack_nerf_mlp_params(model.model_fine)
    od, z = torch.from_numpy(od), torch.from_numpy(z)
    a = fm.fused_mlp_sigma_rays(od, z, p32)
    b = fm.fused_mlp_sigma_rays(od, z, p16)
    assert float((a - b).abs().max()) < 5e-2
    assert float((a - b).norm() / a.norm()) < 1e-2


def test_sigma_is_the_eval_kernels_sigma():
    """K3 computes K1's trunk and density head: same sigma on the same
    weights."""
    _, packed, od, z = _setup(4)
    od, z = torch.from_numpy(od), torch.from_numpy(z)
    sigma = fm.fused_mlp_sigma_rays(od, z, packed)
    assert torch.equal(sigma, fm.fused_mlp_eval_rays(od, z, packed)[3])


def test_cpu_dispatch_counts_no_launch():
    _, packed, od, z = _setup(5, n=8, s=2)
    before = (fm.fused_mlp_sigma_rays.launches,
              fm.fused_mlp_eval_rays.launches)
    fm.fused_mlp_sigma_rays(torch.from_numpy(od), torch.from_numpy(z), packed)
    fm.fused_mlp_eval_rays(torch.from_numpy(od), torch.from_numpy(z), packed)
    assert (fm.fused_mlp_sigma_rays.launches,
            fm.fused_mlp_eval_rays.launches) == before


@pytest.mark.parametrize("bad", ["od_shape", "z_dtype", "noncontig",
                                 "out_dtype", "L_x"])
def test_wrappers_reject_bad_inputs(bad):
    _, packed, od, z = _setup(6, n=16, s=4)
    od, z = torch.from_numpy(od), torch.from_numpy(z)
    kw = {}
    if bad == "od_shape":
        od = od[:6].contiguous()
    elif bad == "z_dtype":
        z = z.double()
    elif bad == "noncontig":
        z = z.T.contiguous().T
    elif bad == "out_dtype":
        kw["out_dtype"] = torch.float16
    else:
        kw["L_x"] = 11
    with pytest.raises(ValueError):
        fm.fused_mlp_sigma_rays(od, z, packed, **kw)
    with pytest.raises(ValueError):
        fm.fused_mlp_eval_rays(od, z, packed, **kw)


def test_cu_offsets_match_packed_layout():
    """csrc/fused_mlp.cu hard-codes the packed offsets; they must be the
    Python layout's."""
    src = (pathlib.Path(fm.__file__).parent / "csrc" /
           "fused_mlp.cu").read_text()
    consts = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr long OFF_(\w+) = (\d+);", src)}
    for name, off in fm.W_OFFSETS.items():
        assert consts[name.upper()] == off, name
    for name, off in fm.B_OFFSETS.items():
        if name[0] == "b" and name[1:].isdigit():
            assert consts["B0"] + 256 * int(name[1:]) == off, name
        else:
            assert consts[name.upper()] == off, name


def test_flop_counts():
    """The function's own widths at L_x=10, L_d=4: 63 position inputs, a
    1-wide density head, a 3-wide colour head, 27 direction inputs."""
    assert fm.sigma_flop_per_sample(10) == 2 * (
        63 * 256 + 6 * 256 ** 2 + 319 * 256 + 256) == 982_528
    assert fm.eval_flop_per_sample(10) == 982_528 + 2 * (
        256 ** 2 + 256 * 128 + 128 * 3) == 1_179_904
    assert fm.eval_flop_per_ray(4) == 2 * 27 * 128 == 6_912
    assert fm.sigma_flop_per_sample(1) == 2 * (
        9 * 256 + 6 * 256 ** 2 + 265 * 256 + 256)
