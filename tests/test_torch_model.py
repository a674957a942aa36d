"""Port vs JAX package: the weight carrier, the packed kernel layout and
the plain MLP forward, on one numpy-seeded parameter tree."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_pytorch_paeng_tpu.kernels.fused_mlp import \
    pack_nerf_mlp_params as jax_pack
from nerf_pytorch_paeng_tpu.models.nerf import NeRF as JaxNeRF
from nerf_pytorch_paeng_tpu.utils.interop import \
    reference_state_dict_from_params
from nerf_pytorch_paeng_tpu_torch.config import NerfConfig
from nerf_pytorch_paeng_tpu_torch.kernels.fused_mlp import \
    pack_nerf_mlp_params
from nerf_pytorch_paeng_tpu_torch.models.nerf import NeRF, init_nerf
from nerf_pytorch_paeng_tpu_torch.utils.interop import (
    jax_params_from_state_dict, state_dict_from_jax_params)

from torch_port_util import np_nerf_params, to_jax


def _port_model(params, L_x=10, L_d=4):
    model = NeRF(L_x=L_x, L_d=L_d)
    model.load_state_dict(state_dict_from_jax_params(params))
    return model


def test_carrier_round_trip_and_reference_keys():
    params = np_nerf_params(0)
    sd = state_dict_from_jax_params(params)
    model = _port_model(params)
    # the port's state_dict IS the reference model_state_dict (names and
    # registration order), and the JAX package's exporter agrees
    ref = reference_state_dict_from_params(params)
    assert list(model.state_dict()) == list(ref) == list(sd)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), ref[k])
    back = jax_params_from_state_dict(model.state_dict())
    for mod in params:
        for layer in params[mod]:
            for leaf in ("kernel", "bias"):
                np.testing.assert_array_equal(back[mod][layer][leaf],
                                              params[mod][layer][leaf])


@pytest.mark.parametrize("L_x,L_d", [(10, 4), (6, 2)])
def test_pack_matches_jax_layout(L_x, L_d):
    """Every packed tensor is the JAX package's packed tensor transposed
    ([out, in] there, [in, out] here), embedding-row permutation and
    zero padding included; biases are float32 and weights bf16 by default."""
    params = np_nerf_params(1, L_x=L_x, L_d=L_d)
    model = _port_model(params, L_x, L_d)
    ours = pack_nerf_mlp_params(model.model_coarse, L_x, L_d,
                                dtype=torch.float32)
    theirs = jax_pack(to_jax(params["coarse"]), L_x=L_x, L_d=L_d)
    for name, t in theirs.items():
        t = np.asarray(t)
        mine = ours[name].numpy()
        if name.startswith("b") and name not in ("bdens", "bcol"):
            np.testing.assert_array_equal(mine, t[:, 0])
        elif name in ("bdens", "bcol"):
            np.testing.assert_array_equal(mine, t[:mine.shape[0], 0])
        elif name == "wdens":
            np.testing.assert_array_equal(mine, t[0])
        elif name == "wcol":
            np.testing.assert_array_equal(mine, t[:3].T)
        else:
            np.testing.assert_array_equal(mine, t.T)
    bf = pack_nerf_mlp_params(model.model_coarse, L_x, L_d)
    assert bf["w"].dtype == torch.bfloat16 and bf["b"].dtype == torch.float32
    np.testing.assert_array_equal(bf["w1"].float().numpy(),
                                  ours["w1"].to(torch.bfloat16).float().numpy())


@pytest.mark.parametrize("module", ["coarse", "fine"])
def test_forward_matches_flax_fp32(module):
    """NeRFMLP.forward == flax NeRF at compute_dtype float32 (the sums run
    in another order: 1e-5)."""
    params = np_nerf_params(2)
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (64, 90)).astype(np.float32)
    flax_model = JaxNeRF(compute_dtype=jnp.float32)
    method = JaxNeRF.coarse_fwd if module == "coarse" else JaxNeRF.fine_fwd
    want = np.asarray(flax_model.apply({"params": to_jax(params)},
                                       jnp.asarray(x), method=method))
    mlp = getattr(_port_model(params), f"model_{module}")
    with torch.no_grad():
        got = mlp(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_forward_bf16_matches_flax_bf16():
    """bf16 operands with float32 accumulation on both sides."""
    params = np_nerf_params(4)
    x = np.random.default_rng(5).normal(0, 0.5, (32, 90)).astype(np.float32)
    flax_model = JaxNeRF(compute_dtype=jnp.bfloat16)
    want = np.asarray(flax_model.apply({"params": to_jax(params)},
                                       jnp.asarray(x),
                                       method=JaxNeRF.coarse_fwd))
    with torch.no_grad():
        got = _port_model(params).model_coarse(
            torch.from_numpy(x), compute_dtype=torch.bfloat16).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


def test_init_scales_and_seed():
    """Xavier weights and U(+-1/sqrt(fan_in)) biases, reproducible from the
    seed, with independent coarse and fine draws."""
    cfg = NerfConfig(device="cpu")
    a, b = init_nerf(cfg, seed=7), init_nerf(cfg, seed=7)
    assert a.model_fine.linear_color.weight.device == torch.device(cfg.device)
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    w = a.model_coarse.linear_x[1].weight.detach()
    assert float(w.abs().max()) <= np.sqrt(6 / 512) + 1e-6
    assert float(w.std()) == pytest.approx(np.sqrt(6 / 512) / np.sqrt(3),
                                           rel=0.05)
    bias = a.model_coarse.linear_d.bias.detach()
    assert float(bias.abs().max()) <= 1 / np.sqrt(256 + 27) + 1e-6
    assert not torch.equal(a.model_coarse.linear_x[0].weight,
                           a.model_fine.linear_x[0].weight)
    # the flax init has the same shapes
    jparams = JaxNeRF().init(jax.random.PRNGKey(0), jnp.zeros((2, 90)))
    sd = state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, jparams["params"]))
    assert {k: v.shape for k, v in sd.items()} == \
        {k: v.shape for k, v in a.state_dict().items()}
