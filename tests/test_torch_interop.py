"""The weight carrier (``utils/interop``) at every trunk depth, and the
checkpoint round trip between the port and the JAX package's reference
checkpoint converters (``reference_checkpoint_from_train_state``,
``train_state_from_reference_checkpoint``; reference depth only, as the
JAX package's own interop is).

Tolerances: the carrier and both checkpoint directions are bit-exact
(transposes and copies only); the port's module forward against JAX
``apply`` at float32 to 1e-5 (the same products, summed in another
order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_pytorch_paeng_tpu.config import NerfConfig as JaxConfig
from nerf_pytorch_paeng_tpu.models.nerf import NeRF as JaxNeRF
from nerf_pytorch_paeng_tpu.train import step as jstep
from nerf_pytorch_paeng_tpu.train.state import \
    create_train_state as jax_create_state
from nerf_pytorch_paeng_tpu.utils.interop import (
    reference_checkpoint_from_train_state,
    train_state_from_reference_checkpoint)
from nerf_pytorch_paeng_tpu_torch.config import NerfConfig
from nerf_pytorch_paeng_tpu_torch.models.nerf import NeRF
from nerf_pytorch_paeng_tpu_torch.ops.posenc import posenc_out_dim
from nerf_pytorch_paeng_tpu_torch.train import (TrainState, create_train_state,
                                                make_optimizer)
from nerf_pytorch_paeng_tpu_torch.train import checkpoint as ckpt
from nerf_pytorch_paeng_tpu_torch.train.schedule import schedule_from_cfg
from nerf_pytorch_paeng_tpu_torch.train.step import make_train_step
from nerf_pytorch_paeng_tpu_torch.utils.interop import (
    jax_params_from_state_dict, layer_pairs, state_dict_from_jax_params)

from torch_port_util import np_nerf_params, to_jax


def _small_cfgs():
    """The JAX package's tests/test_interop.py ``_small_cfg``, both
    packages."""
    kw = dict(compute_dtype="float32", use_pallas=False, N_rays=32,
              N_samples_c=8, N_samples_f=8, near=2.0, far=6.0, iter_N=50,
              iter_warmup=5)
    return JaxConfig(**kw), NerfConfig(device="cpu", **kw)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("depth,width,L_x,L_d", [
    (4, 64, 0, 0), (6, 128, 5, 2), (8, 256, 10, 4)])
def test_carrier_round_trips_at_every_depth(depth, width, L_x, L_d):
    """tree -> state dict -> tree bit-equal; the state dict loads strictly
    into a ``NeRF`` of that depth in the reference order; its module
    forward equals JAX ``apply`` of the same tree."""
    params = np_nerf_params(7, L_x=L_x, L_d=L_d, depth=depth, width=width)
    sd = state_dict_from_jax_params(params)
    model = NeRF(depth=depth, width=width, L_x=L_x, L_d=L_d)
    model.load_state_dict(sd)
    assert list(sd) == list(model.state_dict())
    assert [n for _, n in layer_pairs(depth)][:depth] == [
        f"linear_x.{i}" for i in range(depth)]
    back = jax_params_from_state_dict(model.state_dict())
    got, want = _leaves(back), _leaves(params)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], k)

    jm = JaxNeRF(depth=depth, width=width, L_x=L_x, L_d=L_d,
                 compute_dtype=jnp.float32)
    x = np.random.default_rng(8).normal(
        0, 1, (50, posenc_out_dim(L_x) + posenc_out_dim(L_d))).astype(
        np.float32)
    jc, jf = jm.apply({"params": to_jax(params)}, jnp.asarray(x))
    with torch.no_grad():
        for mlp, ref in ((model.model_coarse, jc), (model.model_fine, jf)):
            np.testing.assert_allclose(mlp(torch.from_numpy(x)).numpy(),
                                       np.asarray(ref), rtol=1e-5, atol=1e-5)


def _tensors(tree):
    """numpy leaves -> torch tensors (what the reference's torch.save
    holds), containers kept."""
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        return torch.tensor(tree)
    return tree


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    return tree


def _adam_state(opt_state):
    return next(s for s in opt_state if hasattr(s, "mu"))


def _assert_state_matches(state, jparams, jmu, jnu, jstep_count):
    """The port's TrainState against a JAX params/moments tree and step:
    bit-equal, parameter by parameter in the optimizer's order."""
    want = {name: state_dict_from_jax_params(jax.device_get(tree))
            for name, tree in (("w", jparams), ("m", jmu), ("v", jnu))}
    opt = state.optimizer.state_dict()
    for i, (name, p) in enumerate(state.model.named_parameters()):
        assert torch.equal(p.detach(), want["w"][name]), name
        st = opt["state"][i]
        assert torch.equal(st["exp_avg"], want["m"][name]), name
        assert torch.equal(st["exp_avg_sq"], want["v"][name]), name
        assert float(st["step"]) == jstep_count
    assert state.step == jstep_count


def test_jax_train_state_restores_into_the_port(tmp_path):
    """A JAX train state after two XLA steps -> the JAX package's
    reference checkpoint -> ``torch.save`` -> the port's
    ``restore_checkpoint``: the same weights, Adam moments and step."""
    jcfg, cfg = _small_cfgs()
    model, jstate, tx = jax_create_state(jcfg, jax.random.PRNGKey(0))
    step = jax.jit(jstep.make_train_step(model, tx, jcfg))
    rng = np.random.default_rng(9)
    for _ in range(2):
        o = rng.normal(0, 0.1, (32, 3)).astype(np.float32) + [0, 0, 4]
        d = (-o / 4 + rng.normal(0, 0.2, (32, 3))).astype(np.float32)
        tgt = rng.uniform(0, 1, (32, 3)).astype(np.float32)
        jstate, _ = step(jstate, jnp.asarray(o, jnp.float32), jnp.asarray(d),
                         jnp.asarray(tgt), jax.random.PRNGKey(1))
    ref = reference_checkpoint_from_train_state(jax.device_get(jstate), jcfg)
    path = ckpt.checkpoint_path(str(tmp_path), "exp", int(jstate.step))
    (tmp_path / "exp").mkdir()
    torch.save(_tensors(ref), path)

    state = create_train_state(cfg, "cpu")
    ckpt.restore_checkpoint(str(tmp_path), "exp", int(jstate.step), state)
    adam = _adam_state(jstate.opt_state)
    _assert_state_matches(state, jstate.params, adam.mu, adam.nu, 2)


def test_port_checkpoint_imports_into_the_jax_package(tmp_path):
    """A port checkpoint after two plain-route steps -> ``torch.load`` ->
    the JAX package's ``train_state_from_reference_checkpoint``: the same
    weights, Adam moments and step."""
    jcfg, cfg = _small_cfgs()
    model = NeRF()
    model.load_state_dict(state_dict_from_jax_params(np_nerf_params(10)))
    state = TrainState(model, make_optimizer(model, cfg), 0)
    step = make_train_step(cfg, schedule_from_cfg(cfg))
    g = torch.Generator().manual_seed(11)
    for _ in range(2):
        o = torch.randn(32, 3, generator=g) * 0.1 + torch.tensor([0, 0, 4.0])
        d = -o / 4 + torch.randn(32, 3, generator=g) * 0.2
        step(state, o, d, torch.rand(32, 3, generator=g))
    path = ckpt.save_checkpoint(str(tmp_path), "exp", state)

    jstate = train_state_from_reference_checkpoint(
        _numpy(torch.load(path, weights_only=True)), jcfg)
    adam = _adam_state(jstate.opt_state)
    assert int(jstate.step) == int(adam.count) == 2
    _assert_state_matches(state, jstate.params, adam.mu, adam.nu, 2)
