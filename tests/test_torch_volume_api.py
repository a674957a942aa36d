"""The public helpers the JAX package exports, in the port: ``ops.
volume_render`` (the [N, S, 4] layout), ``utils.img2mse`` and ``ops.
render_frame`` (a blocked render of a flat ray set), each against the
JAX package's function of that name.

Same numpy-seeded inputs and weights on both sides; JAX's per-block draws
(``split(key, n_blocks)``, then ``split(block key)`` into the coarse
jitter and the fine uniforms) are injected into the port's ``u_c`` /
``u_f``.  Tolerances: compositing to 1e-6 (float32, the same formulas);
the frames' coarse outputs to 1e-5 (float32 plain route, the same
weights), the fine outputs by outlier fraction (an ulp apart in the
coarse weights can flip an inverse-CDF bin: ``ROADMAP.md``'s known
reference behaviour), as tests/test_torch_frame.py holds them; the
blocked render against one unblocked ``render_rays_from_cfg`` of the same
draws to 1e-6 (one code path, blocks only change the products' row count).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_pytorch_paeng_tpu.config import NerfConfig as JaxConfig
from nerf_pytorch_paeng_tpu.models.nerf import NeRF as JaxNeRF
from nerf_pytorch_paeng_tpu.ops import render_frame as jax_render_frame
from nerf_pytorch_paeng_tpu.ops import volume_render as jax_volume_render
from nerf_pytorch_paeng_tpu.ops.render import make_xla_field_fns
from nerf_pytorch_paeng_tpu.utils import img2mse as jax_img2mse
from nerf_pytorch_paeng_tpu_torch.config import NerfConfig
from nerf_pytorch_paeng_tpu_torch.models.nerf import NeRF
from nerf_pytorch_paeng_tpu_torch.ops import render_frame, volume_render
from nerf_pytorch_paeng_tpu_torch.ops.render import (make_plain_field_fns,
                                                     render_rays_from_cfg)
from nerf_pytorch_paeng_tpu_torch.utils import img2mse
from nerf_pytorch_paeng_tpu_torch.utils.interop import \
    state_dict_from_jax_params

from torch_port_util import np_nerf_params, to_jax

SHAPE = dict(netDepth=4, netWidth=64, L_x=6, L_d=2)


def _raw(seed: int, n: int = 64, s: int = 24):
    rng = np.random.default_rng(seed)
    raw = rng.normal(0, 2, (n, s, 4)).astype(np.float32)
    raw[: n // 4, :, 3] = -5.0                       # empty rays
    z = np.sort(rng.uniform(2, 6, (n, s)), -1).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    return raw, z, d


@pytest.mark.parametrize("scan_impl", ["cumprod", "associative"])
def test_volume_render_matches_jax(scan_impl):
    raw, z, d = _raw(0)
    got = volume_render(*(torch.from_numpy(a) for a in (raw, z, d)),
                        scan_impl=scan_impl)
    want = jax_volume_render(*(jnp.asarray(a) for a in (raw, z, d)),
                             scan_impl=scan_impl)
    for name in ("rgb", "disp", "acc", "weights", "depth"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6, err_msg=name)
    # the empty rays composite to the white background
    np.testing.assert_allclose(got.rgb[:16].numpy(), 1.0, atol=1e-6)


def test_img2mse_matches_jax():
    rng = np.random.default_rng(1)
    a, b = (rng.uniform(size=(8, 9, 3)).astype(np.float32) for _ in "ab")
    got = img2mse(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dim() == 0
    np.testing.assert_allclose(float(got), float(jax_img2mse(
        jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)


def _frame_inputs(n: int, block: int, **kw):
    params = np_nerf_params(3, L_x=SHAPE["L_x"], L_d=SHAPE["L_d"],
                            depth=SHAPE["netDepth"],
                            width=SHAPE["netWidth"])
    kw = dict(use_pallas=False, compute_dtype="float32", N_samples_c=16,
              N_samples_f=16, chunk_rays=block, **SHAPE, **kw)
    jcfg, cfg = JaxConfig(**kw), NerfConfig(device="cpu", **kw)
    jmodel = JaxNeRF(depth=SHAPE["netDepth"], width=SHAPE["netWidth"],
                     L_x=SHAPE["L_x"], L_d=SHAPE["L_d"],
                     compute_dtype=jnp.float32)
    model = NeRF(SHAPE["netDepth"], SHAPE["netWidth"], SHAPE["L_x"],
                 SHAPE["L_d"])
    model.load_state_dict(state_dict_from_jax_params(params))
    rng = np.random.default_rng(4)
    o = rng.normal(0, 0.3, (n, 3)) + np.array([0.0, 0.0, 4.0])
    d = rng.normal(0, 0.3, (n, 3)) - o / 4.0
    return (jcfg, cfg, make_xla_field_fns(jmodel, to_jax(params), jcfg),
            make_plain_field_fns(model, cfg), o.astype(np.float32),
            d.astype(np.float32))


def _jax_block_draws(key, n_blocks: int, block: int, cfg):
    """JAX render_frame's draws: per block, the coarse jitter and the fine
    uniforms of ``render_rays`` -> (u_c, u_f) over the padded rays."""
    u_c, u_f = [], []
    for k in jax.random.split(key, n_blocks):
        kc, kf = jax.random.split(k)
        u_c.append(jax.random.uniform(kc, (block, cfg.N_samples_c)))
        u_f.append(jax.random.uniform(kf, (block, cfg.N_samples_f)))
    return (torch.from_numpy(np.concatenate(u_c)),
            torch.from_numpy(np.concatenate(u_f)))


def _outliers(got, want, tol, frac=2e-3):
    bad = np.abs(np.asarray(got) - np.asarray(want)) > tol
    assert bad.mean() <= frac, (bad.mean(), np.abs(got - want).max())


@pytest.mark.parametrize("n,block", [(100, 32), (64, 64)])
def test_render_frame_matches_jax(n, block):
    """A ray count that is not a multiple of the block (100 = 3 x 32 + 4,
    padded with ones) and one that is."""
    jcfg, cfg, jfns, fns, o, d = _frame_inputs(n, block)
    key = jax.random.PRNGKey(7)
    want = jax_render_frame(*jfns, jnp.asarray(o), jnp.asarray(d), key,
                            jcfg)
    u_c, u_f = _jax_block_draws(key, -(-n // block), block, jcfg)
    with torch.no_grad():
        got = render_frame(*fns, torch.from_numpy(o), torch.from_numpy(d),
                           cfg, u_c=u_c, u_f=u_f)
    assert got.rgb_f.shape == (n, 3) and got.gate_frac is None
    np.testing.assert_allclose(got.rgb_c.numpy(), np.asarray(want.rgb_c),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.disp_c.numpy(), np.asarray(want.disp_c),
                               rtol=1e-5, atol=1e-5)
    for name, tol in (("rgb_f", 2e-3), ("disp_f", 5e-3), ("acc_f", 2e-3),
                      ("depth_f", 5e-3)):
        _outliers(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                  tol)


@torch.no_grad()
def test_render_frame_equals_one_unblocked_render():
    n, block = 100, 32
    _, cfg, _, fns, o, d = _frame_inputs(n, block)
    g = torch.Generator().manual_seed(0)
    u_c = torch.rand(128, cfg.N_samples_c, generator=g)
    u_f = torch.rand(128, cfg.N_samples_f, generator=g)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    got = render_frame(*fns, o, d, cfg, u_c=u_c, u_f=u_f)
    want = render_rays_from_cfg(*fns, o, d, cfg, u_c=u_c[:n], u_f=u_f[:n])
    for a, b in zip(got, want):
        if b is None:
            assert a is None
            continue
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6)
    # a generator's draws: seeded alike, the same frame twice
    a = render_frame(*fns, o, d, cfg, generator=torch.Generator()
                     .manual_seed(1), block_rays=48)
    b = render_frame(*fns, o, d, cfg, generator=torch.Generator()
                     .manual_seed(1), block_rays=48)
    assert torch.equal(a.rgb_f, b.rgb_f)
