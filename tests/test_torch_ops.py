"""Port vs JAX package for the plain ops of the dense eval path: rays,
positional encoding, samplers (with the JAX draws injected as ``u=``) and
sample-major compositing.  float32 on both sides; tolerances are a few
float32 ulps of the values compared unless a comment says otherwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_pytorch_paeng_tpu.kernels.fused_mlp import _build_emb
from nerf_pytorch_paeng_tpu.ops import posenc as jposenc
from nerf_pytorch_paeng_tpu.ops import rays as jrays
from nerf_pytorch_paeng_tpu.ops import sampling as jsampling
from nerf_pytorch_paeng_tpu.ops import volume as jvolume
from nerf_pytorch_paeng_tpu.ops.render import \
    hierarchical_z_vals as j_hierarchical
from nerf_pytorch_paeng_tpu_torch.ops import posenc, rays, sampling, volume
from nerf_pytorch_paeng_tpu_torch.ops.render import hierarchical_z_vals


def _t(a):
    return torch.from_numpy(np.array(a))


def test_get_rays_matches_jax():
    from nerf_pytorch_paeng_tpu_torch.utils.synth import orbit_pose
    K = np.array([[20.0, 0, 8.0], [0, 21.0, 6.0], [0, 0, 1]], np.float32)
    c2w = orbit_pose(0.7, 0.35, 4.0)
    jo, jd = jrays.get_rays(12, 16, jnp.asarray(K), jnp.asarray(c2w))
    o, d = rays.get_rays(12, 16, K, torch.from_numpy(c2w))
    assert o.shape == d.shape == (12, 16, 3)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("L", [0, 4, 10])
def test_positional_encoding_matches_jax(L):
    x = np.random.default_rng(L).normal(0, 2, (50, 3)).astype(np.float32)
    want = np.asarray(jposenc.positional_encoding(jnp.asarray(x), L))
    got = posenc.positional_encoding(torch.from_numpy(x), L).numpy()
    assert got.shape == (50, posenc.posenc_out_dim(L) if L else 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("L,rows", [(10, 64), (4, 32)])
def test_build_emb_matches_kernel_embedding(L, rows):
    """The kernels' double-angle embedding: the JAX builder is
    feature-major [rows, T], the port's point-major [T, rows]; the
    recurrence drifts ~2^j ulp at high frequency on both sides alike."""
    x = np.random.default_rng(L).uniform(-6, 6, (40, 3)).astype(np.float32)
    want = np.asarray(_build_emb(jnp.asarray(x.T), L, rows, jnp.float32)).T
    got = posenc.build_emb(torch.from_numpy(x), L, rows).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("perturb", [True, False])
def test_stratified_z_vals_with_jax_draws(perturb):
    key = jax.random.PRNGKey(3)
    want = np.asarray(jsampling.stratified_z_vals(key, 32, 2.0, 6.0, 64,
                                                  perturb=perturb))
    u = np.asarray(jax.random.uniform(key, (32, 64), dtype=jnp.float32))
    got = sampling.stratified_z_vals(32, 2.0, 6.0, 64, perturb=perturb,
                                     u=_t(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_stratified_generator_draws_stay_in_bins():
    g = torch.Generator().manual_seed(0)
    z = sampling.stratified_z_vals(100, 2.0, 6.0, 16, generator=g)
    edges = torch.linspace(2.0, 6.0, 16)
    mids = 0.5 * (edges[1:] + edges[:-1])
    assert bool((z[:, 1:] >= mids - 1e-6).all())
    assert bool((z[:, :-1] <= mids + 1e-6).all())
    assert bool((z[:, 1:] >= z[:, :-1]).all())


@pytest.mark.parametrize("seed", [0, 1])
def test_sample_pdf_from_u_matches_jax(seed):
    rng = np.random.default_rng(seed)
    bins = np.sort(rng.uniform(2, 6, (64, 17)), -1).astype(np.float32)
    w = rng.exponential(1.0, (64, 16)).astype(np.float32)
    w[:5] = 0.0                       # empty rays: the +1e-5 keeps them sane
    u = rng.uniform(0, 1, (64, 24)).astype(np.float32)
    u[0, :3] = [0.0, 1.0, 0.5]
    want = np.asarray(jsampling.sample_pdf_from_u(
        jnp.asarray(bins), jnp.asarray(w), jnp.asarray(u)))
    got = sampling.sample_pdf_from_u(_t(bins), _t(w), _t(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_sample_pdf_det_matches_jax():
    rng = np.random.default_rng(2)
    bins = np.sort(rng.uniform(2, 6, (8, 9)), -1).astype(np.float32)
    w = rng.exponential(1.0, (8, 8)).astype(np.float32)
    want = np.asarray(jsampling.sample_pdf(None, jnp.asarray(bins),
                                           jnp.asarray(w), 12, det=True))
    got = sampling.sample_pdf(_t(bins), _t(w), 12, det=True).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("perturb", [1.0, 0.0])
def test_hierarchical_z_vals_with_jax_draws(perturb):
    """Merged sorted depths; the random case feeds JAX's own fine draws
    (sample_pdf's jax.random.uniform on the same key) to the port."""
    rng = np.random.default_rng(4)
    z = np.sort(rng.uniform(2, 6, (32, 16)), -1).astype(np.float32)
    w = rng.exponential(1.0, (32, 16)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = np.asarray(j_hierarchical(jnp.asarray(z), jnp.asarray(w), key,
                                     n_fine=24, perturb=perturb))
    u = None
    if perturb:
        u = _t(jax.random.uniform(key, (32, 24), dtype=jnp.float32))
    got = hierarchical_z_vals(_t(z), _t(w), n_fine=24, perturb=perturb,
                              u=u).numpy()
    assert got.shape == (32, 40)
    assert np.all(np.diff(got, axis=-1) >= 0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _composite_inputs(seed, s=24, n=40):
    rng = np.random.default_rng(seed)
    z = np.sort(rng.uniform(2, 6, (s, n)), 0).astype(np.float32)
    rays_d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    raw = rng.normal(0, 2, (4, s, n)).astype(np.float32)
    raw[3, :, :3] = -5.0              # empty rays: acc == 0, disp == 0
    raw[3, :, 3] = 50.0               # opaque ray
    return raw, z, rays_d


def test_weights_from_sigma_t_matches_jax():
    raw, z, d = _composite_inputs(6)
    want = np.asarray(jvolume.weights_from_sigma_t(
        jnp.asarray(raw[3]), jnp.asarray(z), jnp.asarray(d)))
    got = volume.weights_from_sigma_t(_t(raw[3]), _t(z), _t(d)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_volume_render_rays_t_matches_jax():
    raw, z, d = _composite_inputs(7)
    want = jvolume.volume_render_rays_t(*(jnp.asarray(r) for r in raw),
                                        jnp.asarray(z), jnp.asarray(d))
    got = volume.volume_render_rays_t(*(_t(r) for r in raw), _t(z), _t(d))
    for name in ("rgb", "disp", "acc", "weights", "depth"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    assert np.all(got.disp.numpy()[:3] == 0.0)
    assert np.all(np.isfinite(got.disp.numpy()))
    assert float(got.disp.max()) <= volume.DISP_CLAMP


def test_volume_render_bf16_logits():
    """The frame path feeds bf16 kernel outputs; compositing upcasts."""
    raw, z, d = _composite_inputs(8)
    b16 = [_t(r).to(torch.bfloat16) for r in raw]
    got = volume.volume_render_rays_t(*b16, _t(z), _t(d))
    ref = volume.volume_render_rays_t(*(r.float() for r in b16), _t(z), _t(d))
    assert got.rgb.dtype == torch.float32
    assert torch.equal(got.rgb, ref.rgb)
