"""The port's occupancy module (ops/occupancy.py) against the JAX
package's: support bounds of analytic density fields on small grids, and
the per-ray interval, hit and cube tests on seeded rays.

Both sides compute in float32 with the same formulas; the tolerance on
bounds and intervals is 1e-6 (relative and absolute: sums of three terms
may run in another order), and every boolean must be equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_pytorch_paeng_tpu.ops import occupancy as jocc
from nerf_pytorch_paeng_tpu_torch.ops import occupancy as occ

TOL = dict(rtol=1e-6, atol=1e-6)


def _field(kind):
    """sigma_raw(x) for x [3, P], written once for both array modules."""
    def fn(xp, m):
        if kind == "ball":          # off-centre ball of radius 1.3
            c = m.asarray([[0.4], [-0.3], [0.2]], dtype=xp.dtype)
            return 1.3 - m.sqrt(m.sum((xp - c) ** 2, 0))
        if kind == "box":           # anisotropic L-inf box
            return 1.0 - m.max(m.abs(xp) / m.asarray(
                [[1.6], [0.7], [1.1]], dtype=xp.dtype), 0)
        if kind == "l1":            # the compact field's L1 ball
            return 20.0 * (1.5 - m.sum(m.abs(xp), 0))
        if kind == "fog":           # density everywhere: invalid
            return m.ones(xp.shape[1:], dtype=xp.dtype)
        return -m.ones(xp.shape[1:], dtype=xp.dtype)   # empty: invalid
    return fn


class _TorchOps:
    """The few array functions ``_field`` uses, for torch tensors."""
    asarray = staticmethod(lambda a, dtype: torch.tensor(a, dtype=dtype))
    sqrt, abs, ones = torch.sqrt, torch.abs, torch.ones
    sum = staticmethod(lambda a, ax: torch.sum(a, ax))
    max = staticmethod(lambda a, ax: torch.amax(a, ax))


@pytest.mark.parametrize("grid", [16, 32])
@pytest.mark.parametrize("kind", ["ball", "box", "l1", "fog", "empty"])
def test_support_bounds_match_jax(kind, grid):
    half = 3.0
    fn = _field(kind)
    want = jocc.support_bounds_from_sigma(lambda xp: fn(xp, jnp), half,
                                          grid=grid)
    got = occ.support_bounds_from_sigma(lambda xp: fn(xp, _TorchOps), half,
                                        grid=grid)
    for name, g, w in zip(("lo", "hi", "radius"), got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)
    assert bool(got[3][0]) == bool(want[3][0])
    assert bool(got[3][0]) == (kind in ("ball", "box", "l1"))


def test_support_bounds_domain_mask():
    """A domain mask restricts the support the bounds measure."""
    half, grid = 3.0, 16
    fn = _field("box")
    mask = np.zeros((grid,) * 3, bool)
    mask[grid // 2:] = True                     # x > 0 half only
    want = jocc.support_bounds_from_sigma(lambda xp: fn(xp, jnp), half,
                                          grid=grid,
                                          domain_mask=jnp.asarray(mask))
    got = occ.support_bounds_from_sigma(lambda xp: fn(xp, _TorchOps), half,
                                        grid=grid,
                                        domain_mask=torch.from_numpy(mask))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    assert float(got[0][0]) > -1.6


def _rays(seed, m=512):
    """Orbit-like rays, a quarter with one direction component set to 0 or
    to +-1e-13 (the guarded division), and some far from the support."""
    rng = np.random.default_rng(seed)
    o = rng.normal(0, 1, (m, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o / 4.0 + rng.normal(0, 0.4, (m, 3))
    q = m // 4
    d[:q, 0] = rng.choice([0.0, 1e-13, -1e-13], q)
    d[q:2 * q, 2] = 0.0
    o[3 * q:] += rng.normal(0, 3.0, (m - 3 * q, 3))
    return o.astype(np.float32), d.astype(np.float32)


def _bounds(valid=True):
    return (np.array([-1.0, -0.5, -0.8], np.float32),
            np.array([1.2, 0.9, 0.6], np.float32),
            np.array([1.5], np.float32), np.array([valid]))


@pytest.mark.parametrize("valid", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_ray_interval_and_hits_match_jax(seed, valid):
    o, d = _rays(seed)
    b = _bounds(valid)
    want = jocc.ray_support_interval(jnp.asarray(o), jnp.asarray(d),
                                     *map(jnp.asarray, b), 2.0, 6.0)
    got = occ.ray_support_interval(torch.from_numpy(o), torch.from_numpy(d),
                                   *map(torch.from_numpy, b), 2.0, 6.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    hits = occ.ray_hits_bounds(torch.from_numpy(o), torch.from_numpy(d),
                               *map(torch.from_numpy, b), 2.0, 6.0)
    jhits = jocc.ray_hits_bounds(jnp.asarray(o), jnp.asarray(d),
                                 *map(jnp.asarray, b), 2.0, 6.0)
    np.testing.assert_array_equal(hits.numpy(), np.asarray(jhits))
    if valid:
        assert 0 < int(hits.sum()) < len(o)
    else:
        assert bool(hits.all())
        assert float(got[0].min()) == 2.0 and float(got[1].max()) == 6.0


@pytest.mark.parametrize("half", [2.5, 5.0, 8.0])
def test_segment_in_cube_matches_jax(half):
    o, d = _rays(2)
    got = occ.segment_in_cube(torch.from_numpy(o), torch.from_numpy(d), half,
                              2.0, 6.0)
    want = jocc.segment_in_cube(jnp.asarray(o), jnp.asarray(d), half, 2.0,
                                6.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dilate_matches_jax():
    rng = np.random.default_rng(3)
    m = rng.random((12, 12, 12)) < 0.02
    np.testing.assert_array_equal(
        occ._dilate(torch.from_numpy(m)).numpy(),
        np.asarray(jocc._dilate(jnp.asarray(m), 12)))
