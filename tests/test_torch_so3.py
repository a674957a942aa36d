"""The port's ``ops/so3.py`` against the JAX package's: ``vec2skew`` and
``so3_exp`` on seeded batched axis-angle vectors, at angles 0, 1e-8
(both in the small-angle branch), 1e-3 and near pi, and their autograd
gradients against ``jax.grad``.

Tolerances: values to 1e-6 absolute (float32 rotations, entries <= 1; the
port takes the angle as sqrt(|r|^2), JAX as ``norm``: a rounding apart);
gradients to 1e-5 relative, with the same absolute floor.  At exactly
theta = 0 JAX's gradient is nan (its ``norm``'s square root has an infinite
derivative there, times a zero cotangent); the port's is the limit, held
against ``jax.grad`` at theta = 1e-8 on the same axis and against the
analytic derivative of the skew term alone, which is all of R's first
order there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_pytorch_paeng_tpu.ops.so3 import so3_exp as jax_so3_exp
from nerf_pytorch_paeng_tpu.ops.so3 import vec2skew as jax_vec2skew
from nerf_pytorch_paeng_tpu_torch.ops import so3_exp, vec2skew

ANGLES = (0.0, 1e-8, 1e-3, 0.5, np.pi - 1e-3)


def _axis_angles(seed: int = 0, n: int = 4) -> np.ndarray:
    """[len(ANGLES), n, 3]: n seeded unit axes at each angle of ANGLES."""
    rng = np.random.default_rng(seed)
    ax = rng.normal(size=(n, 3))
    ax /= np.linalg.norm(ax, axis=-1, keepdims=True)
    return np.stack([a * ax for a in ANGLES]).astype(np.float32)


def test_vec2skew_matches_jax():
    v = np.random.default_rng(1).normal(size=(2, 5, 3)).astype(np.float32)
    got = vec2skew(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_vec2skew(
        jnp.asarray(v))))
    # K v = v x v = 0 and K^T = -K
    np.testing.assert_allclose(np.einsum("...ij,...j->...i", got, v), 0,
                               atol=1e-6)
    np.testing.assert_array_equal(got, -np.swapaxes(got, -1, -2))


@pytest.mark.parametrize("i", range(len(ANGLES)), ids=[f"theta={a:g}"
                                                      for a in ANGLES])
def test_so3_exp_matches_jax(i):
    r = _axis_angles()[i]
    got = so3_exp(torch.from_numpy(r)).numpy()
    want = np.asarray(jax_so3_exp(jnp.asarray(r)))
    assert got.shape == (4, 3, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # a rotation: R R^T = I, det R = 1
    np.testing.assert_allclose(got @ np.swapaxes(got, -1, -2),
                               np.broadcast_to(np.eye(3), got.shape),
                               atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(got), 1.0, atol=1e-5)


def _scalar_weights():
    return np.random.default_rng(3).normal(size=(3, 3)).astype(np.float32)


def _port_grad(r: np.ndarray) -> np.ndarray:
    t = torch.from_numpy(r).requires_grad_(True)
    torch.sum(so3_exp(t) * torch.from_numpy(_scalar_weights())).backward()
    return t.grad.numpy()


def _jax_grad(r: np.ndarray) -> np.ndarray:
    w = jnp.asarray(_scalar_weights())
    return np.asarray(jax.grad(lambda x: jnp.sum(jax_so3_exp(x) * w))(
        jnp.asarray(r)))


@pytest.mark.parametrize("i", range(1, len(ANGLES)), ids=[
    f"theta={a:g}" for a in ANGLES[1:]])
def test_so3_exp_gradient_matches_jax_grad(i):
    for r in _axis_angles(seed=5, n=3)[i]:
        np.testing.assert_allclose(_port_grad(r), _jax_grad(r), rtol=1e-5,
                                   atol=1e-5)


def test_so3_exp_gradient_at_zero_is_the_limit():
    zero = np.zeros(3, np.float32)
    got = _port_grad(zero)
    assert np.all(np.isfinite(got))
    assert np.all(np.isnan(_jax_grad(zero)))        # JAX's norm at 0
    for ax in np.eye(3, dtype=np.float32):
        np.testing.assert_allclose(got, _jax_grad(1e-8 * ax), rtol=1e-5,
                                   atol=1e-5)
    # d/dr sum(w * (I + K(r) + K(r)^2 / 2)) at r = 0: the skew term alone
    w = _scalar_weights()
    want = np.array([w[2, 1] - w[1, 2], w[0, 2] - w[2, 0],
                     w[1, 0] - w[0, 1]])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
