"""Shared inputs for the port-vs-JAX tests (tests/test_torch_*.py): one
numpy-seeded parameter tree in the JAX package's flax layout, handed to
both packages, so each side sees the same weights."""
from __future__ import annotations

import numpy as np

WIDTH = 256


def np_mlp_params(rng: np.random.Generator, L_x: int = 10, L_d: int = 4,
                  depth: int = 8, width: int = WIDTH) -> dict:
    """One NeRFMLP tree {layer: {kernel [in, out], bias [out]}} with the
    models' init scales (Xavier kernels, U(+-1/sqrt(fan_in)) biases)."""
    in_x, in_d = 3 + 6 * L_x, 3 + 6 * L_d
    shapes = {f"trunk_{i}": (in_x if i == 0 else
                             width + (in_x if i == 5 else 0), width)
              for i in range(depth)}
    shapes.update(density=(width, 1), feature=(width, width),
                  view=(width + in_d, width // 2), color=(width // 2, 3))
    out = {}
    for name, (fi, fo) in shapes.items():
        a = np.sqrt(6.0 / (fi + fo))
        out[name] = {
            "kernel": rng.uniform(-a, a, (fi, fo)).astype(np.float32),
            "bias": rng.uniform(-1 / np.sqrt(fi), 1 / np.sqrt(fi),
                                (fo,)).astype(np.float32)}
    return out


def np_nerf_params(seed: int = 0, **kw) -> dict:
    rng = np.random.default_rng(seed)
    return {"coarse": np_mlp_params(rng, **kw),
            "fine": np_mlp_params(rng, **kw)}


def to_jax(tree):
    import jax
    import jax.numpy as jnp
    return jax.tree_util.tree_map(jnp.asarray, tree)


def np_rays(rng: np.random.Generator, n: int, s: int, near=2.0, far=6.0):
    """od [8, n] (orbit-like origins, unnormalised directions toward the
    origin region) and sorted z_t [s, n] in [near, far]."""
    o = rng.normal(0, 0.3, (3, n)) + np.array([[0.0], [0.0], [4.0]])
    d = rng.normal(0, 0.3, (3, n)) - o / 4.0
    od = np.concatenate([o, d, np.zeros((2, n))], 0).astype(np.float32)
    z = np.sort(rng.uniform(near, far, (s, n)), 0).astype(np.float32)
    return od, z
