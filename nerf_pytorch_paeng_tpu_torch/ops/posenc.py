"""Positional (Fourier-feature) encoding.

Counterpart of the JAX package's ``ops/posenc.py`` and of the fused
kernels' in-kernel embedding (``kernels/fused_mlp.py::_build_emb``):

- ``positional_encoding`` is the reference layout
  [x, sin(2^0 x), cos(2^0 x), sin(2^1 x), ...] with no pi factor, used by
  the plain ``NeRF`` module;
- ``build_emb`` is the kernels' layout [x, sin f0..f(L-1), cos f0..f(L-1),
  zero pad], point-major [..., rows], whose sin/cos(2^j x) come from the
  double-angle recurrence (sin 2t = 2 sin t cos t, cos 2t = 1 - 2 sin^2 t)
  exactly as the CUDA kernels compute them.  ``kernels/fused_mlp.py``
  permutes the first-layer weight rows to this order when it packs.
"""
from __future__ import annotations

import torch


def posenc_out_dim(L: int, input_dim: int = 3) -> int:
    """3 + 3*2L: 63 for L=10, 27 for L=4."""
    return input_dim + input_dim * 2 * L


def positional_encoding(x: torch.Tensor, L: int) -> torch.Tensor:
    """Encode ``x[..., D]`` -> ``[..., D + 2*L*D]`` (reference layout)."""
    if L == 0:
        return x
    freqs = 2.0 ** torch.arange(L, dtype=x.dtype, device=x.device)
    xb = x[..., None, :] * freqs[:, None]                    # [..., L, D]
    enc = torch.stack([torch.sin(xb), torch.cos(xb)], dim=-2)  # [..., L, 2, D]
    enc = enc.reshape(*x.shape[:-1], L * 2 * x.shape[-1])
    return torch.cat([x, enc], dim=-1)


def build_emb(x: torch.Tensor, L: int, rows: int) -> torch.Tensor:
    """[..., 3] float32 coords -> [..., rows] float32 embedding in the
    kernels' layout (double-angle recurrence, zero padded to ``rows``)."""
    s, c = torch.sin(x), torch.cos(x)
    sins, coss = [s], [c]
    for _ in range(L - 1):
        s, c = 2.0 * s * c, 1.0 - 2.0 * s * s
        sins.append(s)
        coss.append(c)
    pad = x.new_zeros(*x.shape[:-1], rows - 3 - 6 * L)
    return torch.cat([x, *sins, *coss, pad], dim=-1)
