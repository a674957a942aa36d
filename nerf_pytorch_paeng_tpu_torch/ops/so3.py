"""SO(3) helpers: the axis-angle (Rodrigues) exponential map.

Counterpart of the JAX package's ``ops/so3.py`` (the reference's
``model/NeRFHelper.py`` ``vec2skew`` / ``Exp``): working, differentiable
ops, so that a pose-refinement extension can take gradients through
camera extrinsics.
"""
from __future__ import annotations

import torch


def vec2skew(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] skew-symmetric cross-product matrix."""
    zero = torch.zeros_like(v[..., 0])
    rows = [
        torch.stack([zero, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], zero, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], zero], -1),
    ]
    return torch.stack(rows, -2)


def so3_exp(r: torch.Tensor, eps: float = 1e-15) -> torch.Tensor:
    """Axis-angle [..., 3] -> rotation matrix [..., 3, 3] (Rodrigues).

    R = I + sin(t)/t K + (1 - cos(t))/t^2 K^2, t = ||r||, with the JAX
    package's small-angle branches (t < 1e-6: 1 - t^2/6 and 1/2 - t^2/24)
    and its clamped denominators, both branches under ``torch.where``.
    The norm is taken as sqrt(max(|r|^2, eps^2)) - the value of ||r|| for
    every |r| >= eps - so that its gradient stays finite at r = 0, where
    the small-angle branch's gradient (through t^2) is the exact one."""
    t2 = torch.sum(r * r, -1, keepdim=True)[..., None]           # [..., 1, 1]
    theta = torch.sqrt(torch.clamp(t2, min=eps * eps))
    k = vec2skew(r)
    eye = torch.eye(3, dtype=r.dtype, device=r.device).expand(k.shape)
    small = theta < 1e-6
    a = torch.where(small, 1.0 - t2 / 6.0,
                    torch.sin(theta) / torch.clamp(theta, min=eps))
    b = torch.where(small, 0.5 - t2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.clamp(t2, min=eps))
    return eye + a * k + b * (k @ k)
