"""Volume rendering (alpha compositing) in the sample-major layout.

Counterpart of the JAX package's ``ops/volume.py`` (``weights_from_sigma_t``,
``volume_render_rays_t``), the layout the ray-major kernels emit: every
per-sample tensor is [S, N] and the scan runs along axis 0.

- dists = dz with a 1e10 cap for the last bin, scaled by ||ray_d||;
- alpha = 1 - exp(-relu(sigma) * dist);
- transmittance = exclusive cumprod of (1 - alpha + 1e-10);
- rgb = sum w * sigmoid(c) plus the unconditional white composite (1-acc);
- disparity = 1/max(1e-10, depth/acc) clamped at 5, computed NaN-free
  (acc == 0 gives 0).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

DISP_CLAMP = 5.0


class RenderOutputsT(NamedTuple):
    rgb: torch.Tensor       # [N, 3]
    disp: torch.Tensor      # [N]
    acc: torch.Tensor       # [N]
    weights: torch.Tensor   # [S, N]
    depth: torch.Tensor     # [N]


def _dists_t(z_t: torch.Tensor, rays_d: torch.Tensor) -> torch.Tensor:
    d = z_t[1:] - z_t[:-1]
    d = torch.cat([d, torch.full_like(d[:1], 1e10)], 0)
    return d * torch.linalg.norm(rays_d, dim=-1)[None]


def weights_from_sigma_t(sigma_t: torch.Tensor, z_t: torch.Tensor,
                         rays_d: torch.Tensor) -> torch.Tensor:
    """Compositing weights from density logits: [S, N] -> [S, N]."""
    dists = _dists_t(z_t, rays_d)
    alpha = 1.0 - torch.exp(-torch.relu(sigma_t.float()) * dists)
    trans = torch.cumprod(torch.cat(
        [torch.ones_like(alpha[:1]), 1.0 - alpha + 1e-10], 0), 0)[:-1]
    return alpha * trans


def _disp_from(depth_map: torch.Tensor, acc_map: torch.Tensor
               ) -> torch.Tensor:
    safe_acc = torch.where(acc_map > 0.0, acc_map, torch.ones_like(acc_map))
    disp = 1.0 / torch.clamp(depth_map / safe_acc, min=1e-10)
    disp = torch.clamp(disp, max=DISP_CLAMP)
    return torch.where(acc_map == 0.0, torch.zeros_like(disp), disp)


def volume_render_rays_t(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                         sigma: torch.Tensor, z_t: torch.Tensor,
                         rays_d: torch.Tensor) -> RenderOutputsT:
    """Composite raw [S, N] logits along axis 0; rays_d is [N, 3]."""
    weights = weights_from_sigma_t(sigma, z_t, rays_d)          # [S, N]
    rgb_map = torch.stack(
        [torch.sum(weights * torch.sigmoid(c.float()), 0) for c in (r, g, b)],
        -1)                                                     # [N, 3]
    depth_map = torch.sum(weights * z_t, 0)
    acc_map = torch.sum(weights, 0)
    disp_map = _disp_from(depth_map, acc_map)
    rgb_map = rgb_map + (1.0 - acc_map[..., None])
    return RenderOutputsT(rgb_map, disp_map, acc_map, weights, depth_map)
