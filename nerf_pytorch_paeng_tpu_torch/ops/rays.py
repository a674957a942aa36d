"""Camera rays (counterpart of the JAX package's ``ops/rays.get_rays``).

Pinhole directions ``[(i-cx)/fx, -(j-cy)/fy, -1]`` rotated by the
camera-to-world rotation; origins are the camera centre.  NDC projection
(LLFF) is not ported yet.
"""
from __future__ import annotations

from typing import Tuple

import torch


def get_rays(H: int, W: int, K, c2w: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel world-space ray origins/directions for one camera.

    K: [3,3] intrinsics (array-like); c2w: [3,4] or [4,4] tensor whose
    device and dtype the rays take.  Returns rays_o, rays_d, each [H,W,3].
    """
    c2w = c2w[:3, :4].to(torch.float32)
    K = torch.as_tensor(K, dtype=torch.float32, device=c2w.device)
    i = torch.arange(W, dtype=torch.float32, device=c2w.device)
    j = torch.arange(H, dtype=torch.float32, device=c2w.device)
    jj, ii = torch.meshgrid(j, i, indexing="ij")             # [H, W]
    dirs = torch.stack(
        [(ii - K[0, 2]) / K[0, 0], -(jj - K[1, 2]) / K[1, 1],
         -torch.ones_like(ii)], dim=-1)                      # [H, W, 3]
    rays_d = dirs @ c2w[:3, :3].T
    rays_o = c2w[:3, -1].expand(rays_d.shape)
    return rays_o, rays_d
