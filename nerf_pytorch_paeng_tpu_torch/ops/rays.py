"""Camera rays and training pixel sampling (counterpart of the JAX
package's ``ops/rays.py``).

Pinhole directions ``[(i-cx)/fx, -(j-cy)/fy, -1]`` rotated by the
camera-to-world rotation; origins are the camera centre.  ``ndc_rays``
projects forward-facing (LLFF) rays into normalised device coordinates.
Pixel choice takes an explicit ``torch.Generator`` or injected flat
indices, so tests can feed both packages the same draws.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _pixel_dirs(H: int, W: int, K, device) -> torch.Tensor:
    """[H, W, 3] camera-frame directions."""
    K = torch.as_tensor(K, dtype=torch.float32, device=device)
    i = torch.arange(W, dtype=torch.float32, device=device)
    j = torch.arange(H, dtype=torch.float32, device=device)
    jj, ii = torch.meshgrid(j, i, indexing="ij")             # [H, W]
    return torch.stack(
        [(ii - K[0, 2]) / K[0, 0], -(jj - K[1, 2]) / K[1, 1],
         -torch.ones_like(ii)], dim=-1)


def get_rays(H: int, W: int, K, c2w: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel world-space ray origins/directions for one camera.

    K: [3,3] intrinsics (array-like); c2w: [3,4] or [4,4] tensor whose
    device the rays take.  Returns rays_o, rays_d, each [H,W,3].
    """
    c2w = c2w[:3, :4].to(torch.float32)
    rays_d = _pixel_dirs(H, W, K, c2w.device) @ c2w[:3, :3].T
    rays_o = c2w[:3, -1].expand(rays_d.shape)
    return rays_o, rays_d


def get_rays_batched(H: int, W: int, K, c2ws: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rays for a stack of poses: c2ws [T,3or4,4] -> ([T,H,W,3], [T,H,W,3])."""
    c2ws = c2ws[:, :3, :4].to(torch.float32)
    rays_d = _pixel_dirs(H, W, K, c2ws.device)[None] @ \
        c2ws[:, None, :3, :3].transpose(-1, -2)              # [T, H, W, 3]
    rays_o = c2ws[:, None, None, :3, -1].expand(rays_d.shape)
    return rays_o, rays_d


def ndc_rays(H: int, W: int, focal: float, near: float,
             rays_o: torch.Tensor, rays_d: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shift the origins to the plane z = -near and project the rays into
    NDC space (reference nerf_process.py:8-28); the LLFF path applies it
    with near = 1.  rays [..., 3] float32 -> (rays_o, rays_d) [..., 3]."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    o0 = -1.0 / (W / (2.0 * focal)) * rays_o[..., 0] / rays_o[..., 2]
    o1 = -1.0 / (H / (2.0 * focal)) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]

    d0 = -1.0 / (W / (2.0 * focal)) * (
        rays_d[..., 0] / rays_d[..., 2] - rays_o[..., 0] / rays_o[..., 2])
    d1 = -1.0 / (H / (2.0 * focal)) * (
        rays_d[..., 1] / rays_d[..., 2] - rays_o[..., 1] / rays_o[..., 2])
    d2 = -2.0 * near / rays_o[..., 2]

    return torch.stack([o0, o1, o2], -1), torch.stack([d0, d1, d2], -1)


def sample_pixels(H: int, W: int, n_rays: int, precrop: bool = False,
                  precrop_frac: float = 0.5,
                  generator: Optional[torch.Generator] = None,
                  flat: Optional[torch.Tensor] = None,
                  device=None) -> torch.Tensor:
    """Choose ``n_rays`` pixel (row, col) coords without replacement ->
    int64 [n_rays, 2].  With ``precrop`` the candidates are the centre
    crop of fractional size ``precrop_frac``.  ``flat`` injects the draws:
    indices into the (cropped) candidate set, row-major."""
    if precrop:
        dH, dW = int(H // 2 * precrop_frac), int(W // 2 * precrop_frac)
        rows0, cols0, nH, nW = H // 2 - dH, W // 2 - dW, 2 * dH, 2 * dW
    else:
        rows0 = cols0 = 0
        nH, nW = H, W
    if n_rays > nH * nW:
        raise ValueError(f"{n_rays} rays from {nH}x{nW} candidate pixels")
    if flat is None:
        flat = torch.randperm(nH * nW, generator=generator,
                              device=device)[:n_rays]
    return torch.stack([rows0 + flat // nW, cols0 + flat % nW], -1)


def gather_rays(rays_o: torch.Tensor, rays_d: torch.Tensor,
                img: torch.Tensor, coords: torch.Tensor):
    """Index [H,W,3] fields by [N,2] (row, col) coords -> three [N,3]."""
    r, c = coords[:, 0], coords[:, 1]
    return rays_o[r, c], rays_d[r, c], img[r, c]
