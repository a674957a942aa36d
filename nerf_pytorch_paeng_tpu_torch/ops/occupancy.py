"""Conservative support bounds of a density field, for the culled frame
renderer's pre-cull (counterpart of the JAX package's ``ops/occupancy.py``:
``support_bounds_from_sigma``, ``frustum_union_mask``,
``ray_support_interval``, ``ray_hits_bounds``, ``segment_in_cube``).

A ray segment that never touches ``{x : sigma_raw(x) > 0}`` has zero
alpha at every sample, including the last one whose 1e10 bin distance
would blow any positive tail density up to full opacity.  The support is
estimated by evaluating the density logit on a G^3 grid over the cube
[-half_side, half_side]^3 (centred at the origin: the blender orbit
convention) and dilating the occupied cells by one in every direction.
If the dilated support touches the cube's boundary, or nothing is
occupied, the bounds are flagged invalid and certify nothing.  The grid
says nothing outside the cube, so a miss is only trusted for rays whose
whole [near, far] segment stays inside it (``segment_in_cube``).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

Bounds = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _dilate(m: torch.Tensor) -> torch.Tensor:
    """One-cell 6-neighbourhood closure of a [G, G, G] bool mask."""
    for ax in range(3):
        lo = torch.zeros_like(m)
        hi = torch.zeros_like(m)
        g = m.shape[ax]
        lo.narrow(ax, 0, g - 1).copy_(m.narrow(ax, 1, g - 1))
        hi.narrow(ax, 1, g - 1).copy_(m.narrow(ax, 0, g - 1))
        m = m | lo | hi
    return m


def grid_points(half_side: float, grid: int, device=None) -> torch.Tensor:
    """The [3, G^3] cell centres of the cube, x slowest (``ij`` order)."""
    cell = 2.0 * half_side / grid
    c = (torch.arange(grid, dtype=torch.float32, device=device) + 0.5) \
        * cell - half_side
    gx, gy, gz = torch.meshgrid(c, c, c, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)], 0)


def support_bounds_from_sigma(sigma_plane_fn: Callable, half_side: float,
                              grid: int = 128,
                              domain_mask: Optional[torch.Tensor] = None,
                              device=None) -> Bounds:
    """Bounding volume of {x : sigma_raw(x) > 0} within the origin cube.

    ``sigma_plane_fn``: xplane [3, P] float32 -> sigma_raw [P] (density
    logits before the ReLU; the renderer passes K7, ``fused_mlp_sigma``).
    ``domain_mask`` [G, G, G] bool restricts the measured support (sound
    only when every point tested against the bounds lies in the domain).

    Returns ``(lo [3], hi [3], radius [1], valid [1] bool)`` on ``device``:
    the dilated AABB of the occupied cells (cell outer corners), the
    bounding-sphere radius around the AABB centre (occupied cell centres
    plus the cell half-diagonal), and whether the bounds are usable.
    """
    cell = 2.0 * half_side / grid
    xplane = grid_points(half_side, grid, device)
    occ = (sigma_plane_fn(xplane).float() > 0.0).reshape(grid, grid, grid)
    if domain_mask is not None:
        occ = occ & domain_mask
    occ = _dilate(occ)

    any_occ = occ.any()
    idx = torch.arange(grid, dtype=torch.float32, device=occ.device)
    lo_list, hi_list = [], []
    touches = torch.zeros((), dtype=torch.bool, device=occ.device)
    for ax, other in enumerate(((1, 2), (0, 2), (0, 1))):
        line = occ.any(other[1]).any(other[0])                  # [G]
        i_lo = torch.where(line, idx, torch.full_like(idx, grid)).min()
        i_hi = torch.where(line, idx, torch.full_like(idx, -1.0)).max()
        lo_list.append(i_lo * cell - half_side)
        hi_list.append((i_hi + 1.0) * cell - half_side)
        touches = touches | line[0] | line[-1]
    lo = torch.stack(lo_list)
    hi = torch.stack(hi_list)

    c = 0.5 * (lo + hi)
    d2 = torch.sum((xplane.T - c) ** 2, -1).reshape(grid, grid, grid)
    r = torch.sqrt(torch.where(occ, d2, torch.zeros_like(d2)).max()) \
        + cell * 3.0 ** 0.5 / 2
    valid = any_occ & ~touches
    return lo, hi, r.reshape(1), valid.reshape(1)


def frustum_union_mask(poses, K, H: int, W: int, near: float, far: float,
                       half_side: float, grid: int, device=None
                       ) -> torch.Tensor:
    """[G, G, G] bool: the grid cells that may hold a training sample.  A
    cell is in when its centre lies in the union of the cameras' [near,
    far] frusta fattened by the cell half-diagonal r (depth by r, the pixel
    bounds by the factor 1 + r/t and the term f r / t: the perspective
    bound of a displacement <= r), then dilated by one cell.  The camera
    model is ``ops/rays.get_rays``'s: a point p sits at depth t on pixel
    (i, j) of camera [R | o] iff R^T (p - o) = t ((i - cx)/fx,
    -(j - cy)/fy, -1).

    The training pre-cull restricts the measured support to it: density
    the MLP puts where no training ray samples would otherwise reach the
    cube's boundary and invalidate the bounds.  The cameras are scanned
    with one [G^3] OR accumulator, never a [M, G^3] intermediate.

    poses [M, 3 or 4, 4] camera-to-world; K [3, 3]."""
    poses = torch.as_tensor(poses, dtype=torch.float32,
                            device=device)[:, :3, :4]
    K = torch.as_tensor(K, dtype=torch.float32, device=poses.device)
    cell = 2.0 * half_side / grid
    pts = grid_points(half_side, grid, poses.device).T            # [P, 3]
    r = (3.0 ** 0.5 / 2.0) * cell
    fx, fy, ci, cj = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    t_min = max(near - r, 1e-6)
    mask = torch.zeros(pts.shape[0], dtype=torch.bool, device=poses.device)
    for c2w in poses:
        p_cam = (pts - c2w[:, 3]) @ c2w[:, :3]                    # R^T (p - o)
        t = -p_cam[:, 2]
        safe_t = torch.where(t > 1e-6, t, torch.ones_like(t))
        i = ci + fx * (p_cam[:, 0] / safe_t)
        j = cj - fy * (p_cam[:, 1] / safe_t)
        scale = 1.0 + r / safe_t
        half_i = (torch.maximum(ci, (W - 1) - ci) + 1.0) * scale \
            + fx * r / safe_t
        half_j = (torch.maximum(cj, (H - 1) - cj) + 1.0) * scale \
            + fy * r / safe_t
        mask |= ((t >= t_min) & (t <= far + r) & ((i - ci).abs() <= half_i)
                 & ((j - cj).abs() <= half_j))
    return _dilate(mask.reshape(grid, grid, grid))


def ray_support_interval(rays_o: torch.Tensor, rays_d: torch.Tensor,
                         lo: torch.Tensor, hi: torch.Tensor,
                         radius: torch.Tensor, valid: torch.Tensor,
                         near: float, far: float
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-ray depth interval ``[t_lo, t_hi]`` outside which ``o + t d``
    lies outside the AABB or outside the bounding sphere (so outside the
    support): the slab interval, the sphere chord and [near, far]
    intersected.  A miss is an empty interval (t_lo > t_hi); invalid
    bounds give every ray [near, far].  rays [M, 3] -> ([M], [M])."""
    tiny = torch.where(rays_d < 0, torch.full_like(rays_d, -1e-12),
                       torch.full_like(rays_d, 1e-12))
    inv = 1.0 / torch.where(rays_d.abs() < 1e-12, tiny, rays_d)
    t1 = (lo[None] - rays_o) * inv
    t2 = (hi[None] - rays_o) * inv
    t_lo = torch.minimum(t1, t2).amax(-1)
    t_hi = torch.maximum(t1, t2).amin(-1)

    c = 0.5 * (lo + hi)
    oc = rays_o - c[None]
    dd = torch.clamp(torch.sum(rays_d * rays_d, -1), min=1e-12)
    b_half = torch.sum(oc * rays_d, -1)
    disc = b_half * b_half - dd * (torch.sum(oc * oc, -1) - radius[0] ** 2)
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    ts_lo = (-b_half - sq) / dd
    ts_hi = torch.where(disc >= 0.0, (-b_half + sq) / dd, ts_lo - 1.0)

    t_lo = torch.clamp(torch.maximum(t_lo, ts_lo), min=near)
    t_hi = torch.clamp(torch.minimum(t_hi, ts_hi), max=far)
    t_lo = torch.where(valid[0], t_lo, torch.full_like(t_lo, near))
    t_hi = torch.where(valid[0], t_hi, torch.full_like(t_hi, far))
    return t_lo, t_hi


def ray_hits_bounds(rays_o: torch.Tensor, rays_d: torch.Tensor,
                    lo: torch.Tensor, hi: torch.Tensor, radius: torch.Tensor,
                    valid: torch.Tensor, near: float, far: float
                    ) -> torch.Tensor:
    """True where ``ray_support_interval`` is non-empty (every ray when the
    bounds are invalid): [M] bool."""
    t_lo, t_hi = ray_support_interval(rays_o, rays_d, lo, hi, radius, valid,
                                      near, far)
    return t_lo <= t_hi


def segment_in_cube(rays_o: torch.Tensor, rays_d: torch.Tensor,
                    half_side: float, near: float, far: float
                    ) -> torch.Tensor:
    """True where the whole segment {o + t d : t in [near, far]} lies in
    the cube [-half_side, half_side]^3 (both ends inside suffices, the two
    being convex): [M] bool."""
    a = rays_o + near * rays_d
    b = rays_o + far * rays_d
    return (a.abs() <= half_side).all(-1) & (b.abs() <= half_side).all(-1)
