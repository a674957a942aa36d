"""Sample-axis sharding over the model group (``sp_shards > 1``;
counterpart of the JAX package's ``parallel/sp.py``).

Each rank of the model group holds a contiguous ``S / n`` slice of every
ray's samples and evaluates the field on its slice alone.  The
transmittance is an exclusive product along the sample axis; in log space
it is a prefix sum, which splits over the ranks:

- the last bin of a slice needs the next rank's first depth: an
  ``all_gather`` of every rank's first depth column (``N`` floats; JAX
  takes it with a ``ppermute``);
- each rank's inclusive log-cumsum, plus the exclusive prefix of the
  ranks' totals, a masked sum of their ``all_gather`` (JAX ``:77-79``);
- rgb, depth and acc are sums of weighted terms: one ``all_reduce`` of
  the rank's partial sums.

Only ``all_reduce``, ``all_gather`` and ``broadcast`` are used: NCCL and
gloo carry all three on CUDA tensors.  Every function here is called by
every rank of the group with inputs alike there (rays, depths of every
slice), and returns the same rgb, disparity and acc on every rank.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..ops.render import direction_plane, hierarchical_z_vals, position_plane
from ..ops.volume import RenderOutputs, _disp_from
from .mesh import Group, model_group
from .sharding import all_gather_cat, all_reduce_sum


def _cols(s: int, group: Group) -> slice:
    """This rank's contiguous columns of an ``s``-sample axis."""
    k = s // group.size
    return slice(group.index * k, (group.index + 1) * k)


def composite_sample_sharded(raw: torch.Tensor, z_vals: torch.Tensor,
                             rays_d: torch.Tensor,
                             group: Optional[Group] = None) -> RenderOutputs:
    """Volume rendering with the sample axis split over ``group``
    (default: the model group); the math of ``ops/volume
    .volume_render_planar`` as a distributed log-space prefix sum.

    raw [4, N, S_local] this rank's field outputs (rgb logits 0-2, sigma
    logit 3), z_vals [N, S_local] its contiguous slice of the sorted
    depths, rays_d [N, 3].  Returns rgb, disp, acc and depth of the whole
    rays (alike on every rank) and this rank's [N, S_local] weights."""
    g = group or model_group()
    idx, n_sh = g.index, g.size
    raw = raw.float()

    # bin widths: the slice's last bin ends at the next rank's first depth
    firsts = all_gather_cat(z_vals[:, :1], -1, g)            # [N, n_sh]
    if idx == n_sh - 1:
        last = torch.full_like(z_vals[:, :1], 1e10)
    else:
        last = firsts[:, idx + 1:idx + 2] - z_vals[:, -1:]
    dists = torch.cat([z_vals[:, 1:] - z_vals[:, :-1], last], -1)
    dists = dists * torch.linalg.norm(rays_d, dim=-1)[:, None]

    rgb = torch.sigmoid(raw[0:3])                            # [3, N, S_l]
    alpha = 1.0 - torch.exp(-torch.relu(raw[3]) * dists)     # [N, S_l]

    # exclusive cumprod in log space across the ranks; the clamp before
    # the log as in ops/volume.exclusive_cumprod's associative form
    logt = torch.log(torch.clamp(1.0 - alpha + 1e-10, min=1e-10))
    local_inc = torch.cumsum(logt, -1)                       # inclusive
    totals = all_gather_cat(local_inc[:, -1:], -1, g)        # [N, n_sh]
    mask = (torch.arange(n_sh, device=totals.device) < idx).float()
    prefix = torch.sum(totals * mask, -1, keepdim=True)      # [N, 1]
    weights = alpha * torch.exp(prefix + local_inc - logt)

    # the partial weighted sums of every rank, one all-reduce
    sums = all_reduce_sum(torch.cat([
        torch.sum(weights[None] * rgb, -1),                  # [3, N]
        torch.sum(weights * z_vals, -1)[None],
        torch.sum(weights, -1)[None]]), g)
    rgb_map, depth_map, acc_map = sums[0:3].T, sums[3], sums[4]
    disp_map = _disp_from(depth_map, acc_map)
    rgb_map = rgb_map + (1.0 - acc_map[..., None])
    return RenderOutputs(rgb_map, disp_map, acc_map, weights, depth_map)


def _field_planes(fn: Callable, rays_o, rays_d, viewdirs, z):
    """The field on the planes of depths z [N, S] -> raw [4, N, S]."""
    n, s = z.shape
    return fn(position_plane(rays_o, rays_d, z),
              direction_plane(viewdirs, s)).reshape(4, n, s)


def make_sample_sharded_render(field_fn: Callable,
                               group: Optional[Group] = None) -> Callable:
    """``render(rays_o [N, 3], rays_d [N, 3], z_vals [N, S]) -> (rgb,
    disp, acc)``: one pass with each rank of ``group`` evaluating
    ``field_fn`` on its slice of the samples (every rank is given every
    depth and takes its columns), equal to the unsharded render."""
    def render(rays_o, rays_d, z_vals):
        g = group or model_group()
        z_local = z_vals[:, _cols(z_vals.shape[-1], g)]
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        out = composite_sample_sharded(
            _field_planes(field_fn, rays_o, rays_d, viewdirs, z_local),
            z_local, rays_d, g)
        return out.rgb, out.disp, out.acc
    return render


def sp_coarse_fine(coarse_fn: Callable, fine_fn: Callable,
                   rays_o: torch.Tensor, rays_d: torch.Tensor,
                   z_local: torch.Tensor, *, n_fine: int, perturb: float,
                   u: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   group: Optional[Group] = None):
    """The coarse (+ fine) passes with the samples split over ``group``:
    the shared body of ``make_sample_sharded_render_full`` and the frame
    renderer (``eval/frame._make_sp_frame_renderer``).

    z_local [N, S_c / n] this rank's coarse slice.  The coarse weights
    are gathered to [N, S_c] and the inverse-CDF resample runs alike on
    every rank (the same uniforms ``u`` [N, n_fine], or the same
    generator state); each rank then takes its contiguous
    (S_c + n_fine) / n columns of the merged depths for the fine pass.
    Returns (coarse RenderOutputs, fine RenderOutputs or None)."""
    g = group or model_group()
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    out_c = composite_sample_sharded(
        _field_planes(coarse_fn, rays_o, rays_d, viewdirs, z_local),
        z_local, rays_d, g)
    if n_fine <= 0:
        return out_c, None
    w_full = all_gather_cat(out_c.weights, -1, g)            # [N, S_c]
    z_full = all_gather_cat(z_local, -1, g)
    z_all = hierarchical_z_vals(z_full, w_full, n_fine=n_fine,
                                perturb=perturb, generator=generator, u=u)
    s_merged = z_all.shape[-1]
    if s_merged % g.size:
        raise ValueError(f"the sample-sharded fine pass needs S_c + n_fine "
                         f"= {s_merged} divisible by {g.size} ranks")
    z_f_local = z_all[:, _cols(s_merged, g)].contiguous()
    out_f = composite_sample_sharded(
        _field_planes(fine_fn, rays_o, rays_d, viewdirs, z_f_local),
        z_f_local, rays_d, g)
    return out_c, out_f


def make_sample_sharded_render_full(coarse_fn: Callable, fine_fn: Callable,
                                    *, n_fine: int, perturb: float = 1.0,
                                    group: Optional[Group] = None
                                    ) -> Callable:
    """``render(rays_o, rays_d, z_vals [N, S_c], u=None, generator=None)
    -> (rgb_c, rgb_f, disp_f, acc_f)``: coarse and fine passes with the
    samples split over ``group`` (every rank is given every coarse depth
    and takes its columns), equal to the unsharded render at the same
    draws."""
    def render(rays_o, rays_d, z_vals, u=None, generator=None):
        g = group or model_group()
        out_c, out_f = sp_coarse_fine(
            coarse_fn, fine_fn, rays_o, rays_d,
            z_vals[:, _cols(z_vals.shape[-1], g)], n_fine=n_fine,
            perturb=perturb, u=u, generator=generator, group=g)
        return out_c.rgb, out_f.rgb, out_f.disp, out_f.acc
    return render
