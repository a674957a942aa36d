"""Volume rendering (alpha compositing).

Counterpart of the JAX package's ``ops/volume.py`` in its two layouts:
the sample-major one the ray-major kernels emit (``weights_from_sigma_t``,
``volume_render_rays_t``: every per-sample tensor is [S, N], the scan runs
along axis 0) and the ray-major one of the plane layout
(``weights_from_sigma``, ``volume_render_planar``: [N, S], raw [4, N, S],
the scan along the last axis; ``volume_render``: raw [N, S, 4], the JAX
package's public layout).  Both share ``_weights``; the transmittance
is the ``cumprod`` form of ``exclusive_cumprod``.  Its log-space form
(``scan_impl="associative"``, a prefix sum of logs) is the one-device form
of the sample-sharded path's distributed scan (``parallel/sp.py``).

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


class RenderOutputs(NamedTuple):
    rgb: torch.Tensor       # [N, 3]
    disp: torch.Tensor      # [N]
    acc: torch.Tensor       # [N]
    weights: torch.Tensor   # [N, S]
    depth: torch.Tensor     # [N]


class RenderOutputsT(NamedTuple):
    rgb: torch.Tensor       # [N, 3]
    disp: torch.Tensor      # [N]
    acc: torch.Tensor       # [N]
    weights: torch.Tensor   # [S, N]
    depth: torch.Tensor     # [N]


class _Cumprod(torch.autograd.Function):
    """``torch.cumprod`` whose backward is the formula PyTorch's own takes
    for an input without zeros, reversed_cumsum(out * grad) / x, bit for
    bit, without PyTorch's host check for zeros (a ``.item()``, which no
    CUDA graph can hold: ``train/chunk.py`` captures the step).  The
    transmittance's factors 1 - alpha + 1e-10 are never 0."""

    @staticmethod
    def forward(ctx, x, dim):
        out = torch.cumprod(x, dim)
        ctx.save_for_backward(x, out)
        ctx.dim = dim
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        d = ctx.dim
        return (out * grad).flip(d).cumsum(d).flip(d).div(x), None


def exclusive_cumprod(x: torch.Tensor, axis: int = -1,
                      scan_impl: str = "cumprod") -> torch.Tensor:
    """out[i] = prod(x[:i]) along ``axis``, out[0] = 1.  ``scan_impl``
    "associative": exp of the exclusive prefix sum of log(x), the JAX
    package's log-space scan, which splits over shards of the axis."""
    if scan_impl == "associative":
        # clamp before the log: callers pass x = 1 - alpha + 1e-10, which
        # a compiler may reassociate into (1 + 1e-10) - alpha, exactly 0 at
        # alpha == 1 in float32; log(0) = -inf would then make the prefix
        # -inf - -inf = NaN
        logs = torch.log(torch.clamp(x, min=1e-10))
        return torch.exp(torch.cumsum(logs, axis) - logs)
    ones = torch.ones_like(x.narrow(axis, 0, 1))
    prod = _Cumprod.apply(torch.cat([ones, x], axis), axis)
    return prod.narrow(axis, 0, x.shape[axis])


def _dists(z: torch.Tensor, rays_d: torch.Tensor, axis: int) -> torch.Tensor:
    """dz with a 1e10 cap for the last bin, scaled by ||ray_d||; ``axis``
    is the sample axis: 0 for [S, N], -1 for [N, S]."""
    n = z.shape[axis]
    d = z.narrow(axis, 1, n - 1) - z.narrow(axis, 0, n - 1)
    d = torch.cat([d, torch.full_like(d.narrow(axis, 0, 1), 1e10)], axis)
    norm = torch.linalg.norm(rays_d, dim=-1)
    return d * (norm[None] if axis == 0 else norm[..., None])


def _weights(sigma: torch.Tensor, z: torch.Tensor, rays_d: torch.Tensor,
             axis: int, scan_impl: str = "cumprod") -> torch.Tensor:
    """Compositing weights from density logits (before the ReLU)."""
    alpha = 1.0 - torch.exp(-torch.relu(sigma.float()) * _dists(z, rays_d,
                                                                axis))
    return alpha * exclusive_cumprod(1.0 - alpha + 1e-10, axis, scan_impl)


def weights_from_sigma_t(sigma_t: torch.Tensor, z_t: torch.Tensor,
                         rays_d: torch.Tensor) -> torch.Tensor:
    """Compositing weights from density logits: [S, N] -> [S, N]."""
    return _weights(sigma_t, z_t, rays_d, 0)


def weights_from_sigma(sigma: torch.Tensor, z_vals: torch.Tensor,
                       rays_d: torch.Tensor) -> torch.Tensor:
    """The same in the ray-major layout: [N, S] -> [N, S] (the plane
    layout's density-only coarse pass)."""
    return _weights(sigma, z_vals, rays_d, -1)


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


def volume_render(raw: torch.Tensor, z_vals: torch.Tensor,
                  rays_d: torch.Tensor, scan_impl: str = "cumprod"
                  ) -> RenderOutputs:
    """Composite raw MLP outputs [N, S, 4] (rgb logits, density logit)
    along each ray; z_vals [N, S], rays_d [N, 3] unnormalised.
    ``scan_impl`` as in ``exclusive_cumprod``."""
    raw = raw.float()
    weights = _weights(raw[..., 3], z_vals, rays_d, -1, scan_impl)  # [N, S]
    rgb_map = torch.sum(weights[..., None] * torch.sigmoid(raw[..., :3]), -2)
    depth_map = torch.sum(weights * z_vals, -1)
    acc_map = torch.sum(weights, -1)
    disp_map = _disp_from(depth_map, acc_map)
    rgb_map = rgb_map + (1.0 - acc_map[..., None])
    return RenderOutputs(rgb_map, disp_map, acc_map, weights, depth_map)


def volume_render_planar(raw: torch.Tensor, z_vals: torch.Tensor,
                         rays_d: torch.Tensor) -> RenderOutputs:
    """Composite channel-planar raw logits [4, N, S] (rgb rows 0-2, sigma
    row 3: the plane kernels' [4, P] output reshaped) along the last
    axis; z_vals [N, S], rays_d [N, 3]."""
    raw = raw.float()
    weights = _weights(raw[3], z_vals, rays_d, -1)                 # [N, S]
    rgb_map = torch.sum(weights[None] * torch.sigmoid(raw[0:3]), -1).T
    depth_map = torch.sum(weights * z_vals, -1)
    acc_map = torch.sum(weights, -1)
    disp_map = _disp_from(depth_map, acc_map)
    rgb_map = rgb_map + (1.0 - acc_map[..., None])
    return RenderOutputs(rgb_map, disp_map, acc_map, weights, depth_map)
