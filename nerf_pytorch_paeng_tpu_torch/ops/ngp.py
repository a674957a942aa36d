"""Volume rendering of marched samples: Instant-NGP's rays, whose samples
(``kernels/ngp_march.march``) are compacted in ray order and so ragged
per ray, where ``ops/volume`` composites dense [rays, samples] slabs.

- ``composite``: the per-ray compositing onto white, under autograd (the
  kernels forward and backward on the card, the plain version on the
  CPU);
- ``render_rays_ngp``: march, encode, both MLPs, composite -> the rays'
  colours and what the loss and the counters read (the kept rays, their
  samples), with no host read on the card;
- ``make_ngp_frame_renderer``: frames in blocks of rays, the budget of a
  block holding every sample of the block so that no ray is dropped,
  each ray at the middle of its first lattice interval (u = 0.5).

Spans: ``ngp.march``, ``ngp.encode`` and ``ngp.mlp`` (``models/ngp.py``),
``ngp.composite``.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..kernels import ngp_march
from ..kernels.ngp_march import MarchParams
from ..models.ngp import NGP
from ..utils.spans import span
from .rays import get_rays

DEFAULT_FRAME_BLOCK = 4096


class Composite(torch.autograd.Function):
    """The compositing kernels under autograd (CUDA tensors)."""

    @staticmethod
    def forward(ctx, sigma, rgb, counts, offsets, p: MarchParams):
        out, _, _ = ngp_march.composite_fwd(sigma, rgb, counts, offsets, p)
        ctx.save_for_backward(sigma, rgb, counts, offsets, out)
        ctx.p = p
        return out

    @staticmethod
    def backward(ctx, g):
        sigma, rgb, counts, offsets, out = ctx.saved_tensors
        g_sigma, g_rgb = ngp_march.composite_bwd(sigma, rgb, counts, offsets,
                                                 ctx.p, out, g)
        return g_sigma, g_rgb, None, None, None


def composite(sigma: torch.Tensor, rgb: torch.Tensor, counts: torch.Tensor,
              offsets: torch.Tensor, p: MarchParams) -> torch.Tensor:
    """The kept rays' colours [R, 3] (dropped rays: 0)."""
    if sigma.device.type == "cpu":
        return ngp_march.composite_plain(sigma, rgb, counts, offsets, p)[0]
    return Composite.apply(sigma, rgb, counts, offsets, p)


def render_rays_ngp(model: NGP, rays_o: torch.Tensor, rays_d: torch.Tensor,
                    u: torch.Tensor, p: MarchParams) -> Dict[str, torch.Tensor]:
    """World rays [R, 3], their uniforms [R] -> ``rgb`` [R, 3], ``kept``
    [R] (bool: the ray's samples fit the budget), ``stats`` (int32 [2]:
    kept rays, their samples)."""
    with span("ngp.march"):
        m = ngp_march.march(rays_o, rays_d, u, model.grid_bits, p)
        kept = m.offsets.long() + m.counts.long() <= p.budget
    sigma, rgb = model.field(m.pos, m.sh, m.stats[1:])
    with span("ngp.composite"):
        out = composite(sigma, rgb, m.counts, m.offsets, p)
    return dict(rgb=out, kept=kept, stats=m.stats)


def ngp_loss(out: Dict[str, torch.Tensor], target: torch.Tensor
             ) -> torch.Tensor:
    """The MSE over the kept rays' channels (no host read)."""
    k = out["kept"].to(target.dtype)
    sq = ((out["rgb"] - target) ** 2).sum(1) * k
    return sq.sum() / (3.0 * k.sum().clamp(min=1.0))


def make_ngp_frame_renderer(cfg, H: int, W: int, K, device,
                            block_rays: Optional[int] = None):
    """``render(model, c2w, generator=None) -> (rgb [H, W, 3], disp [H,
    W])``: blocks of ``block_rays`` rays (``cfg.chunk_rays``, else 4096)
    through the marcher at a budget of every candidate of the block.
    ``disp`` is 1 / max(1e-10, depth / acc), the depth in world units (0
    where nothing was hit)."""
    device = torch.device(device)
    block = int(block_rays or cfg.chunk_rays or DEFAULT_FRAME_BLOCK)
    K_t = torch.as_tensor(np.asarray(K), dtype=torch.float32, device=device)

    @torch.no_grad()
    def render(model: NGP, c2w, generator=None):
        c2w = torch.as_tensor(np.asarray(c2w)[:3, :4], dtype=torch.float32,
                              device=device)
        rays_o, rays_d = get_rays(H, W, K_t, c2w)
        rays_o, rays_d = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
        n = rays_o.shape[0]
        rgb = torch.empty((n, 3), device=device)
        disp = torch.empty(n, device=device)
        for a in range(0, n, block):
            o, d = rays_o[a:a + block], rays_d[a:a + block]
            r = o.shape[0]
            p = MarchParams.from_cfg(cfg, budget=r * ngp_march.MAX_STEPS)
            with span("ngp.march"):
                m = ngp_march.march(o, d, torch.full((r,), 0.5,
                                                     device=device),
                                    model.grid_bits, p)
            sigma, c = model.field(m.pos, m.sh, m.stats[1:])
            with span("ngp.composite"):
                out, depth, acc = ngp_march.composite_fwd(
                    sigma, c, m.counts, m.offsets, p, ts=m.ts)
            rgb[a:a + r] = out
            depth = depth / p.scale
            disp[a:a + r] = torch.where(
                acc > 0, 1.0 / torch.clamp(depth / acc.clamp(min=1e-10),
                                           min=1e-10), torch.zeros_like(acc))
        return rgb.reshape(H, W, 3), disp.reshape(H, W)

    render.route = "ngp"
    return render
