"""Stratified and hierarchical (inverse-CDF) depth sampling along rays.

Counterpart of the JAX package's ``ops/sampling.py``.  Every sampler takes
its uniforms either from an explicit ``torch.Generator`` or injected as
``u=`` (tests feed both packages the same draws).
"""
from __future__ import annotations

from typing import Optional

import torch


def stratified_z_vals(n_rays: int, near: float, far: float, n_samples: int,
                      perturb: bool = True,
                      generator: Optional[torch.Generator] = None,
                      u: Optional[torch.Tensor] = None,
                      device=None) -> torch.Tensor:
    """[n_rays, n_samples] jittered (or uniform) depths in [near, far]."""
    t = torch.linspace(0.0, 1.0, n_samples, dtype=torch.float32,
                       device=device)
    z = (near * (1.0 - t) + far * t).expand(n_rays, n_samples)
    if not perturb:
        return z.contiguous()
    mids = 0.5 * (z[..., 1:] + z[..., :-1])
    upper = torch.cat([mids, z[..., -1:]], -1)
    lower = torch.cat([z[..., :1], mids], -1)
    if u is None:
        u = torch.rand((n_rays, n_samples), generator=generator,
                       dtype=torch.float32, device=device)
    return lower + (upper - lower) * u


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int,
               det: bool = False, generator: Optional[torch.Generator] = None,
               u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse-CDF sample ``n_samples`` depths from a per-ray histogram.

    bins [N, B] bin edges, weights [N, B-1] unnormalised masses; ``det``
    uses linspace u's instead of uniform draws.  Returns [N, n_samples].
    """
    shape = (*weights.shape[:-1], n_samples)
    if u is None:
        if det:
            u = torch.linspace(0.0, 1.0, n_samples, dtype=torch.float32,
                               device=weights.device).expand(shape)
        else:
            u = torch.rand(shape, generator=generator, dtype=torch.float32,
                           device=weights.device)
    return sample_pdf_from_u(bins, weights, u)


def sample_pdf_from_u(bins: torch.Tensor, weights: torch.Tensor,
                      u: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF transform of caller-supplied u's."""
    weights = weights + 1e-5                                 # avoid nans
    pdf = weights / torch.sum(weights, -1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)  # [N, B]
    u = u.contiguous()
    # #{j : cdf[j] <= u}, the count the JAX package takes by compare+sum
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    B = cdf.shape[-1]
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=B - 1)
    cdf_b = torch.gather(cdf, -1, below)
    cdf_a = torch.gather(cdf, -1, above)
    bins_b = torch.gather(bins, -1, below)
    bins_a = torch.gather(bins, -1, above)
    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_b) / denom
    return bins_b + t * (bins_a - bins_b)
