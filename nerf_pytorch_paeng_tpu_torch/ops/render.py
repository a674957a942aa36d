"""Hierarchical resampling (counterpart of the JAX package's
``ops/render.hierarchical_z_vals``)."""
from __future__ import annotations

from typing import Optional

import torch

from .sampling import sample_pdf


def hierarchical_z_vals(z_vals: torch.Tensor, weights: torch.Tensor, *,
                        n_fine: int, perturb: float = 1.0,
                        generator: Optional[torch.Generator] = None,
                        u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Merged, sorted coarse+fine depths from the coarse sampling stats:
    z_vals [M, Sc] sorted, weights [M, Sc] -> [M, Sc + n_fine].  The fine
    depths carry no gradient, and every coarse sample stays in the merge
    (the reference semantics)."""
    z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    z_samples = sample_pdf(z_mid, weights[..., 1:-1], n_fine,
                           det=(perturb == 0.0), generator=generator, u=u)
    z_samples = z_samples.detach()
    return torch.sort(torch.cat([z_vals, z_samples], -1), -1).values
