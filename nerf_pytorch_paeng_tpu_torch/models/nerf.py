"""The NeRF MLP (coarse + fine pair) as ``nn.Module``s.

Counterpart of the JAX package's ``models/nerf.py``: an 8x256 ReLU trunk
with the encoded position concatenated back in after trunk layer 4, a
1-channel density head (activation applied by the volume renderer), a
256-channel feature head, a 128-channel view branch and a 3-channel colour
head.  The layers carry the reference implementation's names
(``linear_x.0-7``, ``linear_d``, ``linear_feat``, ``linear_density``,
``linear_color`` under ``model_coarse.`` / ``model_fine.``), registered in
its order, so ``NeRF.state_dict()`` is the reference ``model_state_dict``.

``forward`` is the plain MLP; ``compute_dtype`` rounds every matmul operand
to that type and accumulates in float32, as the JAX package's
``ShardedDense`` does.  Inside the fused kernels' domain rendering and
training go through the kernels (``kernels/fused_mlp.py``) on weights
packed from this module; outside it (``ops/render.plain_route_reason``)
through ``forward`` itself, any depth and width.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.posenc import posenc_out_dim
from ..utils.device import resolve_device


def _linear(x: torch.Tensor, layer: nn.Linear, cdt: torch.dtype
            ) -> torch.Tensor:
    return (x.to(cdt).float() @ layer.weight.to(cdt).float().T
            + layer.bias.float())


class NeRFMLP(nn.Module):
    """One radiance-field MLP: embedded (pos || dir) -> (rgb logits, sigma)."""

    def __init__(self, depth: int = 8, width: int = 256, in_ch_x: int = 63,
                 in_ch_d: int = 27, skips: Sequence[int] = (4,)):
        super().__init__()
        self.in_ch_x, self.skips = in_ch_x, tuple(skips)
        ins = [in_ch_x] + [width + (in_ch_x if i in self.skips else 0)
                           for i in range(depth - 1)]
        self.linear_x = nn.ModuleList(nn.Linear(i, width) for i in ins)
        self.linear_d = nn.Linear(width + in_ch_d, width // 2)
        self.linear_feat = nn.Linear(width, width)
        self.linear_density = nn.Linear(width, 1)
        self.linear_color = nn.Linear(width // 2, 3)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Xavier-uniform weights and U(+-1/sqrt(fan_in)) biases."""
        for layer in self.modules():
            if isinstance(layer, nn.Linear):
                fan_out, fan_in = layer.weight.shape
                a = math.sqrt(6.0 / (fan_in + fan_out))
                bound = 1.0 / math.sqrt(fan_in)
                layer.weight.copy_(torch.rand(
                    layer.weight.shape, generator=generator) * 2 * a - a)
                layer.bias.copy_(torch.rand(
                    layer.bias.shape, generator=generator) * 2 * bound - bound)

    def forward(self, x: torch.Tensor,
                compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """[..., in_ch_x + in_ch_d] -> [..., 4] float32 (rgb logits, sigma)."""
        x = x.float()
        pts, dirs = x[..., :self.in_ch_x], x[..., self.in_ch_x:]
        h = pts
        for i, layer in enumerate(self.linear_x):
            h = torch.relu(_linear(h, layer, compute_dtype))
            if i in self.skips:
                h = torch.cat([pts, h], -1)
        sigma = _linear(h, self.linear_density, compute_dtype)
        feat = _linear(h, self.linear_feat, compute_dtype)
        h = torch.relu(_linear(torch.cat([feat, dirs], -1), self.linear_d,
                               compute_dtype))
        rgb = _linear(h, self.linear_color, compute_dtype)
        return torch.cat([rgb, sigma], -1)


class NeRF(nn.Module):
    """Coarse + fine pair with independent weights."""

    def __init__(self, depth: int = 8, width: int = 256, L_x: int = 10,
                 L_d: int = 4, skips: Sequence[int] = (4,)):
        super().__init__()
        kw = dict(depth=depth, width=width, in_ch_x=posenc_out_dim(L_x),
                  in_ch_d=posenc_out_dim(L_d), skips=skips)
        self.model_coarse = NeRFMLP(**kw)
        self.model_fine = NeRFMLP(**kw)


def init_nerf(cfg, seed: Optional[int] = None, device=None) -> NeRF:
    """Build the model from a NerfConfig with weights drawn from ``seed``
    (default ``cfg.seed``) on the CPU generator, then moved to ``device``
    (default ``cfg.device``)."""
    model = NeRF(depth=cfg.netDepth, width=cfg.netWidth, L_x=cfg.L_x,
                 L_d=cfg.L_d)
    g = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
    model.model_coarse.reset_parameters(g)
    model.model_fine.reset_parameters(g)
    return model.to(resolve_device(cfg.device if device is None else device))
