"""Image quality metrics: SSIM, and LPIPS gated on its weights.

SSIM is the counterpart of the JAX package's ``eval/metrics.compute_ssim``:
11x11 Gaussian window (sigma 1.5), C1=(0.01)^2, C2=(0.03)^2 on [0,1]
images, valid padding, channel mean, with the IQA_pytorch convention of a
relu'd contrast-structure term.  It runs in float64 on the images' device,
so no TF32 convolution path can round it.  A frame narrower or lower than
the window has an empty valid map, whose mean is nan, as in the JAX
package.

LPIPS(VGG16) needs pretrained weights that are not in the repository:
without ``cfg.lpips_weights`` it is reported as nan, as the JAX package
does.  The VGG graph itself is not ported yet, so a set path raises instead
of reporting a number it cannot compute.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def _gaussian_window(size: int, sigma: float, dtype, device) -> torch.Tensor:
    x = torch.arange(size, dtype=dtype, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g)


def compute_ssim(pred: torch.Tensor, gt: torch.Tensor, **kw) -> float:
    """SSIM between two [H, W, C] images in [0, 1]."""
    return float(ssim_tensor(pred, gt, **kw))


@torch.no_grad()
def ssim_tensor(pred: torch.Tensor, gt: torch.Tensor, size: int = 11,
                sigma: float = 1.5, c1: float = 0.01 ** 2,
                c2: float = 0.03 ** 2) -> torch.Tensor:
    """``compute_ssim`` as a 0-dim float64 tensor on ``pred``'s device, so
    that it can be queued on the card without waiting for it."""
    pred = torch.as_tensor(pred).to(torch.float64)
    gt = torch.as_tensor(gt).to(device=pred.device, dtype=torch.float64)
    if pred.shape[0] < size or pred.shape[1] < size:
        # VALID filtering leaves no window: the mean of nothing
        return torch.tensor(math.nan, dtype=torch.float64, device=pred.device)
    ch = pred.shape[-1]
    kernel = _gaussian_window(size, sigma, torch.float64, pred.device)
    kernel = kernel.expand(ch, 1, size, size)

    def filt(img):
        return F.conv2d(img.permute(2, 0, 1)[None], kernel, groups=ch)[0]

    mu_p, mu_g = filt(pred), filt(gt)
    mu_pp, mu_gg, mu_pg = mu_p * mu_p, mu_g * mu_g, mu_p * mu_g
    # variances clamped at 0 and |cov| at sqrt(var_p var_g): cancellation
    # on near-constant windows must not blow the ratio up
    sigma_p = torch.clamp(filt(pred * pred) - mu_pp, min=0.0)
    sigma_g = torch.clamp(filt(gt * gt) - mu_gg, min=0.0)
    bound = torch.sqrt(sigma_p * sigma_g)
    sigma_pg = torch.maximum(torch.minimum(filt(pred * gt) - mu_pg, bound),
                             -bound)
    lum = (2 * mu_pg + c1) / (mu_pp + mu_gg + c1)
    cs = torch.clamp((2 * sigma_pg + c2) / (sigma_p + sigma_g + c2), min=0.0)
    return torch.mean(lum * cs)


def load_lpips_params(path: str) -> Optional[dict]:
    """Empty path -> None (LPIPS reported as nan)."""
    if not path:
        return None
    raise NotImplementedError(
        f"cfg.lpips_weights={path!r}: the LPIPS VGG16 graph is not ported "
        "to PyTorch yet; leave lpips_weights empty to report nan")


def compute_lpips(pred, gt, params: Optional[dict]) -> float:
    """LPIPS-VGG between two [H, W, 3] images; nan without weights."""
    if params is None:
        return math.nan
    raise NotImplementedError("the LPIPS VGG16 graph is not ported yet")
