"""Image quality metrics: SSIM, and LPIPS(VGG16) gated on its weights.

SSIM is the counterpart of the JAX package's ``eval/metrics.compute_ssim``:
11x11 Gaussian window (sigma 1.5), C1=(0.01)^2, C2=(0.03)^2 on [0,1]
images, valid padding, channel mean, with the IQA_pytorch convention of a
relu'd contrast-structure term.  It runs in float64 on the images' device,
so no TF32 convolution path can round it.  A frame narrower or lower than
the window has an empty valid map, whose mean is nan, as in the JAX
package.

LPIPS(VGG16) is the counterpart of the JAX package's ``_lpips_graph``:
VGG16's conv1_2/2_2/3_3/4_3/5_3 taps, channel-unit-normalised, squared
difference, learned per-channel linear weights, spatial mean, summed over
the taps.  Its pretrained weights are not in the repository: they load
from an .npz (``cfg.lpips_weights``, written offline by
``tools/export_lpips_weights.py``), and without one LPIPS is reported as
nan, as the JAX package does.  The graph runs in float32 with TF32 off.
"""
from __future__ import annotations

import hashlib
import math
import os
from typing import Optional

import numpy as np
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




# ----------------------------------------------------------------- LPIPS --

# own copies of the JAX package's tables (eval/metrics.py there)
# VGG16 conv layout: (out_channels, n_convs) per block
_VGG_BLOCKS = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)
_LPIPS_KEYS = ({f"conv{i}_w" for i in range(13)}
               | {f"conv{i}_b" for i in range(13)}
               | {f"lin{i}_w" for i in range(5)})


def load_lpips_params(path: str, device="cpu") -> Optional[dict]:
    """VGG16 + LPIPS-linear weights from an .npz in the layout of
    ``tools/export_lpips_weights.py`` (``conv{i}_w`` HWIO), with the
    convolution weights turned to OIHW once and every tensor put on
    ``device`` once.

    An empty path gives None (LPIPS reported as nan).  A set path that is
    missing raises FileNotFoundError; a ``<path>.sha256`` sidecar that does
    not match, or a missing key, raises ValueError: a configured LPIPS
    never degrades to nan."""
    if not path:
        return None
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"cfg.lpips_weights={path!r} does not exist; export it once "
            "offline with tools/export_lpips_weights.py (needs torchvision "
            "and lpips) and copy it here")
    sidecar = path + ".sha256"
    if os.path.isfile(sidecar):
        with open(sidecar) as f:
            want = f.read().split()[0].strip()
        with open(path, "rb") as f:
            got = hashlib.sha256(f.read()).hexdigest()
        if got != want:
            raise ValueError(
                f"{path} sha256 mismatch: got {got}, expected {want} (from "
                f"{sidecar}); the weights file is corrupt or stale")
    with np.load(path) as npz:
        data = {k: npz[k] for k in npz.files}
    missing = _LPIPS_KEYS - set(data)
    if missing:
        raise ValueError(
            f"{path} is not a valid LPIPS weights file: missing "
            f"{sorted(missing)[:4]}... (re-export with "
            "tools/export_lpips_weights.py)")
    out = {}
    for k in _LPIPS_KEYS:
        v = np.asarray(data[k], np.float32)
        if k.endswith("_w") and k.startswith("conv"):
            v = v.transpose(3, 2, 0, 1)                # HWIO -> OIHW
        elif k.startswith("lin"):
            v = v.reshape(-1)
        out[k] = torch.as_tensor(np.ascontiguousarray(v), device=device)
    return out


def _vgg_features(x: torch.Tensor, params: dict) -> list:
    """x [N, 3, H, W] in [0, 1] -> the 5 tap activations (NCHW): 3x3
    convolutions at padding 1 (the JAX package's "SAME"), ReLU, and a 2x2
    max pool after blocks 0-3 that floors odd sizes (its "VALID"
    ``reduce_window``)."""
    mean = x.new_tensor(_IMAGENET_MEAN).view(1, 3, 1, 1)
    std = x.new_tensor(_IMAGENET_STD).view(1, 3, 1, 1)
    x = (x - mean) / std
    feats, li = [], 0
    for bi, (_, n_convs) in enumerate(_VGG_BLOCKS):
        for _ in range(n_convs):
            x = F.relu(F.conv2d(x, params[f"conv{li}_w"],
                                params[f"conv{li}_b"], padding=1))
            li += 1
        feats.append(x)
        if bi < len(_VGG_BLOCKS) - 1:
            x = F.max_pool2d(x, 2, 2)
    return feats


@torch.no_grad()
def lpips_tensor(pred, gt, params: dict) -> torch.Tensor:
    """LPIPS-VGG between two [H, W, 3] images in [0, 1] as a 0-dim float32
    tensor on the weights' device, so that it can be queued on the card
    without waiting for it: both images through the VGG16 taps in one
    batch, each tap's channels scaled to unit length (+1e-10), the squared
    difference weighted by ``lin{i}_w`` over channels, its mean over H and
    W, summed over the 5 taps.  Float32 throughout, TF32 off."""
    device = params["conv0_w"].device
    x = torch.stack([torch.as_tensor(pred), torch.as_tensor(gt)]).to(
        device=device, dtype=torch.float32).permute(0, 3, 1, 2)
    # cuDNN rounds float32 convolutions to TF32 by default; ``flags``
    # defaults ``enabled`` to False, which would move the convolutions off
    # cuDNN, so it is named
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        total = torch.zeros((), dtype=torch.float32, device=device)
        for i, f in enumerate(_vgg_features(x.contiguous(), params)):
            f = f / (torch.linalg.vector_norm(f, dim=1, keepdim=True) + 1e-10)
            d = (f[0] - f[1]) ** 2                          # [C, H, W]
            lin = params[f"lin{i}_w"].view(-1, 1, 1)
            total = total + torch.mean(torch.sum(d * lin, 0))
    return total


def compute_lpips(pred, gt, params: Optional[dict]) -> float:
    """LPIPS-VGG between two [H, W, 3] images in [0, 1]; nan without
    weights."""
    if params is None:
        return math.nan
    return float(lpips_tensor(pred, gt, params))
