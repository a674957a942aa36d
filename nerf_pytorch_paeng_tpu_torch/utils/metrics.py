"""Small numeric helpers (reference utils.py:6-17)."""
from __future__ import annotations

import math

import numpy as np
import torch


def img2mse(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean squared error of two images (a 0-dim tensor)."""
    return torch.mean((x - y) ** 2)


def mse2psnr(mse: float) -> float:
    """-10 log10(mse)."""
    return -10.0 * math.log10(mse)


def to8b(x: np.ndarray) -> np.ndarray:
    """float [0,1]-ish -> uint8."""
    return (255 * np.clip(x, 0, 1)).astype(np.uint8)
