"""Device choice for the port's entry points: CUDA unless the caller asks
for the CPU, and never a silent fallback."""
from __future__ import annotations

from typing import Optional

import torch


def resolve_device(name: str = "cuda",
                   local_rank: Optional[int] = None) -> torch.device:
    """``"cuda"``/``"cuda:N"`` -> that card (raises when there is none);
    ``"cpu"`` -> the CPU, which runs every kernel's plain version.  Under
    a multi-GPU launch (``local_rank`` given, ``parallel/mesh.py``) a bare
    ``"cuda"`` is the rank's own card, ``cuda:{local_rank}``."""
    if name == "cuda" and local_rank is not None:
        name = f"cuda:{local_rank}"
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but torch sees no CUDA device; "
            "pass --device cpu (device='cpu') to run the plain versions")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}")
    return device
