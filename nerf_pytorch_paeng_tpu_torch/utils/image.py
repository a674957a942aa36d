"""PNG reading and writing through Pillow (the machine the port targets
has Pillow and no imageio)."""
from __future__ import annotations

import numpy as np
from PIL import Image


def imread(path: str) -> np.ndarray:
    """Decode an image file to a uint8 array ([H, W] or [H, W, C])."""
    with Image.open(path) as im:
        return np.asarray(im)


def imwrite(path: str, arr: np.ndarray) -> None:
    """Write a uint8 [H, W] or [H, W, C] array (format from the suffix)."""
    Image.fromarray(np.ascontiguousarray(arr)).save(path)
