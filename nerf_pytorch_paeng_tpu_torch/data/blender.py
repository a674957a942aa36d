"""Blender-synthetic dataset loader (NeRF's transforms_*.json format).

Own copy of the JAX package's ``data/blender.py``: train/val/test JSON
splits, ``testskip`` thinning for val/test, focal from ``camera_angle_x``,
optional integer area downsample, alpha composite onto a white
(``bkg_white``) or black background.  Returns float32 numpy; the frame
renderer moves what it needs to the device.
"""
from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np

from ..utils.image import imread

SPLITS = ("train", "val", "test")


def _read_split(data_root: str, meta: dict,
                skip: int) -> Tuple[np.ndarray, np.ndarray]:
    """Decode every ``skip``-th frame of one split: (rgba uint8 [n,H,W,4],
    poses [n,4,4])."""
    frames = meta["frames"][::skip]
    rgba = np.stack([imread(
        os.path.join(data_root, f["file_path"] + ".png")) for f in frames])
    poses = np.array([f["transform_matrix"] for f in frames], np.float32)
    return rgba, poses


def _downsample_area(imgs: np.ndarray, factor: int) -> np.ndarray:
    """Integer-factor area downsample of [N, H, W, C] (cv2 INTER_AREA for
    exact integer decimation; cv2 per image when the size does not
    divide)."""
    n, h, w, c = imgs.shape
    nh, nw = h // factor, w // factor
    if h % factor == 0 and w % factor == 0:
        return imgs.reshape(n, nh, factor, nw, factor, c).mean((2, 4))
    import cv2
    return np.stack([cv2.resize(im, (nw, nh), interpolation=cv2.INTER_AREA)
                     for im in imgs])


def load_blender(data_root: str, bkg_white: bool = True, downsample: int = 0,
                 testskip: int = 8):
    """Returns (images [N,H,W,3], [K, extrinsics [N,4,4]], [H, W], i_split)."""
    metas = {}
    for s in SPLITS:
        with open(os.path.join(data_root, f"transforms_{s}.json")) as fp:
            metas[s] = json.load(fp)

    per_split = {
        s: _read_split(data_root, metas[s],
                       1 if (s == "train" or testskip == 0) else testskip)
        for s in SPLITS}
    bounds = np.cumsum([0] + [per_split[s][0].shape[0] for s in SPLITS])
    i_split = [np.arange(lo, hi) for lo, hi in zip(bounds[:-1], bounds[1:])]
    rgba = np.concatenate(
        [per_split[s][0] for s in SPLITS]) / np.float32(255.0)
    extrinsics = np.concatenate([per_split[s][1] for s in SPLITS])

    H, W = rgba.shape[1:3]
    focal = 0.5 * W / np.tan(0.5 * float(metas["train"]["camera_angle_x"]))
    if downsample:
        rgba = _downsample_area(rgba, int(downsample))
        H, W = rgba.shape[1:3]
        focal = focal / downsample

    K = np.array([[focal, 0, 0.5 * W],
                  [0, focal, 0.5 * H],
                  [0, 0, 1]], np.float64)

    if rgba.shape[-1] == 4:
        rgb, a = rgba[..., :3], rgba[..., -1:]
        imgs = rgb * a + (1.0 - a) if bkg_white else rgb * a
    else:
        # RGB exports without an alpha plane: nothing to composite
        imgs = rgba[..., :3]
    return imgs.astype(np.float32), [K, extrinsics], [int(H), int(W)], i_split
