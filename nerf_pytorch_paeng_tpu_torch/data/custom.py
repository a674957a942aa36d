"""Custom capture loader: your own video or photos -> COLMAP -> NeRF.

Own copy of the JAX package's ``data/custom.py`` (reference
dataset/load_custom.py:10-83 and methods/image_utils.py:27-83): extract
every ``video_batch``-th frame of ``video.MOV`` when no images/ directory
exists, run the LLFF/COLMAP pipeline with spherify always on, and derive
near/far from the rescaled bounds (0.9 min, 1.0 max), which
``driver.load_dataset`` installs into the config.  Video decoding and resizing go through cv2.
"""
from __future__ import annotations

import os

import numpy as np

from .llff import _load_data, normalize_loaded_poses, spherify_poses


def extract_frames_from_video(data_root: str, batch: int = 30,
                              video_name: str = "video.MOV") -> int:
    """Write every ``batch``-th frame of the video to data_root/images/.

    The reference double-flips each frame (image_utils.py:27-83: a vertical
    + horizontal flip == 180° rotation) to fix phone-capture orientation;
    we reproduce that with cv2.rotate.
    """
    import cv2
    vpath = os.path.join(data_root, video_name)
    cap = cv2.VideoCapture(vpath)
    if not cap.isOpened():
        raise FileNotFoundError(vpath)
    outdir = os.path.join(data_root, "images")
    os.makedirs(outdir, exist_ok=True)
    idx = saved = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if idx % batch == 0:
            frame = cv2.rotate(frame, cv2.ROTATE_180)
            cv2.imwrite(os.path.join(outdir, f"{saved:04d}.png"), frame)
            saved += 1
        idx += 1
    cap.release()
    if saved == 0:
        raise ValueError(f"no frames decoded from {vpath}")
    return saved


def load_custom(data_root: str, downsample: int = 0, testskip: int = 8,
                bd_factor: float = 0.75, video_batch: int = 30,
                colmap_relaunch: bool = False):
    """Returns (images, [K, extrinsics], [H, W], i_split, [near, far])."""
    if not os.path.isdir(os.path.join(data_root, "images")):
        if os.path.isfile(os.path.join(data_root, "video.MOV")):
            extract_frames_from_video(data_root, batch=video_batch)
        else:
            raise FileNotFoundError(
                f"{data_root} needs an images/ dir or a video.MOV")

    poses, bds, imgs = _load_data(data_root, factor=None,
                                  colmap_relaunch=colmap_relaunch)
    poses, bds, imgs = normalize_loaded_poses(poses, bds, imgs,
                                              bd_factor=bd_factor)
    poses, render_poses, bds = spherify_poses(poses, bds)  # always spherify

    hwf = poses[0, :3, -1]
    H, W, focal = int(hwf[0]), int(hwf[1]), float(hwf[2])

    if downsample:
        import cv2
        H, W = int(H // downsample), int(W // downsample)
        focal = focal / downsample
        imgs = np.stack(
            [cv2.resize(im, (W, H), interpolation=cv2.INTER_AREA)
             for im in imgs], 0)

    K = np.array([[focal, 0, 0.5 * W],
                  [0, focal, 0.5 * H],
                  [0, 0, 1]], np.float64)
    extrinsics = poses[:, :3, :4]

    if testskip:
        i_test = np.arange(imgs.shape[0])[::testskip]
    else:
        i_test = np.array([], np.int64)
    i_val = i_test
    i_train = np.array([i for i in np.arange(imgs.shape[0])
                        if i not in i_test])

    near = float(bds.min()) * 0.9
    far = float(bds.max()) * 1.0
    return (imgs.astype(np.float32), [K, extrinsics], [H, W],
            [i_train, i_val, i_test], [near, far])
