"""COLMAP sparse model -> LLFF ``poses_bounds.npy``.

Own copy of the JAX package's ``data/colmap/poses.py`` (reference
dataset/colmap/pose_utils.py:12-94,262: load_colmap_data / save_poses /
gen_poses): per-image rows hold the 3x5 matrix [R|t|hwf] in LLFF's
[-u, r, -t] axis convention plus [near, far] depth percentiles (0.1 /
99.9) of the 3D points visible in that image.  Where ``sparse/0`` holds a
model, no COLMAP binary is needed.
"""
from __future__ import annotations

import os
import numpy as np

from .read_model import detect_model_ext, qvec2rotmat, read_model
from .wrapper import run_colmap


def load_colmap_model(basedir: str):
    """Returns (poses [3,5,N] in LLFF axes, pts3d dict, name-sort perm).

    Reads whichever model format is present (``.bin`` from the mapper, or
    ``.txt`` from a model_converter export / text-shipped dataset) via
    read_model's ext dispatch — reference colmap_read_model.py:262-270."""
    sparse = os.path.join(basedir, "sparse", "0")
    cams, imdata, pts3d = read_model(sparse)
    cam = cams[sorted(cams.keys())[0]]
    hwf = np.array([cam.height, cam.width, cam.params[0]],
                   np.float64).reshape(3, 1)

    keys = list(imdata.keys())
    names = [imdata[k].name for k in keys]
    perm = np.argsort(names)

    bottom = np.array([[0, 0, 0, 1.0]])
    w2c = np.stack([
        np.concatenate(
            [np.concatenate([qvec2rotmat(imdata[k].qvec),
                             imdata[k].tvec.reshape(3, 1)], 1), bottom], 0)
        for k in keys], 0)
    c2w = np.linalg.inv(w2c)

    poses = c2w[:, :3, :4].transpose([1, 2, 0])       # [3, 4, N]
    poses = np.concatenate(
        [poses, np.tile(hwf[..., None], [1, 1, poses.shape[-1]])], 1)
    # COLMAP camera axes (r, -u, t) -> LLFF's (-u, r, -t)
    poses = np.concatenate(
        [poses[:, 1:2, :], poses[:, 0:1, :], -poses[:, 2:3, :],
         poses[:, 3:4, :], poses[:, 4:5, :]], 1)      # [3, 5, N]

    return poses, pts3d, perm, keys


def save_poses_bounds(basedir: str, poses: np.ndarray, pts3d,
                      perm: np.ndarray, image_ids=None) -> np.ndarray:
    """Compute per-image depth bounds and write poses_bounds.npy.

    ``image_ids``: the COLMAP image ids in the column order the poses
    were stacked (load_colmap_model's ``keys``).  COLMAP keeps database
    ids for registered images, so after dropped frames (common for
    handheld video) the ids are NOT contiguous 1..N — indexing columns
    by ``id - 1`` would either mispair visibility with the wrong camera
    or reject a perfectly valid model.  ``None`` assumes contiguous ids
    (legacy layouts only).
    """
    n_images = poses.shape[-1]
    if image_ids is None:
        image_ids = list(range(1, n_images + 1))
    col = {img_id: j for j, img_id in enumerate(image_ids)}
    pts = np.stack([p.xyz for p in pts3d.values()], 0)       # [P, 3]
    vis = np.zeros((pts.shape[0], n_images), bool)
    for row, p in enumerate(pts3d.values()):
        for ind in p.image_ids:
            j = col.get(int(ind))
            if j is None:
                raise ValueError(
                    f"point track references image id {int(ind)}, which "
                    "is not in the registered image set — COLMAP model "
                    "is inconsistent with the pose set")
            vis[row, j] = True

    # depth of each point along each camera's forward (-t) axis
    zvals = np.sum(
        -(pts[:, None, :].transpose([2, 0, 1]) - poses[:3, 3:4, :])
        * poses[:3, 2:3, :], 0)                               # [P, N]

    rows = []
    for i in perm:
        zs = zvals[:, i][vis[:, i]]
        if zs.size == 0:
            raise ValueError(
                f"image column {int(i)} (id {image_ids[int(i)]}) has no "
                "visible 3D points — COLMAP registered it without any "
                "tracks (blurry/textureless frame?); remove the frame "
                "and re-run COLMAP")
        close, inf = np.percentile(zs, 0.1), np.percentile(zs, 99.9)
        rows.append(np.concatenate(
            [poses[..., i].ravel(), np.array([close, inf])], 0))
    arr = np.array(rows)
    np.save(os.path.join(basedir, "poses_bounds.npy"), arr)
    return arr


def gen_poses(basedir: str, match_type: str = "exhaustive_matcher") -> bool:
    """Ensure a sparse model exists (running COLMAP if needed), then write
    poses_bounds.npy (reference pose_utils.py:262-285)."""
    sparse0 = os.path.join(basedir, "sparse", "0")
    try:
        detect_model_ext(sparse0)   # .bin or .txt both count as a model
    except FileNotFoundError:
        run_colmap(basedir, match_type)
    poses, pts3d, perm, keys = load_colmap_model(basedir)
    save_poses_bounds(basedir, poses, pts3d, perm, image_ids=keys)
    return True
