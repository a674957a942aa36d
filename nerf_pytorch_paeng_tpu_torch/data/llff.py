"""LLFF real-scene dataset loader (forward-facing captures).

Own copy of the JAX package's ``data/llff.py`` (reference
dataset/load_llff.py): poses_bounds.npy load (running COLMAP when it is
missing), factor-downsampled image directories, the [-y, x, z] axis fix,
the bound rescale by 1/(bds.min() * bd_factor), recentring to the average
camera, optional spherification, the 120-view two-rotation spiral render
path, and every ``testskip``-th image held out.

As in the JAX package, minification runs in-process (cv2 INTER_AREA)
instead of shelling out to ImageMagick's ``mogrify``.  Images are read and
written through Pillow (``utils/image.py``).  Pure numpy on the host; the
train loop and the frame renderers move what they need to the device.
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from ..utils.image import imread, imwrite

from .colmap.poses import gen_poses
from .colmap.wrapper import remove_colmap_artifacts

IMG_EXTS = ("JPG", "jpg", "png", "jpeg", "PNG")


def _list_images(d: str) -> List[str]:
    return [os.path.join(d, f) for f in sorted(os.listdir(d))
            if f.endswith(IMG_EXTS)]


def minify(basedir: str, factor: int) -> None:
    """Write an images_{factor}/ dir of 1/factor-size PNGs, in-process."""
    import cv2
    outdir = os.path.join(basedir, f"images_{factor}")
    files = _list_images(os.path.join(basedir, "images"))
    if os.path.exists(outdir):
        # idempotency after a partial failure: an interrupted first run
        # leaves a short directory that would otherwise be trusted
        # forever and fail downstream as 'N images but M poses'
        if len(_list_images(outdir)) == len(files):
            return
        import shutil
        shutil.rmtree(outdir)
    os.makedirs(outdir)
    for f in files:
        img = imread(f)
        h, w = img.shape[:2]
        small = cv2.resize(img, (int(w / factor), int(h / factor)),
                           interpolation=cv2.INTER_AREA)
        name = os.path.splitext(os.path.basename(f))[0] + ".png"
        imwrite(os.path.join(outdir, name), small)


def _load_data(basedir: str, factor: Optional[int] = None,
               colmap_relaunch: bool = False):
    """poses [N,3,5] (pre axis-fix, as [3,5,N]), bds [2,N], imgs [H,W,3,N]."""
    pb_path = os.path.join(basedir, "poses_bounds.npy")
    if os.path.isfile(pb_path):
        if colmap_relaunch:
            remove_colmap_artifacts(basedir)
            gen_poses(basedir, "exhaustive_matcher")
    else:
        gen_poses(basedir, "exhaustive_matcher")

    poses_arr = np.load(pb_path)
    poses = poses_arr[:, :-2].reshape([-1, 3, 5]).transpose([1, 2, 0])
    bds = poses_arr[:, -2:].transpose([1, 0])

    factor = None if not factor else factor
    sfx = ""
    if factor is not None:
        sfx = f"_{factor}"
        minify(basedir, factor)
    else:
        factor = 1

    imgdir = os.path.join(basedir, "images" + sfx)
    if not os.path.exists(imgdir):
        raise FileNotFoundError(imgdir)
    imgfiles = _list_images(imgdir)
    if poses.shape[-1] != len(imgfiles):
        raise ValueError(
            f"{len(imgfiles)} images but {poses.shape[-1]} poses in {basedir}")

    sh = imread(imgfiles[0]).shape
    poses[:2, 4, :] = np.array(sh[:2]).reshape([2, 1])   # actual H, W
    poses[2, 4, :] = poses[2, 4, :] / factor             # focal scales

    # stack uint8 first, ONE float32 divide (a per-image /255.0 would
    # build the stack in float64 — ~8 bytes/pixel transient)
    imgs = np.stack([imread(f)[..., :3] for f in imgfiles], -1)
    imgs = imgs.astype(np.float32) / 255.0
    return poses, bds, imgs


# ---------------------------------------------------------------------------
# pose geometry helpers (reference load_llff.py:151-269)

def _normalize(x: np.ndarray) -> np.ndarray:
    return x / np.linalg.norm(x)


def view_matrix(z: np.ndarray, up: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """[3,4] camera matrix with forward z, roughly-up up, center pos."""
    vec2 = _normalize(z)
    vec0 = _normalize(np.cross(up, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], 1)


def poses_avg(poses: np.ndarray) -> np.ndarray:
    """Average camera: mean center, summed forward/up. poses [N,3,5]."""
    hwf = poses[0, :3, -1:]
    center = poses[:, :3, 3].mean(0)
    forward = _normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    return np.concatenate([view_matrix(forward, up, center), hwf], 1)


def recenter_poses(poses: np.ndarray) -> np.ndarray:
    """Rebase all poses so the average camera is the identity."""
    out = poses.copy()
    bottom = np.array([[0, 0, 0, 1.0]])
    c2w = np.concatenate([poses_avg(poses)[:3, :4], bottom], 0)
    homog = np.concatenate(
        [poses[:, :3, :4], np.tile(bottom[None], [poses.shape[0], 1, 1])], 1)
    rebased = np.linalg.inv(c2w) @ homog
    out[:, :3, :4] = rebased[:, :3, :4]
    return out


def render_path_spiral(c2w: np.ndarray, up: np.ndarray, rads: np.ndarray,
                       focal: float, zrate: float, rots: int, N: int
                       ) -> List[np.ndarray]:
    """Spiral of N c2w poses around the average camera (2 rotations for
    llff, reference load_llff.py:179-189)."""
    out = []
    rads = np.array(list(rads) + [1.0])
    hwf = c2w[:, 4:5]
    for theta in np.linspace(0.0, 2.0 * np.pi * rots, N + 1)[:-1]:
        c = c2w[:3, :4] @ (np.array([np.cos(theta), -np.sin(theta),
                                     -np.sin(theta * zrate), 1.0]) * rads)
        z = _normalize(c - c2w[:3, :4] @ np.array([0, 0, -focal, 1.0]))
        out.append(np.concatenate([view_matrix(z, up, c), hwf], 1))
    return out


def spherify_poses(poses: np.ndarray, bds: np.ndarray):
    """Recenter about the point closest to all camera axes and generate a
    circular render path (for 360 captures; reference load_llff.py:207-269)."""
    def add_row(p):
        return np.concatenate(
            [p, np.tile(np.eye(4)[-1:][None], [p.shape[0], 1, 1])], 1)

    rays_d = poses[:, :3, 2:3]
    rays_o = poses[:, :3, 3:4]

    # least-squares point nearest all camera rays
    A_i = np.eye(3) - rays_d * rays_d.transpose([0, 2, 1])
    b_i = -A_i @ rays_o
    pt_mindist = np.squeeze(
        -np.linalg.inv((A_i.transpose([0, 2, 1]) @ A_i).mean(0))
        @ b_i.mean(0))

    center = pt_mindist
    up = (poses[:, :3, 3] - center).mean(0)
    vec0 = _normalize(up)
    vec1 = _normalize(np.cross([0.1, 0.2, 0.3], vec0))
    vec2 = _normalize(np.cross(vec0, vec1))
    c2w = np.stack([vec1, vec2, vec0, center], 1)

    poses_reset = (np.linalg.inv(add_row(c2w[None]))
                   @ add_row(poses[:, :3, :4]))

    rad = np.sqrt(np.mean(np.sum(poses_reset[:, :3, 3] ** 2, -1)))
    sc = 1.0 / rad
    poses_reset[:, :3, 3] *= sc
    bds = bds * sc
    rad *= sc

    centroid = np.mean(poses_reset[:, :3, 3], 0)
    zh = centroid[2]
    radcircle = np.sqrt(rad ** 2 - zh ** 2)

    new_poses = []
    for th in np.linspace(0.0, 2.0 * np.pi, 120):
        camorigin = np.array(
            [radcircle * np.cos(th), radcircle * np.sin(th), zh])
        up = np.array([0, 0, -1.0])
        vec2 = _normalize(camorigin)
        vec0 = _normalize(np.cross(vec2, up))
        vec1 = _normalize(np.cross(vec2, vec0))
        new_poses.append(np.stack([vec0, vec1, vec2, camorigin], 1))
    new_poses = np.stack(new_poses, 0)

    new_poses = np.concatenate([
        new_poses,
        np.broadcast_to(poses[0, :3, -1:], new_poses[:, :3, -1:].shape)], -1)
    poses_reset = np.concatenate([
        poses_reset[:, :3, :4],
        np.broadcast_to(poses[0, :3, -1:], poses_reset[:, :3, -1:].shape)], -1)
    return poses_reset, new_poses, bds


# ---------------------------------------------------------------------------

def normalize_loaded_poses(poses, bds, imgs, bd_factor: float = 0.75):
    """The shared post-_load_data normalization (reference
    load_llff.py:277-295), used by load_llff AND load_custom — one copy
    so a fix to the axis convention or the bound rescale cannot land in
    only one loader:
    axis fix [x_down, y_right, z_back] -> standard [right, up, back],
    [..., N] -> [N, ...] major, 1/(bds.min()*bd_factor) rescale,
    recenter to the average pose.
    Returns (poses [N,3,5], bds [N,2], images [N,H,W,3]) as float32."""
    poses = np.concatenate(
        [poses[:, 1:2, :], -poses[:, 0:1, :], poses[:, 2:, :]], 1)
    poses = np.moveaxis(poses, -1, 0).astype(np.float32)
    images = np.moveaxis(imgs, -1, 0).astype(np.float32)
    bds = np.moveaxis(bds, -1, 0).astype(np.float32)

    sc = 1.0 if bd_factor is None else 1.0 / (bds.min() * bd_factor)
    poses[:, :3, 3] *= sc
    bds *= sc
    return recenter_poses(poses), bds, images


def load_llff(data_root: str, downsample: int = 0, testskip: int = 8,
              bd_factor: float = 0.75, spherify: bool = False,
              path_zflat: bool = False, colmap_relaunch: bool = False):
    """Returns (images, [K, extrinsics], [H, W], i_split, render_poses)."""
    poses, bds, imgs = _load_data(data_root, factor=downsample,
                                  colmap_relaunch=colmap_relaunch)
    poses, bds, images = normalize_loaded_poses(poses, bds, imgs,
                                                bd_factor=bd_factor)

    if spherify:
        poses, render_poses, bds = spherify_poses(poses, bds)
    else:
        c2w = poses_avg(poses)
        up = _normalize(poses[:, :3, 1].sum(0))
        # focus depth heuristic
        close_depth, inf_depth = bds.min() * 0.9, bds.max() * 5.0
        dt = 0.75
        focal = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)
        tt = poses[:, :3, 3]
        rads = np.percentile(np.abs(tt), 90, 0)
        c2w_path = c2w
        n_views, n_rots = 120, 2
        if path_zflat:
            zloc = -close_depth * 0.1
            c2w_path[:3, 3] = c2w_path[:3, 3] + zloc * c2w_path[:3, 2]
            rads[2] = 0.0
            n_rots, n_views = 1, n_views // 2
        render_poses = render_path_spiral(
            c2w_path, up, rads, focal, zrate=0.5, rots=n_rots, N=n_views)

    render_poses = np.array(render_poses, np.float32)

    hwf = poses[0, :3, -1]
    H, W, focal = int(hwf[0]), int(hwf[1]), hwf[2]
    extrinsics = poses[:, :3, :4]
    K = np.array([[focal, 0, 0.5 * W],
                  [0, focal, 0.5 * H],
                  [0, 0, 1]], np.float64)

    # testskip<=0 would crash numpy's [::0]; treat it as 1 (keep every
    # image in the held-out split) like the sibling loaders' 0-handling
    i_test = np.arange(images.shape[0])[::max(int(testskip), 1)]
    i_val = i_test
    i_train = np.array([i for i in np.arange(images.shape[0])
                        if i not in i_test])
    return (images.astype(np.float32), [K, extrinsics], [H, W],
            [i_train, i_val, i_test], render_poses)
