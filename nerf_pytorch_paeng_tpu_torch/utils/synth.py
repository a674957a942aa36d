"""Analytic synthetic scene written in the blender on-disk format.

Own numpy copy of the JAX package's ``utils/synth.make_synth_scene``,
``save_as_blender_dataset``, ``make_forward_scene`` and
``save_as_llff_dataset``: a compactly supported Gaussian density blob
with a position-dependent colour, volume-rendered analytically with the
renderer's compositing formulas (white background), seen from an orbit of
cameras (blender layout) or from a forward-facing capture (LLFF layout,
``images/`` + ``poses_bounds.npy``).  Used by the port's tests and by
``chip_smoke.py`` in place of the real datasets, which are not in the
repository.

``compact_field_params`` / ``compact_field_state_dict`` build a NeRF by
hand whose density has exactly compact support (an L1 ball), so the
culled renderer's support bounds, cull and gates engage without a fitted
model.
"""
from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .image import imwrite
from .interop import state_dict_from_jax_params


def orbit_pose(theta: float, phi: float, radius: float) -> np.ndarray:
    """[4,4] camera-to-world looking at the origin from spherical coords."""
    st, ct = np.sin(theta), np.cos(theta)
    sp, cp = np.sin(phi), np.cos(phi)
    center = radius * np.array([ct * cp, st * cp, sp], np.float64)
    z = center / np.linalg.norm(center)          # camera +z away from origin
    x = np.cross(np.array([0.0, 0.0, 1.0]), z)
    x = x / (np.linalg.norm(x) + 1e-12)
    y = np.cross(z, x)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, center
    return c2w.astype(np.float32)


def _density(pts: np.ndarray, amp: float = 8.0, r: float = 0.6,
             cutoff: float = 1.8) -> np.ndarray:
    """Compactly supported Gaussian blob (continuous at the cutoff): any
    tail density would turn opaque at the 1e10 last-sample distance."""
    d2 = np.sum(pts ** 2, -1) / (2 * r * r)
    floor = np.exp(-(cutoff * cutoff) / (2 * r * r))
    return amp * np.maximum(np.exp(-d2) - floor, 0.0)


def _color(pts: np.ndarray, freq: float = 2.0) -> np.ndarray:
    return 0.5 + 0.4 * np.stack([np.sin(freq * pts[..., i]) for i in range(3)],
                                -1)


def render_gt(H: int, W: int, K: np.ndarray, c2w: np.ndarray,
              near: float, far: float, n_samples: int = 128,
              rows_per_chunk: int = 64) -> np.ndarray:
    """Analytically volume-render the blob for one camera -> [H, W, 3]
    (chunked over image rows, so an 800x800 view stays small in memory)."""
    t = np.linspace(near, far, n_samples, dtype=np.float32)
    dists = np.concatenate([np.diff(t), [1e10]]).astype(np.float32)
    out = np.empty((H, W, 3), np.float32)
    for r0 in range(0, H, rows_per_chunk):
        i, j = np.meshgrid(np.arange(W, dtype=np.float32),
                           np.arange(r0, min(H, r0 + rows_per_chunk),
                                     dtype=np.float32), indexing="xy")
        dirs = np.stack([(i - K[0, 2]) / K[0, 0], -(j - K[1, 2]) / K[1, 1],
                         -np.ones_like(i)], -1)
        rays_d = dirs @ c2w[:3, :3].T
        rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape)
        pts = rays_o[..., None, :] + rays_d[..., None, :] * t[:, None]
        sigma = _density(pts)
        rgb = _color(pts)
        dd = dists * np.linalg.norm(rays_d, axis=-1, keepdims=True)
        alpha = 1.0 - np.exp(-sigma * dd)
        trans = np.cumprod(np.concatenate(
            [np.ones_like(alpha[..., :1]), 1 - alpha + 1e-10], -1),
            -1)[..., :-1]
        w = alpha * trans
        img = (w[..., None] * rgb).sum(-2)
        acc = w.sum(-1, keepdims=True)
        out[r0:r0 + rows_per_chunk] = img + (1.0 - acc)   # white background
    return out


def make_synth_scene(n_views: int = 8, H: int = 32, W: int = 32,
                     radius: float = 4.0, near: float = 2.0, far: float = 6.0,
                     camera_angle_x: Optional[float] = None
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (images [N,H,W,3], K [3,3], poses [N,4,4]).  The focal
    length is 0.9 W (a 58 degree field of view), or the one of the
    horizontal field of view ``camera_angle_x`` (radians; the lego scene's
    is 0.6911).  Views render on threads: numpy's array arithmetic releases
    the interpreter lock."""
    focal = (0.9 * W if camera_angle_x is None
             else 0.5 * W / float(np.tan(0.5 * camera_angle_x)))
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]],
                 np.float32)
    thetas = np.linspace(0, 2 * np.pi, n_views, endpoint=False)
    poses = np.stack([orbit_pose(t, 0.35, radius) for t in thetas])
    with ThreadPoolExecutor(max_workers=min(n_views, 8)) as pool:
        imgs = np.stack(list(pool.map(
            lambda p: render_gt(H, W, K, p, near, far), poses)))
    return imgs, K, poses


def save_as_blender_dataset(root: str, n_train: int = 4, n_val: int = 1,
                            n_test: int = 2, H: int = 16, W: int = 16,
                            radius: float = 4.0,
                            camera_angle_x: Optional[float] = None) -> None:
    """Write the synthetic scene in the blender transforms_*.json layout,
    splits interleaved around the orbit (seeded permutation);
    ``camera_angle_x`` as in ``make_synth_scene``."""
    n = n_train + n_val + n_test
    imgs, K, poses = make_synth_scene(n_views=n, H=H, W=W, radius=radius,
                                      camera_angle_x=camera_angle_x)
    focal = float(K[0, 0])
    camera_angle_x = 2.0 * float(np.arctan(W / (2.0 * focal)))
    order = np.random.default_rng(0).permutation(n)
    splits = (("train", order[:n_train]),
              ("val", order[n_train:n_train + n_val]),
              ("test", order[n_train + n_val:]))
    for split, view_ids in splits:
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames = []
        for j, i in enumerate(view_ids):
            rel = f"{split}/r_{j}"
            rgba = np.concatenate(
                [imgs[i], np.ones_like(imgs[i][..., :1])], -1)
            imwrite(os.path.join(root, rel + ".png"),
                    (rgba * 255).astype(np.uint8))
            frames.append({"file_path": rel,
                           "transform_matrix": poses[i].tolist()})
        meta = {"camera_angle_x": camera_angle_x, "frames": frames}
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump(meta, f)


def make_forward_scene(n_views: int = 20, H: int = 378, W: int = 504,
                       dist: float = 4.0, spread: float = 0.6,
                       n_samples: int = 256
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                  np.ndarray]:
    """Forward-facing capture of the blob (the LLFF geometry): cameras on
    a jittered plane at ``z ~ dist``, all looking at the origin (a mild
    toe-in, like a handheld capture).  Returns (images [N,H,W,3], K [3,3],
    poses [N,4,4] c2w, bounds [N,2]: each view's [near, far] content depth,
    what COLMAP's depth percentiles give for a real scene).  The camera
    draws come first, then the views render on threads."""
    focal = 0.9 * W
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]],
                 np.float32)
    rng = np.random.default_rng(11)
    cutoff = 1.8                                 # the blob's support
    poses, bounds = [], []
    for _ in range(n_views):
        center = np.array([rng.uniform(-spread, spread),
                           rng.uniform(-spread, spread),
                           dist + rng.uniform(-0.15, 0.15)])
        z = center / np.linalg.norm(center)      # back axis (look at 0)
        x = np.cross(np.array([0.0, 1.0, 0.0]), z)
        x = x / np.linalg.norm(x)
        y = np.cross(z, x)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, center
        d = float(np.linalg.norm(center))
        poses.append(c2w)
        bounds.append((max(d - cutoff - 0.2, 0.5), d + cutoff + 0.2))
    with ThreadPoolExecutor(max_workers=min(n_views, 8)) as pool:
        imgs = list(pool.map(
            lambda pb: render_gt(H, W, K, pb[0], pb[1][0], pb[1][1],
                                 n_samples=n_samples), zip(poses, bounds)))
    return (np.stack(imgs), K, np.stack(poses),
            np.asarray(bounds, np.float32))


def save_as_llff_dataset(root: str, n_views: int = 20, H: int = 378,
                         W: int = 504, n_samples: int = 256) -> None:
    """Write the forward-facing scene in the LLFF layout (``images/`` +
    ``poses_bounds.npy``), so that the whole LLFF path runs on it: the
    loader's axis fix, recentring and bound rescale, the NDC projection,
    the spiral render path.  Row i of poses_bounds is the flattened 3x5
    [down | right | back | t | hwf] matrix and the view's [near, far], and
    pairs with the i-th image in sorted file-name order."""
    imgs, K, poses, bounds = make_forward_scene(
        n_views=n_views, H=H, W=W, n_samples=n_samples)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    rows = []
    for i in range(n_views):
        imwrite(os.path.join(root, "images", f"{i:03d}.png"),
                (np.clip(imgs[i], 0, 1) * 255).astype(np.uint8))
        c2w = poses[i]
        # LLFF's on-disk axes [down, right, back] (data/llff.py inverts it)
        llff_pose = np.concatenate(
            [-c2w[:3, 1:2], c2w[:3, 0:1], c2w[:3, 2:4]], 1)
        hwf = np.array([H, W, float(K[0, 0])]).reshape(3, 1)
        rows.append(np.concatenate(
            [np.concatenate([llff_pose, hwf], 1).ravel(), bounds[i]], 0))
    np.save(os.path.join(root, "poses_bounds.npy"),
            np.asarray(rows, np.float64))


def compact_field_params(r: float = 1.5, k: float = 20.0, seed: int = 0,
                         L_x: int = 10, L_d: int = 4, width: int = 256
                         ) -> Dict[str, Dict]:
    """Both MLPs of a NeRF (8 layers, skip at 4) as a numpy params tree in
    the JAX package's layout (kernels [in, out]), built so that

    - trunk layer 0 maps the raw position (embedding rows 0-2) to units
      2i: +x_i and 2i+1: -x_i, so after the ReLU units 0-5 hold |x_i|'s
      two halves;
    - trunk layers 1-4, 6, 7 and the hidden rows of the skip layer carry
      units 0-5 through unchanged (identity), everything else is 0;
    - density logit = k r - k (units 0-5 summed) = k (r - |x|_1): positive
      exactly inside the L1 ball of radius r;
    - the feature and view layers pass units 0-5 on, and the colour is a
      seeded linear map of them (weights from {+-1, +-0.5}).

    Every weight is +-1, +-0.5, +-k or 0, and the bias k r: exact in bf16
    for the k and r the callers use."""
    rng = np.random.default_rng(seed)
    in_x, in_d = 3 + 6 * L_x, 3 + 6 * L_d
    units = np.arange(6)

    def dense(fan_in, fan_out):
        return {"kernel": np.zeros((fan_in, fan_out), np.float32),
                "bias": np.zeros((fan_out,), np.float32)}

    def mlp():
        p = {}
        p["trunk_0"] = dense(in_x, width)
        p["trunk_0"]["kernel"][units // 2, units] = np.where(
            units % 2 == 0, 1.0, -1.0)
        for i in (1, 2, 3, 4, 6, 7):
            p[f"trunk_{i}"] = dense(width, width)
            p[f"trunk_{i}"]["kernel"][units, units] = 1.0
        p["trunk_5"] = dense(in_x + width, width)
        p["trunk_5"]["kernel"][in_x + units, units] = 1.0
        p["density"] = dense(width, 1)
        p["density"]["kernel"][units, 0] = -k
        p["density"]["bias"][0] = k * r
        p["feature"] = dense(width, width)
        p["feature"]["kernel"][units, units] = 1.0
        p["view"] = dense(width + in_d, width // 2)
        p["view"]["kernel"][units, units] = 1.0
        p["color"] = dense(width // 2, 3)
        p["color"]["kernel"][units] = rng.choice(
            np.array([-1.0, -0.5, 0.5, 1.0], np.float32), (6, 3))
        return p

    return {"coarse": mlp(), "fine": mlp()}


def compact_field_state_dict(r: float = 1.5, k: float = 20.0, seed: int = 0,
                             L_x: int = 10, L_d: int = 4
                             ) -> Dict[str, torch.Tensor]:
    """``compact_field_params`` as the port's ``NeRF`` state dict (the
    reference ``model_state_dict``)."""
    return state_dict_from_jax_params(
        compact_field_params(r, k, seed, L_x, L_d))


def random_lpips_params(seed: int = 0) -> Dict[str, np.ndarray]:
    """Seeded random VGG16 + LPIPS-linear weights in the layout of
    ``tools/export_lpips_weights.py`` (``conv{i}_w`` [3, 3, in, out] HWIO,
    ``conv{i}_b`` [out], ``lin{i}_w`` [C_i]), He-scaled so activations
    stay finite through the 13 convolutions: the LPIPS graph's inputs
    where the pretrained weights are not in the repository."""
    from ..eval.metrics import _VGG_BLOCKS
    rng = np.random.default_rng(seed)
    params, li, in_ch = {}, 0, 3
    for ch, n_convs in _VGG_BLOCKS:
        for _ in range(n_convs):
            scale = (2.0 / (9 * in_ch)) ** 0.5
            params[f"conv{li}_w"] = (rng.normal(size=(3, 3, in_ch, ch))
                                     * scale).astype(np.float32)
            params[f"conv{li}_b"] = (rng.normal(size=(ch,))
                                     * 0.01).astype(np.float32)
            in_ch, li = ch, li + 1
    for i, (ch, _) in enumerate(_VGG_BLOCKS):
        params[f"lin{i}_w"] = rng.uniform(0, 0.1, (ch,)).astype(np.float32)
    return params


def save_lpips_params(path: str, params: Dict[str, np.ndarray]) -> str:
    """Write ``params`` as the .npz ``eval/metrics.load_lpips_params``
    reads, with its ``<path>.sha256`` sidecar; returns ``path``."""
    import hashlib
    with open(path, "wb") as f:
        np.savez(f, **params)
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    with open(path + ".sha256", "w") as f:
        f.write(f"{digest}  {os.path.basename(path)}\n")
    return path
