"""Camera-pose and ray plots (a debugging aid), drawn with Pillow.

Counterpart of the JAX package's ``utils/visualize.py`` (the reference's
``methods/visualize.py``): camera centres with their orientation axes,
optionally the jittered points along each camera's centre-pixel ray, and
sampled rays as segments.  The JAX package draws a matplotlib 3D scatter;
the port projects the scene onto the image plane of a fixed view (the
azimuth and elevation of matplotlib's default 3D view) with equal scale on
every axis, and draws the same content.  The files are the JAX package's:
``<out_dir>/<name>.png``.
"""
from __future__ import annotations

import math
import os
from typing import Optional, Sequence

import numpy as np
from PIL import Image, ImageDraw

SIZE = 840                 # pixels a side
MARGIN = 60
VIEW_AZIM, VIEW_ELEV = -60.0, 30.0     # degrees
AXIS_COLORS = ((220, 30, 30), (30, 160, 30), (30, 60, 220))   # r, g, b
RAY_POINT_COLOR = (255, 0, 102)        # "#FF0066"
ORIGIN_COLOR = (255, 165, 0)           # "orange"
RAY_COLOR = (70, 130, 180)             # "steelblue"


def center_ray_points(pose: np.ndarray, K: np.ndarray, hw, near: float,
                      far: float, n_z: int = 120,
                      rng: Optional[np.random.Generator] = None
                      ) -> np.ndarray:
    """z-sampled points along a camera's center-pixel ray, [n_z, 3].

    Mirrors the reference's make_z_vals (methods/visualize.py:16-29):
    linspace(near, far) jittered uniformly per bin, pushed through the
    center pixel's world-space direction.
    """
    pose = np.asarray(pose, np.float64)
    K = np.asarray(K, np.float64)
    h, w = hw
    # pinhole dir of pixel (h/2, w/2), rotated to world (ops/rays.get_rays)
    d_cam = np.array([(w // 2 - K[0, 2]) / K[0, 0],
                      -(h // 2 - K[1, 2]) / K[1, 1], -1.0])
    d = pose[:3, :3] @ d_cam
    o = pose[:3, 3]
    t = np.linspace(0.0, 1.0, n_z)
    z = near * (1.0 - t) + far * t
    mids = 0.5 * (z[1:] + z[:-1])
    upper = np.concatenate([mids, z[-1:]])
    lower = np.concatenate([z[:1], mids])
    u = (rng or np.random.default_rng(0)).uniform(size=n_z)
    z = lower + (upper - lower) * u
    return o[None, :] + d[None, :] * z[:, None]


class _View:
    """The fixed view's projection of world points [M, 3] to pixels,
    scaled so that every point given at construction fits the canvas."""

    def __init__(self, pts: np.ndarray):
        az, el = math.radians(VIEW_AZIM), math.radians(VIEW_ELEV)
        self.right = np.array([-math.sin(az), math.cos(az), 0.0])
        self.up = np.array([-math.cos(az) * math.sin(el),
                            -math.sin(az) * math.sin(el), math.cos(el)])
        uv = self._plane(pts)
        lo, hi = uv.min(0), uv.max(0)
        self.center = 0.5 * (lo + hi)
        self.scale = (SIZE - 2 * MARGIN) / max(float(np.max(hi - lo)), 1e-9)

    def _plane(self, pts: np.ndarray) -> np.ndarray:
        pts = np.asarray(pts, np.float64).reshape(-1, 3)
        return np.stack([pts @ self.right, pts @ self.up], -1)

    def __call__(self, pts: np.ndarray) -> np.ndarray:
        """[M, 3] -> [M, 2] pixel (x, y), y down."""
        uv = (self._plane(pts) - self.center) * self.scale
        return np.stack([SIZE / 2 + uv[:, 0], SIZE / 2 - uv[:, 1]], -1)


def _dot(draw: ImageDraw.ImageDraw, xy, r: float, fill) -> None:
    x, y = xy
    draw.ellipse([x - r, y - r, x + r, y + r], fill=fill)


def _star(draw: ImageDraw.ImageDraw, xy, r: float, fill) -> None:
    x, y = xy
    pts = [(x + (r if k % 2 == 0 else 0.45 * r)
            * math.sin(math.pi * k / 5),
            y - (r if k % 2 == 0 else 0.45 * r)
            * math.cos(math.pi * k / 5)) for k in range(10)]
    draw.polygon(pts, fill=fill)


def _axis_key(draw: ImageDraw.ImageDraw, view: _View) -> None:
    """The world axes' directions in the view, labelled, in a corner."""
    base = np.array([MARGIN / 2 + 20, SIZE - MARGIN / 2 - 20])
    for i, name in enumerate("xyz"):
        e = np.eye(3)[i]
        d = np.array([e @ view.right, -(e @ view.up)]) * 30
        draw.line([tuple(base), tuple(base + d)], fill=AXIS_COLORS[i],
                  width=2)
        draw.text(tuple(base + 1.25 * d), name, fill=(0, 0, 0))


def _legend(draw: ImageDraw.ImageDraw, rows) -> None:
    x, y = SIZE - 130, 16
    for label, mark, color in rows:
        (_star if mark == "star" else _dot)(draw, (x, y + 6), 6 if
                                            mark == "star" else 4, color)
        draw.text((x + 14, y), label, fill=(0, 0, 0))
        y += 18


def visualize_extrinsics(poses: np.ndarray, out_dir: str,
                         idx_list: Optional[Sequence[int]] = None,
                         name: str = "extrinsics",
                         axis_len: float = 0.5,
                         K: Optional[np.ndarray] = None,
                         hw=None, near: float = 2.0, far: float = 6.0,
                         n_z: int = 120) -> str:
    """Save a plot of camera centres and their r/g/b orientation axes of
    length ``axis_len`` (the rows ``idx_list`` of ``poses`` [N, 3|4, 4]),
    and the origin as a star, to ``<out_dir>/<name>.png``; returns the
    path.  With ``K`` and ``hw`` given, also the ``n_z`` jittered points
    along every camera's centre-pixel ray (``center_ray_points``, one
    generator seeded 0 for all cameras), the reference's ``_R_t`` plot."""
    poses = np.asarray(poses, np.float64)
    if idx_list is not None:
        poses = poses[np.asarray(idx_list)]
    os.makedirs(out_dir, exist_ok=True)
    centers = poses[:, :3, 3]
    tips = [c + p[:3, axis] * axis_len for p, c in zip(poses, centers)
            for axis in range(3)]
    ray_pts = []
    if K is not None and hw is not None:
        rng = np.random.default_rng(0)
        ray_pts = [center_ray_points(p, K, hw, near, far, n_z, rng)
                   for p in poses]
    view = _View(np.concatenate([centers, np.zeros((1, 3)),
                                 np.reshape(tips, (-1, 3)), *ray_pts]))
    img = Image.new("RGB", (SIZE, SIZE), "white")
    draw = ImageDraw.Draw(img)
    for pts in ray_pts:
        for xy in view(pts):
            _dot(draw, xy, 1.0, RAY_POINT_COLOR)
    for p, c, xy in zip(poses, centers, view(centers)):
        for axis in range(3):
            tip = view(c + p[:3, axis] * axis_len)[0]
            draw.line([tuple(xy), tuple(tip)], fill=AXIS_COLORS[axis],
                      width=2)
    for xy in view(centers):
        _dot(draw, xy, 4.0, (0, 0, 0))
    _star(draw, view(np.zeros((1, 3)))[0], 12.0, ORIGIN_COLOR)
    _axis_key(draw, view)
    _legend(draw, (("cameras", "dot", (0, 0, 0)),
                   ("origin", "star", ORIGIN_COLOR)))
    path = os.path.join(out_dir, f"{name}.png")
    img.save(path)
    return path


def visualize_rays(rays_o: np.ndarray, rays_d: np.ndarray, out_path: str,
                   t_far: float = 4.0, max_rays: int = 64) -> str:
    """Save a plot of the first ``max_rays`` rays as segments from each
    origin to ``origin + t_far * direction``; returns ``out_path``."""
    o = np.asarray(rays_o, np.float64).reshape(-1, 3)[:max_rays]
    d = np.asarray(rays_d, np.float64).reshape(-1, 3)[:max_rays]
    e = o + d * t_far
    view = _View(np.concatenate([o, e]))
    img = Image.new("RGB", (SIZE, SIZE), "white")
    draw = ImageDraw.Draw(img)
    for a, b in zip(view(o), view(e)):
        draw.line([tuple(a), tuple(b)], fill=RAY_COLOR, width=1)
    _axis_key(draw, view)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    img.save(out_path)
    return out_path
