"""The cells' scenes, made on the card from the seed.

Frozen copies of the analytic scene of
``nerf_pytorch_paeng_tpu_torch/utils/synth.py`` (``_density``,
``_color``, ``render_gt``, ``orbit_pose``, ``make_synth_scene``'s orbit
and ``make_forward_scene``'s forward-facing capture), of the LLFF pose
normalisation and spiral of ``data/llff.py`` (``normalize_loaded_poses``,
``poses_avg``, ``recenter_poses``, ``render_path_spiral``,
``load_llff``'s focus and radii) and of the orbit of
``data/render_pose.py`` (``pose_spherical``, ``get_render_pose``).

The views are rendered in torch on the device, blocks of rays at a time;
the camera draws come from a numpy generator seeded from the run's seed.
Nothing is written to disk: the cells skip the loaders, whose wall is not
measured.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

BLOB_AMP, BLOB_R, BLOB_CUTOFF, COLOR_FREQ = 8.0, 0.6, 1.8, 2.0


def orbit_pose(theta: float, phi: float, radius: float) -> np.ndarray:
    """[4, 4] camera-to-world looking at the origin."""
    st, ct, sp, cp = np.sin(theta), np.cos(theta), np.sin(phi), np.cos(phi)
    center = radius * np.array([ct * cp, st * cp, sp], np.float64)
    z = center / np.linalg.norm(center)
    x = np.cross(np.array([0.0, 0.0, 1.0]), z)
    x = x / (np.linalg.norm(x) + 1e-12)
    y = np.cross(z, x)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, center
    return c2w.astype(np.float32)


def _blob(pts: torch.Tensor):
    """Density (a compactly supported Gaussian) and colour at points."""
    d2 = (pts * pts).sum(-1) / (2 * BLOB_R * BLOB_R)
    floor = float(np.exp(-(BLOB_CUTOFF ** 2) / (2 * BLOB_R * BLOB_R)))
    sigma = BLOB_AMP * torch.clamp(torch.exp(-d2) - floor, min=0.0)
    return sigma, 0.5 + 0.4 * torch.sin(COLOR_FREQ * pts)


@torch.no_grad()
def render_views(H: int, W: int, K: np.ndarray, c2ws: np.ndarray,
                 near, far, device, n_samples: int = 128,
                 block: int = 1 << 17) -> torch.Tensor:
    """The blob composited analytically onto white for each camera ->
    [T, H, W, 3] float32 on ``device``; ``near``/``far`` a number or one
    per view."""
    T = len(c2ws)
    near = np.broadcast_to(np.asarray(near, np.float32), (T,))
    far = np.broadcast_to(np.asarray(far, np.float32), (T,))
    j, i = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                          torch.arange(W, dtype=torch.float32, device=device),
                          indexing="ij")
    dirs = torch.stack([(i - float(K[0, 2])) / float(K[0, 0]),
                        -(j - float(K[1, 2])) / float(K[1, 1]),
                        -torch.ones_like(i)], -1).reshape(-1, 3)
    out = torch.empty((T, H * W, 3), device=device)
    for v in range(T):
        c2w = torch.as_tensor(c2ws[v], dtype=torch.float32, device=device)
        t = torch.linspace(float(near[v]), float(far[v]), n_samples,
                           device=device)
        dist = torch.cat([t[1:] - t[:-1], t.new_full((1,), 1e10)])
        for a in range(0, H * W, block):
            d = dirs[a:a + block] @ c2w[:3, :3].T
            pts = c2w[:3, 3] + d[:, None, :] * t[:, None]
            sigma, rgb = _blob(pts)
            alpha = 1.0 - torch.exp(-sigma * dist
                                    * torch.linalg.norm(d, dim=-1)[:, None])
            trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]),
                                             1.0 - alpha + 1e-10], -1),
                                  -1)[:, :-1]
            w = alpha * trans
            out[v, a:a + block] = ((w[..., None] * rgb).sum(1)
                                   + (1.0 - w.sum(-1))[:, None])
    return out.reshape(T, H, W, 3)


def intrinsics(H: int, W: int, focal: float) -> np.ndarray:
    return np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]],
                    np.float64)


def blender_scene(spec: Dict, seed: int, device) -> Dict:
    """Training views on an orbit around the blob at the spec's field of
    view (``camera_angle_x``), radius and elevation; the orbit starts at
    an angle drawn from the seed.  All views are training views."""
    H, W, n = int(spec["H"]), int(spec["W"]), int(spec["n_train"])
    focal = 0.5 * W / float(np.tan(0.5 * float(spec["camera_angle_x"])))
    K = intrinsics(H, W, focal)
    start = np.random.default_rng(seed).uniform(0.0, 2 * np.pi)
    thetas = start + np.linspace(0, 2 * np.pi, n, endpoint=False)
    poses = np.stack([orbit_pose(t, float(spec["phi"]),
                                 float(spec["radius"])) for t in thetas])
    images = render_views(H, W, K, poses, float(spec["near"]),
                          float(spec["far"]), device)
    return dict(images=images, K=K, poses=poses, hw=(H, W),
                i_train=np.arange(n))


# ------------------------------------------------- forward-facing (LLFF)


def _normalize(x):
    return x / np.linalg.norm(x)


def _view_matrix(z, up, pos):
    vec2 = _normalize(z)
    vec0 = _normalize(np.cross(up, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], 1)


def _poses_avg(poses):
    center = poses[:, :3, 3].mean(0)
    forward = _normalize(poses[:, :3, 2].sum(0))
    return _view_matrix(forward, poses[:, :3, 1].sum(0), center)


def _recenter(poses):
    bottom = np.array([[0, 0, 0, 1.0]])
    c2w = np.concatenate([_poses_avg(poses), bottom], 0)
    homog = np.concatenate(
        [poses[:, :3, :4], np.tile(bottom[None], [len(poses), 1, 1])], 1)
    return (np.linalg.inv(c2w) @ homog)[:, :3, :4]


def _spiral(c2w, up, rads, focal, zrate, rots, n):
    rads = np.array(list(rads) + [1.0])
    out = []
    for theta in np.linspace(0.0, 2.0 * np.pi * rots, n + 1)[:-1]:
        c = c2w[:3, :4] @ (np.array([np.cos(theta), -np.sin(theta),
                                     -np.sin(theta * zrate), 1.0]) * rads)
        z = _normalize(c - c2w[:3, :4] @ np.array([0, 0, -focal, 1.0]))
        out.append(_view_matrix(z, up, c))
    return np.stack(out).astype(np.float32)


def forward_scene(spec: Dict, seed: int, device, images: bool = True
                  ) -> Dict:
    """A forward-facing capture of the blob (cameras on a jittered plane
    at z ~ ``dist``, looking at the origin), its poses normalised and
    recentred as the LLFF loader does (bounds scaled by 1 / (0.75 x the
    nearest)), views ``::testskip`` held out, and the loader's 120-view
    two-turn spiral as the render path.  ``images=False`` makes the
    poses alone."""
    H, W, n = int(spec["H"]), int(spec["W"]), int(spec["n_views"])
    dist, spread = float(spec["dist"]), float(spec["spread"])
    K = intrinsics(H, W, float(spec["focal_frac"]) * W)
    rng = np.random.default_rng(seed)
    poses, bounds = [], []
    for _ in range(n):
        center = np.array([rng.uniform(-spread, spread),
                           rng.uniform(-spread, spread),
                           dist + rng.uniform(-0.15, 0.15)])
        z = center / np.linalg.norm(center)
        x = _normalize(np.cross(np.array([0.0, 1.0, 0.0]), z))
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = \
            x, np.cross(z, x), z, center
        d = float(np.linalg.norm(center))
        poses.append(c2w)
        bounds.append((max(d - BLOB_CUTOFF - 0.2, 0.5), d + BLOB_CUTOFF + 0.2))
    poses, bounds = np.stack(poses), np.asarray(bounds, np.float32)
    imgs = (render_views(H, W, K, poses, bounds[:, 0], bounds[:, 1], device,
                         n_samples=int(spec.get("n_samples", 256)))
            if images else None)
    # the loader's normalisation: scale, recentre
    sc = 1.0 / (float(bounds.min()) * 0.75)
    p = poses[:, :3, :4].astype(np.float32).copy()
    p[:, :3, 3] *= sc
    bounds = bounds * sc
    p = _recenter(p).astype(np.float32)
    # the loader's spiral
    c2w = _poses_avg(p)
    up = _normalize(p[:, :3, 1].sum(0))
    close, inf = bounds.min() * 0.9, bounds.max() * 5.0
    focus = 1.0 / ((1.0 - 0.75) / close + 0.75 / inf)
    rads = np.percentile(np.abs(p[:, :3, 3]), 90, 0)
    path = _spiral(c2w, up, rads, focus, zrate=0.5, rots=2, n=120)
    skip = max(int(spec["testskip"]), 1)
    i_train = np.array([i for i in range(n) if i % skip])
    return dict(images=imgs, K=K, poses=p, hw=(H, W), i_train=i_train,
                render_poses=path)


# -------------------------------------------------- the blender orbit path


def render_orbit(n_angle: int, phi: float, nf: float) -> np.ndarray:
    """The novel-view orbit: theta over [-180, 180) in ``n_angle`` steps at
    elevation ``phi`` (degrees) and radius ``nf`` -> [M, 4, 4]."""
    flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
                    np.float64)
    out = []
    for th in np.linspace(-180.0, 180.0, n_angle + 1)[:-1]:
        m = np.eye(4)
        m[2, 3] = nf
        c, s = np.cos(phi / 180.0 * np.pi), np.sin(phi / 180.0 * np.pi)
        rp = np.eye(4)
        rp[1, 1], rp[1, 2], rp[2, 1], rp[2, 2] = c, -s, s, c
        c, s = np.cos(th / 180.0 * np.pi), np.sin(th / 180.0 * np.pi)
        rt = np.eye(4)
        rt[0, 0], rt[0, 2], rt[2, 0], rt[2, 2] = c, -s, s, c
        out.append(flip @ (rt @ (rp @ m)))
    return np.stack(out).astype(np.float32)


SCENES = {"blender": blender_scene, "forward": forward_scene}
