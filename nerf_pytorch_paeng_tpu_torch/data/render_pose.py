"""Novel-view orbit poses for blender renders.

Own numpy copy of the JAX package's ``data/render_pose.py`` (the
reference's ``dataset/render_pose.py``): ``pose_spherical(theta, phi,
radius)`` composes translate-z, rotate-x, rotate-y and a fixed axis flip;
``get_render_pose`` sweeps theta over [-180, 180) in ``n_angle`` steps or
gives a single pose.
"""
from __future__ import annotations

import numpy as np


def _trans_t(t: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float64)
    m[2, 3] = t
    return m


def _rot_phi(phi: float) -> np.ndarray:
    c, s = np.cos(phi), np.sin(phi)
    m = np.eye(4, dtype=np.float64)
    m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
    return m


def _rot_theta(th: float) -> np.ndarray:
    c, s = np.cos(th), np.sin(th)
    m = np.eye(4, dtype=np.float64)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, -s, s, c
    return m


_AXIS_FIX = np.array([[-1, 0, 0, 0],
                      [0, 0, 1, 0],
                      [0, 1, 0, 0],
                      [0, 0, 0, 1]], np.float64)


def pose_spherical(theta_deg: float, phi_deg: float, radius: float
                   ) -> np.ndarray:
    """[4,4] c2w on a sphere: theta azimuth, phi elevation (degrees), radius."""
    c2w = _trans_t(radius)
    c2w = _rot_phi(phi_deg / 180.0 * np.pi) @ c2w
    c2w = _rot_theta(theta_deg / 180.0 * np.pi) @ c2w
    return (_AXIS_FIX @ c2w).astype(np.float32)


def get_render_pose(n_angle: int = 1, single_angle: float = -1,
                    phi: float = -30.0, nf: float = 4.0) -> np.ndarray:
    """[M,4,4] orbit (theta over [-180,180), M=n_angle) or one pose."""
    if n_angle != 1 and single_angle == -1:
        thetas = np.linspace(-180.0, 180.0, n_angle + 1)[:-1]
        return np.stack([pose_spherical(t, phi, nf) for t in thetas], 0)
    return pose_spherical(single_angle, phi, nf)[None]
