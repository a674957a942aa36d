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

``fit_field_to_blob`` (the JAX package's function of that name) distills
the analytic blob into both MLPs of a ``NeRF``: the port's stand-in for a
trained field with genuine empty space, on which the culled renderer, its
support grids and gated training are measured.  Its parts are
``blob_field`` (the ground truth), ``blob_sigma_loss`` (the density's
hinge), ``orbit_ray_points`` / ``polish_points`` (the points, from
injected draws) and ``blob_fit_loss`` over ``blob_fit_fields``.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Tuple

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


# ------------------------------------------------ the blob-field distillation

# the orbit of ``make_synth_scene``: where rendering will look
FIT_NEAR, FIT_FAR, FIT_RADIUS = 2.0, 6.0, 4.0
FIT_PHI, FIT_FOCAL_FRAC = 0.35, 0.9
FIT_INNER = 3.2          # half-side of the inner cube of the uniform points


def _f32(fn, x: float) -> float:
    """``fn`` of ``x`` in float32, as a Python float: a constant computed
    as the JAX package computes it, exact when it meets a float32 tensor."""
    return float(fn(torch.tensor(x, dtype=torch.float32)))


def blob_field(pts: torch.Tensor, blob_r: float = 0.6,
               blob_cutoff: float = 1.8, blob_amp: float = 8.0,
               blob_hard_w: float = 0.0
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The distillation's ground truth at points [P, 3] -> (density
    [P], colour logits [P, 3]): the truncated Gaussian blob of
    ``_density`` (compact support: any tail density turns opaque at the
    1e10 last-sample distance), or with ``blob_hard_w > 0`` a surface-like
    front, full amplitude inside radius ``blob_cutoff`` with a linear ramp
    of width ``blob_hard_w`` (the step-like fronts long photometric
    training carves, which the culled renderer's sample truncation needs);
    the colour of ``_color`` as logits."""
    if blob_hard_w > 0:
        r = torch.sqrt(torch.sum(pts ** 2, -1))
        sig = blob_amp * torch.clamp((blob_cutoff - r) / blob_hard_w,
                                     0.0, 1.0)
    else:
        d2 = torch.sum(pts ** 2, -1) / (2 * blob_r * blob_r)
        floor = _f32(torch.exp, -(blob_cutoff * blob_cutoff)
                     / (2 * blob_r * blob_r))
        sig = blob_amp * torch.clamp(torch.exp(-d2) - floor, min=0.0)
    col = 0.5 + 0.4 * torch.sin(2.0 * pts)
    return sig, torch.log(col) - torch.log1p(-col)


def blob_sigma_loss(raw: torch.Tensor, sig_gt: torch.Tensor, margin: float,
                    lin_w: float, blob_amp: float) -> torch.Tensor:
    """Per-point density loss: the squared error where occupied (scaled by
    8 / ``blob_amp``, so the loss does not depend on the amplitude), a
    hinge raw <= -``margin`` where empty (squared, plus ``lin_w`` times
    the linear term).  The hinge makes relu(raw) exactly 0 in empty space
    despite fit error: the last sample's 1e10 distance turns any positive
    density there into full opacity, and the support grid reads any
    raw > 0 as occupied."""
    viol = torch.relu(raw + margin)
    return torch.where(sig_gt > 0, (8.0 / blob_amp * (raw - sig_gt)) ** 2,
                       viol ** 2 + lin_w * viol)


def orbit_draws(n_pts: int, uniform_frac: float = 0.0,
                generator: Optional[torch.Generator] = None,
                device=None) -> Dict[str, torch.Tensor]:
    """One main-phase step's draws for ``orbit_ray_points``, from
    ``generator``: U[0, 1) ``theta``, ``u``, ``v``, ``t`` [n_pts]; with
    ``uniform_frac`` > 0 also N(0, 1) ``blur`` [n_pts, 3], U[0, 1)
    ``cube_in`` and ``cube_out`` [n / 2, 3] and N(0, 1) ``udir`` [n, 3]
    for the n uniform points."""
    def rand(*shape):
        return torch.rand(shape, generator=generator, device=device)

    def randn(*shape):
        return torch.randn(shape, generator=generator, device=device)
    out = dict(theta=rand(n_pts), u=rand(n_pts), v=rand(n_pts),
               t=rand(n_pts))
    if uniform_frac > 0:
        n_uni = max(2, int(n_pts * uniform_frac))
        out.update(blur=randn(n_pts, 3), cube_in=rand(n_uni // 2, 3),
                   cube_out=rand(n_uni - n_uni // 2, 3), udir=randn(n_uni, 3))
    return out


def polish_draws(n_pts: int, generator: Optional[torch.Generator] = None,
                 device=None) -> Dict[str, torch.Tensor]:
    """One polish step's draws for ``polish_points``: N(0, 1) ``blob``
    [n_pts, 3] and U[0, 1) ``cube`` [3 n_pts, 3]."""
    return dict(blob=torch.randn((n_pts, 3), generator=generator,
                                 device=device),
                cube=torch.rand((3 * n_pts, 3), generator=generator,
                                device=device))


def _uniform(u01: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """U[0, 1) draws scaled to [lo, hi), as ``jax.random.uniform`` scales
    its own."""
    return u01 * (hi - lo) + lo


def orbit_ray_points(draws: Dict[str, torch.Tensor], uniform_frac: float = 0.0,
                     uniform_halfside: float = 6.0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Points where rendering will look, from ``orbit_draws``' tensors:
    one pixel ray of a random orbit camera each (``make_synth_scene``'s
    orbit and focal length), at a uniform depth in [near, far) ->
    (points [P, 3], unit directions [P, 3]).  With ``uniform_frac`` > 0
    the view cone is blurred (direction noise, amplified by the depth),
    so the ray points also press the volume off the frusta, and the
    uniform points follow: half in the inner cube (dense pressure where
    junk density costs render quality), half over the whole
    [-``uniform_halfside``, ``uniform_halfside``]^3 cube that the support
    grid probes, with random unit directions."""
    theta = _uniform(draws["theta"], 0.0, 2 * math.pi)
    st, ct = torch.sin(theta), torch.cos(theta)
    sp, cp = _f32(torch.sin, FIT_PHI), _f32(torch.cos, FIT_PHI)
    center = FIT_RADIUS * torch.stack(
        [ct * cp, st * cp, torch.full_like(ct, sp)], -1)           # [P, 3]
    z = center / torch.linalg.norm(center, dim=-1, keepdim=True)
    up = torch.zeros_like(z)
    up[:, 2] = 1.0              # a fill, not a copy from the host
    x = torch.linalg.cross(up, z)
    x = x / (torch.linalg.norm(x, dim=-1, keepdim=True) + 1e-12)
    y = torch.linalg.cross(z, x)
    u = _uniform(draws["u"], -0.5, 0.5)
    v = _uniform(draws["v"], -0.5, 0.5)
    d = (x * (u / FIT_FOCAL_FRAC)[:, None] + y * (-v / FIT_FOCAL_FRAC)[:, None]
         - z)
    t = _uniform(draws["t"], FIT_NEAR, FIT_FAR)
    if uniform_frac > 0:
        d = d + 0.35 * draws["blur"]
    pts = center + t[:, None] * d
    dirs = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    if uniform_frac > 0:
        inner = min(FIT_INNER, uniform_halfside)
        upts = torch.cat([
            _uniform(draws["cube_in"], -inner, inner),
            _uniform(draws["cube_out"], -uniform_halfside, uniform_halfside)])
        udir = draws["udir"]
        udir = udir / (torch.linalg.norm(udir, dim=-1, keepdim=True) + 1e-9)
        pts, dirs = torch.cat([pts, upts]), torch.cat([dirs, udir])
    return pts, dirs


def polish_points(draws: Dict[str, torch.Tensor], blob_cutoff: float = 1.8,
                  uniform_halfside: float = 6.0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The polish phase's sweep, from ``polish_draws``' tensors: a quarter
    of the points in a Gaussian ball around the blob (so the occupied
    regression stays anchored), the rest uniform over the whole cube;
    directions radial -> (points [4 n, 3], directions [4 n, 3])."""
    pts = torch.cat([draws["blob"] * (0.6 * blob_cutoff),
                     _uniform(draws["cube"], -uniform_halfside,
                              uniform_halfside)])
    dirs = pts / (torch.linalg.norm(pts, dim=-1, keepdim=True) + 1e-9)
    return pts, dirs


def blob_fit_fields(model, cfg=None, L_x: int = 10, L_d: int = 4,
                    train_fn: Optional[Callable] = None) -> List[Callable]:
    """The coarse and fine modules of ``model`` as differentiable fields
    ``(points [P, 3], directions [P, 3]) -> raw [P, 4]`` float32, routed as
    the train step routes (``ops/render.plain_route_reason`` of ``cfg``,
    default ``NerfConfig()``, at the model's depth and width and the
    encodings ``L_x``, ``L_d``): inside the kernels' domain the plane pair
    (``fused_mlp_vjp.fused_mlp_train``, or ``train_fn``: K8 forward, K9
    backward; their plain versions on the CPU), else the plain MLP
    (``ops/render.plain_field_fn``) under autograd, the JAX package's
    embedding and ``cfg.compute_dtype``."""
    from ..config import NerfConfig
    from ..kernels.fused_mlp import kernel_weight_dtype, pack_flat
    from ..kernels.fused_mlp_vjp import fused_mlp_train
    from ..ops.render import plain_field_fn, plain_route_reason

    mlps = (model.model_coarse, model.model_fine)
    device = next(model.parameters()).device
    cfg = dataclasses.replace(
        cfg or NerfConfig(), netDepth=len(mlps[0].linear_x),
        netWidth=mlps[0].linear_x[0].out_features, L_x=L_x, L_d=L_d,
        chunk_pts=0, device=device.type)
    if plain_route_reason(cfg) is not None:
        return [(lambda f: lambda pts, dirs: f(pts.T, dirs.T).T)(
            plain_field_fn(m, cfg)) for m in mlps]
    train_fn = train_fn or fused_mlp_train
    wdt = kernel_weight_dtype(cfg.compute_dtype, device)

    def field(mlp):
        def fn(pts, dirs):
            w, b = pack_flat(mlp, L_x, L_d)
            return train_fn(w, b, pts.T.contiguous(), dirs.T.contiguous(),
                            L_x, L_d, wdt).T
        return fn
    return [field(m) for m in mlps]


def blob_fit_loss(fields: List[Callable], pts: torch.Tensor,
                  dirs: torch.Tensor, blob_r: float = 0.6,
                  blob_cutoff: float = 1.8, blob_amp: float = 8.0,
                  blob_hard_w: float = 0.0, polish: bool = False
                  ) -> torch.Tensor:
    """The distillation loss of one step: for each field the mean density
    loss plus the mean squared error of the colour logits.  The main
    phase's hinge is the soft squared one at margin 0.2 (a deeper one
    sharpens the silhouette ring); the polish phase's is at margin 0.5
    with a linear term (the squared term's gradient vanishes near the
    margin, which would leave straggler bumps slightly positive), with the
    colour supervised only where occupied and the density only where
    occupied and in the far field beyond ``blob_cutoff + 0.6``: a hinge
    right outside the silhouette would sharpen the front, and regressing
    the whole empty cube drags the shared trunk."""
    sig_gt, raw_col = blob_field(pts, blob_r, blob_cutoff, blob_amp,
                                 blob_hard_w)
    occ = sig_gt > 0
    margin, lin_w = (0.5, 0.5) if polish else (0.2, 0.0)
    if polish:
        keep = occ | (torch.sqrt(torch.sum(pts ** 2, -1))
                      > blob_cutoff + 0.6)
    total = 0.0
    for fn in fields:
        raw = fn(pts, dirs)
        ce = (raw[:, :3] - raw_col) ** 2
        sl = blob_sigma_loss(raw[:, 3], sig_gt, margin, lin_w, blob_amp)
        if polish:
            ce = torch.where(occ[:, None], ce, torch.zeros_like(ce))
            sl = torch.where(keep, sl, torch.zeros_like(sl))
        total = total + torch.mean(sl) + torch.mean(ce)
    return total


POLISH_MIN_STEPS = 40
COSINE_FLOOR = 0.01       # the main phase's last rate, a share of the first


def polish_steps(n_steps: int) -> int:
    """The polish phase's length after ``n_steps`` main steps."""
    return max(n_steps // 8, POLISH_MIN_STEPS)


def fit_learning_rates(n_steps: int, lr: float, lr_schedule: str = "cosine"
                       ) -> Tuple[List[float], float]:
    """The distillation's learning rates -> (the main phase's, one a step;
    the polish phase's).  ``"constant"``: ``lr`` throughout, as the JAX
    function runs its ``optax.adam(lr)``.  ``"cosine"``: the main phase
    decays from ``lr`` to ``COSINE_FLOOR`` of it along a half cosine, and
    the polish phase runs at ``lr`` times ``POLISH_MIN_STEPS`` over its
    length, so that however long it is it moves the weights as far as the
    shortest polish does at ``lr``.  At a constant rate the hard-fronted
    blob's fit (1,500 steps at amplitude 60) can end inside an Adam loss
    spike, in the JAX function as here, and its 187 polish steps, which
    press nothing between the blob and the far field, grow a density
    halo there that the culled and dense renderers read differently; the
    40-step polish of the 300-step fits does not."""
    if lr_schedule == "constant":
        return [lr] * n_steps, lr
    if lr_schedule != "cosine":
        raise ValueError(f"lr_schedule {lr_schedule!r}: constant or cosine")
    end = COSINE_FLOOR * lr
    main = [end + 0.5 * (lr - end) * (1 + math.cos(
        math.pi * i / max(n_steps - 1, 1))) for i in range(n_steps)]
    return main, lr * POLISH_MIN_STEPS / polish_steps(n_steps)


def fit_field_to_blob(model, n_steps: int = 400, n_pts: int = 8192,
                      lr: float = 2e-3, L_x: int = 10, L_d: int = 4,
                      blob_r: float = 0.6, blob_cutoff: float = 1.8,
                      blob_amp: float = 8.0, blob_hard_w: float = 0.0,
                      uniform_frac: float = 0.0,
                      uniform_halfside: float = 6.0,
                      generator: Optional[torch.Generator] = None,
                      draws: Optional[Callable] = None, cfg=None,
                      lr_schedule: str = "cosine"
                      ) -> Tuple[Dict[str, torch.Tensor], float]:
    """Distill the analytic blob into both MLPs of ``model`` (a ``NeRF``)
    -> (the fitted ``NeRF`` state dict, the final main-phase loss); the
    JAX package's ``utils/synth.fit_field_to_blob``, which
    ``lr_schedule="constant"`` reproduces, with the learning rates of
    ``fit_learning_rates`` by default.  ``model`` itself is left as it
    was, as the JAX function leaves its params.

    Each MLP's raw outputs are regressed at points along the orbit's
    camera rays: the density logit to the blob's density where occupied
    and under a hinge where empty (``blob_sigma_loss``), the colour
    logits to logit(colour).  Photometric training on the white-background
    blob would learn white fog; distillation gives a field with genuine
    empty space.  ``n_steps`` Adam steps (eps 1e-8, optax's ``adam``) at
    ``n_pts`` ray points (``orbit_ray_points``); with
    ``uniform_frac`` > 0 also that share of uniform points, and a polish
    phase of max(``n_steps`` // 8, 40) steps over 4 ``n_pts`` points of
    the whole cube (``polish_points``), so that the support grid reads a
    clean shell.  The fields are ``blob_fit_fields``' of ``cfg`` (its
    ``compute_dtype`` and route, as the JAX function takes them from its
    ``model``): the plane pair (2 K8 + 2 K9 launches a step on the card)
    inside the kernels' domain.

    ``draws(i, phase)`` gives step i's draws of ``phase`` ("main" or
    "polish"; ``orbit_draws``' or ``polish_draws``' keys); without it they
    come from ``generator`` (a ``torch.Generator`` on the model's device,
    seeded by the caller).  The loss is read once, at the end: the last
    main step's, one minibatch's, as the JAX function returns it.  A
    caller judging the fitted field reads ``blob_fit_loss`` of the
    returned weights on fresh draws."""
    model = copy.deepcopy(model)
    device = next(model.parameters()).device
    fields = blob_fit_fields(model, cfg, L_x, L_d)
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    blob = dict(blob_r=blob_r, blob_cutoff=blob_cutoff, blob_amp=blob_amp,
                blob_hard_w=blob_hard_w)
    if draws is None:
        def draws(i, phase):
            if phase == "main":
                return orbit_draws(n_pts, uniform_frac, generator, device)
            return polish_draws(n_pts, generator, device)

    def step(pts, dirs, polish):
        opt.zero_grad(set_to_none=True)
        loss = blob_fit_loss(fields, pts, dirs, polish=polish, **blob)
        loss.backward()
        opt.step()
        return loss.detach()

    main_lrs, polish_lr = fit_learning_rates(n_steps, lr, lr_schedule)
    for i in range(n_steps):
        opt.param_groups[0]["lr"] = main_lrs[i]
        loss = step(*orbit_ray_points(draws(i, "main"), uniform_frac,
                                      uniform_halfside), False)
    if uniform_frac > 0:
        opt.param_groups[0]["lr"] = polish_lr
        for j in range(polish_steps(n_steps)):
            step(*polish_points(draws(j, "polish"), blob_cutoff,
                                uniform_halfside), True)
    return ({k: v.detach().clone() for k, v in model.state_dict().items()},
            float(loss))


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
