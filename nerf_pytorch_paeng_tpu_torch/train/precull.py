"""Occupancy-gated training (``cfg.train_precull``; counterpart of the JAX
package's ``train/precull.py``).

Support bounds of each MLP module's density field (the coarse and the fine
networks are independent, so each gets its own) are measured on a G^3 grid
(K7, ``fused_mlp_sigma``) every ``train_precull_every`` steps, restricted to
the union of the training cameras' frusta; the train step then gates each
pass's kernels (K5 forward, K6 backward) to every ray's support interval
(``ops/render.render_rays_train(support=...)``).

Why gating does not change training: a sample provably outside a module's
support has a density logit <= 0, so its compositing weight is exactly 0
ungated too, and its gradient contribution is 0 (the ReLU kills the
density cotangent, the zero weight the colour ones); skipping it changes
only the float32 summation order of the gradients.  Between refreshes the
bounds can go stale only by support growth through non-local weight
updates; the refresh re-measures the live field.

The driver decides at every refresh whether gating pays
(``make_gate_frac_estimator`` against ``train_precull_min_gate``) and backs
off while it declines (``driver.train``).  The reference has no such path:
it evaluates every sample of every ray every step.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

_ON = ("on", "true", "t", "yes", "y", "1")


def train_precull_mode(cfg) -> str:
    """``cfg.train_precull`` as "auto" | "on" | "off".  "auto" (the
    default) and "on" both run the policy-guarded gated path where it
    applies; an explicit "on" (or True) warns where it does not."""
    v = cfg.train_precull
    if isinstance(v, bool):
        return "on" if v else "off"
    s = str(v).strip().lower()
    if s == "auto":
        return "auto"
    return "on" if s in _ON else "off"


def train_precull_enabled(cfg, n_rays: int = 0) -> bool:
    """Gating applies where the gated kernels run: blender (origin-centred)
    scenes, the ray-major kernel pair (the kernels' domain, ``use_pallas``
    included, ``use_rays_train`` and its shapes; the plane and plain routes
    train ungated), and a usable support grid (on the CPU only with an
    explicit ``render_precull_grid``: there the grid runs the plain
    versions).  ``n_rays`` is the count one rank trains on
    (``train_precull_active``)."""
    from ..eval.frame import _precull_grid
    from ..ops.render import supports_train_rays_kernels

    n = n_rays or cfg.N_rays
    return bool(train_precull_mode(cfg) != "off"
                and cfg.data_type == "blender"
                and cfg.use_rays_train
                and supports_train_rays_kernels(cfg, n)
                and _precull_grid(cfg, torch.device(cfg.device)) > 0)


def train_precull_active(cfg, world: int) -> bool:
    """``train_precull_enabled`` at the per-rank ray count of a launch of
    ``world`` ranks, where the ranks split the batch evenly (the JAX
    package's ``train_precull_active``: its shard_map path needs a
    dividing batch, and each shard gates its ``N_rays / world`` rays).
    Never under ``n_model_shards > 1``: the width-sharded step takes the
    plain route (JAX ``train/precull.py:77-83``)."""
    if int(cfg.n_model_shards) > 1 or cfg.N_rays % world != 0:
        return False
    return train_precull_enabled(cfg, cfg.N_rays // world)


def make_train_support_program(cfg, poses=None, K=None, hw=None,
                               device=None, points_fn: Optional[Callable] = None):
    """``(prog, half)``: ``prog(model) -> ((lo, hi, r, valid) coarse,
    (lo, hi, r, valid) fine)`` packs each module of a ``NeRF`` in the
    compute type and measures its support on the ``render_precull_grid``^3
    grid over [-half, half]^3 (half = ``render_precull_halfside`` or far,
    as the culled renderer's): two K7 launches.

    With the training cameras (``poses`` [M, 3 or 4, 4], ``K``, ``hw``)
    the measurement is restricted to their frustum union
    (``ops/occupancy.frustum_union_mask``, computed once here): density
    where no training ray samples is irrelevant to training but would
    reach the cube's boundary and invalidate the bounds.  Sound for gating
    training steps only; the culled renderer keeps unmasked bounds.
    ``points_fn`` defaults to the K7 wrapper."""
    from ..eval.frame import _precull_grid, _precull_half
    from ..kernels.fused_mlp import fused_mlp_sigma, pack_nerf
    from ..ops.occupancy import frustum_union_mask, support_bounds_from_sigma

    device = torch.device(device if device is not None else cfg.device)
    points_fn = points_fn or fused_mlp_sigma
    half = _precull_half(cfg)
    grid = _precull_grid(cfg, device)
    domain = None
    if poses is not None:
        domain = frustum_union_mask(poses, K, int(hw[0]), int(hw[1]),
                                    float(cfg.near), float(cfg.far), half,
                                    grid, device=device)

    def prog(model):
        packed = pack_nerf(model, cfg, device=device)

        def bounds_of(p):
            return support_bounds_from_sigma(
                lambda xp: points_fn(xp, p, L_x=cfg.L_x,
                                     out_dtype=torch.bfloat16),
                half, grid=grid, domain_mask=domain, device=device)

        return bounds_of(packed["coarse"]), bounds_of(packed["fine"])

    return prog, half


def make_gate_frac_estimator(cfg):
    """Predictor of the gated step's skipped block share (the ``gate_frac``
    metric) on a ray batch, without any MLP: the interval and gate-plan
    arithmetic of the gated passes (same tile choice).

    - coarse: the stratified sampler's bin midpoints (a jittered draw
      moves a sample within its bin, so row activity differs from a real
      step only at boundary bins);
    - fine: a lower bound: the fine samples are spread over the ray's
      whole active interval, where real ones gather at surfaces inside it.

    Weighted by row count over the two passes, as the step's metric.
    Returns ``est(bounds_c, bounds_f, rays_o [N, 3], rays_d [N, 3]) ->``
    0-dim float32."""
    from ..eval.frame import _precull_half
    from ..ops.render import (_train_rays_tile, train_gate_plan,
                              train_gate_tile, train_support_intervals)

    half = _precull_half(cfg)
    near, far = float(cfg.near), float(cfg.far)
    s_c, s_f = int(cfg.N_samples_c), int(cfg.N_samples_f)

    @torch.no_grad()
    def est(bounds_c, bounds_f, rays_o, rays_d):
        n = rays_o.shape[0]
        dev = rays_o.device
        tile = train_gate_tile(cfg, n, _train_rays_tile(n) or 2048)
        mids = near + (far - near) * (
            torch.arange(s_c, dtype=torch.float32, device=dev) + 0.5) / s_c
        z_c = mids[:, None].expand(s_c, n)
        lo_c, hi_c = train_support_intervals(rays_o, rays_d, bounds_c, half,
                                             near, far)
        *_, gf_c = train_gate_plan(z_c, lo_c, hi_c, tile)
        if s_f <= 0:
            return gf_c
        lo_f, hi_f = train_support_intervals(rays_o, rays_d, bounds_f, half,
                                             near, far)
        # coarse midpoints + s_f points spread over each ray's clamped
        # active interval (an empty interval puts them at lo_f > hi_f:
        # inactive, so miss rays gate fully)
        lo = torch.clamp(lo_f, min=near)
        width = torch.clamp(torch.clamp(hi_f, max=far) - lo, min=0.0)
        u = (torch.arange(s_f, dtype=torch.float32, device=dev) + 0.5) / s_f
        z_f = lo[None] + width[None] * u[:, None]                # [S_f, N]
        z_all = torch.sort(torch.cat([z_c, z_f], 0), 0).values
        *_, gf_f = train_gate_plan(z_all, lo_f, hi_f, tile)
        r_c, r_f = s_c // 8, (s_c + s_f) // 8
        return (gf_c * r_c + gf_f * r_f) / (r_c + r_f)

    return est
