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

The policy (``SupportPolicy``, NeRF's hook between the train loop's
chunks) decides at every refresh whether gating pays
(``make_gate_frac_estimator`` against ``train_precull_min_gate``) and backs
off while it declines.  The reference has no such path: it evaluates every
sample of every ray every step.
"""
from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from .. import parallel
from ..ops.rays import get_rays
from ..parallel import print0
from ..utils.spans import span
from .chunk import NoHook

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


class SupportPolicy:
    """The refresh of occupancy-gated training: support bounds of both
    modules from the live weights, the predicted skipped share on a fixed
    probe batch, and the decision whether the next steps run gated.

    The probe batch is drawn once with ``np.random.default_rng(seed + 7)``
    exactly as the JAX package's driver draws it (up to 4 training views,
    then pixels of each), at the ray count one rank trains on, so both
    predict the same ``gate_frac``.  Each refresh makes one host read
    (both validity flags and the prediction), appends
    ``iter,bounds_valid,gate_frac_pred,gated`` to
    ``logs/<exp>/precull_policy.csv`` (truncated on a fresh run, appended
    on a resume) and prints the decision when it changes.  Under a
    process group the bounds and the prediction are rank 0's, broadcast,
    so every rank decides alike and gates with the same bounds; rank 0
    alone writes and prints.

    As the train loop's hook (``train/chunk.NoHook``) it refreshes before
    step ``iter_start + 1`` and then every ``train_precull_every`` steps,
    the interval doubling (up to ``train_precull_backoff_max`` times)
    while the policy declines."""

    def __init__(self, cfg, K, extrinsics, hw, i_train, device, n_est: int):
        H, W = hw
        self.cfg = cfg
        self.prog, _ = make_train_support_program(
            cfg, poses=np.asarray(extrinsics)[i_train, :3, :4],
            K=np.asarray(K), hw=(H, W), device=device)
        self.est = make_gate_frac_estimator(cfg)
        rng = np.random.default_rng(cfg.seed + 7)
        sel = rng.choice(i_train, size=min(4, len(i_train)), replace=False)
        eo, ed = [], []
        for p in sel:
            ro, rd = get_rays(H, W, K, torch.as_tensor(
                np.asarray(extrinsics[p])[:3, :4], dtype=torch.float32))
            pix = rng.choice(H * W, size=-(-n_est // len(sel)), replace=False)
            eo.append(ro.reshape(-1, 3).numpy()[pix])
            ed.append(rd.reshape(-1, 3).numpy()[pix])
        self.rays_o = torch.as_tensor(np.concatenate(eo)[:n_est], device=device)
        self.rays_d = torch.as_tensor(np.concatenate(ed)[:n_est], device=device)
        self.gated = None           # the first refresh always prints
        self.support, self.backoff = None, 1
        self.next_refresh = cfg.iter_start + 1
        self.path = os.path.join(cfg.logdir, cfg.exp_name,
                                 "precull_policy.csv")
        if parallel.is_main() and (cfg.iter_start == 0
                                   or not os.path.isfile(self.path)):
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            with open(self.path, "w") as f:
                f.write("iter,bounds_valid,gate_frac_pred,gated\n")

    def refresh(self, model, it: int):
        """The bounds to gate with from step ``it`` on, or None (ungated):
        None while the bounds are invalid or the predicted skipped share
        cannot repay the sort and the smaller tiles.  Span
        ``policy.refresh``."""
        with span("policy.refresh"):
            bc, bf = self.prog(model)
            gf = self.est(bc, bf, self.rays_o, self.rays_d)
            if parallel.world_size() > 1:
                for t in (*bc, *bf, gf):
                    parallel.broadcast0(t)
            vc, vf, gfh = torch.stack([bc[3][0].float(), bf[3][0].float(),
                                       gf.float()]).tolist()  # one host read
        valid = bool(vc) and bool(vf)
        on = valid and gfh >= self.cfg.train_precull_min_gate
        if parallel.is_main():
            with open(self.path, "a") as f:
                f.write(f"{it},{int(valid)},{gfh:.4f},{int(on)}\n")
        if on != self.gated:
            self.gated = on
            why = f"predicted gate_frac {gfh:.3f}" if valid \
                else "bounds invalid"
            print0(f">> train_precull -> {'GATED' if on else 'ungated'} "
                   f"({why}) @ iter {it}")
        return (bc, bf) if on else None

    def before(self, i: int, model):
        """The bounds that step ``i`` gates with, refreshed first where a
        refresh is due."""
        if i >= self.next_refresh:
            cfg = self.cfg
            self.support = self.refresh(model, i)
            # declined refreshes stretch the interval (no bounds are in
            # use while ungated, so staleness costs nothing); engaging
            # resets it
            self.backoff = 1 if self.support is not None else min(
                self.backoff * 2, max(int(cfg.train_precull_backoff_max), 1))
            self.next_refresh = i + max(int(cfg.train_precull_every),
                                        1) * self.backoff
        return self.support

    def next_boundary(self, i: int) -> int:
        return self.next_refresh


def support_hook(cfg, K, extrinsics, hw, i_train, device, world: int):
    """NeRF's hook between the train loop's chunks: the ``SupportPolicy``
    at the per-rank ray count where ``train_precull_active`` holds, else
    ``NoHook``, said once (also where an explicit "on" cannot apply)."""
    if train_precull_active(cfg, world):
        policy = SupportPolicy(cfg, K, extrinsics, hw, i_train, device,
                               n_est=cfg.N_rays // world)
        print0(f">> train_precull on (refresh every "
               f"{cfg.train_precull_every} iters)")
        return policy
    if train_precull_mode(cfg) == "on":
        print0(">> train_precull requested but inapplicable here (needs "
               "blender data, the ray-major kernel pair (the kernels' domain, "
               "use_rays_train and its shapes at the per-rank ray count, "
               "which the ranks must split evenly) and a usable support "
               "grid) — running ungated")
    return NoHook()
