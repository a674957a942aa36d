"""Frame renderers on the fused kernels: the exact dense renderer and the
occupancy-culled two-phase renderer.

Counterpart of the JAX package's ``eval/frame.py`` on a single device.
``make_frame_renderer`` routes as it does: ``cfg.render_cull == "auto"``
(the default) with a fine pass goes to the culled renderer, anything else
to the dense one.  Held-out evaluation forces the dense one
(``eval/test.py``).

**Dense** (``render_cull="none"``, or no fine pass), per block of rays:

1. stratified coarse depths;
2. the sigma kernel (``fused_mlp_sigma_rays``) over the coarse samples;
3. sample-major compositing weights;
4. inverse-CDF resample and the sorted merge (coarse + fine);
5. the full-field kernel (``fused_mlp_eval_rays``) over the merged samples;
6. sample-major compositing -> rgb, disparity.

Blocks only bound memory here; the last block is ragged, since the kernels
mask the edge themselves.  Each frame makes one launch of each kernel per
block (``renderer.launches_per_frame``).

**Culled** (``render_cull="auto"``):

- Phase 1, every ray of the frame at once: coarse sigma, compositing
  weights, and the cull decision.  Rays whose coarse occupancy (the sum
  of the weights) is <= ``render_cull_tau`` composite to the white
  background.  Surviving rays are sorted by how many merged samples their
  window needs (``ops/render.truncation_bounds``), and one host read of a
  small cumulative histogram over the sample-count classes
  (``_trunc_classes``) ends the phase.
- Phase 2, a greedy cover of the surviving rays by blocks of
  {block, block/2, block/4, block/8} rays: gather a block, resample,
  keep each ray's window of the block's class
  (``ops/render.truncation_window``), the full field, composite, and
  scatter into the frame in place.
- Pre-cull (``render_precull``, K4): support bounds of the coarse field
  from a G^3 grid of K7 (``fused_mlp_sigma``; ``ops/occupancy.py``), once
  per set of packed weights, give every ray a conservative depth interval.
  Rays are sorted by which 8-sample rows it touches
  (``ops/render.span_sort``), and the gated sigma kernel skips each
  (128-ray tile, row) block that no ray of the tile needs
  (``_gated_sigma_t``).  Gate-fine (``render_gate_fine``, K5): the fine
  module's own bounds gate the phase-2 full-field kernel the same way,
  from the actual sample depths (``_gated_fine_rays``).  Gated samples
  carry density logits <= 0, so they get the zero weights their
  evaluation would give.  Invalid bounds, and rays whose segment leaves
  the grid's cube, are never gated.

**The plane route.**  Where the sample counts are not whole 8-sample rows
(``_use_rays_kernels``), and in the dense renderer without a fine pass,
both renderers take the JAX package's plane layout
(``ops/render.render_rays_from_cfg`` and ``hierarchical_fine_pass``): K7
(``fused_mlp_sigma``) on the coarse position plane where only the density
is needed, K8 (``fused_mlp_eval``, or ``plane_fn``) as the field.  The
pre-cull and gate-fine gate the ray kernels, so they are off there
(``render_precull auto`` is off there in the JAX package too).

Each culled frame appends ``{"n_act", "blocks", "gate_frac_coarse",
"gate_frac_fine"}`` to ``renderer.stats`` (the gate fractions are the
skipped share of (tile, row) blocks, 0-dim device tensors, or None where
the pass ran ungated).

Not carried from the JAX renderer: the block-structured phase 0 (JAX runs
it only off the gated-kernel path; here the ungated culled path renders
the same frame), ray padding to the tile (the kernels mask their edges),
the packing and renderer caches, and the mesh and sample-sharded paths.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from ..kernels.fused_mlp import (fused_mlp_eval, fused_mlp_eval_rays,
                                 fused_mlp_sigma, fused_mlp_sigma_rays)
from ..ops.occupancy import support_bounds_from_sigma
from ..ops.rays import get_rays
from ..ops.render import (GATE_ROWS, hierarchical_fine_pass,
                          hierarchical_z_vals, make_field_fns, make_sigma_fn,
                          pack_od, position_plane, render_rays_from_cfg,
                          span_sort, tile_row_gate, train_support_intervals,
                          truncation_bounds, truncation_window)
from ..ops.sampling import stratified_z_vals
from ..ops.volume import (_disp_from, volume_render_rays_t,
                          weights_from_sigma, weights_from_sigma_t)

DEFAULT_BLOCK = 131072
PRECULL_GRID = 128     # the support grid's cells per axis on the card
_OFF = ("off", "false", "f", "no", "n", "0")


def _check_supported(cfg) -> None:
    """The fused kernels take the reference architecture; the port renders
    blender scenes."""
    if not (cfg.netDepth == 8 and cfg.netWidth == 256
            and 1 <= cfg.L_x <= 10 and 1 <= cfg.L_d <= 4):
        raise NotImplementedError(
            "the port renders the 8x256 reference MLP (1<=L_x<=10, "
            f"1<=L_d<=4) only; got {cfg.netDepth}x{cfg.netWidth}, "
            f"L_x={cfg.L_x}, L_d={cfg.L_d}")
    if cfg.data_type != "blender":
        raise NotImplementedError(
            f"data_type={cfg.data_type!r}: NDC rays are not ported yet")


def make_frame_renderer(cfg, H: int, W: int, K, device,
                        block_rays: Optional[int] = None,
                        stratified: bool = True,
                        sigma_fn: Callable = fused_mlp_sigma_rays,
                        field_fn: Callable = fused_mlp_eval_rays,
                        points_fn: Callable = fused_mlp_sigma,
                        plane_fn: Callable = fused_mlp_eval):
    """Returns ``render(packed, c2w, generator=None) -> (rgb [H,W,3],
    disp [H,W])`` for packed weights from ``kernels.fused_mlp.pack_nerf``:
    the culled renderer for ``cfg.render_cull == "auto"`` with a fine
    pass, else the dense one.

    ``sigma_fn`` / ``field_fn`` / ``points_fn`` / ``plane_fn`` default to
    the kernel wrappers; passing the plain versions renders the same frame
    without the kernels.  The kernels emit bf16 logits, as on the JAX
    package's frame path.  The ray block is ``block_rays``, else
    ``cfg.chunk_rays``, else min(131072, H*W).  ``render.rays_route`` says
    whether the frame runs the ray kernels (K3/K4, K1/K5) or the plane
    layout (K7 for the coarse density, K8)."""
    _check_supported(cfg)
    device = torch.device(device)
    block = int(block_rays or cfg.chunk_rays or min(DEFAULT_BLOCK, H * W))
    if cfg.render_cull == "auto" and cfg.N_samples_f > 0:
        return _make_culled_frame_renderer(cfg, H, W, K, device, block,
                                           stratified, sigma_fn, field_fn,
                                           points_fn, plane_fn)
    return _make_dense_frame_renderer(cfg, H, W, K, device, block,
                                      stratified, sigma_fn, field_fn,
                                      points_fn, plane_fn)


def _frame_rays(H, W, K, c2w, device):
    c2w = torch.as_tensor(c2w, dtype=torch.float32, device=device)
    rays_o, rays_d = get_rays(H, W, K, c2w)
    return (rays_o.reshape(-1, 3).contiguous(),
            rays_d.reshape(-1, 3).contiguous())


def _make_dense_frame_renderer(cfg, H, W, K, device, block, stratified,
                               sigma_fn, field_fn, points_fn, plane_fn):
    n_total = H * W
    n_coarse, n_fine = cfg.N_samples_c, cfg.N_samples_f
    near, far, perturb = float(cfg.near), float(cfg.far), float(cfg.perturb)
    use_rays = _use_rays_kernels(cfg) and n_fine > 0

    def render_block_planes(packed, rays_o, rays_d, generator):
        """The JAX package's plane route: K7 as the coarse density (with a
        fine pass), K8 as the field."""
        coarse, fine = make_field_fns(packed["coarse"], packed["fine"], cfg,
                                      plane_fn)
        sigma = (make_sigma_fn(packed["coarse"], cfg, points_fn)
                 if n_fine > 0 else None)
        out = render_rays_from_cfg(coarse, fine, rays_o, rays_d, cfg,
                                   stratified=stratified,
                                   coarse_sigma_fn=sigma, generator=generator)
        if n_fine > 0:
            return out.rgb_f, out.disp_f
        return out.rgb_c, out.disp_c

    def render_block(packed, rays_o, rays_d, generator):
        if not use_rays:
            return render_block_planes(packed, rays_o, rays_d, generator)
        m = rays_o.shape[0]
        z_vals = stratified_z_vals(m, near, far, n_coarse,
                                   perturb=stratified, generator=generator,
                                   device=device)
        od = pack_od(rays_o, rays_d)
        sigma_t = sigma_fn(od, z_vals.T.contiguous(), packed["coarse"],
                           L_x=cfg.L_x, out_dtype=torch.bfloat16)
        weights = weights_from_sigma_t(sigma_t, z_vals.T, rays_d).T
        z_all = hierarchical_z_vals(z_vals, weights, n_fine=n_fine,
                                    perturb=perturb, generator=generator)
        z_t = z_all.T.contiguous()
        r, g, b, sg = field_fn(od, z_t, packed["fine"], L_x=cfg.L_x,
                               L_d=cfg.L_d, out_dtype=torch.bfloat16)
        out = volume_render_rays_t(r, g, b, sg, z_t, rays_d)
        return out.rgb, out.disp

    @torch.no_grad()
    def render(packed, c2w, generator: Optional[torch.Generator] = None):
        rays_o, rays_d = _frame_rays(H, W, K, c2w, device)
        parts = [render_block(packed, rays_o[i:i + block],
                              rays_d[i:i + block], generator)
                 for i in range(0, n_total, block)]
        rgb = torch.cat([p[0] for p in parts], 0).reshape(H, W, 3)
        disp = torch.cat([p[1] for p in parts], 0).reshape(H, W)
        return rgb, disp

    render.block = block
    render.launches_per_frame = -(-n_total // block)   # per kernel
    render.rays_route = use_rays
    return render


# ------------------------------------------------------- the culled renderer


def _trunc_classes(s_full: int, n_fine: int, trunc_eps: float):
    """Sample counts of the phase-2 blocks: {3/4, 7/8, 1} of the merged
    count, rounded up to the kernels' 8-sample rows (without truncation,
    the full count alone)."""
    if trunc_eps <= 0:
        return [s_full]
    cand = sorted({int(math.ceil(s_full * f / 8)) * 8 for f in (0.75, 0.875)})
    return [c for c in cand if n_fine < c < s_full] + [s_full]


def _use_rays_kernels(cfg) -> bool:
    """Sample counts the gated kernels take: whole 8-sample rows in both
    passes (the JAX package's ``_use_rays_kernels``)."""
    return (cfg.N_samples_c % GATE_ROWS == 0
            and (cfg.N_samples_c + cfg.N_samples_f) % GATE_ROWS == 0)


def _precull_grid(cfg, device: torch.device) -> int:
    """Support-grid cells per axis: the config's, else 128 on the card and
    0 (off) on the CPU, where the grid would run the plain MLP."""
    return int(cfg.render_precull_grid) or (
        PRECULL_GRID if device.type == "cuda" else 0)


def _use_precull(cfg, device: torch.device) -> bool:
    """Coarse pre-cull: blender (origin-centred) scenes with a usable grid,
    on the gated kernels' shapes."""
    return (str(cfg.render_precull).lower() not in _OFF
            and _use_rays_kernels(cfg) and cfg.data_type == "blender"
            and _precull_grid(cfg, device) > 0)


def _use_gate_fine(cfg, device: torch.device) -> bool:
    """Fine-pass gating by the fine module's own bounds; the caller checks
    the kernels' shapes."""
    return (str(cfg.render_gate_fine).lower() not in _OFF
            and cfg.data_type == "blender"
            and _precull_grid(cfg, device) > 0)


def _precull_half(cfg) -> float:
    """Half-side of the grid's cube: the config's, else ``far``."""
    return float(cfg.render_precull_halfside) or float(cfg.far)


def _row_envelopes(near: float, far: float, s: int, s_rows: int, device):
    """Depth envelope of each s_rows-sample row of the stratified coarse
    depths, for every jitter draw (sample j lies between the midpoints
    around it, clamped to near/far), widened by 1e-4 (far - near) against
    float32 rounding -> (row_lo [R], row_hi [R]) float32."""
    zs = np.linspace(near, far, s, dtype=np.float64)
    if s > 1:
        mids = 0.5 * (zs[1:] + zs[:-1])
        lower = np.concatenate([zs[:1], mids])
        upper = np.concatenate([mids, zs[-1:]])
    else:
        lower = upper = zs
    margin = 1e-4 * (far - near)
    k = np.arange(s // s_rows)
    return (torch.tensor(lower[k * s_rows] - margin, dtype=torch.float32,
                         device=device),
            torch.tensor(upper[k * s_rows + s_rows - 1] + margin,
                         dtype=torch.float32, device=device))


def _gated_sigma_t(packed_coarse, rays_o, rays_d, z_vals, pc, half: float,
                   near: float, far: float, L_x: int,
                   sigma_fn: Callable = fused_mlp_sigma_rays):
    """Coarse sigma of every ray with the pre-cull (K4): each ray's support
    interval against the static row envelopes gives its active rows; rays
    are span-sorted so tiles share spans, and the gated kernel skips every
    (128-ray tile, 8-sample row) block no ray of the tile needs.

    A provable miss (an empty interval, t_lo > t_hi beyond the envelopes'
    rounding margin) has no active row.  The JAX package's version tests
    only that [t_lo, t_hi] overlaps a row's envelope, which an inverted
    interval can, and so leaves such misses ungated: the frame is the
    same, the port skips more.

    z_vals [M, S] stratified coarse depths, pc the coarse (lo, hi, radius,
    valid) bounds -> (sigma [S, M] bf16 logits in the original ray order,
    gate): active blocks as the ungated kernel gives them, gated ones 0."""
    m, s = z_vals.shape
    t_lo, t_hi = train_support_intervals(rays_o, rays_d, pc, half, near,
                                         far)
    row_lo, row_hi = _row_envelopes(near, far, s, GATE_ROWS, z_vals.device)
    hit = t_lo <= t_hi + 1e-4 * (far - near)
    act = ((t_lo[:, None] <= row_hi[None]) & (t_hi[:, None] >= row_lo[None])
           & hit[:, None])
    order, inv = span_sort(act)
    gate, _ = tile_row_gate(act[order])
    sigma_s = sigma_fn(pack_od(rays_o[order], rays_d[order]),
                       z_vals[order].T.contiguous(), packed_coarse, L_x=L_x,
                       out_dtype=torch.bfloat16, gate=gate)
    return sigma_s[:, inv], gate


def _gated_fine_rays(packed_fine, rays_o, rays_d, z_all, fb, half: float,
                     near: float, far: float, L_x: int, L_d: int,
                     field_fn: Callable = fused_mlp_eval_rays):
    """Full field of a phase-2 block gated by the fine module's bounds
    (K5): row activity from the actual merged depths against each ray's
    support interval (widened by 1e-4 (far - near) against rounding),
    span sort, gated kernel, unsort.

    z_all [M, S] -> ((r, g, b, sigma) [S, M] in the original ray order,
    gate)."""
    m, s = z_all.shape
    t_lo, t_hi = train_support_intervals(rays_o, rays_d, fb, half, near,
                                         far)
    margin = 1e-4 * (far - near)
    act = ((z_all >= t_lo[:, None] - margin)
           & (z_all <= t_hi[:, None] + margin))
    act = act.reshape(m, s // GATE_ROWS, GATE_ROWS).any(-1)
    order, inv = span_sort(act)
    gate, _ = tile_row_gate(act[order])
    outs = field_fn(pack_od(rays_o[order], rays_d[order]),
                    z_all[order].T.contiguous(), packed_fine, L_x=L_x,
                    L_d=L_d, out_dtype=torch.bfloat16, gate=gate)
    return tuple(t[:, inv] for t in outs), gate


def _support_for_eval(packed_module, cfg, device: torch.device,
                      points_fn: Callable = fused_mlp_sigma):
    """((lo, hi, radius, valid), valid as a bool) support bounds of one
    module's density field on the G^3 grid (one host read of ``valid``).
    The culled renderer calls it once per set of packed weights."""
    bounds = support_bounds_from_sigma(
        lambda xp: points_fn(xp, packed_module, L_x=cfg.L_x,
                             out_dtype=torch.bfloat16),
        _precull_half(cfg), grid=_precull_grid(cfg, device), device=device)
    return bounds, bool(bounds[3][0])


def _greedy_cover(n: int, sizes):
    """(start, size) blocks covering at least n rays, the largest sizes
    first; the overhang is below the smallest size."""
    g = sizes[-1]
    rem = -(-n // g) * g
    out, pos = [], 0
    for sz in sizes:
        while rem >= sz:
            out.append((pos, sz))
            pos += sz
            rem -= sz
    return out


def _cover(n_act: int, cum, sizes, s_classes):
    """Phase-2 blocks (start, size, s_keep) over the need-sorted rays: a
    block's sample count is the class of its last active ray (``cum`` the
    cumulative count of rays per class), and the overhang past n_act is
    culled rays, rendered all the same."""
    out = []
    for pos, sz in _greedy_cover(n_act, sizes):
        end = min(pos + sz, n_act)
        s_keep = next(c for c, cc in zip(s_classes, cum) if cc >= end)
        out.append((pos, sz, s_keep))
    return out


def _make_culled_frame_renderer(cfg, H, W, K, device, block, stratified,
                                sigma_fn, field_fn, points_fn, plane_fn):
    n_coarse, n_fine = cfg.N_samples_c, cfg.N_samples_f
    near, far = float(cfg.near), float(cfg.far)
    tau, trunc_eps = float(cfg.render_cull_tau), float(cfg.render_trunc_eps)
    perturb = float(cfg.perturb)
    n_total = H * W
    s_full = n_coarse + n_fine
    s_classes = _trunc_classes(s_full, n_fine, trunc_eps)
    # the plane route (sample counts off the 8-sample rows): K7 on the
    # coarse positions in phase 1, K8 in phase 2, no gates
    use_rays = _use_rays_kernels(cfg)
    use_precull = _use_precull(cfg, device)
    use_gate_fine = _use_gate_fine(cfg, device) and use_rays
    half = _precull_half(cfg)
    sizes = [sz for sz in (block, block // 2, block // 4, block // 8)
             if sz >= 8 and sz % 8 == 0] or [block]

    def stats_tail(z_vals, weights):
        """Cull decision, sort by sample need, the class histogram, and the
        background composite of the culled rays."""
        acc = torch.sum(weights, -1)
        active = acc > tau
        if len(s_classes) > 1:
            k_start, k_need = truncation_bounds(weights, trunc_eps)
            s_req = n_fine + k_need - k_start
        else:
            s_req = torch.full_like(acc, s_full, dtype=torch.int64)
        sort_key = torch.where(active, s_req, torch.full_like(s_req,
                                                              s_full + 2))
        order = torch.argsort(sort_key, stable=True)
        class_cum = torch.stack([torch.sum(sort_key <= c) for c in s_classes])
        rgb0 = (1.0 - 0.5 * torch.clamp(acc, min=0.0))[:, None].repeat(1, 3)
        disp0 = _disp_from(torch.sum(weights * z_vals, -1), acc)
        return order, class_cum, rgb0, disp0

    def fine_block(packed, rays_o, rays_d, z_vals, weights, s_keep, fb,
                   generator):
        if not use_rays:
            _, fine = make_field_fns(packed["coarse"], packed["fine"], cfg,
                                     plane_fn)
            out = hierarchical_fine_pass(
                fine, rays_o, rays_d, z_vals, weights, n_fine=n_fine,
                perturb=perturb, n_keep=s_keep, trunc_eps=trunc_eps,
                generator=generator)
            return out.rgb, out.disp, None
        z_all = hierarchical_z_vals(z_vals, weights, n_fine=n_fine,
                                    perturb=perturb, generator=generator)
        if s_keep < s_full:
            z_all = truncation_window(z_all, z_vals, weights, s_keep,
                                      trunc_eps)
        gate = None
        if fb is not None:
            (r, g, b, sg), gate = _gated_fine_rays(
                packed["fine"], rays_o, rays_d, z_all, fb, half, near, far,
                cfg.L_x, cfg.L_d, field_fn)
        else:
            r, g, b, sg = field_fn(pack_od(rays_o, rays_d),
                                   z_all.T.contiguous(), packed["fine"],
                                   L_x=cfg.L_x, L_d=cfg.L_d,
                                   out_dtype=torch.bfloat16)
        out = volume_render_rays_t(r, g, b, sg, z_all.T, rays_d)
        return out.rgb, out.disp, gate

    stats: list = []
    support: dict = {}   # module -> (its packed weights, bounds or None)

    def module_bounds(packed, module: str):
        """The module's valid bounds, else None: one grid per set of packed
        weights (the last set seen, held by a strong reference)."""
        w = packed[module]["w"]
        seen = support.get(module)
        if seen is None or seen[0] is not w:
            bounds, valid = _support_for_eval(packed[module], cfg, device,
                                              points_fn)
            support[module] = seen = (w, bounds if valid else None)
        return seen[1]

    @torch.no_grad()
    def render(packed, c2w, generator: Optional[torch.Generator] = None):
        rays_o, rays_d = _frame_rays(H, W, K, c2w, device)
        pc = module_bounds(packed, "coarse") if use_precull else None
        fb = module_bounds(packed, "fine") if use_gate_fine else None

        # phase 1: every ray's coarse stats, the cull and the sort
        z_vals = stratified_z_vals(n_total, near, far, n_coarse,
                                   perturb=stratified, generator=generator,
                                   device=device)
        gate_c = None
        if not use_rays:
            sigma = make_sigma_fn(packed["coarse"], cfg, points_fn)(
                position_plane(rays_o, rays_d, z_vals))
            weights = weights_from_sigma(sigma.reshape(n_total, n_coarse),
                                         z_vals, rays_d)
        elif pc is not None:
            sigma_t, gate_c = _gated_sigma_t(packed["coarse"], rays_o,
                                             rays_d, z_vals, pc, half, near,
                                             far, cfg.L_x, sigma_fn)
            weights = weights_from_sigma_t(sigma_t, z_vals.T, rays_d).T
        else:
            sigma_t = sigma_fn(pack_od(rays_o, rays_d),
                               z_vals.T.contiguous(), packed["coarse"],
                               L_x=cfg.L_x, out_dtype=torch.bfloat16)
            weights = weights_from_sigma_t(sigma_t, z_vals.T, rays_d).T
        order, class_cum, rgb_frame, disp_frame = stats_tail(z_vals, weights)
        cum = class_cum.tolist()              # the frame's one host read
        n_act = cum[-1]

        # phase 2: the surviving rays, block by block, scattered in place
        blocks = _cover(n_act, cum, sizes, s_classes)
        gated_off = gated_all = None
        for pos, sz, s_keep in blocks:
            idx = order[pos:min(pos + sz, n_total)]
            rgb, disp, gate = fine_block(packed, rays_o[idx], rays_d[idx],
                                         z_vals[idx], weights[idx], s_keep,
                                         fb, generator)
            rgb_frame.index_copy_(0, idx, rgb)
            disp_frame.index_copy_(0, idx, disp)
            if gate is not None:
                off = torch.sum(gate == 0)
                gated_off = off if gated_off is None else gated_off + off
                gated_all = (gated_all or 0) + gate.numel()
        stats.append(dict(
            n_act=n_act, blocks=len(blocks),
            gate_frac_coarse=(None if gate_c is None
                              else 1.0 - gate_c.float().mean()),
            gate_frac_fine=(None if gated_off is None
                            else gated_off / gated_all)))
        return rgb_frame.reshape(H, W, 3), disp_frame.reshape(H, W)

    render.block = block
    render.sizes = sizes
    render.stats = stats
    render.rays_route = use_rays
    return render
