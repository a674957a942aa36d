"""Frame renderers on the fused kernels: the exact dense renderer and the
occupancy-culled two-phase renderer.

Counterpart of the JAX package's ``eval/frame.py``, on one device or
split over the ranks of a process group (below).  ``make_frame_renderer``
takes the architecture's renderer (``arch/``); NeRF's,
``make_nerf_frame_renderer``, routes as the JAX package's does:
``cfg.render_cull == "auto"`` (the default) with a fine pass goes to the
culled renderer, anything else to the dense one.  Held-out evaluation
forces the dense one (``eval/test.py``).

**Dense** (``render_cull="none"``, or no fine pass), per block of rays:

1. stratified coarse depths;
2. the sigma kernel (``fused_mlp_sigma_rays``) over the coarse samples;
3. sample-major compositing weights;
4. inverse-CDF resample and the sorted merge (coarse + fine);
5. the full-field kernel (``fused_mlp_eval_rays``) over the merged samples;
6. sample-major compositing -> rgb, disparity.

Each frame's rays are generated on the device and, for LLFF, projected
into NDC (``ops/render.maybe_ndc``) before anything else, so both
renderers and both phases of the culled one see NDC rays.

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
- Pre-cull (``render_precull``, K4; blender scenes only): support bounds of the coarse field
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
- Phase 0 (``render_precull on`` off the ray kernels; the JAX package's
  ``_phase0`` and ``_phase1_block``): the same coarse bounds, from the
  route's own coarse density (K7, or the plain MLP's sigma row), mark the
  rays that may hit the support (and every ray whose segment leaves the
  cube); a stable sort puts them first and one host read takes their
  count.  Phase 1 then runs on a greedy cover of the hit rays only, each
  block's weights scattered into a frame of zero weights, so a missed ray
  composites to the background.  The cover's overhang past the hit count
  is missed rays, rendered all the same, as in the JAX package.  Every
  ray keeps its row of the frame's one stratified draw.

**The plane route.**  Where the sample counts are not whole 8-sample rows
(``_use_rays_kernels``), and in the dense renderer without a fine pass,
both renderers take the JAX package's plane layout
(``ops/render.render_rays_from_cfg`` and ``hierarchical_fine_pass``): K7
(``fused_mlp_sigma``) on the coarse position plane where only the density
is needed, K8 (``fused_mlp_eval``, or ``plane_fn``) as the field.  The
gates are the ray kernels', so gate-fine is off there; ``render_precull
on`` runs phase 0 there, ``auto`` does not (as in the JAX package).

**The plain route.**  Outside the kernels' domain
(``ops/render.plain_route_reason``: ``use_pallas`` off, or an architecture
other than 8x256 with 1 <= L_x <= 10 and 1 <= L_d <= 4) both renderers run
the plain MLP (``ops/render.plain_field_fn``, float32 logits) on the plane
layout, as the JAX package's XLA route does: the dense renderer the full
coarse field (no density-only function) and the fine pass; the culled one
the coarse field's sigma row in phase 1 (all-ones directions, as the
JAX package feeds: sigma does not read them) and ``hierarchical_fine_pass``
in phase 2, with no gate-fine, and phase 0 under ``render_precull on``
only.  ``pack_nerf`` hands such a renderer the two
modules in place of packed weights.  ``renderer.route`` is "rays",
"planes" or "plain".

Each culled frame appends ``{"n_act", "blocks", "n_trunc",
"trunc_blocks", "gate_frac_coarse", "gate_frac_fine"}`` to
``renderer.stats`` (``n_trunc``: the active rays whose window fits a
truncated sample class; ``trunc_blocks``: the cover blocks rendered at
fewer than the merged samples; the gate fractions are the skipped share of
(tile, row) blocks, after phase 0 the missed rays' share of the frame,
0-dim device tensors, or None where the pass ran ungated).
``renderer.set_support(packed, module, bounds)`` injects a module's
support bounds for a set of fields from ``pack_nerf`` in place of its
grid.

**Data parallelism** (the JAX package's mesh-sharded frames, over the
ranks of a process group, ``parallel/``): every rank generates the whole
frame's rays and draws every uniform of a block alike (the ``generator``
must be seeded alike on every rank), renders its contiguous part of the
block's rays (``parallel.rank_bounds``) through the same kernels and
gathers the parts into the block on every rank (``_split_render``).  Each
block's uniforms are drawn whole before it is split, with or without a
group (the samplers' own draws, in their order), so one path renders every
frame; without a group the split is the whole block.  The dense
renderer splits each ray block; the culled one splits phase 1 (the weights
are gathered, so that the cull, the sort, the class histogram and the
greedy cover, all host decisions, are the same on every rank) and each
phase-2 cover block.  The support bounds are rank 0's, broadcast.  A
block of fewer rays than ranks is rendered whole on every rank.

The split is over every rank of the world, as the JAX package's
``_shard_over_rays`` splits over every mesh axis: under
``n_model_shards > 1`` the frames render the gathered full weights
(``parallel/tensor.full_model``) through these renderers and kernels.

**Sample-sharded** (``sp_shards > 1``, ``_make_sp_frame_renderer``; the
JAX package's ``_make_sp_frame_renderer``): the rays split over the data
group and each ray's samples over the model group, K8 on each rank's
slice of the samples in both passes (``parallel/sp.py``).

Not carried from the JAX renderer: ray padding to the tile (the kernels
mask their edges), and the packing and renderer caches.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from .. import parallel
from ..arch import architecture
from ..kernels.fused_mlp import (fused_mlp_eval, fused_mlp_eval_rays,
                                 fused_mlp_sigma, fused_mlp_sigma_rays)
from ..ops.occupancy import (ray_hits_bounds, segment_in_cube,
                             support_bounds_from_sigma)
from ..ops.rays import get_rays
from ..ops.render import (GATE_ROWS, hierarchical_fine_pass,
                          hierarchical_z_vals, make_field_fns, make_sigma_fn,
                          maybe_ndc, pack_od, plain_field_fn, position_plane,
                          render_rays_from_cfg, span_sort, supports_kernels,
                          tile_row_gate, train_support_intervals,
                          truncation_bounds, truncation_window)
from ..ops.sampling import stratified_z_vals
from ..ops.volume import (_disp_from, volume_render_rays_t,
                          weights_from_sigma, weights_from_sigma_t)
from ..utils.spans import setup_span, span

DEFAULT_BLOCK = 131072
PRECULL_GRID = 128     # the support grid's cells per axis on the card
_OFF = ("off", "false", "f", "no", "n", "0")


def make_frame_renderer(cfg, H: int, W: int, K, device,
                        block_rays: Optional[int] = None, **plain):
    """The frame renderer of ``cfg``'s architecture (``arch/``): NeRF's
    ``make_nerf_frame_renderer`` (``plain``: its ``stratified`` and its
    kernel stand-ins), or Instant-NGP's
    ``ops/ngp.make_ngp_frame_renderer`` (route "ngp"), called with the
    ``NGP`` model."""
    return architecture(cfg).make_frame_renderer(cfg, H, W, K, device,
                                                 block_rays, **plain)


def make_nerf_frame_renderer(cfg, H: int, W: int, K, device,
                             block_rays: Optional[int] = None,
                             stratified: bool = True,
                             sigma_fn: Callable = fused_mlp_sigma_rays,
                             field_fn: Callable = fused_mlp_eval_rays,
                             points_fn: Callable = fused_mlp_sigma,
                             plane_fn: Callable = fused_mlp_eval):
    """Returns ``render(packed, c2w, generator=None) -> (rgb [H,W,3],
    disp [H,W])`` for the fields from ``kernels.fused_mlp.pack_nerf``
    (packed weights, or on the plain route the two modules): with
    ``cfg.sp_shards > 1`` the sample-sharded one (``plane_fn``, K8, on
    each rank's slice of the samples), else the culled renderer for
    ``cfg.render_cull == "auto"`` with a fine pass, else the dense one.

    ``sigma_fn`` / ``field_fn`` / ``points_fn`` / ``plane_fn`` default to
    the kernel wrappers; passing the plain versions renders the same frame
    without the kernels.  The kernels emit bf16 logits, as on the JAX
    package's frame path.  The ray block is ``block_rays``, else
    ``cfg.chunk_rays``, else min(131072, H*W).  ``render.route`` says
    whether the frame runs the ray kernels ("rays": K3/K4, K1/K5), the
    plane layout ("planes": K7 for the coarse density, K8) or the plain
    MLP ("plain"); ``render.rays_route`` is ``route == "rays"``."""
    device = torch.device(device)
    block = int(block_rays or cfg.chunk_rays or min(DEFAULT_BLOCK, H * W))
    if int(cfg.sp_shards) > 1:
        return _make_sp_frame_renderer(cfg, H, W, K, device, block,
                                       stratified, plane_fn)
    if cfg.render_cull == "auto" and cfg.N_samples_f > 0:
        return _make_culled_frame_renderer(cfg, H, W, K, device, block,
                                           stratified, sigma_fn, field_fn,
                                           points_fn, plane_fn)
    return _make_dense_frame_renderer(cfg, H, W, K, device, block,
                                      stratified, sigma_fn, field_fn,
                                      points_fn, plane_fn)


def _make_ray_gen(cfg, H, W, K, device):
    """``c2w -> (rays_o, rays_d)``, each [H*W, 3] on ``device``: the
    frame's rays, in NDC for LLFF.  The focal length of the projection is
    K's float32 one, as the JAX package's ``_make_ray_gen`` takes it."""
    focal = float(np.asarray(K, np.float32)[0, 0])

    def gen_rays(c2w):
        c2w = torch.as_tensor(c2w, dtype=torch.float32, device=device)
        rays_o, rays_d = get_rays(H, W, K, c2w)
        rays_o, rays_d = maybe_ndc(rays_o.reshape(-1, 3),
                                   rays_d.reshape(-1, 3), H, W, focal,
                                   cfg.data_type)
        return rays_o.contiguous(), rays_d.contiguous()
    return gen_rays


def _split_render(fn: Callable, m: int, *rows, group=None):
    """``fn(*rows)`` (each row input [m, ...], or None) -> a tuple of
    [m, ...] outputs, computed on this rank's contiguous part of the m
    rows and gathered on every rank of ``group`` (default: the world,
    every mesh axis, as the JAX package's ``_shard_over_rays``).  Without
    a process group, and for fewer rows than ranks, ``fn`` takes every
    row."""
    g = group or parallel.world_group()
    if not parallel.is_distributed() or m < g.size:
        return fn(*rows)
    lo, hi = parallel.rank_bounds(m, g.index, g.size)
    out = fn(*(None if t is None else t[lo:hi] for t in rows))
    return parallel.gather_rows(out, m, g)


def _uniforms(m: int, n: int, generator, device) -> torch.Tensor:
    """[m, n] uniforms as the samplers draw them from ``generator``."""
    return torch.rand((m, n), generator=generator, dtype=torch.float32,
                      device=device)


def _need_generator(generator) -> None:
    if parallel.world_size() > 1 and generator is None:
        raise ValueError("a frame split over ranks needs a generator seeded "
                         "alike on every rank: the ranks draw every uniform "
                         "of a block alike")


def _frame_route(cfg, use_rays: bool) -> str:
    """"plain" outside the kernels' domain, else "rays" or "planes"."""
    if not supports_kernels(cfg):
        return "plain"
    return "rays" if use_rays else "planes"


def _check_fields(packed, route: str) -> None:
    """The fields a renderer was given must be its route's: the plain
    route's modules or packed weights, never the one for the other (no
    route hands over to another)."""
    if (packed.get("route") == "plain") != (route == "plain"):
        raise ValueError(
            f"a {route!r} renderer was given "
            f"{'modules' if packed.get('route') == 'plain' else 'packed weights'}"
            "; build both from the same config (kernels.fused_mlp.pack_nerf)")


def _plane_fields(packed, cfg, route: str, plane_fn, points_fn):
    """(coarse field, fine field, coarse density ``xplane -> sigma [P]``)
    of the plane layout: the plane kernel (K8) with K7 as the density, or
    on the plain route the plain MLP with the coarse field's sigma row
    (all-ones directions, as the JAX package feeds: sigma does not read
    them)."""
    if route == "plain":
        coarse = plain_field_fn(packed["coarse"], cfg)
        fine = plain_field_fn(packed["fine"], cfg)
        return coarse, fine, lambda xp: coarse(xp, torch.ones_like(xp))[3]
    coarse, fine = make_field_fns(packed["coarse"], packed["fine"], cfg,
                                  plane_fn)
    return coarse, fine, make_sigma_fn(packed["coarse"], cfg, points_fn)


def _make_dense_frame_renderer(cfg, H, W, K, device, block, stratified,
                               sigma_fn, field_fn, points_fn, plane_fn):
    n_total = H * W
    n_coarse, n_fine = cfg.N_samples_c, cfg.N_samples_f
    near, far, perturb = float(cfg.near), float(cfg.far), float(cfg.perturb)
    route = _frame_route(cfg, _use_rays_kernels(cfg) and n_fine > 0)
    gen_rays = _make_ray_gen(cfg, H, W, K, device)

    def render_block_planes(packed, rays_o, rays_d, u_c, u_f):
        """The JAX package's plane route: K7 as the coarse density (with a
        fine pass), K8 as the field; on the plain route the plain MLP and
        the full coarse field, as its XLA route."""
        coarse, fine, sigma = _plane_fields(packed, cfg, route, plane_fn,
                                            points_fn)
        if route == "plain" or n_fine <= 0:
            sigma = None
        out = render_rays_from_cfg(coarse, fine, rays_o, rays_d, cfg,
                                   stratified=stratified,
                                   coarse_sigma_fn=sigma, u_c=u_c, u_f=u_f)
        if n_fine > 0:
            return out.rgb_f, out.disp_f
        return out.rgb_c, out.disp_c

    def render_block(packed, rays_o, rays_d, u_c, u_f):
        """One block's (rgb, disp) at the coarse jitter ``u_c`` and the
        fine uniforms ``u_f`` (None where the sampler draws none)."""
        if route != "rays":
            return render_block_planes(packed, rays_o, rays_d, u_c, u_f)
        m = rays_o.shape[0]
        z_vals = stratified_z_vals(m, near, far, n_coarse,
                                   perturb=stratified, u=u_c, device=device)
        od = pack_od(rays_o, rays_d)
        sigma_t = sigma_fn(od, z_vals.T.contiguous(), packed["coarse"],
                           L_x=cfg.L_x, out_dtype=torch.bfloat16)
        weights = weights_from_sigma_t(sigma_t, z_vals.T, rays_d).T
        z_all = hierarchical_z_vals(z_vals, weights, n_fine=n_fine,
                                    perturb=perturb, u=u_f)
        z_t = z_all.T.contiguous()
        r, g, b, sg = field_fn(od, z_t, packed["fine"], L_x=cfg.L_x,
                               L_d=cfg.L_d, out_dtype=torch.bfloat16)
        out = volume_render_rays_t(r, g, b, sg, z_t, rays_d)
        return out.rgb, out.disp

    def split_block(packed, rays_o, rays_d, generator):
        """A block: its uniforms drawn whole (the coarse jitter, then the
        fine ones, the order in which the samplers draw them), each rank's
        part rendered, the parts gathered (one part without a group)."""
        m = rays_o.shape[0]
        u_c = (_uniforms(m, n_coarse, generator, device) if stratified
               else None)
        u_f = (_uniforms(m, n_fine, generator, device)
               if n_fine > 0 and perturb != 0.0 else None)
        return _split_render(
            lambda ro, rd, uc, uf: render_block(packed, ro, rd, uc, uf),
            m, rays_o, rays_d, u_c, u_f)

    @torch.no_grad()
    def render(packed, c2w, generator: Optional[torch.Generator] = None):
        _check_fields(packed, route)
        _need_generator(generator)
        with span("frame"):
            rays_o, rays_d = gen_rays(c2w)
            parts = [split_block(packed, rays_o[i:i + block],
                                 rays_d[i:i + block], generator)
                     for i in range(0, n_total, block)]
            rgb = torch.cat([p[0] for p in parts], 0).reshape(H, W, 3)
            disp = torch.cat([p[1] for p in parts], 0).reshape(H, W)
        return rgb, disp

    render.block = block
    # per kernel; the plain route launches none
    render.launches_per_frame = (0 if route == "plain"
                                 else -(-n_total // block))
    render.route = route
    render.rays_route = route == "rays"
    return render


# ------------------------------------------------ the sample-sharded renderer


def _make_sp_frame_renderer(cfg, H, W, K, device, block, stratified,
                            plane_fn):
    """The frame with each ray's samples split over the model group
    (``cfg.sp_shards``; the JAX package's ``_make_sp_frame_renderer``).

    Per block: the uniforms are drawn whole, as the dense renderer draws
    them; the rays split over the data group; each rank builds its rays'
    coarse depths whole (alike on every model rank) and runs the coarse
    field on its contiguous ``S_c / n`` columns; the distributed composite
    (``parallel/sp.py``) gives the coarse weights, gathered to [N, S_c]
    for the inverse-CDF resample, which runs alike on every model rank;
    each rank takes its ``(S_c + S_f) / n`` columns of the merged depths
    for the fine field.  Both fields are K8 (``plane_fn``, bf16 logits)
    inside the kernels' domain and the plain MLP outside it; no cull, as
    in the JAX package.  ``render.route`` is "planes" or "plain"."""
    from ..parallel.sp import sp_coarse_fine

    n_total = H * W
    n_coarse, n_fine = cfg.N_samples_c, cfg.N_samples_f
    near, far, perturb = float(cfg.near), float(cfg.far), float(cfg.perturb)
    route = _frame_route(cfg, False)
    gen_rays = _make_ray_gen(cfg, H, W, K, device)
    model_g, data_g = parallel.model_group(), parallel.data_group()
    if model_g.size != int(cfg.sp_shards):
        raise ValueError(
            f"sp_shards={cfg.sp_shards} needs a model group of as many "
            f"ranks; this launch's has {model_g.size} (n_model_shards="
            f"{cfg.n_model_shards}, parallel.init_layout)")
    cols = slice(model_g.index * (n_coarse // model_g.size),
                 (model_g.index + 1) * (n_coarse // model_g.size))

    def rank_part(packed, rays_o, rays_d, u_c, u_f):
        coarse, fine, _ = _plane_fields(packed, cfg, route, plane_fn, None)
        z_vals = stratified_z_vals(rays_o.shape[0], near, far, n_coarse,
                                   perturb=stratified, u=u_c, device=device)
        out_c, out_f = sp_coarse_fine(
            coarse, fine, rays_o, rays_d, z_vals[:, cols].contiguous(),
            n_fine=n_fine, perturb=perturb, u=u_f, group=model_g)
        out = out_c if out_f is None else out_f
        return out.rgb, out.disp

    @torch.no_grad()
    def render(packed, c2w, generator: Optional[torch.Generator] = None):
        _check_fields(packed, route)
        _need_generator(generator)
        with span("frame"):
            rays_o, rays_d = gen_rays(c2w)
            parts = []
            for i in range(0, n_total, block):
                ro, rd = rays_o[i:i + block], rays_d[i:i + block]
                m = ro.shape[0]
                u_c = (_uniforms(m, n_coarse, generator, device)
                       if stratified else None)
                u_f = (_uniforms(m, n_fine, generator, device)
                       if n_fine > 0 and perturb != 0.0 else None)
                parts.append(_split_render(
                    lambda *rows: rank_part(packed, *rows), m, ro, rd, u_c,
                    u_f, group=data_g))
            rgb = torch.cat([p[0] for p in parts], 0).reshape(H, W, 3)
            disp = torch.cat([p[1] for p in parts], 0).reshape(H, W)
        return rgb, disp

    render.block = block
    render.route = route
    render.rays_route = False
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
    """The ray kernels: the kernels' domain and sample counts in whole
    8-sample rows in both passes (the JAX package's
    ``_use_rays_kernels``)."""
    return (supports_kernels(cfg) and cfg.N_samples_c % GATE_ROWS == 0
            and (cfg.N_samples_c + cfg.N_samples_f) % GATE_ROWS == 0)


def _precull_grid(cfg, device: torch.device) -> int:
    """Support-grid cells per axis: the config's, else 128 on the card and
    0 (off) on the CPU, where the grid would run the plain MLP."""
    return int(cfg.render_precull_grid) or (
        PRECULL_GRID if device.type == "cuda" else 0)


def _use_precull(cfg, device: torch.device) -> bool:
    """Coarse pre-cull (the JAX package's three states): "off" never;
    "auto" only on the ray kernels, where it is the gated sigma kernel;
    "on" on every route, off the ray kernels as phase 0.  Blender
    (origin-centred) scenes with a usable grid only."""
    mode = str(cfg.render_precull).lower()
    if mode in _OFF or (mode == "auto" and not _use_rays_kernels(cfg)):
        return False
    return cfg.data_type == "blender" and _precull_grid(cfg, device) > 0


def _use_gate_fine(cfg, device: torch.device) -> bool:
    """Fine-pass gating by the fine module's own bounds: blender scenes
    with a usable grid, on the ray kernels."""
    return (str(cfg.render_gate_fine).lower() not in _OFF
            and _use_rays_kernels(cfg) and cfg.data_type == "blender"
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


def _support_bounds(sigma_plane_fn: Callable, cfg, device: torch.device):
    """((lo, hi, radius, valid), valid as a bool) support bounds of the
    density ``xplane [3, P] -> sigma [P]`` on the G^3 grid (one host read
    of ``valid``).  The culled renderer calls it once per set of fields."""
    with setup_span("setup.support_grid"):
        bounds = support_bounds_from_sigma(
            sigma_plane_fn, _precull_half(cfg),
            grid=_precull_grid(cfg, device), device=device)
        return bounds, bool(bounds[3][0])


def _support_for_eval(packed_module, cfg, device: torch.device,
                      points_fn: Callable = fused_mlp_sigma):
    """``_support_bounds`` of one packed module's density on K7."""
    return _support_bounds(make_sigma_fn(packed_module, cfg, points_fn), cfg,
                           device)


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
    # coarse positions in phase 1, K8 in phase 2, no gates (phase 0 in
    # their place under render_precull on); the plain route the same with
    # the plain MLP
    route = _frame_route(cfg, _use_rays_kernels(cfg))
    use_rays = route == "rays"
    use_precull = _use_precull(cfg, device)
    use_gate_fine = _use_gate_fine(cfg, device)
    half = _precull_half(cfg)
    gen_rays = _make_ray_gen(cfg, H, W, K, device)
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

    def fine_block(packed, rays_o, rays_d, z_vals, weights, s_keep, fb, u):
        """(rgb, disp, gate) of a phase-2 block at the fine uniforms ``u``
        (None at ``perturb`` 0)."""
        if not use_rays:
            _, fine, _ = _plane_fields(packed, cfg, route, plane_fn,
                                       points_fn)
            out = hierarchical_fine_pass(
                fine, rays_o, rays_d, z_vals, weights, n_fine=n_fine,
                perturb=perturb, n_keep=s_keep, trunc_eps=trunc_eps, u=u)
            return out.rgb, out.disp, None
        z_all = hierarchical_z_vals(z_vals, weights, n_fine=n_fine,
                                    perturb=perturb, u=u)
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
    support: dict = {}   # module -> (its field from pack_nerf, bounds or None)

    def module_bounds(packed, module: str):
        """The module's valid bounds, else None: one grid per field that
        ``pack_nerf`` handed over (its packed weights, or on the plain route
        its module copy; the last one seen, held by a strong reference), of
        the route's own density.  Off the ray kernels only the coarse
        module's are asked for (no gate-fine there)."""
        field = packed[module]
        seen = support.get(module)
        if seen is None or seen[0] is not field:
            sigma = (_plane_fields(packed, cfg, route, plane_fn, points_fn)[2]
                     if route == "plain"
                     else make_sigma_fn(field, cfg, points_fn))
            bounds, valid = _support_bounds(sigma, cfg, device)
            if parallel.world_size() > 1:     # rank 0's, on every rank
                for t in bounds:
                    parallel.broadcast0(t)
                valid = bool(bounds[3][0])
            support[module] = seen = (field, bounds if valid else None)
        return seen[1]

    def coarse_weights(packed, pc, rays_o, rays_d, z_vals):
        """(compositing weights [M, Sc] of the coarse pass, the pre-cull's
        gate or None)."""
        m = rays_o.shape[0]
        if not use_rays:
            *_, coarse_sigma = _plane_fields(packed, cfg, route, plane_fn,
                                             points_fn)
            sigma = coarse_sigma(position_plane(rays_o, rays_d, z_vals))
            return weights_from_sigma(sigma.reshape(m, n_coarse), z_vals,
                                      rays_d), None
        if pc is not None:
            sigma_t, gate = _gated_sigma_t(packed["coarse"], rays_o, rays_d,
                                           z_vals, pc, half, near, far,
                                           cfg.L_x, sigma_fn)
        else:
            gate = None
            sigma_t = sigma_fn(pack_od(rays_o, rays_d),
                               z_vals.T.contiguous(), packed["coarse"],
                               L_x=cfg.L_x, out_dtype=torch.bfloat16)
        return weights_from_sigma_t(sigma_t, z_vals.T, rays_d).T, gate

    def precull_weights(packed, pc, rays_o, rays_d, z_vals):
        """Phase 0 and the phase-1 blocks (the JAX package's ``_phase0``
        and ``_phase1_block``): the rays that may hit the bounds ``pc``
        (and those whose segment leaves the grid's cube) sorted first, one
        host read of their count, then ``coarse_weights`` over a greedy
        cover of them, each block split over the ranks and scattered into
        zero weights -> (weights [n_total, Sc], the hit count)."""
        hit = (ray_hits_bounds(rays_o, rays_d, *pc, near, far)
               | ~segment_in_cube(rays_o, rays_d, half, near, far))
        order0 = torch.argsort((~hit).to(torch.int32), stable=True)
        with span("frame.read_hits"):
            n_hit = int(hit.sum())    # host read 1 of 2, as in the JAX package
        weights = torch.zeros_like(z_vals)
        for pos, sz in _greedy_cover(n_hit, sizes):
            idx = order0[pos:min(pos + sz, n_total)]
            (w,), _ = split(
                lambda i: coarse_weights(packed, None, rays_o[i], rays_d[i],
                                         z_vals[i]),
                idx.shape[0], idx)
            weights.index_copy_(0, idx, w)
        return weights, n_hit

    def split(fn, m: int, *rows):
        """``fn`` over this rank's rows, its row outputs gathered, and the
        rank's gate (None where ungated, and on ranks other than 0 where
        every rank took every row, so that no gate is counted twice)."""
        gates = []

        def rank_part(*part):
            *out, gate = fn(*part)
            gates.append(gate)
            return tuple(out)
        out = _split_render(rank_part, m, *rows)
        whole = parallel.is_distributed() and m < parallel.world_size()
        return out, (None if whole and parallel.rank() else gates[0])

    def gate_share(gates, gated: bool):
        """Skipped share of the (tile, row) blocks under ``gates`` (one entry
        a block; None where this rank counts none), over every rank's gates;
        None where the pass ran ungated or had no block (both alike on every
        rank)."""
        if not gated or not gates:
            return None
        off, total = torch.zeros((), device=device), 0
        for g in gates:
            if g is not None:
                off, total = off + torch.sum(g == 0), total + g.numel()
        # a fill, not a host-to-device copy, which would wait for the frame
        counts = parallel.all_reduce_sum(torch.stack(
            [off, torch.full((), float(total), device=device)]))
        return counts[0] / counts[1]

    @torch.no_grad()
    def render(packed, c2w, generator: Optional[torch.Generator] = None):
        _check_fields(packed, route)
        _need_generator(generator)
        with span("frame"):
            # phase 1: every ray's coarse stats (off the ray kernels with
            # bounds: only phase 0's hit rays'), the cull and the sort
            with span("frame.phase1"):
                rays_o, rays_d = gen_rays(c2w)
                pc = module_bounds(packed, "coarse") if use_precull else None
                fb = module_bounds(packed, "fine") if use_gate_fine else None
                z_vals = stratified_z_vals(n_total, near, far, n_coarse,
                                           perturb=stratified,
                                           generator=generator,
                                           device=device)
                if pc is not None and not use_rays:
                    with span("frame.phase0"):
                        weights, n_hit = precull_weights(
                            packed, pc, rays_o, rays_d, z_vals)
                    # the missed share; a fill, not a host-to-device copy
                    frac_c = torch.full((), (n_total - n_hit) / n_total,
                                        device=device)
                else:
                    (weights,), gate_c = split(
                        lambda ro, rd, z: coarse_weights(packed, pc, ro, rd,
                                                         z),
                        n_total, rays_o, rays_d, z_vals)
                    frac_c = gate_share([gate_c],
                                        use_rays and pc is not None)
                order, class_cum, rgb_frame, disp_frame = stats_tail(
                    z_vals, weights)
                with span("frame.read"):
                    # the frame's host read (phase 0's second)
                    cum = class_cum.tolist()
                n_act = cum[-1]

            # phase 2: the surviving rays, block by block, scattered in
            # place; each block's fine uniforms are drawn whole first
            with span("frame.phase2"):
                blocks = _cover(n_act, cum, sizes, s_classes)
                gates = []
                for pos, sz, s_keep in blocks:
                    idx = order[pos:min(pos + sz, n_total)]
                    m = idx.shape[0]
                    u = (_uniforms(m, n_fine, generator, device)
                         if perturb != 0.0 else None)
                    (rgb, disp), gate = split(
                        lambda i, uf: fine_block(
                            packed, rays_o[i], rays_d[i], z_vals[i],
                            weights[i], s_keep, fb, uf),
                        m, idx, u)
                    rgb_frame.index_copy_(0, idx, rgb)
                    disp_frame.index_copy_(0, idx, disp)
                    gates.append(gate)
                stats.append(dict(
                    n_act=n_act, blocks=len(blocks),
                    n_trunc=cum[-2] if len(cum) > 1 else 0,
                    trunc_blocks=sum(s_keep < s_full
                                     for *_, s_keep in blocks),
                    gate_frac_coarse=frac_c,
                    gate_frac_fine=gate_share(gates,
                                              use_rays and fb is not None)))
        return rgb_frame.reshape(H, W, 3), disp_frame.reshape(H, W)

    def set_support(packed, module: str, bounds) -> None:
        """Use ``bounds`` ((lo, hi, radius, valid) on the device, as
        ``_support_for_eval`` gives them) as ``module``'s support for
        these fields from ``pack_nerf``, in place of its grid: the hook
        through which a caller injects known bounds (the dry run's ball)."""
        support[module] = (packed[module],
                           bounds if bool(bounds[3][0]) else None)

    render.block = block
    render.sizes = sizes
    render.stats = stats
    render.set_support = set_support
    render.route = route
    render.rays_route = use_rays
    return render
