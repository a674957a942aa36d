"""Hierarchical resampling, the training render, the plane-layout render
and the culled renderer's gate and truncation helpers (counterpart of the
JAX package's ``ops/render.py``: ``hierarchical_z_vals``,
``supports_train_rays_kernels``, ``render_rays_train`` with its
occupancy-gated passes (``train_support_intervals``, ``train_gate_tile``,
``train_gate_plan``, ``_gated_train_pass``), ``render_rays``,
``render_rays_from_cfg``, ``hierarchical_fine_pass`` and their field
functions, ``render_frame``, ``maybe_ndc``, ``span_sort``,
``tile_row_gate``, ``truncation_bounds`` and ``truncation_window``), and
the plain-MLP route (``plain_route_reason``, ``supports_kernels``,
``chunked_apply``, ``make_plain_field_fns``: the JAX package's
``_supports_pallas`` and ``make_xla_field_fns``).

The plane layout: positions and unit view directions as [3, P] planes,
flattened ray-major (point n * S + s), through field functions
``(xplane, dplane) -> raw [4, P]`` (rows r, g, b, sigma) and compositing
over [4, N, S].  The JAX package takes it where the ray-major kernels'
shapes do not apply; so does the port (``train/step.py``,
``eval/frame.py``).  The plain route's field functions take the same
planes, so it renders through the same compositing."""
from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from .occupancy import ray_support_interval, segment_in_cube
from .posenc import positional_encoding
from .rays import ndc_rays
from .sampling import sample_pdf, stratified_z_vals
from .volume import (volume_render_planar, volume_render_rays_t,
                     weights_from_sigma)


class RaysRender(NamedTuple):
    rgb_c: torch.Tensor                 # [N, 3]
    disp_c: torch.Tensor                # [N]
    rgb_f: Optional[torch.Tensor]
    disp_f: Optional[torch.Tensor]
    acc_f: Optional[torch.Tensor]
    depth_f: Optional[torch.Tensor]
    # skipped share of the (ray tile, 8-sample row) kernel blocks, weighted
    # by sample count over both passes (a 0-dim tensor; None when ungated)
    gate_frac: Optional[torch.Tensor] = None


def pack_od(rays_o: torch.Tensor, rays_d: torch.Tensor) -> torch.Tensor:
    """[M, 3] + [M, 3] -> the kernels' [8, M] layout (rows 6-7 zero)."""
    return torch.cat([rays_o.T, rays_d.T, rays_o.new_zeros(2, len(rays_o))],
                     0).contiguous()


def hierarchical_z_vals(z_vals: torch.Tensor, weights: torch.Tensor, *,
                        n_fine: int, perturb: float = 1.0,
                        generator: Optional[torch.Generator] = None,
                        u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Merged, sorted coarse+fine depths from the coarse sampling stats:
    z_vals [M, Sc] sorted, weights [M, Sc] -> [M, Sc + n_fine].  The fine
    depths carry no gradient, and every coarse sample stays in the merge
    (the reference semantics)."""
    z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    z_samples = sample_pdf(z_mid, weights[..., 1:-1], n_fine,
                           det=(perturb == 0.0), generator=generator, u=u)
    z_samples = z_samples.detach()
    return torch.sort(torch.cat([z_vals, z_samples], -1), -1).values


def _train_rays_tile(m: int) -> Optional[int]:
    """The JAX package's ray tile for its training kernels (2048, else the
    largest of 1024 ... 128 that divides m; None when m is not a multiple
    of 128).  The port's kernels work in 128-ray blocks; this tile only
    seeds ``train_gate_tile``, so that the gate plan is the JAX
    package's."""
    if m % 128 != 0:
        return None
    return next(t for t in (2048, 1024, 512, 256, 128) if m % t == 0)


def plain_route_reason(cfg, train: bool = False) -> Optional[str]:
    """Why ``cfg`` takes the plain-MLP route, or None inside the fused
    kernels' domain: ``use_pallas`` on, the 8x256 MLP, 1 <= L_x <= 10 and
    1 <= L_d <= 4 (the kernels always embed one sin/cos band, so L = 0
    takes the plain route).  The JAX package's ``_supports_pallas``; it
    reads the config alone, never whether a kernel built or launched.
    With ``train`` (the train step) ``n_model_shards > 1`` takes it too:
    the width-sharded step runs the sharded plain MLP, as the JAX package
    forces its XLA route under GSPMD (``parallel/sharding.py``
    ``force_xla``); the frame renderers keep the kernels there."""
    if train and int(getattr(cfg, "n_model_shards", 1)) > 1:
        return (f"n_model_shards {cfg.n_model_shards}: the width-sharded "
                "step runs no kernel")
    if not cfg.use_pallas:
        return "use_pallas false"
    if cfg.netDepth != 8:
        return f"netDepth {cfg.netDepth} != 8"
    if cfg.netWidth != 256:
        return f"netWidth {cfg.netWidth} != 256"
    if not 1 <= cfg.L_x <= 10:
        return f"L_x {cfg.L_x} outside 1..10"
    if not 1 <= cfg.L_d <= 4:
        return f"L_d {cfg.L_d} outside 1..4"
    return None


def supports_kernels(cfg) -> bool:
    """The fused kernels' domain (``plain_route_reason`` is None)."""
    return plain_route_reason(cfg) is None


def supports_train_rays_kernels(cfg, n_rays: int) -> bool:
    """Where the ray-major training pair runs: inside the train step's
    kernels' domain (``plain_route_reason(cfg, train=True)``), a multiple
    of 128 rays and sample counts (coarse, merged) that are multiples of
    8."""
    s_merged = cfg.N_samples_c + cfg.N_samples_f
    return (plain_route_reason(cfg, train=True) is None
            and cfg.N_samples_c % 8 == 0
            and (cfg.N_samples_f == 0 or s_merged % 8 == 0)
            and _train_rays_tile(n_rays) is not None)


def train_support_intervals(rays_o: torch.Tensor, rays_d: torch.Tensor,
                            bounds, half: float, near: float, far: float
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-ray conservative support interval of one module's bounds
    ``(lo, hi, radius, valid)`` (``ops/occupancy.support_bounds_from_sigma``):
    rays whose [near, far] segment leaves the cube of half-side ``half``
    get [near, far] (the grid certifies nothing outside it), and invalid
    bounds give every ray [near, far].  rays [M, 3] -> (t_lo [M],
    t_hi [M]).  The training passes and the culled renderer both use it."""
    t_lo, t_hi = ray_support_interval(rays_o, rays_d, *bounds, near, far)
    inside = segment_in_cube(rays_o, rays_d, half, near, far)
    return (torch.where(inside, t_lo, torch.full_like(t_lo, near)),
            torch.where(inside, t_hi, torch.full_like(t_hi, far)))


def train_gate_tile(cfg, n: int, base_tile: int) -> int:
    """The gate plan's ray tile: ``cfg.train_precull_tile``, else
    min(base_tile, 512), cut to the largest multiple of 128 that divides
    n (the JAX package's choice, so that the plan, ``gate_frac`` and the
    policy's decisions are its own)."""
    gt = int(getattr(cfg, "train_precull_tile", 0))
    want = max(128, min(gt or min(base_tile, 512), n))
    for tile in range(want - want % 128, 127, -128):
        if n % tile == 0:
            return tile
    return 128


def train_gate_plan(zs: torch.Tensor, t_lo: torch.Tensor, t_hi: torch.Tensor,
                    tile: int):
    """The span-sorted (ray tile, 8-sample row) gate plan of one gated
    training pass: a row of a ray is active when any of its 8 depths lies
    in the ray's support interval.

    zs [S, N] (S % 8 == 0), t_lo/t_hi [N] -> (order [N], inv [N],
    gate [(N / tile) * (S / 8)] int32 tile-major, gate_frac: the skipped
    share of blocks, 0-dim)."""
    s, n = zs.shape
    act = (zs >= t_lo[None]) & (zs <= t_hi[None])              # [S, N]
    act_r = act.reshape(s // GATE_ROWS, GATE_ROWS, n).any(1).T  # [N, R]
    order, inv = span_sort(act_r)
    gate, gate_frac = tile_row_gate(act_r[order], tile)
    return order, inv, gate, gate_frac


def _gated_train_pass(w: torch.Tensor, b: torch.Tensor, od: torch.Tensor,
                      z_t: torch.Tensor, t_lo: torch.Tensor,
                      t_hi: torch.Tensor, cfg, weight_dtype: torch.dtype):
    """One occupancy-gated training pass (K5 forward, K6 backward).

    Every sample outside the module's support interval has a density logit
    <= 0, so its compositing weight is 0 ungated too, and its gradient
    contribution is 0 (the ReLU kills the density cotangent, the zero
    weight the colour ones).  The rays are span-sorted so that tiles share
    spans, the gated pair runs on the sorted rays, and the four outputs
    are unsorted: compositing, the draws and the loss see the original
    ray order, so the forward equals the ungated pass where it matters and
    the gradients differ only in float32 summation order.

    The plan's tile is the JAX package's (``train_gate_tile``: 512 at 4096
    rays); the kernels gate 128-ray blocks, so each tile's gate row is
    repeated for its 128-ray blocks.  z_t [S, N], od [8, N] ->
    ((r, g, b, sigma) [S, N], gate_frac)."""
    from ..kernels.fused_mlp_vjp import fused_mlp_train_rays

    s, n = z_t.shape
    tile = train_gate_tile(cfg, n, _train_rays_tile(n) or 2048)
    order, inv, gate, gate_frac = train_gate_plan(z_t.detach(), t_lo, t_hi,
                                                  tile)
    gate = gate.view(n // tile, s // GATE_ROWS).repeat_interleave(
        tile // GATE_TILE, 0).reshape(-1).contiguous()
    outs = fused_mlp_train_rays(w, b, od[:, order].contiguous(),
                                z_t[:, order].contiguous(), cfg.L_x, cfg.L_d,
                                weight_dtype, gate=gate)
    return tuple(t[:, inv] for t in outs), gate_frac


def render_rays_train(model, rays_o: torch.Tensor, rays_d: torch.Tensor,
                      cfg, generator: Optional[torch.Generator] = None,
                      u_c: Optional[torch.Tensor] = None,
                      u_f: Optional[torch.Tensor] = None,
                      support=None) -> RaysRender:
    """Training render of a ``NeRF`` on the ray-major kernel pair
    (``kernels/fused_mlp_vjp.fused_mlp_train_rays``): jittered coarse
    depths, the coarse pass, compositing, the inverse-CDF fine depths (no
    gradient) merged with the coarse ones, the fine pass over all of them,
    compositing.  Each pass packs its module's float32 parameters
    differentiably, so ``loss.backward()`` reaches the module.

    rays_o, rays_d [N, 3]; the draws come from ``generator`` (coarse
    jitter first, then the fine uniforms) or are injected as ``u_c``
    [N, Sc] and ``u_f`` [N, Sf].

    ``support`` (``cfg.train_precull``, ``train/precull.py``) = (coarse
    bounds, fine bounds, half-side): each pass is gated by its own
    module's support intervals (``_gated_train_pass``; the two modules are
    independent networks) and ``gate_frac`` is set.  The loss is the
    ungated one bit for bit; the gradients differ in summation order."""
    from ..kernels.fused_mlp import kernel_weight_dtype, pack_flat
    from ..kernels.fused_mlp_vjp import fused_mlp_train_rays

    n = rays_o.shape[0]
    assert supports_train_rays_kernels(cfg, n), (
        f"N_rays={n}, N_samples_c={cfg.N_samples_c}, "
        f"N_samples_f={cfg.N_samples_f}, route "
        f"{plain_route_reason(cfg) or 'kernels'}: the ray-major training "
        "kernels take the kernels' domain, a multiple of 128 rays and sample "
        "counts that are multiples of 8; other shapes train on the plane "
        "layout (render_rays_from_cfg with make_train_field_fns), other "
        "architectures on the plain route (make_plain_field_fns)")
    wdt = kernel_weight_dtype(cfg.compute_dtype, rays_o.device)
    near, far = float(cfg.near), float(cfg.far)
    od = pack_od(rays_o, rays_d)
    if support is not None:
        bounds_c, bounds_f, half = support
        iv_c = train_support_intervals(rays_o, rays_d, bounds_c, half, near,
                                       far)
        iv_f = train_support_intervals(rays_o, rays_d, bounds_f, half, near,
                                       far)

    def field(mlp, z_t, iv):
        w, b = pack_flat(mlp, cfg.L_x, cfg.L_d)
        gate_frac = None
        if iv is None:
            outs = fused_mlp_train_rays(w, b, od, z_t, cfg.L_x, cfg.L_d, wdt)
        else:
            outs, gate_frac = _gated_train_pass(w, b, od, z_t, *iv, cfg, wdt)
        return volume_render_rays_t(*outs, z_t, rays_d), gate_frac

    z_vals = stratified_z_vals(n, near, far, cfg.N_samples_c, perturb=True,
                               generator=generator, u=u_c,
                               device=rays_o.device)
    out_c, gate_frac = field(model.model_coarse, z_vals.T.contiguous(),
                             None if support is None else iv_c)
    if cfg.N_samples_f <= 0:
        return RaysRender(out_c.rgb, out_c.disp, None, None, None, None,
                          gate_frac)
    z_all = hierarchical_z_vals(z_vals, out_c.weights.detach().T,
                                n_fine=cfg.N_samples_f,
                                perturb=float(cfg.perturb),
                                generator=generator, u=u_f)
    out_f, gf_f = field(model.model_fine, z_all.T.contiguous(),
                        None if support is None else iv_f)
    if support is not None:
        # block share over both passes, weighted by sample count (the
        # kernels' cost follows the active blocks)
        s_c, s_m = cfg.N_samples_c, cfg.N_samples_c + cfg.N_samples_f
        gate_frac = (gate_frac * s_c + gf_f * s_m) / (s_c + s_m)
    return RaysRender(out_c.rgb, out_c.disp, out_f.rgb, out_f.disp,
                      out_f.acc, out_f.depth, gate_frac)


# ---------------------------------------------------------- the plane layout


def make_train_field_fns(model, cfg) -> Tuple[Callable, Callable]:
    """Differentiable field functions of a ``NeRF``'s two modules on the
    plane pair (``kernels/fused_mlp_vjp.fused_mlp_train``: K8 forward, K9
    backward), float32 logits; the counterpart of the JAX package's
    ``make_pallas_train_field_fns``.  Each call packs its module's
    parameters differentiably, so ``loss.backward()`` reaches the module.
    The JAX version pads the planes to its 1024-point tile; the kernels
    here mask their ragged last block instead."""
    from ..kernels.fused_mlp import kernel_weight_dtype, pack_flat
    from ..kernels.fused_mlp_vjp import fused_mlp_train

    def build(mlp):
        def fn(xplane, dplane):
            w, b = pack_flat(mlp, cfg.L_x, cfg.L_d)
            return fused_mlp_train(
                w, b, xplane, dplane, cfg.L_x, cfg.L_d,
                kernel_weight_dtype(cfg.compute_dtype, xplane.device))
        return fn
    return build(model.model_coarse), build(model.model_fine)


def make_field_fns(packed_coarse, packed_fine, cfg,
                   plane_fn: Optional[Callable] = None
                   ) -> Tuple[Callable, Callable]:
    """Evaluation field functions on the plane kernel (K8,
    ``fused_mlp.fused_mlp_eval``, or ``plane_fn``: its plain version),
    bf16 logits as on the JAX package's frame path; the counterpart of
    ``make_pallas_field_fns`` (without its 8192-point tile padding)."""
    from ..kernels.fused_mlp import fused_mlp_eval
    plane_fn = plane_fn or fused_mlp_eval

    def build(packed):
        return lambda xplane, dplane: plane_fn(
            xplane, dplane, packed, L_x=cfg.L_x, L_d=cfg.L_d,
            out_dtype=torch.bfloat16)
    return build(packed_coarse), build(packed_fine)


def make_sigma_fn(packed_coarse, cfg, points_fn: Optional[Callable] = None
                  ) -> Callable:
    """Density-only coarse field ``xplane [3, P] -> sigma [P]`` (bf16) on
    the points kernel (K7, ``fused_mlp.fused_mlp_sigma``, or
    ``points_fn``); the counterpart of ``make_pallas_sigma_fn``."""
    from ..kernels.fused_mlp import fused_mlp_sigma
    points_fn = points_fn or fused_mlp_sigma
    return lambda xplane: points_fn(xplane, packed_coarse, L_x=cfg.L_x,
                                    out_dtype=torch.bfloat16)


# ------------------------------------------------------- the plain route

# At bf16 compute ``models/nerf._linear`` multiplies bf16-rounded operands
# held in float32: each is exact in TF32's 10-bit mantissa, so TF32 tensor
# cores give the float32 products (float32 sums, in another order).  The
# plain route allows TF32 around its forward products on the card at bf16
# only; float32 compute stays true float32, and the backward's products
# (float32 cotangents, which TF32 would round) run outside the scope.  A
# switch for the A/B reading of chip_smoke.py, read at each call.
PLAIN_TF32_AT_BF16 = True


@contextlib.contextmanager
def _tf32_products(on: bool):
    """Allow TF32 in CUDA float32 matmuls inside the block, then restore
    the flag as it was."""
    if not on:
        yield
        return
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def chunked_apply(fn: Callable[[torch.Tensor], torch.Tensor],
                  x: torch.Tensor, chunk_pts: int) -> torch.Tensor:
    """``fn`` over row chunks of ``x`` of at most ``chunk_pts`` rows, the
    results concatenated (``chunk_pts <= 0``: one call).  Bounds the
    activations' memory; the JAX package's ``chunked_apply`` without its
    equal-size padding (a TPU layout)."""
    n = x.shape[0]
    if chunk_pts <= 0 or n <= chunk_pts:
        return fn(x)
    return torch.cat([fn(x[i:i + chunk_pts]) for i in range(0, n, chunk_pts)])


def plain_field_fn(mlp, cfg) -> Callable:
    """One ``NeRFMLP`` as a field function ``(xplane [3, P], dplane [3, P])
    -> raw [4, P]`` float32 on the plain route: the reference positional
    encoding (L = 0 gives the coordinates), then ``mlp.forward`` at
    ``cfg.compute_dtype``, over ``cfg.chunk_pts``-point chunks.  The
    encoding runs inside each chunk (elementwise, so the same values as the
    JAX package's encoding of the whole plane).  Differentiable: under
    autograd ``loss.backward()`` reaches the module."""
    cdt = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    L_x, L_d, chunk = int(cfg.L_x), int(cfg.L_d), int(cfg.chunk_pts)

    def apply(xd):                                      # [p, 6] -> [p, 4]
        emb = torch.cat([positional_encoding(xd[:, :3], L_x),
                         positional_encoding(xd[:, 3:], L_d)], -1)
        return mlp(emb, cdt)

    def fn(xplane, dplane):
        tf32 = (cdt == torch.bfloat16 and xplane.is_cuda
                and PLAIN_TF32_AT_BF16)
        with _tf32_products(tf32):
            return chunked_apply(apply, torch.cat([xplane, dplane]).T,
                                 chunk).T
    return fn


def make_plain_field_fns(model, cfg) -> Tuple[Callable, Callable]:
    """The plain route's field functions of a ``NeRF``'s two modules
    (``plain_field_fn``); the counterpart of the JAX package's
    ``make_xla_field_fns``.  No kernel runs on this route, as none runs on
    the JAX package's XLA route."""
    return (plain_field_fn(model.model_coarse, cfg),
            plain_field_fn(model.model_fine, cfg))


def position_plane(rays_o: torch.Tensor, rays_d: torch.Tensor,
               z: torch.Tensor) -> torch.Tensor:
    """rays [M, 3], depths z [M, S] -> positions [3, M * S], contiguous,
    point m * S + s."""
    return (rays_o.T[:, :, None] + rays_d.T[:, :, None] * z[None]).reshape(
        3, -1)


def direction_plane(viewdirs: torch.Tensor, s: int) -> torch.Tensor:
    """unit directions [M, 3] -> [3, M * S], each repeated for its S
    points."""
    return viewdirs.T[:, :, None].expand(3, viewdirs.shape[0], s).reshape(
        3, -1)


def _unit(rays_d: torch.Tensor) -> torch.Tensor:
    return rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)


def hierarchical_fine_pass(fine_fn: Callable, rays_o: torch.Tensor,
                           rays_d: torch.Tensor, z_vals: torch.Tensor,
                           weights: torch.Tensor, *, n_fine: int,
                           perturb: float = 1.0,
                           n_keep: Optional[int] = None,
                           trunc_eps: float = 0.0,
                           generator: Optional[torch.Generator] = None,
                           u: Optional[torch.Tensor] = None):
    """The fine pass on the plane layout, given the coarse stats: inverse-CDF
    resample (uniforms from ``generator`` or injected ``u`` [M, n_fine]),
    merge, optionally an ``n_keep``-sample window of the merged depths
    (``truncation_window``, the culled renderer's truncation), the field,
    compositing.  rays [M, 3], z_vals and weights [M, Sc] ->
    ``volume.RenderOutputs`` over the kept samples."""
    z_all = hierarchical_z_vals(z_vals, weights, n_fine=n_fine,
                                perturb=perturb, generator=generator, u=u)
    if n_keep is not None and n_keep < z_all.shape[-1]:
        z_all = truncation_window(z_all, z_vals, weights, n_keep, trunc_eps)
    m, s = z_all.shape
    raw = fine_fn(position_plane(rays_o, rays_d, z_all),
                  direction_plane(_unit(rays_d), s))
    return volume_render_planar(raw.reshape(4, m, s), z_all, rays_d)


def render_rays(coarse_fn: Callable, fine_fn: Callable, rays_o: torch.Tensor,
                rays_d: torch.Tensor, *, near: float, far: float,
                n_coarse: int, n_fine: int, perturb: float = 1.0,
                stratified: bool = True,
                coarse_sigma_fn: Optional[Callable] = None,
                generator: Optional[torch.Generator] = None,
                u_c: Optional[torch.Tensor] = None,
                u_f: Optional[torch.Tensor] = None) -> RaysRender:
    """A flat batch of rays [N, 3] through the coarse (+ fine) pipeline on
    the plane layout: stratified depths, the coarse field on the planes
    (or, with ``coarse_sigma_fn`` and a fine pass, density alone: only the
    resampling weights are needed), compositing, then
    ``hierarchical_fine_pass``.  The draws are taken as
    ``render_rays_train`` takes them: the coarse jitter first (unless
    ``stratified`` is off), then the fine uniforms, from ``generator`` or
    injected as ``u_c`` [N, Sc] and ``u_f`` [N, Sf]."""
    n = rays_o.shape[0]
    z_vals = stratified_z_vals(n, near, far, n_coarse, perturb=stratified,
                               generator=generator, u=u_c,
                               device=rays_o.device)
    xp = position_plane(rays_o, rays_d, z_vals)
    if coarse_sigma_fn is not None and n_fine > 0:
        sigma_c = coarse_sigma_fn(xp).reshape(n, n_coarse)
        weights_c = weights_from_sigma(sigma_c, z_vals, rays_d)
        out_c = None
    else:
        raw_c = coarse_fn(xp, direction_plane(_unit(rays_d), n_coarse)).reshape(
            4, n, n_coarse)
        out_c = volume_render_planar(raw_c, z_vals, rays_d)
        weights_c = out_c.weights
    if n_fine <= 0:
        return RaysRender(out_c.rgb, out_c.disp, None, None, None, None)
    out_f = hierarchical_fine_pass(fine_fn, rays_o, rays_d, z_vals,
                                   weights_c.detach(), n_fine=n_fine,
                                   perturb=perturb, generator=generator,
                                   u=u_f)
    return RaysRender(None if out_c is None else out_c.rgb,
                      None if out_c is None else out_c.disp, out_f.rgb,
                      out_f.disp, out_f.acc, out_f.depth)


def render_rays_from_cfg(coarse_fn: Callable, fine_fn: Callable,
                         rays_o: torch.Tensor, rays_d: torch.Tensor, cfg,
                         stratified: bool = True,
                         coarse_sigma_fn: Optional[Callable] = None,
                         generator: Optional[torch.Generator] = None,
                         u_c: Optional[torch.Tensor] = None,
                         u_f: Optional[torch.Tensor] = None) -> RaysRender:
    """``render_rays`` with its settings from a ``NerfConfig``."""
    return render_rays(coarse_fn, fine_fn, rays_o, rays_d,
                       near=float(cfg.near), far=float(cfg.far),
                       n_coarse=cfg.N_samples_c, n_fine=cfg.N_samples_f,
                       perturb=float(cfg.perturb), stratified=stratified,
                       coarse_sigma_fn=coarse_sigma_fn, generator=generator,
                       u_c=u_c, u_f=u_f)


def render_frame(coarse_fn: Callable, fine_fn: Callable,
                 rays_o: torch.Tensor, rays_d: torch.Tensor, cfg, *,
                 block_rays: Optional[int] = None, stratified: bool = True,
                 coarse_sigma_fn: Optional[Callable] = None,
                 generator: Optional[torch.Generator] = None,
                 u_c: Optional[torch.Tensor] = None,
                 u_f: Optional[torch.Tensor] = None) -> RaysRender:
    """An arbitrary flat set of rays [N, 3], rendered in blocks of
    ``block_rays`` (else ``cfg.chunk_rays``, else 4096) to bound memory: a
    host loop of ``render_rays_from_cfg`` over the blocks, the JAX
    package's ``render_frame``.  The rays are padded with ones to a whole
    number of blocks, as the JAX package pads them, and the padding is cut
    off the outputs.  Each block draws from ``generator`` as
    ``render_rays`` does, unless ``u_c`` / ``u_f`` (rows for the padded
    ray count) are injected.  With the plane kernels' field functions
    (``make_field_fns``; ``make_sigma_fn`` as ``coarse_sigma_fn``) a block
    launches K8 (K7 for the coarse density) and K8."""
    n = rays_o.shape[0]
    block = int(block_rays or cfg.chunk_rays or 4096)
    n_pad = -n % block
    ro = torch.cat([rays_o, rays_o.new_ones(n_pad, 3)])
    rd = torch.cat([rays_d, rays_d.new_ones(n_pad, 3)])
    parts = []
    for i in range(0, n + n_pad, block):
        sl = slice(i, i + block)
        parts.append(render_rays_from_cfg(
            coarse_fn, fine_fn, ro[sl], rd[sl], cfg, stratified=stratified,
            coarse_sigma_fn=coarse_sigma_fn, generator=generator,
            u_c=None if u_c is None else u_c[sl],
            u_f=None if u_f is None else u_f[sl]))
    return RaysRender(*(None if f[0] is None else torch.cat(f)[:n]
                        for f in zip(*parts)))


def maybe_ndc(rays_o: torch.Tensor, rays_d: torch.Tensor, H: int, W: int,
              focal: float, data_type: str
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The NDC projection with near = 1 for LLFF (forward-facing) scenes,
    the rays unchanged for every other data type (reference
    nerf_process.py:224-226).  The view directions are then taken from the
    NDC ``rays_d``, as in the JAX package."""
    if data_type == "llff":
        return ndc_rays(H, W, focal, 1.0, rays_o, rays_d)
    return rays_o, rays_d


GATE_TILE = 128     # rays per gate tile: the kernels' block of rays
GATE_ROWS = 8       # samples per gate row


def span_sort(act: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Order rays by their (first, last) active-row span, so that gate
    tiles share spans; rays with no active row (provable misses) sort
    last and gate whole tiles.  act [N, R] bool -> (order [N], inv [N]),
    ``inv`` the inverse permutation; the sort is stable."""
    n, n_rows = act.shape
    a = act.to(torch.uint8)
    first = a.argmax(1)
    last = (n_rows - 1) - a.flip(1).argmax(1)
    span_key = torch.where(act.any(1), first * (n_rows + 1) + last,
                           torch.full_like(first, n_rows * (n_rows + 2)))
    order = torch.argsort(span_key, stable=True)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n, device=act.device)
    return order, inv


def tile_row_gate(act_sorted: torch.Tensor, tile: int = GATE_TILE
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(ray tile, sample row) gate over span-sorted row activity: a
    (tile, row) block runs iff any ray of the tile is active in the row.

    act_sorted [N, R] bool -> (gate [ceil(N / tile) * R] int32, tile-major:
    gate[t * R + r]; the skipped share of blocks, a 0-dim tensor).  A
    ragged last tile is padded with inactive rays.  This is the layout the
    gated kernels read (``kernels/fused_mlp.py``)."""
    n, n_rows = act_sorted.shape
    pad = -n % tile
    if pad:
        act_sorted = torch.cat([act_sorted, act_sorted.new_zeros(pad, n_rows)])
    gate = act_sorted.reshape(-1, tile, n_rows).any(1).reshape(-1)
    gate = gate.to(torch.int32)
    return gate, 1.0 - gate.float().mean()


def truncation_bounds(weights: torch.Tensor, eps: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-ray coarse window [k_start, k_need) of the sample truncation:
    k_start one bin before the first coarse sample where the cumulative
    weight reaches ``eps``, k_need one bin past the transmittance collapse
    (remaining T <= eps).  The one-bin margins keep the fine samples that
    the resample puts between the coarse midpoints.  weights [M, Sc] ->
    (k_start [M], k_need [M]), 0 <= k_start <= k_need <= Sc."""
    nc = weights.shape[-1]
    cum = torch.cumsum(weights, -1)
    rem = 1.0 - cum
    k_need = torch.clamp(torch.sum(rem > eps, -1) + 2, max=nc)
    k_start = torch.clamp(torch.sum(cum < eps, -1) - 1, min=0)
    return k_start, torch.maximum(k_need, k_start)


def truncation_window(z_all: torch.Tensor, z_vals: torch.Tensor,
                      weights: torch.Tensor, n_keep: int, eps: float
                      ) -> torch.Tensor:
    """Per-ray ``n_keep``-sample window of the sorted merged depths: it
    starts at the first merged depth at or past z_vals[k_start]
    (``truncation_bounds``), moved earlier where it would run past the
    end.  z_all [M, S] sorted, z_vals/weights [M, Sc] -> [M, n_keep]."""
    if eps <= 0:
        return z_all[:, :n_keep]
    k_start, _ = truncation_bounds(weights, eps)
    nc = z_vals.shape[-1]
    z_cut = torch.gather(z_vals, -1,
                         torch.clamp(k_start, max=nc - 1)[:, None])
    m_start = torch.sum(z_all < z_cut, -1)
    m_start = torch.clamp(m_start, 0, z_all.shape[-1] - n_keep)
    idx = m_start[:, None] + torch.arange(n_keep, device=z_all.device)
    return torch.gather(z_all, -1, idx)
