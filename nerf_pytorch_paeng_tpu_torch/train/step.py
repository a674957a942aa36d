"""The train step: render -> loss -> backward -> Adam update.

Counterpart of the JAX package's ``train/step.py``, routed three ways as
it routes (``step_route``): outside the fused kernels' domain
(``ops/render.plain_route_reason``: ``use_pallas`` off or another
architecture) the plain MLP under autograd (``render_rays_from_cfg`` on
``make_plain_field_fns``, the JAX package's XLA route); inside it the
ray-major pair (``render_rays_train``) where ``use_rays_train`` is on and
the shapes apply (a multiple of 128 rays, sample counts in whole 8-sample
rows), the plane pair (``render_rays_from_cfg`` on
``make_train_field_fns``) otherwise.  Two batch modes, as in the
reference:

- global batch: the step receives a pre-sliced [N, 3] x 3 ray batch;
- per image: the step receives one image and its pose, draws ``N_rays``
  pixels (from the centre crop while ``precrop``) and gathers their rays.

Both steps project LLFF rays into NDC (``ops/render.maybe_ndc``) before
rendering; the ray pool and the image's ray fields hold world rays, as in
the JAX package.

Each step draws from a generator seeded from (seed, completed updates),
the counterpart of ``fold_in(key, state.step)``: a resumed run replays the
same draws.  Tests inject the JAX package's draws instead (``coords``,
``u_c``, ``u_f``).  A step is its draws (``batch_draws``,
``image_draws``: the pixels, the coarse jitter, the fine uniforms, in the
order the render would take them) and then its body (``make_train_body``,
``make_image_train_body``: render, loss, backward, Adam, with every draw
injected), so that ``train/chunk.py`` can stage the draws into the static
buffers of a captured body.

Under a process group (``parallel/``, the JAX package's shard_map path)
both steps still receive the whole batch: the global batch, or the image
whose ``N_rays`` pixels every rank draws alike.  Each data rank keeps its
contiguous slice (``parallel.rank_bounds``), routes and renders it as the
JAX package's kernels see a shard (``step_route`` at the rank's own
count), and after ``backward`` the gradients are summed over the ranks
weighted by each rank's share of the batch, one flat buffer, before
Adam steps; so are the loss entries, and the PSNRs are taken again from
the mean losses (``_pmean_metrics`` there).  At world size > 1 the
render's jitter comes from a generator seeded from (seed, step, rank);
at world size 1 every draw is the plain run's.  Injected ``u_c``/``u_f``
are the rank's own.

Under ``n_model_shards > 1`` (the JAX package's GSPMD path) the ranks
of a model group hold their parts of the MLP's width
(``parallel/tensor.py``) and the step takes the plain route
(``plain_route_reason(cfg, train=True)``, the JAX package's
``force_xla``).  Its draws are the one-process run's: each data rank
takes its rows of the batch and of the whole batch's jitter
(``_global_draws``); the gradients, split or replicated, and the metrics
are reduced over the data group alone.

Both steps take ``support=`` (coarse bounds, fine bounds) from
``train/precull.make_train_support_program``, or None: with bounds each
pass is occupancy-gated (K5, K6) and the metrics gain ``gate_frac``; the
loss is the ungated one bit for bit.

Instant-NGP (``cfg.arch == "ngp"``, ``models/ngp.py``) has a step kind of
its own on the global batch, one process: ``ngp_draws`` (one uniform a
ray, from the step's generator) and ``make_ngp_train_body`` (march,
encode, both MLPs, composite, the MSE over the kept rays, backward, Adam),
which adds the step's counts to an ``NGPCounters`` on the device.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .. import parallel
from ..kernels.ngp_march import MarchParams
from ..models.ngp import update_occupancy_grid
from ..ops.ngp import ngp_loss, render_rays_ngp
from ..ops.rays import gather_rays, get_rays, sample_pixels
from ..ops.render import (make_plain_field_fns, make_train_field_fns,
                          maybe_ndc, plain_route_reason, render_rays_from_cfg,
                          render_rays_train, supports_train_rays_kernels)
from ..utils.spans import span
from .state import TrainState, set_lr

_U64 = (1 << 64) - 1


def mse2psnr(mse: torch.Tensor) -> torch.Tensor:
    """-10 log10(mse), reference utils.py:17."""
    return -10.0 * torch.log(mse) / math.log(10.0)


def _splitmix(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _U64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _U64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _U64
    return x ^ (x >> 31)


def step_generator(seed: int, step: int, device,
                   rank: Optional[int] = None) -> torch.Generator:
    """The generator of one train step, seeded from (seed, count of
    completed updates) through a splitmix64 finaliser: every bit of the
    64-bit seed depends on both, and the CPU generator, which keeps only
    the low 32 bits, still sees both.  With ``rank`` (data parallelism at
    world size > 1) the rank is mixed in too, as the JAX package folds
    ``axis_index`` into the render's key."""
    x = _splitmix(((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF))
    if rank is not None:
        x = _splitmix(x ^ (rank & 0xFFFFFFFF))
    return torch.Generator(device=device).manual_seed(x)


def step_route(cfg, n_rays: int) -> str:
    """The step's route, the JAX package's: "plain" outside the kernels'
    domain and under ``n_model_shards > 1`` (``plain_route_reason(cfg,
    train=True)``), else "rays" (the ray-major pair: K1/K2, or gated
    K5/K6) where ``use_rays_train`` is on and its shapes apply, else
    "planes" (the plane pair: K8/K9)."""
    if plain_route_reason(cfg, train=True) is not None:
        return "plain"
    if cfg.use_rays_train and supports_train_rays_kernels(cfg, n_rays):
        return "rays"
    return "planes"


def uses_ray_pair(cfg, n_rays: int) -> bool:
    return step_route(cfg, n_rays) == "rays"


def _loss_and_metrics(model, rays_o, rays_d, target, cfg,
                      generator=None, u_c=None, u_f=None, support=None):
    """MSE(coarse) + MSE(fine) and the PSNRs taken from the losses; with
    ``support`` (coarse bounds, fine bounds, half-side) the gated passes'
    skipped block share as ``gate_frac``.  The plane and plain routes take
    no ``support``, as in the JAX package (``train/precull`` enables
    gating on the ray route only)."""
    route = step_route(cfg, rays_o.shape[0])
    if route == "rays":
        out = render_rays_train(model, rays_o, rays_d, cfg, generator, u_c,
                                u_f, support)
    else:
        coarse, fine = (make_train_field_fns if route == "planes"
                        else make_plain_field_fns)(model, cfg)
        out = render_rays_from_cfg(coarse, fine, rays_o, rays_d, cfg,
                                   generator=generator, u_c=u_c, u_f=u_f)
    loss_c = torch.mean((out.rgb_c - target) ** 2)
    metrics = dict(loss_c=loss_c, psnr_c=mse2psnr(loss_c))
    loss = loss_c
    if cfg.N_samples_f > 0:
        loss_f = torch.mean((out.rgb_f - target) ** 2)
        loss = loss_c + loss_f
        metrics.update(loss_f=loss_f, psnr_f=mse2psnr(loss_f))
    metrics.update(loss=loss, psnr=mse2psnr(loss))
    if out.gate_frac is not None:
        metrics["gate_frac"] = out.gate_frac
    return loss, {k: v.detach() for k, v in metrics.items()}


def _reduce_metrics(metrics: Dict[str, torch.Tensor], share: float
                    ) -> Dict[str, torch.Tensor]:
    """The data group's loss entries (and ``gate_frac``) averaged by their
    shares of the batch in one all-reduce, the PSNRs taken again from the
    mean losses: PSNR is not linear in the MSE."""
    keys = [k for k in metrics if not k.startswith("psnr")]
    vals = parallel.all_reduce_sum(
        torch.stack([metrics[k].float() for k in keys]) * share,
        parallel.data_group())
    out = dict(zip(keys, vals.unbind()))
    return {k: mse2psnr(out["loss" + k[4:]]) if k.startswith("psnr")
            else out[k] for k in metrics}


def apply_update(state: TrainState, loss_fn, share: Optional[float] = None
                 ) -> Dict[str, torch.Tensor]:
    """One Adam update at the optimizer's current ``lr``; under a process
    group (``share``: this rank's share of the batch) the gradients and
    metrics are reduced over the data group first (a width-sharded model's
    split gradients are each rank's own parts, its replicated ones alike
    over the model group).  No host read: ``train/chunk.py`` captures it.
    The step count is the caller's."""
    state.optimizer.zero_grad(set_to_none=True)
    loss, metrics = loss_fn()
    loss.backward()
    if share is not None:
        parallel.all_reduce_grads(state.model.parameters(), share,
                                  parallel.data_group())
        metrics = _reduce_metrics(metrics, share)
    state.optimizer.step()
    return metrics


def scheduled_update(state: TrainState, schedule: Callable[[int], float],
            body) -> Dict[str, torch.Tensor]:
    """``body()`` (an ``apply_update``, or a staged step's replay in
    ``train/chunk.py``) at ``schedule(state.step)``, then one more
    completed update: the one place where a train step's learning rate is
    set and its count advanced, for the single steps and the driver's
    chunks alike."""
    set_lr(state.optimizer, schedule(state.step))
    metrics = body()
    state.step += 1
    return metrics


def _rank_slice(n: int):
    """(lo, hi, share, render rank): this rank's rows of an n-row batch
    (its data index's part), its share of the batch (None without a
    process group: nothing is reduced) and the rank to mix into the
    render's generator: the data index where data parallelism alone
    splits the batch (the JAX package's shard_map path), None at one data
    rank and under ``n_model_shards > 1`` (its GSPMD path: the plain run's
    draws, ``_global_draws``)."""
    g = parallel.data_group()
    lo, hi = parallel.rank_bounds(n, g.index, g.size)
    share = (hi - lo) / n if parallel.is_distributed() else None
    per_rank = g.size > 1 and parallel.layout().n_model == 1
    return lo, hi, share, (g.index if per_rank else None)


def _global_draws(cfg, generator, n: int, lo: int, hi: int, u_c, u_f):
    """Under ``n_model_shards > 1`` with more than one data rank: rows
    [lo, hi) of the render's draws for the whole n-ray batch, drawn as the
    plain run's samplers draw them (the coarse jitter, then the fine
    uniforms), so that the step is the one-process step (the JAX
    package's GSPMD semantics).  Injected draws, and every other layout,
    pass through."""
    if (u_c is not None or u_f is not None or parallel.layout().n_model == 1
            or hi - lo == n):
        return u_c, u_f
    dev = generator.device
    u_c = torch.rand((n, cfg.N_samples_c), generator=generator,
                     device=dev)[lo:hi]
    if cfg.N_samples_f > 0 and float(cfg.perturb) != 0.0:
        u_f = torch.rand((n, cfg.N_samples_f), generator=generator,
                         device=dev)[lo:hi]
    return u_c, u_f


def _render_draws(cfg, generator: torch.Generator, n: int, lo: int,
                  hi: int, u_c, u_f, device):
    """The render's uniforms of this rank's rows [lo, hi) of an n-ray
    batch, each drawn from ``generator`` unless injected, in the order and
    shapes the samplers draw them (``stratified_z_vals``: the coarse
    jitter [m, Sc]; ``sample_pdf``: the fine uniforms [m, Sf], none at
    ``perturb 0`` or without a fine pass), or the whole batch's rows
    under ``_global_draws``."""
    u_c, u_f = _global_draws(cfg, generator, n, lo, hi, u_c, u_f)
    if u_c is None:
        u_c = torch.rand((hi - lo, cfg.N_samples_c), generator=generator,
                         dtype=torch.float32, device=device)
    if u_f is None and cfg.N_samples_f > 0 and float(cfg.perturb) != 0.0:
        u_f = torch.rand((hi - lo, cfg.N_samples_f), generator=generator,
                         dtype=torch.float32, device=device)
    return u_c, u_f


def batch_draws(cfg, step: int, n: int, device,
                u_c: Optional[torch.Tensor] = None,
                u_f: Optional[torch.Tensor] = None):
    """(u_c, u_f) of global-batch update ``step`` (``step`` completed
    updates before it) for this rank's slice of an n-ray batch, from the
    step's own generator; injected draws are kept."""
    lo, hi, _, render_rank = _rank_slice(n)
    gen = step_generator(cfg.seed + 3, step, device, render_rank)
    return _render_draws(cfg, gen, n, lo, hi, u_c, u_f, device)


def image_draws(cfg, step: int, H: int, W: int, precrop: bool, device,
                coords: Optional[torch.Tensor] = None,
                u_c: Optional[torch.Tensor] = None,
                u_f: Optional[torch.Tensor] = None):
    """(coords, u_c, u_f) of per-image update ``step``: the ``N_rays``
    pixels (``sample_pixels``' randperm, from the centre crop while
    ``precrop``), then the render's uniforms of this rank's rays, from the
    step's generator (under data parallelism the pixels from the
    rank-free one, every rank alike, the render's from the rank's own);
    injected draws are kept."""
    lo, hi, _, render_rank = _rank_slice(cfg.N_rays)
    gen = step_generator(cfg.seed + 3, step, device)
    if coords is None:
        coords = sample_pixels(H, W, cfg.N_rays, precrop, cfg.precrop_frac,
                               generator=gen, device=device)
    if render_rank is not None:
        gen = step_generator(cfg.seed + 3, step, device, render_rank)
    return (coords, *_render_draws(cfg, gen, cfg.N_rays, lo, hi, u_c, u_f,
                                   device))


def _with_half(cfg, support):
    """(coarse bounds, fine bounds) -> the render's (..., half-side)."""
    if support is None:
        return None
    from ..eval.frame import _precull_half
    return (*support, _precull_half(cfg))


def make_train_body(cfg, H: int = 0, W: int = 0, focal: float = 0.0):
    """The global-batch step with its draws injected: ``(state, rays_o,
    rays_d, target, u_c, u_f, support=None) -> metrics``, one
    ``apply_update`` at the optimizer's ``lr``, no host read and no step
    count.  The rays are the global batch (a rank keeps its slice; the
    draws are the rank's, ``batch_draws``).  ``H``, ``W`` and ``focal``
    serve only LLFF's NDC projection, applied to each batch of world
    rays."""
    def body(state: TrainState, rays_o, rays_d, target, u_c, u_f,
             support=None):
        lo, hi, share, _ = _rank_slice(rays_o.shape[0])
        rays_o, rays_d = maybe_ndc(rays_o[lo:hi], rays_d[lo:hi], H, W, focal,
                                   cfg.data_type)
        target = target[lo:hi]
        sup = _with_half(cfg, support)
        return apply_update(state, lambda: _loss_and_metrics(
            state.model, rays_o, rays_d, target, cfg, None, u_c, u_f, sup),
            share)
    return body


def make_train_step(cfg, schedule: Callable[[int], float], H: int = 0,
                    W: int = 0, focal: float = 0.0):
    """Global-batch step: ``(state, rays_o, rays_d, target, u_c=None,
    u_f=None, support=None) -> metrics``; updates ``state`` in place:
    ``batch_draws``, then ``make_train_body``'s body at
    ``schedule(state.step)``."""
    body = make_train_body(cfg, H, W, focal)

    def train_step(state: TrainState, rays_o, rays_d, target,
                   u_c: Optional[torch.Tensor] = None,
                   u_f: Optional[torch.Tensor] = None, support=None):
        u_c, u_f = batch_draws(cfg, state.step, rays_o.shape[0],
                               rays_o.device, u_c, u_f)
        return scheduled_update(state, schedule, lambda: body(
            state, rays_o, rays_d, target, u_c, u_f, support))
    return train_step


def make_image_train_body(cfg, H: int, W: int, K):
    """The per-image step with its draws injected: ``(state, image
    [H,W,3], pose, coords [N_rays, 2], u_c, u_f, support=None) ->
    metrics``, one ``apply_update`` at the optimizer's ``lr``, no host
    read and no step count.  The image's rays are generated, the pixels
    at ``coords`` gathered (this rank's rows) and, for LLFF, projected
    into NDC."""
    focal = float(np.asarray(K)[0, 0])
    K_on = {}           # K on each device, copied once (none in a capture)

    def body(state: TrainState, image, pose, coords, u_c, u_f,
             support=None):
        lo, hi, share, _ = _rank_slice(cfg.N_rays)
        dev = image.device
        if dev not in K_on:
            K_on[dev] = torch.as_tensor(np.asarray(K), dtype=torch.float32,
                                        device=dev)
        rays_o, rays_d = get_rays(H, W, K_on[dev], pose)
        ro, rd, target = gather_rays(rays_o, rays_d, image, coords[lo:hi])
        ro, rd = maybe_ndc(ro, rd, H, W, focal, cfg.data_type)
        sup = _with_half(cfg, support)
        return apply_update(state, lambda: _loss_and_metrics(
            state.model, ro.contiguous(), rd.contiguous(), target, cfg, None,
            u_c, u_f, sup), share)
    return body


def make_image_train_step(cfg, schedule: Callable[[int], float], H: int,
                          W: int, K):
    """Per-image step: ``(state, image [H,W,3], pose, precrop=False,
    coords=None, u_c=None, u_f=None, support=None) -> metrics``:
    ``image_draws`` (the step's generator draws the pixels first, then the
    render's jitter), then ``make_image_train_body``'s body at
    ``schedule(state.step)``."""
    body = make_image_train_body(cfg, H, W, K)

    def train_step(state: TrainState, image, pose, precrop: bool = False,
                   coords: Optional[torch.Tensor] = None,
                   u_c: Optional[torch.Tensor] = None,
                   u_f: Optional[torch.Tensor] = None, support=None):
        coords, u_c, u_f = image_draws(cfg, state.step, H, W, precrop,
                                       image.device, coords, u_c, u_f)
        return scheduled_update(state, schedule, lambda: body(
            state, image, pose, coords, u_c, u_f, support))
    return train_step


# ------------------------------------------------------------ Instant-NGP


class NGPCounters:
    """The NGP steps' counts, accumulated on the device without a host
    read: rays drawn, rays kept within the budget, samples kept, and the
    fewest samples kept in one step since ``reset_min``."""

    def __init__(self, device):
        self.t = torch.zeros(4, dtype=torch.float64, device=device)
        self.reset_min()

    def reset_min(self) -> None:
        self.t[3].fill_(math.inf)

    def add(self, n_rays: int, stats: torch.Tensor) -> None:
        self.t[0] += n_rays
        self.t[1:3] += stats.double()
        torch.minimum(self.t[3:], stats[1:].double(), out=self.t[3:])


def ngp_draws(cfg, step: int, n: int, device,
              u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The per-ray uniforms [n] of NGP update ``step`` (``step`` completed
    updates before it), from the step's generator; injected ones are
    kept."""
    if u is None:
        gen = step_generator(cfg.seed + 3, step, device)
        u = torch.rand((n,), generator=gen, dtype=torch.float32,
                       device=device)
    return u


def make_ngp_train_body(cfg, counters: Optional[NGPCounters] = None):
    """The NGP step with its draws injected: ``(state, rays_o, rays_d,
    target, u, u_f=None, support=None) -> metrics`` (``loss``, ``psnr``),
    one ``apply_update`` at the optimizer's ``lr``, no host read and no
    step count; ``u_f`` and ``support`` are NeRF's and unused."""
    params = MarchParams.from_cfg(cfg)

    def body(state: TrainState, rays_o, rays_d, target, u, u_f=None,
             support=None):
        def loss_fn():
            out = render_rays_ngp(state.model, rays_o, rays_d, u, params)
            loss = ngp_loss(out, target)
            if counters is not None:
                counters.add(rays_o.shape[0], out["stats"])
            d = loss.detach()
            return loss, dict(loss=d, psnr=mse2psnr(d))
        return apply_update(state, loss_fn)
    return body


def ngp_grid_update(model, cfg, step: int) -> None:
    """The occupancy grid's update after ``step`` completed updates
    (``models/ngp.update_occupancy_grid``), its draws from a generator
    seeded from (seed + 5, step); span ``ngp.grid_update``."""
    with span("ngp.grid_update"):
        device = model.grid_values.device
        update_occupancy_grid(model, cfg, step, step_generator(
            cfg.seed + 5, step, device))
