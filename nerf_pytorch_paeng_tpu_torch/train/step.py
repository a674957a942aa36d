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
``u_c``, ``u_f``).

Under a process group (``parallel/``, the JAX package's shard_map path)
both steps still receive the whole batch: the global batch, or the image
whose ``N_rays`` pixels every rank draws alike.  Each rank keeps its
contiguous slice (``parallel.rank_bounds``), routes and renders it as the
JAX package's kernels see a shard (``step_route`` at the rank's own
count), and after ``backward`` the gradients are summed over the ranks
weighted by each rank's share of the batch, one flat buffer, before
Adam steps; so are the loss entries, and the PSNRs are taken again from
the mean losses (``_pmean_metrics`` there).  At world size > 1 the
render's jitter comes from a generator seeded from (seed, step, rank);
at world size 1 every draw is the plain run's.  Injected ``u_c``/``u_f``
are the rank's own.

Both steps take ``support=`` (coarse bounds, fine bounds) from
``train/precull.make_train_support_program``, or None: with bounds each
pass is occupancy-gated (K5, K6) and the metrics gain ``gate_frac``; the
loss is the ungated one bit for bit.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .. import parallel
from ..ops.rays import gather_rays, get_rays, sample_pixels
from ..ops.render import (make_plain_field_fns, make_train_field_fns,
                          maybe_ndc, render_rays_from_cfg, render_rays_train,
                          supports_kernels, supports_train_rays_kernels)
from .state import TrainState

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
    domain, else "rays" (the ray-major pair: K1/K2, or gated K5/K6) where
    ``use_rays_train`` is on and its shapes apply, else "planes" (the
    plane pair: K8/K9)."""
    if not supports_kernels(cfg):
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
    """The ranks' loss entries (and ``gate_frac``) averaged by their
    shares of the batch in one all-reduce, the PSNRs taken again from the
    mean losses: PSNR is not linear in the MSE."""
    keys = [k for k in metrics if not k.startswith("psnr")]
    vals = parallel.all_reduce_sum(
        torch.stack([metrics[k].float() for k in keys]) * share)
    out = dict(zip(keys, vals.unbind()))
    return {k: mse2psnr(out["loss" + k[4:]]) if k.startswith("psnr")
            else out[k] for k in metrics}


def _update(state: TrainState, schedule: Callable[[int], float],
            loss_fn, share: Optional[float] = None
            ) -> Dict[str, torch.Tensor]:
    """One Adam update; under a process group (``share``: this rank's
    share of the batch) the gradients and metrics are reduced over the
    ranks first."""
    for group in state.optimizer.param_groups:
        group["lr"] = schedule(state.step)
    state.optimizer.zero_grad(set_to_none=True)
    loss, metrics = loss_fn()
    loss.backward()
    if share is not None:
        parallel.all_reduce_grads(state.model.parameters(), share)
        metrics = _reduce_metrics(metrics, share)
    state.optimizer.step()
    state.step += 1
    return metrics


def _rank_slice(n: int):
    """(lo, hi, share, render rank): this rank's rows of an n-row batch,
    its share of the batch (None without a process group: nothing is
    reduced) and the rank to mix into the render's generator (None at
    world size 1: the plain run's draws)."""
    world, r = parallel.world_size(), parallel.rank()
    lo, hi = parallel.rank_bounds(n, r, world)
    share = (hi - lo) / n if parallel.is_distributed() else None
    return lo, hi, share, (r if world > 1 else None)


def _with_half(cfg, support):
    """(coarse bounds, fine bounds) -> the render's (..., half-side)."""
    if support is None:
        return None
    from ..eval.frame import _precull_half
    return (*support, _precull_half(cfg))


def make_train_step(cfg, schedule: Callable[[int], float], H: int = 0,
                    W: int = 0, focal: float = 0.0):
    """Global-batch step: ``(state, rays_o, rays_d, target, u_c=None,
    u_f=None, support=None) -> metrics``; updates ``state`` in place.
    The rays are the global batch (a rank keeps its slice).
    ``H``, ``W`` and ``focal`` serve only LLFF's NDC projection, applied
    to each batch of world rays."""
    seed = cfg.seed + 3

    def train_step(state: TrainState, rays_o, rays_d, target,
                   u_c: Optional[torch.Tensor] = None,
                   u_f: Optional[torch.Tensor] = None, support=None):
        lo, hi, share, render_rank = _rank_slice(rays_o.shape[0])
        gen = step_generator(seed, state.step, rays_o.device, render_rank)
        rays_o, rays_d = maybe_ndc(rays_o[lo:hi], rays_d[lo:hi], H, W, focal,
                                   cfg.data_type)
        target = target[lo:hi]
        sup = _with_half(cfg, support)
        return _update(state, schedule, lambda: _loss_and_metrics(
            state.model, rays_o, rays_d, target, cfg, gen, u_c, u_f, sup),
            share)
    return train_step


def make_image_train_step(cfg, schedule: Callable[[int], float], H: int,
                          W: int, K):
    """Per-image step: ``(state, image [H,W,3], pose, precrop=False,
    coords=None, u_c=None, u_f=None, support=None) -> metrics``.  The
    image's rays are generated, ``N_rays`` pixels drawn (the step's
    generator draws the pixels first, then the render's jitter) and
    gathered (and, for LLFF, projected into NDC)."""
    seed = cfg.seed + 3
    focal = float(np.asarray(K)[0, 0])

    def train_step(state: TrainState, image, pose, precrop: bool = False,
                   coords: Optional[torch.Tensor] = None,
                   u_c: Optional[torch.Tensor] = None,
                   u_f: Optional[torch.Tensor] = None, support=None):
        lo, hi, share, render_rank = _rank_slice(cfg.N_rays)
        gen = step_generator(seed, state.step, image.device)
        rays_o, rays_d = get_rays(H, W, K, pose)
        if coords is None:
            coords = sample_pixels(H, W, cfg.N_rays, precrop,
                                   cfg.precrop_frac, generator=gen,
                                   device=image.device)
        ro, rd, target = gather_rays(rays_o, rays_d, image, coords[lo:hi])
        ro, rd = maybe_ndc(ro, rd, H, W, focal, cfg.data_type)
        if render_rank is not None:
            gen = step_generator(seed, state.step, image.device, render_rank)
        sup = _with_half(cfg, support)
        return _update(state, schedule, lambda: _loss_and_metrics(
            state.model, ro.contiguous(), rd.contiguous(), target, cfg, gen,
            u_c, u_f, sup), share)
    return train_step
