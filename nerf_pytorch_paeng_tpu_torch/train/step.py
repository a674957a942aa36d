"""The train step: render -> loss -> backward -> Adam update.

Counterpart of the JAX package's ``train/step.py`` on its fused kernels,
routed as it routes them (``uses_ray_pair``): the ray-major pair
(``render_rays_train``) where ``use_rays_train`` is on and the shapes
apply (a multiple of 128 rays, sample counts in whole 8-sample rows), the
plane pair (``render_rays_from_cfg`` on ``make_train_field_fns``)
otherwise.  Two batch modes, as in the reference:

- global batch: the step receives a pre-sliced [N, 3] x 3 ray batch;
- per image: the step receives one image and its pose, draws ``N_rays``
  pixels (from the centre crop while ``precrop``) and gathers their rays.

Each step draws from a generator seeded from (seed, completed updates),
the counterpart of ``fold_in(key, state.step)``: a resumed run replays the
same draws.  Tests inject the JAX package's draws instead (``coords``,
``u_c``, ``u_f``).

Both steps take ``support=`` (coarse bounds, fine bounds) from
``train/precull.make_train_support_program``, or None: with bounds each
pass is occupancy-gated (K5, K6) and the metrics gain ``gate_frac``; the
loss is the ungated one bit for bit.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from ..ops.rays import gather_rays, get_rays, sample_pixels
from ..ops.render import (make_train_field_fns, render_rays_from_cfg,
                          render_rays_train, supports_train_rays_kernels)
from .state import TrainState

_U64 = (1 << 64) - 1


def mse2psnr(mse: torch.Tensor) -> torch.Tensor:
    """-10 log10(mse), reference utils.py:17."""
    return -10.0 * torch.log(mse) / math.log(10.0)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one train step, seeded from (seed, count of
    completed updates) through a splitmix64 finaliser: every bit of the
    64-bit seed depends on both, and the CPU generator, which keeps only
    the low 32 bits, still sees both."""
    x = (((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF)) + 0x9E3779B97F4A7C15
    x &= _U64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _U64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _U64
    x ^= x >> 31
    return torch.Generator(device=device).manual_seed(x)


def uses_ray_pair(cfg, n_rays: int) -> bool:
    """The step's route, the JAX package's: the ray-major pair (K1/K2, or
    gated K5/K6) where ``use_rays_train`` is on and its shapes apply, else
    the plane pair (K8/K9)."""
    return bool(cfg.use_rays_train
                and supports_train_rays_kernels(cfg, n_rays))


def _loss_and_metrics(model, rays_o, rays_d, target, cfg,
                      generator=None, u_c=None, u_f=None, support=None):
    """MSE(coarse) + MSE(fine) and the PSNRs taken from the losses; with
    ``support`` (coarse bounds, fine bounds, half-side) the gated passes'
    skipped block share as ``gate_frac``.  The plane route takes no
    ``support``, as in the JAX package (``train/precull`` enables gating on
    the ray route only)."""
    if uses_ray_pair(cfg, rays_o.shape[0]):
        out = render_rays_train(model, rays_o, rays_d, cfg, generator, u_c,
                                u_f, support)
    else:
        coarse, fine = make_train_field_fns(model, cfg)
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


def _update(state: TrainState, schedule: Callable[[int], float],
            loss_fn) -> Dict[str, torch.Tensor]:
    for group in state.optimizer.param_groups:
        group["lr"] = schedule(state.step)
    state.optimizer.zero_grad(set_to_none=True)
    loss, metrics = loss_fn()
    loss.backward()
    state.optimizer.step()
    state.step += 1
    return metrics


def _with_half(cfg, support):
    """(coarse bounds, fine bounds) -> the render's (..., half-side)."""
    if support is None:
        return None
    from ..eval.frame import _precull_half
    return (*support, _precull_half(cfg))


def make_train_step(cfg, schedule: Callable[[int], float]):
    """Global-batch step: ``(state, rays_o, rays_d, target, u_c=None,
    u_f=None, support=None) -> metrics``; updates ``state`` in place."""
    seed = cfg.seed + 3

    def train_step(state: TrainState, rays_o, rays_d, target,
                   u_c: Optional[torch.Tensor] = None,
                   u_f: Optional[torch.Tensor] = None, support=None):
        gen = step_generator(seed, state.step, rays_o.device)
        sup = _with_half(cfg, support)
        return _update(state, schedule, lambda: _loss_and_metrics(
            state.model, rays_o, rays_d, target, cfg, gen, u_c, u_f, sup))
    return train_step


def make_image_train_step(cfg, schedule: Callable[[int], float], H: int,
                          W: int, K):
    """Per-image step: ``(state, image [H,W,3], pose, precrop=False,
    coords=None, u_c=None, u_f=None, support=None) -> metrics``.  The
    image's rays are generated, ``N_rays`` pixels drawn (the step's
    generator draws the pixels first, then the render's jitter) and
    gathered."""
    seed = cfg.seed + 3

    def train_step(state: TrainState, image, pose, precrop: bool = False,
                   coords: Optional[torch.Tensor] = None,
                   u_c: Optional[torch.Tensor] = None,
                   u_f: Optional[torch.Tensor] = None, support=None):
        gen = step_generator(seed, state.step, image.device)
        rays_o, rays_d = get_rays(H, W, K, pose)
        if coords is None:
            coords = sample_pixels(H, W, cfg.N_rays, precrop,
                                   cfg.precrop_frac, generator=gen,
                                   device=image.device)
        ro, rd, target = gather_rays(rays_o, rays_d, image, coords)
        sup = _with_half(cfg, support)
        return _update(state, schedule, lambda: _loss_and_metrics(
            state.model, ro.contiguous(), rd.contiguous(), target, cfg, gen,
            u_c, u_f, sup))
    return train_step
