"""NeRF (Mildenhall et al., ECCV 2020): the coarse and fine MLPs of
``models/nerf.py`` on the fused ray kernels, as ``arch/__init__.py``
lists its pieces.  The step bodies and draws are ``train/step.py``'s, the
frame renderers ``eval/frame.py``'s, the occupancy policy
``train/precull.py``'s."""
from __future__ import annotations

import numpy as np
import torch

from ..eval.frame import make_nerf_frame_renderer
from ..kernels.fused_mlp import pack_nerf
from ..models.nerf import NeRF, init_nerf
from ..ops.render import plain_route_reason
from ..parallel.tensor import full_model, shard_nerf
from ..train.chunk import StepKind
from ..train.precull import support_hook
from ..train.schedule import cosine_annealing_warmup_restarts
from ..train.step import (_rank_slice, batch_draws, image_draws,
                          make_image_train_body, make_train_body)


def fresh_model(cfg, device) -> NeRF:
    """The weights drawn from ``cfg.seed``; under ``n_model_shards > 1``
    the rank's parts of them (``parallel/tensor.shard_nerf``)."""
    return shard_nerf(init_nerf(cfg, device=device))


def empty_model(cfg) -> NeRF:
    return NeRF(depth=cfg.netDepth, width=cfg.netWidth, L_x=cfg.L_x,
                L_d=cfg.L_d)


def make_optimizer(model, cfg) -> torch.optim.Adam:
    """Adam(beta=(0.9, 0.999), eps=1e-8), as optax.adam in the JAX package
    and torch's Adam in the reference; capturable on a CUDA device
    (``train/state.make_optimizer``)."""
    device = next(model.parameters()).device
    if device.type == "cuda":
        return torch.optim.Adam(
            model.parameters(), lr=torch.tensor(float(cfg.lr), device=device),
            betas=(0.9, 0.999), eps=1e-8, capturable=True)
    return torch.optim.Adam(model.parameters(), lr=cfg.lr,
                            betas=(0.9, 0.999), eps=1e-8)


def schedule(cfg):
    """The reference driver's warmup-cosine instance: one cycle of
    ``iter_N + 1`` steps, warmup ``iter_warmup``, peak ``lr``, floor
    ``lr_min``."""
    def lr(step: int) -> float:
        return cosine_annealing_warmup_restarts(
            step, cfg.iter_N + 1, cfg.iter_warmup, cfg.lr, cfg.lr_min)
    return lr


def route_line(cfg) -> str:
    """The fused kernels, or the plain MLP and why."""
    reason = plain_route_reason(
        cfg, train=not (cfg.eval_only or cfg.render_only))
    return (f"{'fused kernels' if reason is None else 'plain'}"
            + (f" ({reason})" if reason else ""))


def frame_weights(model, cfg, device):
    """The weights packed for the kernels (``pack_nerf``), gathered to
    full width first."""
    return pack_nerf(full_model(model), cfg, device=device)


make_frame_renderer = make_nerf_frame_renderer


def step_kind(cfg, H: int, W: int, K, device, pool: bool) -> StepKind:
    """The global-batch step (``make_train_body``, ``batch_draws``) or the
    per-image one (``make_image_train_body``, ``image_draws``), both with
    this rank's rows of the coarse jitter and the fine uniforms (none at
    ``perturb 0`` or without a fine pass)."""
    lo, hi, _, _ = _rank_slice(int(cfg.N_rays))
    fine = cfg.N_samples_f > 0
    u_f = ((hi - lo, cfg.N_samples_f)
           if fine and float(cfg.perturb) != 0.0 else None)
    keys = ("loss_c", "psnr_c", *(("loss_f", "psnr_f") if fine else ()),
            "loss", "psnr")
    if pool:
        body = make_train_body(cfg, H, W, float(np.asarray(K)[0, 0]))
        return StepKind(body, batch_draws, (hi - lo, cfg.N_samples_c), u_f,
                        keys)
    return StepKind(make_image_train_body(cfg, H, W, K), image_draws,
                    (hi - lo, cfg.N_samples_c), u_f, keys)


def check_run(cfg, world: int) -> None:
    """NeRF trains on any launch ``parallel/`` accepts."""


chunk_hook = support_hook
