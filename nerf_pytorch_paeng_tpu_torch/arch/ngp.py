"""Instant-NGP's NeRF (Müller et al., SIGGRAPH 2022): the hash encoding,
the two width-64 MLPs and the occupancy grid of ``models/ngp.py``, on its
hash-grid, marching and compositing kernels, as ``arch/__init__.py``
lists its pieces.  The step body, its draws and counters are
``train/step.py``'s, the frame renderer ``ops/ngp.py``'s.  It trains on
the global ray pool, in one process, with no gated training."""
from __future__ import annotations

import torch

from ..models.ngp import (ADAM_BETAS, ADAM_EPS, LR_DECAY, LR_DECAY_EVERY,
                          LR_DECAY_START, MLP_L2, NGP, grid_update_due,
                          init_ngp, next_grid_update)
from ..ops.ngp import make_ngp_frame_renderer
from ..train.chunk import StepKind
from ..train.schedule import ngp_step_decay
from ..train.step import (NGPCounters, make_ngp_train_body, ngp_batch_draws,
                          ngp_grid_update)


def fresh_model(cfg, device) -> NGP:
    return init_ngp(cfg, device=device)


def empty_model(cfg) -> NGP:
    return NGP(cfg)


def make_optimizer(model, cfg) -> torch.optim.Adam:
    """Instant-NGP's Adam: betas (0.9, 0.99), eps 1e-15, L2 1e-6 on the
    MLP weights (added to their gradients), none on the hash tables
    (``models/ngp.py``); capturable on a CUDA device, as NeRF's, and there
    fused (one kernel a parameter group: over 12.2M parameters the foreach
    form took 0.36 ms more of a 2.5 ms step on an H100)."""
    device = next(model.parameters()).device
    groups = [dict(params=list(model.tables), weight_decay=0.0),
              dict(params=model.mlp_parameters(), weight_decay=MLP_L2)]
    kw = dict(betas=ADAM_BETAS, eps=ADAM_EPS)
    if device.type == "cuda":
        return torch.optim.Adam(
            groups, lr=torch.tensor(float(cfg.lr), device=device),
            capturable=True, fused=True, **kw)
    return torch.optim.Adam(groups, lr=cfg.lr, **kw)


def schedule(cfg):
    """``ngp_step_decay`` at the published decay steps."""
    def lr(step: int) -> float:
        return ngp_step_decay(step, cfg.lr, LR_DECAY_START, LR_DECAY_EVERY,
                              LR_DECAY)
    return lr


def route_line(cfg) -> str:
    return "Instant-NGP (hash grid, marcher and compositing kernels)"


def frame_weights(model, cfg, device) -> NGP:
    """The frame renderer takes the model itself."""
    return model


def make_frame_renderer(cfg, H: int, W: int, K, device, block_rays=None,
                        **plain):
    """``ops/ngp.make_ngp_frame_renderer`` (route "ngp"), called with the
    ``NGP`` model; NeRF's kernel stand-ins (``plain``) have no use
    here."""
    return make_ngp_frame_renderer(cfg, H, W, K, device, block_rays)


def step_kind(cfg, H: int, W: int, K, device, pool: bool) -> StepKind:
    """One uniform a ray (``ngp_batch_draws``) and ``make_ngp_train_body``,
    whose counts accumulate in an ``NGPCounters``; the pool alone."""
    if not pool:
        raise ValueError("Instant-NGP trains on the global ray pool")
    counters = NGPCounters(device)
    return StepKind(make_ngp_train_body(cfg, counters), ngp_batch_draws,
                    (int(cfg.N_rays),), None, ("loss", "psnr"), counters)


def check_run(cfg, world: int) -> None:
    if world > 1:
        raise ValueError("Instant-NGP trains in one process")


class GridHook:
    """The occupancy grid's update between chunks: before every iteration
    that ``models/ngp.grid_update_due`` names (every ``GRID_EVERY`` steps
    from that step on; ``train/step.ngp_grid_update`` after ``i - 1``
    completed updates), and a chunk ends before the next one, so that with
    ``scan_chunk`` 16 and an update every 16 steps every update falls
    between chunks.  No bounds: nothing is gated."""

    def __init__(self, cfg):
        self.cfg = cfg

    def before(self, i: int, model) -> None:
        if grid_update_due(i):
            ngp_grid_update(model, self.cfg, i - 1)
        return None

    def next_boundary(self, i: int) -> int:
        return next_grid_update(i)


def chunk_hook(cfg, K, extrinsics, hw, i_train, device, world: int
               ) -> GridHook:
    return GridHook(cfg)
