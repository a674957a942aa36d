"""Training state: the model, its Adam optimizer and the count of
completed updates (counterpart of the JAX package's ``train/state.py``)."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models.nerf import NeRF, init_nerf
from ..utils.spans import setup_span


@dataclass
class TrainState:
    model: NeRF
    optimizer: torch.optim.Adam
    step: int = 0              # completed updates


def make_optimizer(model: NeRF, cfg) -> torch.optim.Adam:
    """Adam(beta=(0.9, 0.999), eps=1e-8), as optax.adam in the JAX package
    and torch's Adam in the reference.  The train step sets ``lr`` to the
    schedule's value before every update (``set_lr``).

    On a CUDA device the optimizer is capturable: its step count lives on
    the card and ``lr`` is a device scalar, so that one configuration runs
    the eager steps and the CUDA graphs of ``train/chunk.py`` alike, bit
    for bit.  On the CPU (no graphs) ``lr`` is a float, as in the JAX
    package's parity runs."""
    device = next(model.parameters()).device
    if cfg.arch == "ngp":
        return _make_ngp_optimizer(model, cfg, device)
    if device.type == "cuda":
        return torch.optim.Adam(
            model.parameters(), lr=torch.tensor(float(cfg.lr), device=device),
            betas=(0.9, 0.999), eps=1e-8, capturable=True)
    return torch.optim.Adam(model.parameters(), lr=cfg.lr,
                            betas=(0.9, 0.999), eps=1e-8)


def _make_ngp_optimizer(model, cfg, device) -> torch.optim.Adam:
    """Instant-NGP's Adam: betas (0.9, 0.99), eps 1e-15, L2 1e-6 on the
    MLP weights (added to their gradients), none on the hash tables
    (``models/ngp.py``); capturable on a CUDA device, as NeRF's, and there
    fused (one kernel a parameter group: over 12.2M parameters the foreach
    form took 0.36 ms more of a 2.5 ms step on an H100)."""
    from ..models.ngp import ADAM_BETAS, ADAM_EPS, MLP_L2
    groups = [dict(params=list(model.tables), weight_decay=0.0),
              dict(params=model.mlp_parameters(), weight_decay=MLP_L2)]
    kw = dict(betas=ADAM_BETAS, eps=ADAM_EPS)
    if device.type == "cuda":
        return torch.optim.Adam(
            groups, lr=torch.tensor(float(cfg.lr), device=device),
            capturable=True, fused=True, **kw)
    return torch.optim.Adam(groups, lr=cfg.lr, **kw)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """The next update's learning rate: filled into a device scalar ``lr``
    (queued on the stream, no host sync), or set where it is a float."""
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def create_train_state(cfg, device=None) -> TrainState:
    """Fresh weights drawn from ``cfg.seed`` (NeRF's, or Instant-NGP's
    where ``cfg.arch`` says so) and a fresh optimizer; under a
    model group of more than one rank (``n_model_shards > 1``) the rank's
    parts of those weights (``parallel/tensor.shard_nerf``), so that
    Adam's moments are split too.  Set-up span ``setup.state``."""
    from ..parallel.tensor import shard_nerf
    with setup_span("setup.state"):
        if cfg.arch == "ngp":
            from ..models.ngp import init_ngp
            model = init_ngp(cfg, device=device)
            return TrainState(model, make_optimizer(model, cfg), 0)
        model = shard_nerf(init_nerf(cfg, device=device))
        return TrainState(model, make_optimizer(model, cfg), 0)
