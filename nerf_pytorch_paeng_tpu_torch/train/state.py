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
    if device.type == "cuda":
        return torch.optim.Adam(
            model.parameters(), lr=torch.tensor(float(cfg.lr), device=device),
            betas=(0.9, 0.999), eps=1e-8, capturable=True)
    return torch.optim.Adam(model.parameters(), lr=cfg.lr,
                            betas=(0.9, 0.999), eps=1e-8)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """The next update's learning rate: filled into a device scalar ``lr``
    (queued on the stream, no host sync), or set where it is a float."""
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def create_train_state(cfg, device=None) -> TrainState:
    """Fresh weights drawn from ``cfg.seed`` and a fresh optimizer; under a
    model group of more than one rank (``n_model_shards > 1``) the rank's
    parts of those weights (``parallel/tensor.shard_nerf``), so that
    Adam's moments are split too.  Set-up span ``setup.state``."""
    from ..parallel.tensor import shard_nerf
    with setup_span("setup.state"):
        model = shard_nerf(init_nerf(cfg, device=device))
        return TrainState(model, make_optimizer(model, cfg), 0)
