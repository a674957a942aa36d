"""Training state: the model, its Adam optimizer and the count of
completed updates (counterpart of the JAX package's ``train/state.py``)."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..arch import architecture
from ..utils.spans import setup_span


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Adam
    step: int = 0              # completed updates


def make_optimizer(model: torch.nn.Module, cfg) -> torch.optim.Adam:
    """The architecture's Adam (``arch/``: NeRF's as optax.adam in the
    JAX package and torch's Adam in the reference, Instant-NGP's with its
    published settings).  The train step sets ``lr`` to the schedule's
    value before every update (``set_lr``).

    On a CUDA device the optimizer is capturable: its step count lives on
    the card and ``lr`` is a device scalar, so that one configuration runs
    the eager steps and the CUDA graphs of ``train/chunk.py`` alike, bit
    for bit.  On the CPU (no graphs) ``lr`` is a float, as in the JAX
    package's parity runs."""
    return architecture(cfg).make_optimizer(model, cfg)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """The next update's learning rate: filled into a device scalar ``lr``
    (queued on the stream, no host sync), or set where it is a float."""
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def create_train_state(cfg, device=None) -> TrainState:
    """Fresh weights drawn from ``cfg.seed`` (the architecture's
    ``fresh_model``, ``arch/``: under a NeRF model group of more than one
    rank, ``n_model_shards > 1``, the rank's parts of them, so that Adam's
    moments are split too) and a fresh optimizer.  Set-up span
    ``setup.state``."""
    arch = architecture(cfg)
    with setup_span("setup.state"):
        model = arch.fresh_model(cfg, device)
        return TrainState(model, arch.make_optimizer(model, cfg), 0)
