"""Training state: the model, its Adam optimizer and the count of
completed updates (counterpart of the JAX package's ``train/state.py``)."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models.nerf import NeRF, init_nerf


@dataclass
class TrainState:
    model: NeRF
    optimizer: torch.optim.Adam
    step: int = 0              # completed updates


def make_optimizer(model: NeRF, cfg) -> torch.optim.Adam:
    """Adam(beta=(0.9, 0.999), eps=1e-8), as optax.adam in the JAX package
    and torch's Adam in the reference.  The train step sets ``lr`` to the
    schedule's value before every update."""
    return torch.optim.Adam(model.parameters(), lr=cfg.lr,
                            betas=(0.9, 0.999), eps=1e-8)


def create_train_state(cfg, device=None) -> TrainState:
    """Fresh weights drawn from ``cfg.seed`` and a fresh optimizer."""
    model = init_nerf(cfg, device=device)
    return TrainState(model, make_optimizer(model, cfg), 0)
