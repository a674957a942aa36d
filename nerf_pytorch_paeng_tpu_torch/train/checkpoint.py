"""Checkpoints in the reference's format.

``logs/<exp>/<exp>_<step>.pth.tar`` written with ``torch.save``, holding
``idx`` (completed updates), ``model_state_dict`` (the reference layer
names, ``NeRF.state_dict()``) and ``optimizer_state_dict``.  The
``--eval_only`` entry and the reference read the same files.  The step is
in the file, so the schedule resumes where it stopped.  Under a process
group only rank 0 writes (every rank holds the same state); every rank
restores.
"""
from __future__ import annotations

import os
import re
from typing import Optional

import torch

from .. import parallel
from .state import TrainState


def checkpoint_path(logdir: str, exp_name: str, step: int) -> str:
    return os.path.join(logdir, exp_name, f"{exp_name}_{step}.pth.tar")


def latest_checkpoint_step(logdir: str, exp_name: str) -> Optional[int]:
    """Highest step with a checkpoint under logs/<exp>/, or None (backs
    ``iter_start = -1``)."""
    d = os.path.join(logdir, exp_name)
    if not os.path.isdir(d):
        return None
    pat = re.compile(re.escape(exp_name) + r"_(\d+)\.pth\.tar$")
    steps = [int(m.group(1)) for f in os.listdir(d) if (m := pat.match(f))]
    return max(steps) if steps else None


def save_checkpoint(logdir: str, exp_name: str, state: TrainState) -> str:
    """Write ``state`` (rank 0 only); returns the checkpoint's path."""
    path = checkpoint_path(logdir, exp_name, state.step)
    if not parallel.is_main():
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save({"idx": state.step,
                "model_state_dict": state.model.state_dict(),
                "optimizer_state_dict": state.optimizer.state_dict()}, tmp)
    os.replace(tmp, path)        # a reader sees the old file or the new one
    return path


def restore_checkpoint(logdir: str, exp_name: str, step: int,
                       state: TrainState) -> TrainState:
    """Load weights, optimizer moments and the step count into ``state``
    (on its model's device)."""
    device = next(state.model.parameters()).device
    ckpt = torch.load(checkpoint_path(logdir, exp_name, step),
                      map_location=device, weights_only=True)
    state.model.load_state_dict(ckpt["model_state_dict"])
    state.optimizer.load_state_dict(ckpt["optimizer_state_dict"])
    state.step = int(ckpt["idx"])
    return state
