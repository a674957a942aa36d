"""Checkpoints in the reference's format.

``logs/<exp>/<exp>_<step>.pth.tar`` written with ``torch.save``, holding
``idx`` (completed updates), ``model_state_dict`` (the reference layer
names, ``NeRF.state_dict()``) and ``optimizer_state_dict``.  The
``--eval_only`` entry and the reference read the same files.  The step is
in the file, so the schedule resumes where it stopped.  Under a process
group only rank 0 writes (every rank holds the same state); every rank
restores.  A width-sharded model (``parallel/tensor.py``) is gathered
over its model group first, weights and Adam's moments, so the file is
the ordinary full-width one (a one-process run and the JAX package's
converters read it), and a restore cuts the rank's parts from it again
(the JAX package's ``restore_params_only`` re-applies its shardings).
"""
from __future__ import annotations

import os
import re
from typing import Dict, Optional, Tuple

import torch

from .. import parallel
from ..parallel.tensor import ShardedNeRF, shard_state_dict, shard_tensor
from ..utils.spans import setup_span
from .state import TrainState

_MOMENTS = ("exp_avg", "exp_avg_sq")
# the optimizer's own configuration, kept over a checkpoint's (_load_optimizer)
_RUN_KEYS = ("capturable", "foreach", "fused", "differentiable")


def _split_dims(model) -> list:
    """Each parameter's split dim, in the optimizer's order."""
    return [model.full_dims[name] for name, _ in model.named_parameters()]


def full_states(state: TrainState) -> Tuple[Dict, Dict]:
    """(model state dict, optimizer state dict) at full width: a sharded
    model's gathered over its model group (a collective: every rank of
    the group calls it)."""
    model, osd = state.model, state.optimizer.state_dict()
    for group in osd["param_groups"]:      # a device scalar on the card
        group["lr"] = float(group["lr"])
    if not isinstance(model, ShardedNeRF):
        return model.state_dict(), osd
    group = model.group
    for i, dim in enumerate(_split_dims(model)):
        entry = osd["state"].get(i)
        if entry is None or dim is None:
            continue
        osd["state"][i] = {k: (parallel.all_gather_cat(v, dim, group)
                               if k in _MOMENTS else v)
                           for k, v in entry.items()}
    return model.full_state_dict(), osd


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
    """Write ``state`` (rank 0 only; every rank of a width-sharded model
    calls it, for the gather); returns the checkpoint's path.  Set-up
    span ``checkpoint.save``."""
    path = checkpoint_path(logdir, exp_name, state.step)
    with setup_span("checkpoint.save"):
        model_sd, optim_sd = full_states(state)
        if not parallel.is_main():
            return path
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        torch.save({"idx": state.step, "model_state_dict": model_sd,
                    "optimizer_state_dict": optim_sd}, tmp)
        os.replace(tmp, path)    # a reader sees the old file or the new one
    return path


def restore_checkpoint(logdir: str, exp_name: str, step: int,
                       state: TrainState) -> TrainState:
    """Load weights, optimizer moments and the step count into ``state``
    (on its model's device)."""
    model = state.model
    device = next(model.parameters()).device
    ckpt = torch.load(checkpoint_path(logdir, exp_name, step),
                      map_location=device, weights_only=True)
    model_sd, optim_sd = ckpt["model_state_dict"], ckpt["optimizer_state_dict"]
    if isinstance(model, ShardedNeRF):
        n, m = model.group.size, model.group.index
        model_sd = shard_state_dict(model_sd, model.full_dims, n, m)
        for i, dim in enumerate(_split_dims(model)):
            entry = optim_sd["state"].get(i)
            if entry is not None and dim is not None:
                optim_sd["state"][i] = {
                    k: shard_tensor(v, dim, n, m) if k in _MOMENTS else v
                    for k, v in entry.items()}
    model.load_state_dict(model_sd)
    _load_optimizer(state.optimizer, optim_sd)
    state.step = int(ckpt["idx"])
    return state


def _load_optimizer(optimizer: torch.optim.Optimizer, osd: Dict) -> None:
    """Adam's moments, step counts and ``lr`` from ``osd`` into
    ``optimizer``, which keeps its own way of running (``_RUN_KEYS``;
    ``train/state.make_optimizer``: capturable with a device-scalar ``lr``
    on the card).  ``load_state_dict`` alone would take the writer's: the
    reference, the JAX package's exporter and a port run on the CPU write
    ``capturable`` False, and a capturable optimizer's device ``lr`` then
    fails its first update (and no CUDA graph can hold one that is not
    capturable).  Under ``capturable`` each step count moves to its
    parameter's device as float32, where a capturable Adam keeps it."""
    own = [{k: g[k] for k in ("lr", *_RUN_KEYS) if k in g}
           for g in optimizer.param_groups]
    optimizer.load_state_dict(osd)
    for group, keep in zip(optimizer.param_groups, own):
        lr = keep.pop("lr")
        if isinstance(lr, torch.Tensor):      # the capturable device scalar
            lr.fill_(float(group["lr"]))
            group["lr"] = lr
        group.update(keep)
        if not group.get("capturable"):
            continue
        for p in group["params"]:
            entry = optimizer.state.get(p, {})
            if "step" in entry:
                entry["step"] = torch.as_tensor(
                    entry["step"]).to(device=p.device, dtype=torch.float32)
