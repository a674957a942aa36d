"""The launch contract and the process group.

A multi-GPU run is launched by ``torchrun`` (``python -m
torch.distributed.run``), which sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` in every process.
``maybe_initialize_distributed`` follows the JAX package's failure policy
(its ``parallel/mesh.maybe_initialize_distributed``):

- none of the variables set: one process, and no group is made;
- some set but not all: RuntimeError naming the missing ones;
- ``init_process_group`` fails: RuntimeError; a launch that was asked for
  never degrades quietly to one process.

The backend is NCCL on the card and gloo on the CPU; each rank's device
is ``cuda:{LOCAL_RANK}``.  Every rank holds the whole model and renders
or trains on its own slice of the rays (``parallel/sharding.py``).
"""
from __future__ import annotations

import os
import socket
from typing import Tuple

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT")


def is_distributed() -> bool:
    """A process group exists (also at world size 1)."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def is_main() -> bool:
    """Rank 0, the one that writes checkpoints, logs and images."""
    return rank() == 0


def print0(*args, **kw) -> None:
    """``print`` on rank 0 only."""
    if is_main():
        print(*args, **kw)


def free_port() -> int:
    """A TCP port of this host that is free now, for ``MASTER_PORT``."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch_env():
    """The contract's variables, or None when none is set."""
    requested = {v: os.environ[v] for v in LAUNCH_ENV if os.environ.get(v)}
    if not requested:
        return None
    missing = [v for v in LAUNCH_ENV if v not in requested]
    if missing:
        raise RuntimeError(
            f"multi-GPU launch half-configured: {sorted(requested)} set but "
            f"{missing} missing; launch with torchrun, or set all of "
            f"{LAUNCH_ENV} in every process")
    return requested


def maybe_initialize_distributed(device_name: str = "cuda"
                                 ) -> Tuple[torch.device, bool]:
    """(this rank's device, whether this call made the process group).

    Without the launch variables: ``resolve_device(device_name)`` and no
    group (a group the caller made already is kept and used).  With them:
    the device is ``cuda:{LOCAL_RANK}`` (or the CPU when asked for), and
    the group is made over NCCL (CUDA) or gloo (CPU) at
    ``MASTER_ADDR:MASTER_PORT``."""
    env = _launch_env()
    if env is None or is_distributed():
        local = int(env["LOCAL_RANK"]) if env else None
        return resolve_device(device_name, local_rank=local), False
    r, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    device = resolve_device(device_name, local_rank=int(env["LOCAL_RANK"]))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    try:
        # env:// reads MASTER_ADDR and MASTER_PORT, and under torchrun joins
        # the store its agent already serves there
        dist.init_process_group(backend, init_method="env://", rank=r,
                                world_size=world)
    except Exception as e:  # any failure of the launch is fatal, never quiet
        raise RuntimeError(
            f"multi-GPU launch requested (rank {r} of {world}, {backend} at "
            f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}) but "
            "init_process_group failed; refusing to run as one process"
        ) from e
    return device, True


def check_data_shards(cfg) -> None:
    """``n_data_shards`` set (> 0) must be the launch's world size."""
    n = int(cfg.n_data_shards)
    if n and n != world_size():
        raise ValueError(
            f"n_data_shards={n} but the launch has {world_size()} "
            f"process(es); launch with torchrun --nproc_per_node {n}, or "
            "leave n_data_shards at 0 (every rank of the launch)")


def destroy() -> None:
    if is_distributed():
        dist.destroy_process_group()
