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
is ``cuda:{LOCAL_RANK}``.

The rank layout (``init_layout``; the JAX package's ``make_mesh``): the
launch's ranks form an ``n_data`` x ``n_model`` grid, rank ``r`` at data
index ``r // n_model`` and model index ``r % n_model`` (JAX's
``reshape(n_data, n_model)``).  The ranks of one model index form a *data
group*: they split the rays (``parallel/sharding.py``).  The ranks of one
data index form a *model group*: they split the MLP's width
(``parallel/tensor.py``) or each ray's samples (``parallel/sp.py``).
Without a process group, or at ``n_model`` 1, no group is made: the data
group is the world and the model group is this rank alone, and a
collective over a group of one rank is no call at all.
"""
from __future__ import annotations

import os
import socket
from typing import NamedTuple, Optional, Tuple

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


class Group(NamedTuple):
    """A set of ranks that run collectives together: the process group
    (None: the default group, the whole world), its members' global ranks
    in order, and this rank's place among them."""
    pg: Optional[object]
    ranks: Tuple[int, ...]
    index: int

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def src(self) -> int:
        """The global rank of the group's first member."""
        return self.ranks[0]


class Layout(NamedTuple):
    n_data: int
    n_model: int
    data: Group          # same model index: the ranks that split the rays
    model: Group         # same data index: the ranks that split the width


_LAYOUT: Optional[Layout] = None


def _alone() -> Group:
    return Group(None, (rank(),), 0)


def world_group() -> Group:
    """Every rank of the launch (this rank alone without a group)."""
    if not is_distributed():
        return _alone()
    return Group(None, tuple(range(world_size())), rank())


def layout() -> Layout:
    """The layout ``init_layout`` made, else the data-parallel one: every
    rank in the data group, the model group this rank alone."""
    if _LAYOUT is not None:
        return _LAYOUT
    return Layout(world_size(), 1, world_group(), _alone())


def data_group() -> Group:
    return layout().data


def model_group() -> Group:
    return layout().model


def check_data_shards(cfg, world: Optional[int] = None) -> Tuple[int, int]:
    """(n_data, n_model) of a launch of ``world`` ranks (default: this
    launch's): ``n_data_shards`` 0 means ``world // n_model_shards``;
    raises ValueError unless ``n_data x n_model == world``."""
    world = world_size() if world is None else world
    n_model = max(1, int(cfg.n_model_shards))
    if world % n_model:
        raise ValueError(
            f"n_model_shards={n_model} does not divide the launch's {world} "
            f"process(es); launch a multiple of {n_model} ranks")
    n_data = int(cfg.n_data_shards) or world // n_model
    if n_data * n_model != world:
        raise ValueError(
            f"n_data_shards={cfg.n_data_shards} x n_model_shards={n_model} "
            f"= {n_data * n_model} but the launch has {world} process(es); "
            f"launch with torchrun --nproc_per_node {n_data * n_model}, or "
            "leave n_data_shards at 0 (world // n_model_shards)")
    return n_data, n_model


def init_layout(cfg) -> Layout:
    """Make the ``n_data`` x ``n_model`` layout of this launch
    (``check_data_shards``) and keep it for ``layout()``.  Every rank makes
    every group, in one order (data groups by model index, then model
    groups by data index), as ``dist.new_group`` requires; groups of one
    rank and a data group of the whole world are not made."""
    global _LAYOUT
    world, r = world_size(), rank()
    n_data, n_model = check_data_shards(cfg, world)
    if not is_distributed() or n_model == 1:
        _LAYOUT = None
        return layout()
    if _LAYOUT is not None and (_LAYOUT.n_data, _LAYOUT.n_model) == (
            n_data, n_model):
        return _LAYOUT          # made already: every rank returns here
    d, m = divmod(r, n_model)

    def groups(members):
        out = []
        for ranks in members:
            ranks = tuple(ranks)
            pg = dist.new_group(list(ranks)) if 1 < len(ranks) < world \
                else None
            out.append(Group(pg, ranks, ranks.index(r) if r in ranks else -1))
        return out
    data = groups(range(k, world, n_model) for k in range(n_model))[m]
    model = groups(range(k * n_model, (k + 1) * n_model)
                   for k in range(n_data))[d]
    _LAYOUT = Layout(n_data, n_model, data, model)
    return _LAYOUT


def destroy() -> None:
    global _LAYOUT
    _LAYOUT = None
    if is_distributed():
        dist.destroy_process_group()
