"""Collectives of the train step and the frame renderers (counterpart of
the data-axis parts of the JAX package's ``parallel/sharding.py`` and
``train/step.py``).

Each helper runs over a ``Group`` of the rank layout (``parallel/mesh.py``;
default: the whole world) and is the identity without a process group
and over a group of one rank inside a larger world.  The step's
reductions and the frames' gathers run their collectives at world size 1
too (they then copy), so a launch of one process runs them and is
bit-equal to a plain run.
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional, Sequence, Tuple, TypeVar

import torch
import torch.distributed as dist

from .mesh import Group, is_distributed, is_main, rank, world_group, world_size

T = TypeVar("T")


def rank_bounds(n: int, r: int, world: int) -> Tuple[int, int]:
    """[lo, hi) of rank ``r``'s contiguous part of ``n`` rows: the first
    ``n % world`` ranks take one row more (3 ranks at 4096: 1366, 1365,
    1365)."""
    base, extra = divmod(n, world)
    lo = r * base + min(r, extra)
    return lo, lo + base + (1 if r < extra else 0)


def _runs(group: Optional[Group]) -> Optional[Group]:
    """``group`` (default: the world) where its collectives run, else None:
    no process group, or a group of one rank inside a larger world."""
    group = group or world_group()
    if not is_distributed():
        return None
    if group.size == 1 and world_size() > 1:
        return None
    return group


def all_reduce_sum(t: torch.Tensor, group: Optional[Group] = None
                   ) -> torch.Tensor:
    """Sum ``t`` over the ranks of ``group`` in place; returns it."""
    g = _runs(group)
    if g is not None:
        dist.all_reduce(t, group=g.pg)
    return t


def all_gather_cat(t: torch.Tensor, dim: int, group: Optional[Group] = None
                   ) -> torch.Tensor:
    """The ranks' ``t`` (one shape on every rank) concatenated along
    ``dim`` in the group's order."""
    g = _runs(group)
    if g is None:
        return t
    t = t.contiguous()
    got = [torch.empty_like(t) for _ in range(g.size)]
    dist.all_gather(got, t, group=g.pg)
    return torch.cat(got, dim)


def all_reduce_grads(params: Iterable[torch.Tensor], weight: float,
                     group: Optional[Group] = None) -> None:
    """Replace every gradient by the sum over the ranks of ``group`` of
    ``weight`` times the rank's gradient, through one flat buffer.  With
    ``weight`` = the rank's share of the global batch (``n_r / N``) the
    result is the gradient of the loss over the whole batch, however it
    was split."""
    g = _runs(group)
    if g is None:
        return
    params = [p for p in params if p.requires_grad]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads]).mul_(weight)
    dist.all_reduce(flat, group=g.pg)
    # one multi-tensor copy back: the step is short of host time
    torch._foreach_copy_(grads, [part.view_as(t) for part, t in zip(
        flat.split([t.numel() for t in grads]), grads)])


def broadcast0(t: torch.Tensor, group: Optional[Group] = None
               ) -> torch.Tensor:
    """The group's first rank's ``t`` on every rank of the group (default:
    rank 0's on every rank), in place; returns it."""
    g = _runs(group)
    if g is not None:
        dist.broadcast(t.view(torch.uint8) if t.dtype == torch.bool else t,
                       g.src, group=g.pg)
    return t


def gather_rows(parts: Sequence[torch.Tensor], n: int,
                group: Optional[Group] = None) -> Tuple[torch.Tensor, ...]:
    """Each rank's rows ``rank_bounds(n, index, size)`` of every tensor in
    ``parts`` -> the whole tensors ([n, ...]) on every rank of ``group``
    (default: the world).  The parts are padded to ``ceil(n / size)`` rows
    for the gather, so ``n`` need not divide."""
    g = _runs(group)
    if g is None:
        return tuple(parts)
    per = -(-n // g.size)
    out = []
    for t in parts:
        pad = t.new_zeros((per, *t.shape[1:]))
        pad[:t.shape[0]] = t
        got = [torch.empty_like(pad) for _ in range(g.size)]
        dist.all_gather(got, pad.contiguous(), group=g.pg)
        out.append(torch.cat([part[:hi - lo] for part, (lo, hi) in zip(
            got, (rank_bounds(n, r, g.size) for r in range(g.size)))], 0))
    return tuple(out)


def check_replicas(tensors: Iterable[torch.Tensor], what: str,
                   group: Optional[Group] = None) -> None:
    """Raise on every rank of ``group`` (default: the world) unless each
    holds its first rank's ``tensors`` bit for bit (the weights that data
    parallelism keeps alike, and the replicated weights of the
    width-sharded MLP)."""
    g = _runs(group)
    tensors = list(tensors)
    if g is None or g.size == 1 or not tensors:
        return
    flat = torch.cat([t.detach().float().reshape(-1).view(torch.int32)
                      for t in tensors])
    same = torch.equal(flat, broadcast0(flat.clone(), g))
    differ = all_reduce_sum(torch.tensor([0.0 if same else 1.0],
                                         device=flat.device), g)
    if float(differ) > 0:
        raise RuntimeError(
            f"{what}: {int(differ)} rank(s) hold other bits than rank "
            f"{g.src} (rank {rank()} {'agrees' if same else 'differs'})")


def rank0_first(fn: Callable[[bool], T], device) -> T:
    """``fn(True)`` on rank 0, then ``fn(False)`` on the other ranks once
    it has returned: for work that writes files the ranks then read (the
    data preparation of a loader).  A failure on rank 0 raises on every
    rank, so that none waits for it."""
    if not is_distributed():
        return fn(True)
    done = torch.zeros((), device=device)
    if is_main():
        try:
            out = fn(True)
            done.fill_(1.0)
        finally:
            broadcast0(done)
        return out
    if not bool(broadcast0(done)):
        raise RuntimeError("rank 0 failed the work the other ranks wait "
                           "for; its error says why")
    return fn(False)
