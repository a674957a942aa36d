"""Data-parallel pieces of the train step and the frame renderers
(counterpart of the data-axis parts of the JAX package's
``parallel/sharding.py`` and ``train/step.py``).

Every helper is the identity without a process group.  The step's
reductions and the frames' gathers run their collectives at world size 1
too (they then copy), so a launch of one process runs them and is
bit-equal to a plain run.
"""
from __future__ import annotations

from typing import Callable, Iterable, Sequence, Tuple, TypeVar

import torch
import torch.distributed as dist

from .mesh import is_distributed, is_main, rank, world_size

T = TypeVar("T")


def rank_bounds(n: int, r: int, world: int) -> Tuple[int, int]:
    """[lo, hi) of rank ``r``'s contiguous part of ``n`` rows: the first
    ``n % world`` ranks take one row more (3 ranks at 4096: 1366, 1365,
    1365)."""
    base, extra = divmod(n, world)
    lo = r * base + min(r, extra)
    return lo, lo + base + (1 if r < extra else 0)


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the ranks in place; returns it."""
    if is_distributed():
        dist.all_reduce(t)
    return t


def all_reduce_grads(params: Iterable[torch.Tensor], weight: float) -> None:
    """Replace every gradient by the sum over the ranks of ``weight`` times
    the rank's gradient, through one flat buffer.  With ``weight`` =
    the rank's share of the global batch (``n_r / N``) the result is the
    gradient of the loss over the whole batch, however it was split."""
    if not is_distributed():
        return
    params = [p for p in params if p.requires_grad]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads]).mul_(weight)
    dist.all_reduce(flat)
    # one multi-tensor copy back: the step is short of host time
    torch._foreach_copy_(grads, [part.view_as(g) for part, g in zip(
        flat.split([g.numel() for g in grads]), grads)])


def broadcast0(t: torch.Tensor) -> torch.Tensor:
    """Rank 0's ``t`` on every rank, in place; returns it."""
    if is_distributed():
        dist.broadcast(t.view(torch.uint8) if t.dtype == torch.bool else t, 0)
    return t


def gather_rows(parts: Sequence[torch.Tensor], n: int
                ) -> Tuple[torch.Tensor, ...]:
    """Each rank's rows ``rank_bounds(n, rank, world)`` of every tensor in
    ``parts`` -> the whole tensors ([n, ...]) on every rank.  The parts
    are padded to ``ceil(n / world)`` rows for the gather, so ``n`` need
    not divide."""
    if not is_distributed():
        return tuple(parts)
    world = world_size()
    per = -(-n // world)
    out = []
    for t in parts:
        pad = t.new_zeros((per, *t.shape[1:]))
        pad[:t.shape[0]] = t
        got = [torch.empty_like(pad) for _ in range(world)]
        dist.all_gather(got, pad.contiguous())
        out.append(torch.cat([g[:hi - lo] for g, (lo, hi) in zip(
            got, (rank_bounds(n, r, world) for r in range(world)))], 0))
    return tuple(out)


def check_replicas(tensors: Iterable[torch.Tensor], what: str) -> None:
    """Raise on every rank unless every rank holds rank 0's ``tensors``
    bit for bit (the weights a data-parallel run must keep alike)."""
    if not is_distributed() or world_size() == 1:
        return
    flat = torch.cat([t.detach().float().reshape(-1).view(torch.int32)
                      for t in tensors])
    same = torch.equal(flat, broadcast0(flat.clone()))
    differ = all_reduce_sum(torch.tensor([0.0 if same else 1.0],
                                         device=flat.device))
    if float(differ) > 0:
        raise RuntimeError(
            f"{what}: {int(differ)} rank(s) hold other bits than rank 0 "
            f"(rank {rank()} {'agrees' if same else 'differs'})")


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
