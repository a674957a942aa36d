"""Pipelined per-frame eval loop (own copy of the JAX package's
``eval/pipeline.py``).

Frame i+1's device work is enqueued before frame i's outputs are fetched
and encoded, and host IO (PNG writes) runs on a small thread pool, so image
IO overlaps device rendering.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable

import torch

from ..utils.spans import span


def to_host(t: torch.Tensor) -> torch.Tensor:
    """``t`` copied into a fresh pinned host buffer, queued on the current
    stream (``non_blocking``): read it only after an event recorded behind
    the copy has completed."""
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return buf.copy_(t, non_blocking=True)


def pipelined_frames(items: Iterable, render_one: Callable,
                     drain_one: Callable, io_workers: int = 2) -> None:
    """Run ``render_one(i, item)`` one frame ahead of
    ``drain_one(i, outputs, submit)``; queued IO errors surface after the
    loop, and the pool always shuts down (waiting for queued writes).
    Spans ``pipeline.issue`` and ``pipeline.drain``: the k-th drain is the
    k-th frame issued."""
    io_pool = ThreadPoolExecutor(max_workers=io_workers)
    io_futs = []

    def submit(fn, *args):
        io_futs.append(io_pool.submit(fn, *args))

    try:
        pending = None
        for i, item in enumerate(items):
            with span("pipeline.issue"):
                out = render_one(i, item)
            if pending is not None:
                with span("pipeline.drain"):
                    drain_one(*pending, submit)
            pending = (i, out)
        if pending is not None:
            with span("pipeline.drain"):
                drain_one(*pending, submit)
        for f in io_futs:
            f.result()                    # surface any IO error
    finally:
        io_pool.shutdown(wait=True)
