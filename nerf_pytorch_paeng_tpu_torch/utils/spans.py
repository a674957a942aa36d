"""The program's spans, on ``torch.profiler``'s clock.

Two kinds, both named ``nerf/<name>`` in a profiler's trace:

- ``span(name)``: a hot span (a train chunk, a step's staging, a frame's
  phase).  While a torch profiler session runs it is a
  ``torch.profiler.record_function``, so the span lands in that trace
  beside the device ops it launched; otherwise it is a shared no-op
  context behind one check of the profiler's flag (0.15 us on an H100
  machine's host, where an annotation costs 13 us).  Nothing is kept here:
  whoever started the profiler exports or reads the spans.
- ``setup_span(name)``: work done a bounded number of times in a run
  (the kernel library's load, ``pack_nerf``, the support grid, the ray
  pool, the first chunk's capture).  It always adds its host seconds and
  count to ``setup_table()``, under its name and its nesting depth among
  set-up spans, and annotates as a hot span while a profiler runs.
  ``setup_seconds()`` sums the outermost entries, so that set-up nested
  in set-up (a library loaded during a capture) counts once.

"Tracing on" means a torch profiler is running: the ``profile`` knob's
window (``driver._Profiler``), or any caller's ``torch.profiler.profile``.
There is no other switch.

Span names (see PERF.md, Layers): ``chunk``, ``step.stage``,
``step.launch``, ``policy.refresh``, ``pool.reshuffle``, ``frame``,
``frame.phase0``, ``frame.read_hits``, ``frame.phase1``, ``frame.read``,
``frame.phase2``, ``pipeline.issue``, ``pipeline.drain``; Instant-NGP's
``ngp.march``, ``ngp.encode``, ``ngp.mlp``, ``ngp.composite`` (inside a
step; a CUDA graph's replay shows none of them, its kernels are named)
and ``ngp.grid_update`` (between chunks); set-up:
``setup.kernels``, ``setup.pack``, ``setup.support_grid``, ``setup.pool``,
``setup.state``, ``chunk.capture``, ``data.load``, ``checkpoint.save``.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Tuple

import torch

PREFIX = "nerf/"
_profiling = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()
_table: Dict[Tuple[str, int], List[float]] = {}   # (name, depth) -> [n, s]
_local = threading.local()


def span(name: str):
    """``with span(name):`` a ``nerf/<name>`` annotation while a profiler
    runs, else nothing."""
    if not _profiling():
        return _OFF
    return torch.profiler.record_function(PREFIX + name)


class setup_span:
    """``with setup_span(name):`` the block's host seconds and count into
    ``setup_table()``; annotated as ``span`` while a profiler runs."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "setup_span":
        self.depth = getattr(_local, "depth", 0)
        _local.depth = self.depth + 1
        self.mark = span(self.name)
        self.mark.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        dt = time.perf_counter() - self.t0
        self.mark.__exit__(*exc)
        _local.depth = self.depth
        row = _table.setdefault((self.name, self.depth), [0, 0.0])
        row[0] += 1
        row[1] += dt


def setup_table() -> List[dict]:
    """The set-up spans of this process so far: ``{"name", "depth", "n",
    "s"}`` each, depth 0 the outermost, in the order they first ended."""
    return [{"name": name, "depth": depth, "n": int(n), "s": s}
            for (name, depth), (n, s) in _table.items()]


def setup_seconds() -> float:
    """Host seconds in outermost set-up spans: nested ones count once."""
    return sum(s for (_, depth), (_, s) in _table.items() if depth == 0)


def reset_setup_table() -> None:
    _table.clear()
