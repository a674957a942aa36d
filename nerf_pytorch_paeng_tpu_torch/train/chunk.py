"""Chunks of train steps: the port's ``scan_chunk``.

The JAX package fuses ``scan_chunk`` consecutive train steps into one
device program (``lax.scan``, its ``driver.py:252-260, 285-290, 325-355,
388-436``) wherever no exact-iteration hook falls inside the chunk.  The
port keeps its chunk schedule (``ChunkSchedule``) and gives a chunk its
CUDA meaning (``StagedSteps``):

- Every step of a chunk is staged: its draws come first, from the step's
  own generator, in the order and shapes the single step takes them
  (``train/step.batch_draws``, ``image_draws``), and are written with its
  batch (the pool slice, or the image's index) into static buffers; the
  learning rate ``schedule(i - 1)`` is filled into the optimizer's device
  scalar (``train/state.make_optimizer``: capturable Adam on the card) and
  the step count advanced by ``train/step.scheduled_update``, as for a
  single step (``make_train_step``, ``make_image_train_step``).
- The staged body (``train/step.make_train_body``,
  ``make_image_train_body``: render, loss, backward, Adam) reads only
  those buffers and writes its metrics (loss, PSNRs, ``gate_frac``, and
  under ``check_nans`` a finiteness flag) into a static row, copied into
  the chunk's ``[K, M]`` metric slab after the step.
- On the card the body of each step kind (ungated or gated; the route
  and batch mode are the run's, and precrop changes only the staged
  pixels) is captured once as a
  ``torch.cuda.CUDAGraph`` and replayed once a step of every full-length
  chunk, the slot copies queued between replays.  The first full-length
  chunk of a kind runs its first steps eagerly on the capture stream
  (real steps of the trajectory, no extra update) before the capture.  A
  chunk of length 1 runs the same body eagerly.  A failed capture or
  replay raises; nothing falls back to eager steps.
- On the CPU every step runs the same body eagerly: no graphs, the same
  staging, slabs and schedule.

The draws and the body are the architecture's (``StepKind``, from its
``arch/`` module): NeRF's above, or Instant-NGP's one uniform a ray and
``make_ngp_train_body`` on the pool.  Between chunks the driver's loop
runs the architecture's hook (``NoHook`` describes it): NeRF's occupancy
policy (``train/precull.SupportPolicy``) or Instant-NGP's grid update,
and a chunk ends before the hook's next work is due.

The trajectory does not depend on ``scan_chunk``: the draws, the inputs
and the body are the single step's.  The kernel wrappers' launch counters
(``kernels.launch_counts``) stay true: the launches a capture recorded
are taken off again (a capture launches nothing) and added at every
replay.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from .. import kernels
from ..arch import architecture
from ..utils.spans import setup_span, span
from .state import TrainState
from .step import scheduled_update

# the profiler window, in steps after iter_start (JAX driver.py:378-386)
PROFILE_START, PROFILE_STOP = 10, 15
# eager steps of the trajectory on the capture stream before a kind's
# first capture (at most all but one step of its chunk)
WARMUP_STEPS = 2


def chunk_off_reason(cfg, backend: Optional[str], world: int = 1
                     ) -> Optional[str]:
    """Why every chunk has length 1 whatever ``scan_chunk`` says, or None:
    a width-sharded model (``n_model_shards > 1``) and a gloo process group
    run collectives that a CUDA graph cannot hold (gloo stages them
    through the host); an NCCL group of more than one rank (``world``)
    captures only where a run on as many cards has shown the captured
    steps bit-equal to eager ones, which none has yet (a world-1 NCCL
    group captures: ``chip_smoke.py``).  Decided from the configuration
    and the group before any capture."""
    if int(cfg.n_model_shards) > 1:
        return (f"n_model_shards {cfg.n_model_shards}: the width-sharded "
                "step is not captured")
    if backend == "gloo":
        return "a gloo process group stages its collectives through the host"
    if backend == "nccl" and world > 1:
        return (f"an NCCL group of {world} ranks: its captured all-reduces "
                "are untried on more than one card")
    return None


@dataclass(frozen=True)
class ChunkSchedule:
    """The JAX package's ``_chunk_len`` (``driver.py:332-355``) as a pure
    function of the loop's state.  ``k`` is the full chunk length: 1 when
    ``scan_chunk <= 1``, when the run has fewer than ``2 * scan_chunk``
    steps (JAX ``:325-327``) or when ``chunk_off_reason`` holds."""
    k: int
    iter_start: int
    iter_N: int
    profile: bool
    global_batch: bool
    precrop_iters: int
    n_rays: int
    save_every: int = 0      # 0: the hook is off
    test_every: int = 0
    render_every: int = 0

    @classmethod
    def from_cfg(cls, cfg, test_on: bool, render_on: bool,
                 off_reason: Optional[str] = None) -> "ChunkSchedule":
        k = max(int(cfg.scan_chunk), 1)
        if off_reason is not None or cfg.iter_N - cfg.iter_start < 2 * k:
            k = 1
        return cls(k=k, iter_start=cfg.iter_start, iter_N=cfg.iter_N,
                   profile=bool(cfg.profile),
                   global_batch=bool(cfg.global_batch),
                   precrop_iters=int(cfg.precrop_iters),
                   n_rays=int(cfg.N_rays), save_every=int(cfg.idx_save),
                   test_every=int(cfg.idx_test) if test_on else 0,
                   render_every=int(cfg.idx_render) if render_on else 0)

    def length(self, i: int, pool_cursor: int = 0, pool_size: int = 0,
               next_refresh: Optional[int] = None) -> int:
        """``k`` if iterations ``i .. i + k - 1`` can run as one chunk, else
        1.  As in the JAX package: the chunk stays inside the run; the
        profiler window runs single steps (``i <= iter_start + 15``); the
        precrop flag is constant over a per-image chunk; a global-batch
        chunk ends before the pool would reshuffle (``pool_cursor``, the
        pool's ``i_batch``); save, test and render may fall only on the
        chunk's last iteration.  One rule of the port's own: a chunk ends
        before iteration ``next_refresh``, the loop hook's
        ``next_boundary`` (``NoHook``): NeRF's pre-cull refresh or
        Instant-NGP's grid update (the JAX package moves a refresh to the
        next chunk's start; here its cadence is the same at every
        ``scan_chunk``)."""
        k = self.k
        if k == 1 or i + k - 1 > self.iter_N:
            return 1
        if self.profile and i <= self.iter_start + PROFILE_STOP:
            return 1
        if not self.global_batch and (
                (i < self.precrop_iters) != (i + k - 1 < self.precrop_iters)):
            return 1
        if self.global_batch and pool_cursor + k * self.n_rays > pool_size:
            return 1
        for e in range(i, i + k - 1):
            if any(every and e % every == 0 for every in (
                    self.save_every, self.test_every, self.render_every)):
                return 1
        if next_refresh is not None and i < next_refresh <= i + k - 1:
            return 1
        return k


class NoHook:
    """The loop's work between chunks where there is none.  A hook (an
    architecture's ``chunk_hook``, ``arch/``) has two methods:
    ``before(i, model)`` does the work due before iteration ``i`` and
    returns the bounds that the chunk from ``i`` on gates with, or None;
    ``next_boundary(i)`` is the iteration before which a chunk must end,
    or None (``ChunkSchedule.length``'s ``next_refresh``)."""

    def before(self, i: int, model) -> None:
        return None

    def next_boundary(self, i: int) -> None:
        return None


@dataclass(frozen=True)
class StepKind:
    """What ``StagedSteps`` takes from an architecture (its
    ``step_kind``, ``arch/``): the staged ``body`` with its draws injected
    (``train/step.make_train_body`` and its kin); ``draws``, which the
    body's static buffers are staged from (on the pool ``(cfg, step, n,
    device) -> (u_c, u_f)``, as ``train/step.batch_draws``; per image
    ``(cfg, step, H, W, precrop, device) -> (coords, u_c, u_f)``, as
    ``image_draws``); the shapes of those buffers (``u_f`` None: the step
    has no fine uniforms); the body's metric ``keys``; the ``counters``
    the body adds to, or None."""
    body: Callable
    draws: Callable
    u_c: tuple
    u_f: Optional[tuple]
    keys: tuple
    counters: object = None


class _Graph:
    """One captured step: the graph and the launch counts its capture
    recorded (added at every replay)."""

    def __init__(self, graph: "torch.cuda.CUDAGraph", launches: tuple):
        self.graph = graph
        self.launches = launches

    def replay(self) -> None:
        self.graph.replay()
        kernels.add_launch_counts(self.launches)


class StagedSteps:
    """The train steps of one run, staged (see the module docstring).

    Global batch: ``pool`` (``train/batching.RayPool``); a step's input is
    its batch's offset in the pool (``pool.next_start``).  Per image:
    ``images`` [T, H, W, 3] and ``poses`` [T, 3, 4] on the device; a
    step's input is its image's index there.  The body, its draws, the
    shapes of their buffers, the metric keys and the ``counters`` (None,
    or Instant-NGP's ``train/step.NGPCounters``) are the architecture's
    ``StepKind`` for the batch mode, resolved once here.  ``graphs``:
    capture and replay full-length chunks (the card only).  ``keys`` name
    the metric slab's columns; under ``check_nans`` the last column,
    ``finite``, is 1 where the step's loss, gradients and updated weights
    are all finite."""

    def __init__(self, cfg, state: TrainState,
                 schedule: Callable[[int], float], device: torch.device,
                 H: int, W: int, K, pool=None, images=None, poses=None,
                 graphs: bool = False):
        with setup_span("setup.state"):
            self.cfg, self.state, self.schedule = cfg, state, schedule
            self.device = torch.device(device)
            self.H, self.W = H, W
            self.pool, self.images, self.poses = pool, images, poses
            n = int(cfg.N_rays)
            dev = self.device
            kind = architecture(cfg).step_kind(cfg, H, W, K, dev,
                                               pool is not None)
            self.body, self.draws = kind.body, kind.draws
            self.counters = kind.counters
            if pool is not None:
                self.rays = [torch.empty((n, 3), device=dev)
                             for _ in range(3)]
            else:
                self.coords = torch.empty((n, 2), dtype=torch.long,
                                          device=dev)
                self.index = torch.zeros(1, dtype=torch.long, device=dev)
            self.u_c = torch.empty(kind.u_c, device=dev)
            self.u_f = (torch.empty(kind.u_f, device=dev)
                        if kind.u_f is not None else None)
            self.keys = (*kind.keys, "gate_frac",
                         *(("finite",) if cfg.check_nans else ()))
            self.out = torch.zeros(len(self.keys), device=dev)
            self.nan = torch.full((), math.nan, device=dev)
            self.support = None      # static copies of the live bounds
            self.support_of = None   # the bounds they were copied from
            self.use_graphs = bool(graphs) and dev.type == "cuda"
            self.stream = torch.cuda.Stream(dev) if self.use_graphs else None
            self.graphs = {}
            self.captures = self.replays = 0

    def set_support(self, support) -> None:
        """The bounds that gated steps read from now on, copied into the
        static buffers (made at the first refresh that engages); None, or
        the bounds last copied, leave them as they are (ungated steps read
        none)."""
        if support is None or support is self.support_of:
            return
        self.support_of = support
        if self.support is None:
            self.support = tuple(tuple(t.clone() for t in b) for b in support)
        else:
            for dst, src in zip(self.support, support):
                for d, s in zip(dst, src):
                    d.copy_(s)

    def _stage(self, item: int, precrop: bool) -> None:
        """Step ``state.step + 1``'s draws and input into the static
        buffers (its learning rate is ``train/step.scheduled_update``'s)."""
        cfg, step, dev = self.cfg, self.state.step, self.device
        if self.pool is not None:
            u_c, u_f = self.draws(cfg, step, int(cfg.N_rays), dev)
            batch = self.pool.pool[item:item + int(cfg.N_rays)]
            for k, slot in enumerate(self.rays):
                slot.copy_(batch[:, k])
        else:
            coords, u_c, u_f = self.draws(cfg, step, self.H, self.W,
                                          precrop, dev)
            self.coords.copy_(coords)
            self.index.fill_(item)
        self.u_c.copy_(u_c)
        if self.u_f is not None:
            self.u_f.copy_(u_f)

    def _finite(self, loss: torch.Tensor) -> torch.Tensor:
        """1 where the loss, every gradient and every updated weight are
        finite, else 0 (a 0-dim device tensor; no host read)."""
        params = list(self.state.model.parameters())
        flat = torch.cat([t.reshape(-1) for t in params + [
            p.grad for p in params if p.grad is not None]])
        return torch.isfinite(flat.mul(0.0).sum() + loss * 0.0).float()

    def _body(self, gated: bool) -> Callable[[], None]:
        """The staged step of one kind: reads the static buffers, updates
        the state, writes the metric row ``out``."""
        st = self.state

        def run() -> None:
            support = self.support if gated else None
            if self.pool is not None:
                m = self.body(st, *self.rays, self.u_c, self.u_f, support)
            else:
                image = self.images.index_select(0, self.index)[0]
                pose = self.poses.index_select(0, self.index)[0]
                m = self.body(st, image, pose, self.coords, self.u_c,
                              self.u_f, support)
            vals = [m[k] if k in m else self.nan for k in self.keys
                    if k != "finite"]
            if self.cfg.check_nans:
                vals.append(self._finite(m["loss"]))
            self.out.copy_(torch.stack([v.float() for v in vals]))
        return run

    def _capture(self, gated: bool) -> _Graph:
        graph = torch.cuda.CUDAGraph()
        body = self._body(gated)
        before = kernels.launch_counts()
        # the gradients are made inside the capture, in the graph's pool
        self.state.optimizer.zero_grad(set_to_none=True)
        with torch.cuda.graph(graph, stream=self.stream):
            body()
        recorded = tuple(b - a for a, b in zip(before,
                                               kernels.launch_counts()))
        kernels.add_launch_counts(recorded, -1)    # a capture launches none
        self.captures += 1
        return _Graph(graph, recorded)

    def run(self, items: Sequence[int], precrop: bool = False,
            gated: bool = False, replay: bool = False) -> torch.Tensor:
        """The steps of one chunk, one per item (pool offset or image
        index), from ``state.step`` on; returns the chunk's metric slab
        [len(items), len(keys)] on the device and advances ``state.step``.
        With ``replay`` (a full-length chunk, ``graphs`` on) the steps
        replay the kind's graph, captured here first if need be."""
        if gated and self.support is None:
            raise ValueError("a gated step needs set_support first")
        with span("chunk"):
            slab = torch.empty((len(items), len(self.keys)),
                               device=self.device)
            body = self._body(gated)
            done = 0
            if replay and self.use_graphs:
                graph = self.graphs.get(gated)
                if graph is None:
                    # real steps of the trajectory before the capture, on
                    # the capture stream (lazy state: Adam's moments,
                    # handles)
                    with setup_span("chunk.capture"):
                        done = min(WARMUP_STEPS, len(items) - 1)
                        cur = torch.cuda.current_stream(self.device)
                        self.stream.wait_stream(cur)
                        with torch.cuda.stream(self.stream):
                            for j in range(done):
                                self._step(body, items[j], precrop, slab[j])
                        cur.wait_stream(self.stream)
                        graph = self.graphs[gated] = self._capture(gated)
                for j in range(done, len(items)):
                    self._step(graph.replay, items[j], precrop, slab[j])
                    self.replays += 1
            else:
                for j, item in enumerate(items):
                    self._step(body, item, precrop, slab[j])
        return slab

    def _step(self, run: Callable[[], None], item: int, precrop: bool,
              row: torch.Tensor) -> None:
        """One step: its draws and input staged, then ``run`` (the body or
        a replay) through ``train/step.scheduled_update``, which sets its
        learning rate and advances ``state.step`` as for a single step;
        its metric row into ``row``."""
        def staged() -> None:
            with span("step.stage"):
                self._stage(item, precrop)
            with span("step.launch"):
                run()
        scheduled_update(self.state, self.schedule, staged)
        row.copy_(self.out)

    def row_metrics(self, row: np.ndarray) -> Dict[str, float]:
        """One host row of a slab as the logged metrics: ``gate_frac``
        only where the step ran gated, no ``finite`` flag."""
        return {k: float(v) for k, v in zip(self.keys, row)
                if k != "finite" and not (k == "gate_frac" and math.isnan(v))}

    def first_bad_step(self, slab: np.ndarray, first: int) -> Optional[int]:
        """The first iteration (``first`` + row) of a host slab whose
        ``finite`` flag is 0 (``check_nans``), or None."""
        bad = np.flatnonzero(slab[:, self.keys.index("finite")] < 0.5)
        return first + int(bad[0]) if len(bad) else None

    def close(self) -> None:
        """Drop the graphs and the gradients they made (after the run)."""
        if self.use_graphs:
            torch.cuda.current_stream(self.device).synchronize()
        self.graphs.clear()
        self.state.optimizer.zero_grad(set_to_none=True)
