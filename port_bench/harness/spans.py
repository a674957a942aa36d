"""The program's ``nerf/`` spans in a profiled sub-window (``trace.Trace``),
with each device op attributed to the innermost span around the host call
that launched it.

Everything is read from the profiler's own events (``tr.prof.events()``):
its Chrome export has run already (``Trace._read``) and cannot run twice,
and its time origin is not that of ``tr.ops``, so nothing here is joined
with ``tr.ops``.  A device op carries the correlation id of the runtime
call (``cudaLaunchKernel``, ``cudaGraphLaunch``, ``cudaMemcpyAsync`` ...)
that launched it, and that call's chain of host parents leads to the
span: a CUDA graph's kernels belong to the span around its replay.  The
device-side copies of the annotations (Kineto's ``gpu_user_annotation``)
are not device work.  The walk is made once per trace and kept on it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

PREFIX = "nerf/"
RUNTIME = "cu"       # runtime (cuda*) and driver (cu*) calls launch device ops


@dataclass
class Span:
    name: str                    # without the prefix
    start: float                 # host seconds, from the profiler's origin
    end: float
    parent: int                  # index of the enclosing span, or -1
    names: frozenset             # its own name and its enclosing spans'


@dataclass
class DeviceOp:
    name: str
    start: float                 # device seconds, on the same clock
    end: float
    span: int                    # index of the innermost span, or -1


@dataclass
class Spans:
    spans: List[Span] = field(default_factory=list)
    ops: List[DeviceOp] = field(default_factory=list)

    def named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def host_s(self, name: str) -> float:
        """Host seconds inside the spans named ``name``."""
        return sum(s.end - s.start for s in self.named(name))

    def device_s(self, under, skip: Callable[[str], bool] = lambda n: False
                 ) -> float:
        """Device seconds of the ops launched inside a span named in
        ``under`` (at any depth), less those whose name ``skip`` takes."""
        under = frozenset(under)
        return sum(op.end - op.start for op in self.ops
                   if op.span >= 0 and under & self.spans[op.span].names
                   and not skip(op.name))

    def busy(self) -> List[Tuple[float, float]]:
        """The union of the device ops' intervals, in order."""
        out: List[List[float]] = []
        for op in sorted(self.ops, key=lambda o: o.start):
            if out and op.start <= out[-1][1]:
                out[-1][1] = max(out[-1][1], op.end)
            else:
                out.append([op.start, op.end])
        return [(a, b) for a, b in out]

    def idle_inside(self, name: str) -> float:
        """Seconds of the device's idle gaps (between busy intervals) whose
        midpoint falls inside a span named ``name`` on the host."""
        busy = self.busy()
        spans = self.named(name)
        total = 0.0
        for (_, a), (b, _) in zip(busy, busy[1:]):
            mid = 0.5 * (a + b)
            if any(s.start <= mid <= s.end for s in spans):
                total += b - a
        return total

    def first_op_waits(self, name: str) -> List[float]:
        """For each span named ``name`` that launched a device op: seconds
        from its host start to the start of the first op launched inside
        it, in the spans' order."""
        first: Dict[int, float] = {}
        for op in self.ops:
            i = op.span
            while i >= 0:
                if self.spans[i].name == name:
                    first[i] = min(first.get(i, op.start), op.start)
                i = self.spans[i].parent
        return [first[i] - self.spans[i].start for i in sorted(first)]


def spans_of(tr) -> Optional[Spans]:
    """The trace's spans and attributed device ops, or None where it holds
    no ``nerf/`` span (a program without them) or there is no trace."""
    if tr is None or getattr(tr, "prof", None) is None:
        return None
    if not hasattr(tr, "nerf_spans"):
        tr.nerf_spans = walk(tr.prof.events())
    return tr.nerf_spans


def _is_device(e) -> bool:
    return "CPU" not in str(e.device_type)


def walk(events) -> Optional[Spans]:
    """``Spans`` of profiler events (``FunctionEvent``s in start order,
    parents before children), or None without a ``nerf/`` span."""
    out = Spans()
    index: Dict[int, int] = {}           # id(host event) -> span index
    runtime: Dict[int, object] = {}      # correlation id -> runtime call
    for e in events:
        if _is_device(e):
            continue
        if e.name.startswith(PREFIX):
            p = _span_above(e.cpu_parent, index)
            name = e.name[len(PREFIX):]
            index[id(e)] = len(out.spans)
            out.spans.append(Span(
                name, e.time_range.start * 1e-6, e.time_range.end * 1e-6, p,
                frozenset([name]) | (out.spans[p].names if p >= 0
                                     else frozenset())))
        elif e.name.startswith(RUNTIME):
            runtime[e.id] = e
    if not out.spans:
        return None
    for e in events:
        if (not _is_device(e) or getattr(e, "is_user_annotation", False)
                or e.name.startswith(PREFIX)):
            continue
        call = runtime.get(e.id)
        out.ops.append(DeviceOp(
            e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6,
            _span_above(call, index)))
    return out


def _span_above(e, index: Dict[int, int]) -> int:
    """The innermost span among ``e`` and its host parents, or -1."""
    while e is not None:
        if id(e) in index:
            return index[id(e)]
        e = e.cpu_parent
    return -1
