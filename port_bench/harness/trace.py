"""A profiled sub-window: ``torch.profiler`` over a few steps or frames,
reduced in memory to what the per-layer metrics and the ``breakdown``
read.

The device's busy time is the union of the intervals in which a kernel,
copy or fill ran (two overlapping kernels count once), the window the
host clock's span from the profiler's start to the synchronised stop.
Each idle gap between busy intervals is named by the innermost host
activity (operator, runtime call or annotation) under its middle.  The
trace is written under ``TMPDIR`` only long enough to be parsed.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
import warnings
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
NAMED_GAPS = 64      # the longest gaps are named; the rest only counted


class Trace:
    """``with Trace(device) as tr:`` profiles the block; afterwards
    ``tr.window_s``, ``tr.busy_s``, ``tr.ops`` (device ops: name, start
    and duration in seconds) and ``tr.breakdown()``."""

    def __init__(self, device: torch.device):
        self.device = device
        self.ops: List[Tuple[str, float, float]] = []
        self.gaps: List[Tuple[str, float]] = []
        self.window_s = self.busy_s = 0.0

    def __enter__(self) -> "Trace":
        from torch.profiler import ProfilerActivity, profile
        warnings.filterwarnings("ignore", message="Warning: Profiler clears")
        torch.cuda.synchronize(self.device)
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        torch.cuda.synchronize(self.device)
        self.window_s = time.perf_counter() - self.t0
        self.prof.stop()
        if exc[0] is None:
            self._read()

    def _read(self) -> None:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        dev, host = [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = e.get("cat", "")
            item = (e["name"], float(e["ts"]) * 1e-6, float(e["dur"]) * 1e-6)
            if cat in DEVICE_CATS:
                dev.append(item)
            elif cat in HOST_CATS:
                host.append(item)
        self.ops = sorted(dev, key=lambda t: t[1])
        busy, gaps, end = 0.0, [], None
        for name, start, dur in self.ops:
            if end is None or start > end:
                if end is not None:
                    gaps.append((end, start))
                busy += dur
                end = start + dur
            elif start + dur > end:
                busy += start + dur - end
                end = start + dur
        self.busy_s = busy
        longest = sorted(gaps, key=lambda g: g[0] - g[1])[:NAMED_GAPS]
        self.gaps = [(_host_under(host, 0.5 * (a + b)), b - a)
                     for a, b in longest]

    def time_of(self, names) -> Tuple[float, int]:
        """Summed device seconds and count of the kernels whose function
        (the name without return type, namespace-free template arguments
        or parameters) is one of ``names``."""
        names = set(names)
        hits = [d for n, _, d in self.ops if kernel_function(n) in names]
        return sum(hits), len(hits)

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        by_name: Dict[str, float] = defaultdict(float)
        for name, _, dur in self.ops:
            by_name[name[:160]] += dur
        by_gap: Dict[str, float] = defaultdict(float)
        for name, dur in self.gaps:
            by_gap[name] = max(by_gap[name], dur)
        return {"device_ops": sorted(([n, t] for n, t in by_name.items()),
                                     key=lambda x: -x[1])[:top],
                "idle_gaps": sorted(([n, t] for n, t in by_gap.items()),
                                    key=lambda x: -x[1])[:top]}


def kernel_function(name: str) -> str:
    """"void (anonymous namespace)::foo<8>(float const*)" -> "foo": the
    return type, the anonymous namespace (where the program's kernels
    live), template arguments and parameters go; a named namespace stays,
    so that the program's ``reduce_kernel`` is not PyTorch's
    ``at::native::reduce_kernel``."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    for stop in "(<":
        name = name.split(stop, 1)[0]
    return name.strip()


def _host_under(host: List[Tuple[str, float, float]], t: float) -> str:
    """The innermost (shortest) host activity spanning time ``t``."""
    best = None
    for name, start, dur in host:
        if start <= t <= start + dur and (best is None or dur < best[1]):
            best = (name, dur)
    return f"host: {best[0][:120]}" if best else "host: python"
