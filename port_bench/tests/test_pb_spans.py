"""The readers of the program's spans (``harness/spans.py`` and the seven
metrics on it) on a CPU profile made with the program's span module, into
which device ops are laid at chosen times: each runtime call under the
span that launches it, the device ops it launched carrying its
correlation id, as CUPTI gives them on the card (a CUDA graph's kernels
all carry their one ``cudaGraphLaunch``'s).  Each reader gives the value
those times make, and nothing on a trace without ``nerf/`` spans.

    python -m pytest port_bench/tests -q
"""
import sys
import time

import pytest
import torch
from torch.autograd import DeviceType
from torch.autograd.profiler_util import FunctionEvent
from torch.profiler import ProfilerActivity, profile

from nerf_pytorch_paeng_tpu_torch.utils import spans as program
from port_bench.harness.common import load_reader
from port_bench.harness.spans import spans_of

SIGMA = "void (anonymous namespace)::sigma_rays_wgmma_kernel<true>(int)"
EVAL = "void (anonymous namespace)::eval_rays_wgmma_kernel<false>(int)"
WAITS = (50.0, 150.0, 400.0)     # us from a frame's start to its first op
STAGE_OPS = (10.0, 6.0)          # us, a step's draws and slot copy


class _Prof:
    def __init__(self, events):
        self._events = sorted(events, key=lambda e: (e.time_range.start,
                                                     -e.time_range.end))

    def events(self):
        return self._events


class _Trace:
    """What the readers take from ``trace.Trace``: its profiler."""

    def __init__(self, events):
        self.prof = _Prof(events)


class _Device:
    """Device ops laid into a profile, each with its runtime call."""

    def __init__(self):
        self.events, self.cid = [], 10 ** 6

    def launch(self, span, ops, call="cudaLaunchKernel"):
        """One runtime call under ``span`` (a host event) launching
        ``ops`` [(name, start_us, end_us)]."""
        self.cid += 1
        t = span.time_range.start + 1.0
        rt = FunctionEvent(self.cid, call, span.thread, t, t + 1.0)
        rt.cpu_parent = span
        self.events.append(rt)
        for name, a, b in ops:
            self.events.append(FunctionEvent(self.cid, name, span.thread, a,
                                             b, device_type=DeviceType.CUDA))

    def annotation(self, name, a, b):
        """Kineto's device-side copy of an annotation: not device work."""
        self.events.append(FunctionEvent(
            1, program.PREFIX + name, 0, a, b, device_type=DeviceType.CUDA,
            is_user_annotation=True))


def _host_spans(prof, name):
    return [e for e in prof.events()
            if e.name == program.PREFIX + name and "CPU" in str(e.device_type)]


@pytest.fixture(scope="module")
def render_rec():
    """Three frames as the culled renderer's spans make them, with device
    ops laid so that frame k's first op starts ``WAITS[k]`` after the
    frame, a sigma kernel (100 us) and a sort (30 us) in phase 1, a host
    read's copy (2 us), a bubble until 40 us after the read's host end,
    an eval kernel (200 us) and a scatter (30 us) in phase 2, and the
    frame's pinned copy after it (outside the frame's span) up to the
    next frame's first op."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in WAITS:
            with program.span("pipeline.issue"):
                with program.span("frame"):
                    with program.span("frame.phase1"):
                        time.sleep(1e-3)
                        with program.span("frame.read"):
                            time.sleep(1e-3)
                    with program.span("frame.phase2"):
                        time.sleep(1e-3)
    events = list(prof.events())
    frames = _host_spans(prof, "frame")
    p1, read, p2 = (_host_spans(prof, n) for n in
                    ("frame.phase1", "frame.read", "frame.phase2"))
    issue = _host_spans(prof, "pipeline.issue")
    dev, idle, ends = _Device(), [], []
    for k, wait in enumerate(WAITS):
        d0 = frames[k].time_range.start + wait
        if k:                             # the last frame's copy runs on
            dev.launch(issue[k - 1], [("Memcpy DtoH (Device -> Pinned)",
                                       ends[-1], d0)], "cudaMemcpyAsync")
        dev.launch(p1[k], [(SIGMA, d0, d0 + 100.0),
                           ("radixSortKVInPlace", d0 + 100.0, d0 + 130.0)])
        dev.launch(read[k], [("Memcpy DtoH (Device -> Pageable)",
                              d0 + 130.0, d0 + 132.0)], "cudaMemcpyAsync")
        t2 = read[k].time_range.end + 40.0
        dev.launch(p2[k], [(EVAL, t2, t2 + 200.0),
                           ("index_scatter", t2 + 200.0, t2 + 230.0)])
        dev.annotation("frame.phase1", d0 + 132.0, t2)
        idle.append(t2 - (d0 + 132.0))
        ends.append(t2 + 230.0)
    dev.launch(issue[-1], [("Memcpy DtoH (Device -> Pinned)", ends[-1],
                            ends[-1] + 5.0)], "cudaMemcpyAsync")
    # an op whose launch the trace missed belongs to no span
    dev.events.append(FunctionEvent(7, "orphan", 0, ends[-1] + 5.0,
                                    ends[-1] + 6.0,
                                    device_type=DeviceType.CUDA))
    rec = dict(kind="render", trace=_Trace(events + dev.events),
               trace_frames=len(WAITS))
    return rec, idle


@pytest.fixture(scope="module")
def train_rec():
    """Two chunks of two steps: each stage launches a draw and a copy
    (``STAGE_OPS``), each launch one graph replay of three kernels."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with program.span("chunk"):
                for _ in range(2):
                    with program.span("step.stage"):
                        time.sleep(2e-4)
                    with program.span("step.launch"):
                        time.sleep(2e-4)
    dev, t = _Device(), 0.0
    stages, launches = (_host_spans(prof, n)
                        for n in ("step.stage", "step.launch"))
    for stage, launch in zip(stages, launches):
        t = max(t, stage.time_range.start)
        for dur in STAGE_OPS:
            dev.launch(stage, [("philox_rand", t, t + dur)])
            t += dur
        dev.launch(launch, [(n, t + 100.0 * j, t + 100.0 * (j + 1))
                            for j, n in enumerate(("k1", "k2", "adam"))],
                   "cudaGraphLaunch")
        t += 300.0
    chunk_s = sum(e.time_range.elapsed_us() for e in _host_spans(prof,
                                                                 "chunk"))
    rec = dict(kind="train", trace=_Trace(list(prof.events()) + dev.events),
               trace_steps=4)
    return rec, chunk_s


def test_glue_and_kernels_account_for_the_frames(render_rec):
    rec, _ = render_rec
    coarse = load_reader("coarse_glue_ms.render")(rec)
    fine = load_reader("fine_glue_ms.render")(rec)
    assert coarse == pytest.approx(0.032) and fine == pytest.approx(0.030)
    sp = spans_of(rec["trace"])
    assert sp is spans_of(rec["trace"])           # walked once
    mlp = sp.device_s(["frame"]) - 1e-3 * (coarse + fine) * 3
    assert mlp == pytest.approx(3 * 300e-6)


def test_renderer_idle_is_the_bubbles_inside_frames(render_rec):
    rec, idle = render_rec
    got = load_reader("renderer_idle_ms.render")(rec)
    assert got == pytest.approx(1e-3 * sum(idle) / len(WAITS))
    assert got > 0


def test_frame_wait_is_the_median_first_op_delay(render_rec):
    rec, _ = render_rec
    got = load_reader("frame_wait_ms.render")(rec)
    assert got == pytest.approx(1e-3 * sorted(WAITS)[1])


def test_stage_and_host_step_per_step(train_rec):
    rec, chunk_us = train_rec
    assert load_reader("stage_ms.train")(rec) == pytest.approx(
        1e-3 * sum(STAGE_OPS))
    assert load_reader("host_step_ms.train")(rec) == pytest.approx(
        1e-3 * chunk_us / 4)
    # the replays' kernels belong to the launches
    sp = spans_of(rec["trace"])
    assert sp.device_s(["step.launch"]) == pytest.approx(4 * 300e-6)


def test_setup_program_s_sums_the_outermost_set_up():
    program.reset_setup_table()
    read = load_reader("setup_program_s")
    assert read({}) is None
    with program.setup_span("setup.a"):
        with program.setup_span("setup.b"):
            time.sleep(0.01)
    assert read({}) == pytest.approx(program.setup_seconds())
    outer = [r for r in program.setup_table() if r["depth"] == 0]
    assert [r["name"] for r in outer] == ["setup.a"]
    assert read({}) == outer[0]["s"]


def test_setup_program_s_is_silent_without_the_span_module(monkeypatch):
    monkeypatch.setitem(sys.modules, "nerf_pytorch_paeng_tpu_torch.utils.spans",
                        None)
    assert load_reader("setup_program_s")({}) is None


SPAN_READERS = ["stage_ms.train", "host_step_ms.train",
                "coarse_glue_ms.render", "fine_glue_ms.render",
                "renderer_idle_ms.render", "frame_wait_ms.render"]


@pytest.mark.parametrize("metric", SPAN_READERS)
def test_nothing_without_nerf_spans(metric):
    """A program without spans: a trace of the same work reads nothing,
    as does no trace."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(8).sum()
    kind = metric.split(".")[-1]
    n = "trace_steps" if kind == "train" else "trace_frames"
    rec = dict(kind=kind, trace=_Trace(list(prof.events())), **{n: 2})
    assert load_reader(metric)(rec) is None
    assert load_reader(metric)(dict(rec, trace=None)) is None
