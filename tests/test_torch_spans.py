"""The program's spans (``utils/spans.py``) on the CPU: off, they never
enter ``record_function``; under a profiler, frames and chunks nest their
phases and steps in order; the set-up table counts each call once and
nested set-up once; the ``profile`` knob's trace carries them."""
import json
import os
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nerf_pytorch_paeng_tpu_torch.config import NerfConfig
from nerf_pytorch_paeng_tpu_torch.driver import main_worker
from nerf_pytorch_paeng_tpu_torch.eval import frame
from nerf_pytorch_paeng_tpu_torch.eval.pipeline import pipelined_frames
from nerf_pytorch_paeng_tpu_torch.kernels import fused_mlp as fm
from nerf_pytorch_paeng_tpu_torch.models.nerf import NeRF
from nerf_pytorch_paeng_tpu_torch.train import (RayPool, build_ray_pool,
                                                create_train_state)
from nerf_pytorch_paeng_tpu_torch.train.chunk import StagedSteps
from nerf_pytorch_paeng_tpu_torch.train.schedule import schedule_from_cfg
from nerf_pytorch_paeng_tpu_torch.utils import spans
from nerf_pytorch_paeng_tpu_torch.utils.synth import (
    compact_field_state_dict, make_synth_scene, save_as_blender_dataset)

import torch_port_util  # noqa: F401  (this worker's share of the cores)

H = W = 16
FRAME_KW = dict(L_x=10, L_d=4, N_samples_c=16, N_samples_f=24, near=2.0,
                far=6.0, perturb=0.0, compute_dtype="float32",
                chunk_rays=64, render_precull_grid=48)
ROUTES = {
    # the ray route: pre-cull K4 and gate-fine K5 (their plain versions)
    "rays": dict(),
    # the plain route with phase 0 (render_precull on)
    "plain_phase0": dict(use_pallas=False, render_precull="on"),
}
TRAIN_KW = dict(data_type="blender", near=2.0, far=6.0, exp_name="spans",
                iter_N=24, iter_warmup=2, N_rays=64, N_samples_c=8,
                N_samples_f=8, netDepth=2, netWidth=32, L_x=4, L_d=2,
                testskip=1, idx_save=0, idx_test=0, idx_render=0,
                idx_print=6, idx_vis=6, chunk_rays=64,
                compute_dtype="float32", bkg_white=True, global_batch=True,
                device="cpu")


@pytest.fixture(scope="module")
def scene16(tmp_path_factory):
    root = tmp_path_factory.mktemp("spans16")
    save_as_blender_dataset(str(root), n_train=3, n_val=1, n_test=1, H=16,
                            W=16)
    return str(root)


def _frame_setup(route):
    _, K, poses = make_synth_scene(n_views=2, H=H, W=W)
    model = NeRF()
    # an L1 ball of radius 1: valid support bounds, a quarter of the rays
    model.load_state_dict(compact_field_state_dict(r=1.0, k=20.0))
    cfg = NerfConfig(device="cpu", **FRAME_KW, **ROUTES[route])
    renderer = frame.make_frame_renderer(cfg, H, W, K, "cpu",
                                         stratified=False)
    packed = fm.pack_nerf(model, cfg)
    renderer(packed, torch.from_numpy(poses[0]))     # builds the grids
    assert renderer.stats[-1]["gate_frac_coarse"] is not None
    return renderer, packed, poses


def _render_two(renderer, packed, poses):
    pipelined_frames(poses[:2],
                     lambda i, p: renderer(packed, torch.from_numpy(p)),
                     lambda i, out, submit: None)


def _staged(root, n=3):
    from nerf_pytorch_paeng_tpu_torch.data import load_blender
    cfg = NerfConfig(data_root=root, log_dir="", **TRAIN_KW).validate()
    images, (K, ext), hw, i_split = load_blender(root, True, 0, 1)
    gen = torch.Generator().manual_seed(cfg.seed + 1)
    pool = RayPool(build_ray_pool(images, K, ext, i_split[0], gen, "cpu"),
                   gen)
    steps = StagedSteps(cfg, create_train_state(cfg, "cpu"),
                        schedule_from_cfg(cfg), torch.device("cpu"), *hw, K,
                        pool=pool)
    return steps, [pool.next_start(cfg.N_rays) for _ in range(n)]


def _nerf_spans(prof):
    """(name, depth among nerf/ spans) of the trace's spans, in start
    order."""
    out, depth = [], {}
    for e in prof.events():
        if not e.name.startswith(spans.PREFIX) or "CPU" not in str(
                e.device_type):
            continue
        p = e.cpu_parent
        while p is not None and id(p) not in depth:
            p = p.cpu_parent
        depth[id(e)] = 0 if p is None else depth[id(p)] + 1
        out.append((e.name[len(spans.PREFIX):], depth[id(e)]))
    return out


def test_spans_off_never_enter_record_function(monkeypatch, scene16):
    """Without a profiler: a culled frame on the CPU's route, a chunk of
    staged steps and the frame pipeline never build an annotation."""
    renderer, packed, poses = _frame_setup("rays")
    steps, items = _staged(scene16)

    def refuse(*a, **k):
        raise AssertionError("record_function entered with tracing off")
    # the spans' annotation (torch's own optimizer annotates through
    # torch.autograd.profiler, whatever the profiler's state)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    _render_two(renderer, packed, poses)
    slab = steps.run(items)
    assert slab.shape[0] == len(items) and steps.state.step == len(items)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_frame_spans_nest_in_order(route):
    """Each frame: ``frame`` over ``frame.phase1`` (holding phase 0 and
    its host read where it runs, then the frame's one host read) and
    ``frame.phase2``, inside ``pipeline.issue``; the drains follow, one a
    frame."""
    renderer, packed, poses = _frame_setup(route)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _render_two(renderer, packed, poses)
    phase0 = ([("frame.phase0", 3), ("frame.read_hits", 4)]
              if route == "plain_phase0" else [])
    one = [("pipeline.issue", 0), ("frame", 1), ("frame.phase1", 2),
           *phase0, ("frame.read", 3), ("frame.phase2", 2)]
    assert _nerf_spans(prof) == one + one + [("pipeline.drain", 0)] * 2


def test_chunk_spans_hold_a_stage_and_a_launch_per_step(scene16):
    steps, items = _staged(scene16, n=3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        steps.run(items)
    assert _nerf_spans(prof) == [("chunk", 0)] + [
        ("step.stage", 1), ("step.launch", 1)] * 3


def test_setup_table_counts_calls_and_nested_spans_once(scene16):
    spans.reset_setup_table()
    cfg = NerfConfig(device="cpu", **FRAME_KW, netDepth=2, netWidth=32)
    model = NeRF(depth=2, width=32, L_x=10, L_d=4)
    fm.pack_nerf(model, cfg)
    _staged(scene16)
    rows = {(r["name"], r["depth"]): r for r in spans.setup_table()}
    assert rows[("setup.pack", 0)]["n"] == 1
    # StagedSteps and create_train_state, once each; the pool once
    assert rows[("setup.state", 0)]["n"] == 2
    assert rows[("setup.pool", 0)]["n"] == 1
    spans.reset_setup_table()
    with spans.setup_span("outer"):
        time.sleep(0.02)
        with spans.setup_span("inner"):
            time.sleep(0.02)
    rows = {(r["name"], r["depth"]): r for r in spans.setup_table()}
    outer, inner = rows[("outer", 0)]["s"], rows[("inner", 1)]["s"]
    assert inner >= 0.02 and outer >= 0.04
    assert spans.setup_seconds() == outer


def test_setup_span_annotates_only_under_a_profiler():
    spans.reset_setup_table()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.setup_span("setup.x"):
            pass
    with spans.setup_span("setup.x"):
        pass
    assert _nerf_spans(prof) == [("setup.x", 0)]
    assert spans.setup_table()[0]["n"] == 2


def test_profile_knob_trace_holds_the_chunk_spans(tmp_path, scene16):
    """``driver.train`` with ``profile`` true: the Chrome trace of steps
    10-14 holds the program's chunk and step spans; the run returns the
    set-up table."""
    cfg = NerfConfig(data_root=scene16, log_dir=str(tmp_path / "logs"),
                     **{**TRAIN_KW, "iter_N": 16, "profile": True,
                        "scan_chunk": 4, "exp_name": "prof"}).validate()
    res = main_worker(cfg)
    path = os.path.join(cfg.logdir, "prof", "profile", "trace_10-14.json")
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"nerf/chunk", "nerf/step.stage", "nerf/step.launch"} <= names
    setup = {r["name"] for r in res["spans"]}
    assert {"data.load", "setup.state", "setup.pool"} <= setup
    assert np.isfinite(res["loss"]).all()
