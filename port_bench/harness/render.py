"""Cells of kind ``render``: novel views through the program's frame
renderer, one frame ahead, and the check of sampled frames against the
reference's exact frames.

The cell's architecture (``arch/<name>.py``, named by its configuration)
gives what runs: the field drawn from the seed, the program's frame
renderer on it (the field prepared once, and the renderer that
``eval/frame.make_frame_renderer`` returns for the configuration), the
reference's exact frames and the counts the metric readers take.  This
module gives how it is measured.  Set-up makes the path (the blender
orbit, or the forward-facing capture's spiral), the field and the
renderer, and renders the cell's warm-up frames (the first builds the
support grids).  The window renders the path's poses in order
from pose 0, through ``eval/pipeline.pipelined_frames``: frame i + 1 is
issued before frame i's pixels are taken, as ``eval/render.run_render``
does, without its PNG and video writes.  A frame's pixels go to pinned
host memory by an asynchronous copy; its latency runs from the call that
renders it to the moment the host sees the copy done.  New frames are
issued until ``seconds`` have passed; the frames whose pixels arrived
inside the window are counted.

Each frame draws from a generator of its own, seeded from the run's seed
and the frame's index, so the reference can draw the frame's coarse
jitter again.  The fine uniforms are assigned to rays by the program's
own sort of the active rays, which is the program's state; the
reference draws its own (``FINE_STREAM``), so the comparison holds the
quadrature's noise as well as the program's rounding.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from .. import arch
from .common import Checks, quantile, splitmix64, sync
from .scenes import SCENES, intrinsics, render_orbit
from .trace import Trace

FINE_STREAM = 0x5EED        # the reference's fine uniforms: another stream
WARMUP_FRAMES = 2           # the first builds the support grids
# the numbers ``compare`` gives that a cell's limits may hold
LIMIT_KEYS = ("rgb_rmse", "rgb_max", "active_gap")
ARCH_NEEDS = ("render_field", "frame_renderer", "reference_frame",
              "render_counts", "ROUND_CONTROL")
# the default architecture's ray kernels, which the glue readers
# (``metrics/*_glue_ms.render.py``) leave out of a phase's device time
MLP_KERNELS = arch.load(arch.DEFAULT).MLP_KERNELS


def frame_seed(seed: int, i: int, stream: int = 0) -> int:
    return splitmix64(((seed & 0xFFFFFFFF) << 32)
                      ^ (stream << 20) ^ (i & 0xFFFFF))


def frame_seeds(seed: int, i: int, fine_stream: int = FINE_STREAM):
    """Frame ``i``'s coarse seed (the program's generator) and the
    reference's fine one."""
    return frame_seed(seed, i), frame_seed(seed, i, fine_stream)


def make_path(ctx) -> Dict:
    """(K, hw, poses [M, 4, 4] or [M, 3, 4]) of the cell's novel views."""
    cfg = ctx.cfg
    spec = {**ctx.config["scene"], **(ctx.scene_overrides or {})}
    if spec["kind"] == "forward":
        scene = SCENES["forward"](spec, ctx.seed, ctx.device, images=False)
        return dict(K=scene["K"], hw=scene["hw"],
                    poses=scene["render_poses"])
    H, W = int(spec["H"]), int(spec["W"])
    focal = 0.5 * W / float(np.tan(0.5 * float(spec["camera_angle_x"])))
    return dict(K=intrinsics(H, W, focal), hw=(H, W),
                poses=render_orbit(cfg.n_angle, cfg.phi, cfg.nf))


def _program(ctx, path, sd) -> dict:
    from nerf_pytorch_paeng_tpu_torch.eval.pipeline import pipelined_frames

    a, dev = arch.of(ctx.config), ctx.device
    H, W = path["hw"]
    poses = path["poses"]
    renderer, field = a.frame_renderer(ctx.cfg, path["hw"], path["K"], sd,
                                       dev)
    frames: Dict[int, dict] = {}
    want_stats = bool(ctx.trace)

    def render_one(i, pose):
        gen = torch.Generator(device=dev).manual_seed(frame_seed(ctx.seed, i))
        t_call = time.perf_counter()
        rgb, disp = renderer(field, torch.as_tensor(pose[:3, :4]), gen)
        # the culled renderer's count of the rays it rendered (a host
        # number: the frame's own host read gave it)
        stats = getattr(renderer, "stats", None)
        n_act = stats[-1]["n_act"] if stats else None
        if dev.type != "cuda":
            return dict(rgb=rgb, t_call=t_call, event=None, stats=None,
                        n_act=n_act)
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in (rgb, disp)]
        for h, t in zip(host, (rgb, disp)):
            h.copy_(t, non_blocking=True)
        stats = None
        if want_stats and renderer.stats:
            st = renderer.stats[-1]
            vals = [st[k] for k in ("gate_frac_coarse", "gate_frac_fine")]
            dev_vals = torch.stack([v.float() if v is not None
                                    else torch.full((), float("nan"),
                                                    device=dev)
                                    for v in vals])
            stats = (st, torch.empty(2, pin_memory=True))
            stats[1].copy_(dev_vals, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record()
        return dict(rgb=host[0], t_call=t_call, event=copied, stats=stats,
                    n_act=n_act)

    def drain_one(i, out, submit):
        if out["event"] is not None:
            out["event"].synchronize()
        out["t_done"] = time.perf_counter()
        if out["stats"] is not None:
            st, host = out["stats"]
            out["stats"] = dict(n_act=st["n_act"], n_trunc=st["n_trunc"],
                                trunc_blocks=st["trunc_blocks"],
                                blocks=st["blocks"],
                                gate_frac_coarse=float(host[0]),
                                gate_frac_fine=float(host[1]))
        frames[i] = out

    def run_frames(first: int, count=None, until=None) -> List[int]:
        """Frames ``first, first + 1, ...`` (pose index modulo the path)
        until ``count`` are issued or the host clock passes ``until``."""
        def items():
            j = 0
            while ((count is None or j < count)
                   and (until is None or time.perf_counter() < until)):
                yield poses[(j % len(poses))]
                j += 1
        done = []

        def render_idx(j, pose):
            done.append(first + j)
            return render_one(first + j, pose)

        pipelined_frames(items(), render_idx,
                         lambda j, out, submit: drain_one(first + j, out,
                                                          submit))
        return done

    warm = run_frames(10 ** 6, count=WARMUP_FRAMES)
    for i in warm:
        frames.pop(i)
    sync(dev)
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    issued = run_frames(0, until=t0 + ctx.seconds)
    end = t0 + ctx.seconds
    counted = [i for i in issued if frames[i]["t_done"] <= end]
    if not counted:
        raise RuntimeError("no frame reached the host inside the window")
    window_s = max(frames[i]["t_done"] for i in counted) - t0
    lat = [frames[i]["t_done"] - frames[i]["t_call"] for i in counted]
    rec = dict(kind="render", frames=len(counted), window_s=window_s,
               hw=(H, W), route=renderer.route,
               stats=[frames[i]["stats"] for i in counted
                      if frames[i]["stats"] is not None])
    if ctx.trace:
        with Trace(dev) as tr:
            traced = run_frames(2 * 10 ** 6,
                                count=int(ctx.workload["trace_frames"]))
        rec.update(trace=tr, trace_frames=len(traced),
                   **a.render_counts(ctx.cfg))
    rec["memory_peak_bytes"] = (int(torch.cuda.max_memory_allocated(dev))
                                if dev.type == "cuda" else 0)
    kept = {i: (frames[i]["rgb"], frames[i]["n_act"]) for i in counted}
    return dict(setup_s=setup_s, rec=rec, lat=lat, kept=kept,
                n_poses=len(poses))


def compare(prog: torch.Tensor, refr: torch.Tensor, n_prog: int,
            n_ref: int) -> Dict[str, float]:
    """rgb_rmse: the root mean square of the sampled frames' colour gaps;
    rgb_max: the widest gap of one colour; active_gap: the gap between
    the rays the program rendered over the sampled frames and the rays
    whose exact coarse occupancy is above the cull's tau, over the
    latter (the coarse pass's own output).  A cell's limits say which
    are held (see PERF.md)."""
    diff = (prog.float() - refr.float()).abs()
    return {"rgb_rmse": float(diff.square().mean().sqrt()),
            "rgb_max": float(diff.max()),
            "active_gap": abs(n_prog - n_ref) / max(n_ref, 1)}


def field_state_dict(ctx) -> Dict[str, torch.Tensor]:
    """The cell's field, drawn on the device from the run's seed."""
    return arch.of(ctx.config).render_field(
        ctx.workload["field"],
        torch.Generator(device=ctx.device).manual_seed(ctx.seed),
        ctx.device, ctx.cfg)


def run(ctx) -> dict:
    cfg, dev = ctx.cfg, ctx.device
    a = arch.of(ctx.config)
    path = make_path(ctx)
    sd = field_state_dict(ctx)
    out = _program(ctx, path, sd)
    rec = out["rec"]
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # the check: sampled frames of the window against the exact frames
    check = ctx.workload["check"]
    counted = sorted(out["kept"])
    pick = np.random.default_rng(ctx.seed).choice(
        counted, size=min(int(check["frames"]), len(counted)), replace=False)
    progs, refs, n_prog, n_ref = [], [], 0, 0
    for i in sorted(int(j) for j in pick):
        pose = path["poses"][i % out["n_poses"]]
        rgb, n = a.reference_frame(sd, cfg, path["K"], path["hw"], pose,
                                   frame_seeds(ctx.seed, i), dev)
        refs.append(rgb)
        n_ref += n
        progs.append(out["kept"][i][0].to(dev))
        n_prog += out["kept"][i][1] if out["kept"][i][1] is not None else n
    checks = Checks()
    numbers = compare(torch.stack(progs), torch.stack(refs), n_prog, n_ref)
    for name, value in numbers.items():
        if name in check["limits"]:
            checks.add(name, value, check["limits"][name])
    lat = out["lat"]
    return dict(
        e2e={"frame_ms": 1e3 * rec["window_s"] / rec["frames"],
             "frame_ms_p90": 1e3 * quantile(lat, 9, 10),
             "setup_s": out["setup_s"]},
        rec=rec, checks=checks, readings=numbers, attempted=rec["frames"],
        failed=0,
        notes={"frames_checked": [int(j) for j in sorted(pick)],
               "readings": numbers, **_stats_notes(rec)})


def _stats_notes(rec) -> dict:
    """The culled renderer's record over the window's frames (traced runs
    read it): the truncated rays' share of all rays, and cover blocks and
    truncated blocks a frame."""
    stats = rec["stats"]
    if not stats:
        return {}
    H, W = rec["hw"]
    return {"trunc_ray_share": sum(s["n_trunc"] for s in stats)
            / (len(stats) * H * W),
            "blocks": sum(s["blocks"] for s in stats) / len(stats),
            "trunc_blocks": sum(s["trunc_blocks"] for s in stats)
            / len(stats)}
