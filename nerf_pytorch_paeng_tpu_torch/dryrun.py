"""Multi-rank dry run: one step or frame of every distributed path.

    python -m nerf_pytorch_paeng_tpu_torch.dryrun N [--device cpu]
        [--timeout SECONDS]

The counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``.
It starts N ranks, each a process of this module, under the torchrun
contract that ``parallel/mesh.py`` reads (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``).  The ranks make a gloo
group themselves, on the CPU and on the card alike: two ranks may share
one card, which NCCL refuses (``parallel.maybe_initialize_distributed``
keeps a group its caller made).  Rank r runs on ``cuda:{r % cards}``, or
on the CPU with ``--device cpu``; ``--device cuda`` without a card
raises.  Every rank has ``--timeout`` seconds (default 300); a rank that
fails or outlives it stops the run.

Six phases at the reference width (8x256, L_x 10, L_d 4) and tiny sample
counts, each printing one ``dryrun OK`` line:

1. the width-sharded and data-parallel train step (``n_data x 2`` ranks
   when N is even, else ``N x 1``), float32, on the plain route;
2. the data-parallel train step on the kernel route (K1/K2);
3. per-image data-parallel training, precrop on, then off (K1/K2);
4. the culled frame over the data-parallel ranks: the real support grid
   once (K7), then valid ball bounds injected through
   ``renderer.set_support`` (the pre-cull K4 and gate-fine K5 engage);
5. the sample-sharded render over ``1 x N`` ranks, coarse and fine,
   float32, the plain route;
6. the occupancy-gated data-parallel train step with the same injected
   bounds (K5/K6).

Every rank checks that each replicated result (losses, the frame, the
weights that must be alike) equals rank 0's.  Rank 0 prints the ``OK``
lines and, last, one JSON line ``{"dryrun": [...]}``: each phase's result
and its kernel launches summed over the ranks (none on the CPU, where
every kernel's plain version runs).
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import math
import os
import subprocess
import sys
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

from . import parallel
from .config import NerfConfig
from .utils.device import resolve_device

# the launch counters of ``kernels.LAUNCH_COUNTERS``, by kernel, in order
KERNEL_NAMES = ("K3", "K4", "K1", "K5", "K7", "K8", "K2", "K6", "K9")
FULL_WIDTH = dict(netDepth=8, netWidth=256, L_x=10, L_d=4, near=2.0,
                  far=6.0, iter_N=100, iter_warmup=5)
BALL = ((-1.5, -1.5, -1.5), (1.5, 1.5, 1.5), 2.0)     # lo, hi, radius
FRAME_GRID = 16            # the culled frame's real support grid, per axis


def _agree(t: torch.Tensor, what: str) -> None:
    """Raise unless this rank's ``t`` equals rank 0's bit for bit."""
    mine = t.detach().float().reshape(-1).contiguous()
    if not torch.equal(mine, parallel.broadcast0(mine.clone())):
        raise RuntimeError(f"dryrun: rank {parallel.rank()}'s {what} differs "
                           "from rank 0's")


def _finite(x: torch.Tensor, what: str) -> float:
    v = float(x)
    if not math.isfinite(v):
        raise RuntimeError(f"dryrun: {what} is {v}")
    return v


def _launches() -> torch.Tensor:
    from .kernels import launch_counts
    return torch.tensor(launch_counts(), dtype=torch.float64)


def _ball(device) -> tuple:
    lo, hi, r = BALL
    return (torch.tensor(lo, device=device), torch.tensor(hi, device=device),
            torch.tensor([r], device=device),
            torch.tensor([True], device=device))


def _rays(rng: np.random.Generator, n: int, device):
    """(origins, directions, colours) [n, 3] each, alike on every rank:
    origins on the radius-4 orbit shell; the first half of the rays
    through the centre region, the second half tangent to the shell, so
    that every sample in [near, far] stays inside the support grid's cube
    and the injected ball gates the tangent rays whole."""
    o = rng.normal(size=(n, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o / 4.0 + 0.3 * rng.normal(size=(n, 3))
    t = np.cross(o[n // 2:], rng.normal(size=(n - n // 2, 3)))
    d[n // 2:] = 0.5 * t / np.linalg.norm(t, axis=-1, keepdims=True)
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=device)
                 for a in (o, d, rng.uniform(size=(n, 3))))


def _train(cfg: NerfConfig, device) -> tuple:
    """(fresh state, global-batch step) of ``cfg``, its layout made."""
    from .train import create_train_state
    from .train.schedule import schedule_from_cfg
    from .train.step import make_train_step
    parallel.init_layout(cfg)
    state = create_train_state(cfg, device)
    return state, make_train_step(cfg, schedule_from_cfg(cfg))


def phase_tp(n: int, device, rng) -> tuple:
    from .parallel.tensor import check_model_replicas
    n_model = 2 if n % 2 == 0 else 1
    n_data = n // n_model
    cfg = NerfConfig(device=str(device), N_rays=8 * n_data, N_samples_c=8,
                     N_samples_f=8, compute_dtype="float32", use_pallas=False,
                     n_data_shards=n_data, n_model_shards=n_model,
                     **FULL_WIDTH)
    state, step = _train(cfg, device)
    m = step(state, *_rays(rng, cfg.N_rays, device))
    if state.step != 1:
        raise RuntimeError(f"dryrun: {state.step} updates after one step")
    _agree(m["loss"], "width-sharded step's loss")
    check_model_replicas(state.model, "dryrun: width-sharded step")
    return (f"width-sharded x data-parallel train step, full-width 8x256, "
            f"float32, plain route, layout {n_data} x {n_model}",
            f"loss={_finite(m['loss'], 'loss'):.4f}")


def phase_dp(n: int, device, rng) -> tuple:
    cfg = NerfConfig(device=str(device), N_rays=128 * n, N_samples_c=8,
                     N_samples_f=8, **FULL_WIDTH)
    state, step = _train(cfg, device)
    m = step(state, *_rays(rng, cfg.N_rays, device))
    _agree(m["loss"], "data-parallel step's loss")
    parallel.check_replicas(state.model.parameters(),
                            "dryrun: data-parallel step")
    return (f"data-parallel train step on the kernel route, dp={n}",
            f"loss={_finite(m['loss'], 'loss'):.4f}")


def _image_setup(n: int, device):
    """(cfg, state after two per-image steps, K, pose, H) of phase 3."""
    from .train import create_train_state
    from .train.schedule import schedule_from_cfg
    from .train.step import make_image_train_step
    from .utils.synth import make_synth_scene
    n_rays = 128 * n
    # a multiple of 4, so that the half-size centre crop holds the rays
    side = 4 * math.ceil(math.sqrt(n_rays) / 2)
    imgs, K, poses = make_synth_scene(n_views=1, H=side, W=side)
    cfg = NerfConfig(device=str(device), N_rays=n_rays, N_samples_c=8,
                     N_samples_f=8, precrop_iters=1, precrop_frac=0.5,
                     **FULL_WIDTH)
    parallel.init_layout(cfg)
    state = create_train_state(cfg, device)
    step = make_image_train_step(cfg, schedule_from_cfg(cfg), side, side, K)
    image = torch.as_tensor(imgs[0], device=device)
    pose = torch.as_tensor(poses[0][:3, :4], device=device)
    losses = [step(state, image, pose, precrop=p)["loss"]
              for p in (True, False)]
    return cfg, state, K, pose, side, losses


def phase_image(n: int, device, ctx: dict) -> tuple:
    cfg, state, K, pose, side, losses = _image_setup(n, device)
    for i, loss in enumerate(losses):
        _agree(loss, f"per-image step {i + 1}'s loss")
    ctx.update(cfg=cfg, state=state, K=K, pose=pose, side=side)
    return (f"per-image data-parallel training, precrop on then off, "
            f"dp={n}", f"loss={_finite(losses[-1], 'loss'):.4f}")


def phase_culled(n: int, device, ctx: dict) -> tuple:
    from .eval.frame import _support_for_eval, make_frame_renderer
    from .kernels.fused_mlp import pack_nerf
    cfg = dataclasses.replace(ctx["cfg"], chunk_rays=128 * n,
                              render_cull="auto", render_cull_tau=0.5,
                              render_precull="on",
                              render_precull_grid=FRAME_GRID)
    side = ctx["side"]
    packed = pack_nerf(ctx["state"].model, cfg, device=device)
    # the real grid once: a two-step field's bounds are invalid, so the
    # frame itself runs on injected ball bounds
    real, _ = _support_for_eval(packed["coarse"], cfg, device)
    if not bool(torch.isfinite(real[0]).all()):
        raise RuntimeError("dryrun: the support grid gave non-finite bounds")
    render = make_frame_renderer(cfg, side, side, ctx["K"], device)
    for module in ("coarse", "fine"):
        render.set_support(packed, module, _ball(device))
    rgb, disp = render(packed, ctx["pose"],
                       torch.Generator(device).manual_seed(6))
    if rgb.shape != (side, side, 3) or not bool(torch.isfinite(rgb).all()):
        raise RuntimeError(f"dryrun: culled frame {tuple(rgb.shape)} not "
                           "finite or misshapen")
    st = render.stats[-1]
    if st["gate_frac_coarse"] is None or st["gate_frac_fine"] is None:
        raise RuntimeError("dryrun: the injected bounds gated no pass")
    _agree(rgb, "culled frame")
    return (f"culled frame over dp={n}, injected ball bounds",
            f"rgb mean={float(rgb.mean()):.4f}, {st['n_act']} of "
            f"{side * side} rays active, skipped coarse "
            f"{float(st['gate_frac_coarse']):.3f} fine "
            f"{float(st['gate_frac_fine']):.3f}")


def phase_sp(n: int, device, rng) -> tuple:
    from .models.nerf import init_nerf
    from .ops.render import make_plain_field_fns
    from .ops.sampling import stratified_z_vals
    from .parallel.sp import make_sample_sharded_render_full
    cfg = NerfConfig(device=str(device), N_samples_c=2 * n,
                     N_samples_f=2 * n, compute_dtype="float32",
                     use_pallas=False, sp_shards=n, n_model_shards=n,
                     **FULL_WIDTH)
    parallel.init_layout(cfg)
    model = init_nerf(cfg, seed=7, device=device)
    render = make_sample_sharded_render_full(
        *make_plain_field_fns(model, cfg), n_fine=cfg.N_samples_f)
    o, d, _ = _rays(rng, 16, device)
    z = stratified_z_vals(16, 2.0, 6.0, cfg.N_samples_c, generator=torch.
                          Generator(device).manual_seed(8), device=device)
    with torch.no_grad():
        rgb_c, rgb, _, acc = render(o, d, z, generator=torch.Generator(
            device).manual_seed(9))
    for t, what in ((rgb_c, "coarse rgb"), (rgb, "fine rgb")):
        if not bool(torch.isfinite(t).all()):
            raise RuntimeError(f"dryrun: sample-sharded {what} not finite")
    _agree(acc, "sample-sharded render")
    return (f"sample-sharded render sp={n}, full-width 8x256 coarse+fine",
            f"acc mean={float(acc.mean()):.4f}")


def phase_gated(n: int, device, rng) -> tuple:
    from .train.precull import train_precull_active
    cfg = NerfConfig(device=str(device), N_rays=256 * n, N_samples_c=8,
                     N_samples_f=8, train_precull="on",
                     render_precull_grid=FRAME_GRID, **FULL_WIDTH)
    if not train_precull_active(cfg, parallel.world_size()):
        raise RuntimeError("dryrun: gated training inapplicable")
    state, step = _train(cfg, device)
    ball = _ball(device)
    m = step(state, *_rays(rng, cfg.N_rays, device), support=(ball, ball))
    if "gate_frac" not in m:
        raise RuntimeError("dryrun: the gated step reported no gate_frac")
    _agree(m["loss"], "gated step's loss")
    return (f"occupancy-gated train step dp={n}",
            f"loss={_finite(m['loss'], 'loss'):.4f}, "
            f"gate_frac={float(m['gate_frac']):.3f}")


PHASES = ("tp", "dp", "image", "culled", "sp", "gated")


def worker(n: int, device) -> int:
    """One rank: the gloo group from the launch's variables, then the six
    phases in order, each with its launches counted."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        "gloo", init_method="env://", rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]),
        timeout=datetime.timedelta(seconds=float(os.environ.get(
            "DRYRUN_TIMEOUT", "300"))))
    rng = np.random.default_rng(0)
    ctx: dict = {}
    calls = dict(tp=lambda: phase_tp(n, device, rng),
                 dp=lambda: phase_dp(n, device, rng),
                 image=lambda: phase_image(n, device, ctx),
                 culled=lambda: phase_culled(n, device, ctx),
                 sp=lambda: phase_sp(n, device, rng),
                 gated=lambda: phase_gated(n, device, rng))
    report: List[Dict] = []
    try:
        for i, name in enumerate(PHASES, 1):
            before = _launches()
            label, detail = calls[name]()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            delta = parallel.all_reduce_sum(_launches() - before)
            launches = {k: int(v) for k, v in zip(KERNEL_NAMES, delta)
                        if v}
            parallel.print0(f"dryrun OK ({i}: {label}): {detail}",
                            flush=True)
            report.append(dict(phase=name, what=label, result=detail,
                               launches=launches))
        parallel.print0(json.dumps({"dryrun": report}), flush=True)
    finally:
        parallel.destroy()
    return 0


def launch(n: int, device_name: str, timeout: float) -> int:
    """Start the n ranks, wait for each (``timeout`` seconds a rank) and
    print rank 0's output; the output of any rank that failed too.
    Returns 0 when every rank exited 0."""
    device = resolve_device(device_name)
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    port = parallel.free_port()
    threads = max(1, (os.cpu_count() or 1) // n)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.pathsep.join(filter(None, (root,
                                         os.environ.get("PYTHONPATH"))))
    procs = []
    for r in range(n):
        env = {**os.environ, "RANK": str(r), "WORLD_SIZE": str(n),
               "LOCAL_RANK": str(r), "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(port), "DRYRUN_TIMEOUT": str(timeout),
               "PYTHONPATH": path,
               "OMP_NUM_THREADS": os.environ.get("OMP_NUM_THREADS",
                                                 str(threads))}
        rank_device = f"cuda:{r % cards}" if cards else "cpu"
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "nerf_pytorch_paeng_tpu_torch.dryrun",
             str(n), "--device", rank_device, "--worker"], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs, rcs = [], []
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=timeout)[0])
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                outs.append(p.communicate()[0] + f"\n(rank timed out after "
                            f"{timeout:.0f} s)")
            rcs.append(p.returncode)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    print(outs[0], end="", flush=True)
    for r in range(1, n):
        if rcs[r] != 0:
            print(f"--- rank {r} (exit {rcs[r]}) ---\n{outs[r]}", end="",
                  flush=True)
    return 0 if all(rc == 0 for rc in rcs) else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m nerf_pytorch_paeng_tpu_torch.dryrun",
        description="one step or frame of every distributed path on N "
                    "gloo ranks")
    ap.add_argument("n", type=int, help="ranks")
    ap.add_argument("--device", default="cuda",
                    help="cuda (rank r on card r %% cards) or cpu")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds each rank may take")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.n < 1:
        ap.error("n must be at least 1")
    if args.worker:
        return worker(args.n, resolve_device(args.device))
    return launch(args.n, args.device, args.timeout)


if __name__ == "__main__":
    sys.exit(main())
