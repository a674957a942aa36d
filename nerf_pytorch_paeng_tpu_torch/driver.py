"""Experiment driver: dataset -> state -> train loop -> test, render and
save hooks, or the standalone evaluation or rendering of a saved
checkpoint.

Counterpart of the JAX package's ``driver.main_worker``: the dataset
dispatch by ``data_type`` (``load_dataset``: blender, LLFF with its spiral
render path, custom with the near/far its loader derives), the
coarse+fine model, Adam under the warmup-cosine schedule, global ray
batching or per-image sampling, resume (``iter_start``, ``-1`` for the
latest checkpoint) and the loop with the ``idx_print``, ``idx_vis``,
``idx_save``, ``idx_test`` and ``idx_render`` hooks, and occupancy-gated
training (``train_precull``) with its refresh policy; a run from step 0
draws the training cameras into ``logs/<exp>/_ext_vis/`` first
(``utils/visualize.py``).  Checkpoints are the
reference format, ``logs/<exp>/<exp>_<step>.pth.tar``
(``train/checkpoint.py``).  With ``eval_only`` and/or ``render_only`` it
restores the weights saved at ``testing_idx``, packs them once for the
fused kernels (on the plain route hands the renderers the modules) and
runs the held-out-view evaluation and/or the novel-view render.  It prints
the field route once: the fused kernels, or the plain MLP and why.  LLFF
rays are projected into NDC inside the train steps and the frame
renderers, never in the ray pool.

Under a torchrun launch (``parallel/mesh.py``: ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) ``main_worker`` makes
the process group first, on the rank's own card, then the rank layout
(``parallel.init_layout``: ``n_data_shards`` x ``n_model_shards``, its
data and model groups), and destroys both at the end.  Every data rank
trains on its slice of each batch (``train/step.py``); under
``n_model_shards > 1`` the ranks of a model group hold their parts of
the MLP's width (``parallel/tensor.py``) and train on the plain route.
Every rank renders its part of every frame (``eval/frame.py``; the hooks
render the gathered full weights through the kernels, and with
``sp_shards > 1`` each model rank renders its slice of every ray's
samples).  The weights that must be alike are checked bit for bit at
every checkpoint and at the end (every parameter over the data group, a
sharded model's replicated ones over the model group); rank 0 alone
writes the checkpoints (gathered to full width), ``metrics.csv``,
``precull_policy.csv``, the images and the printed logs.  Every rank
restores on a resume.
"""
from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import List, Optional

import numpy as np
import torch
import torch.distributed

from . import parallel
from .config import NerfConfig, load_config
from .data import load_blender, load_custom, load_llff
from .eval.render import run_render
from .eval.test import run_test
from .kernels import build
from .kernels.fused_mlp import pack_nerf
from .models.nerf import NeRF
from .ops.rays import get_rays
from .ops.render import plain_route_reason
from .train import RayPool, build_ray_pool, create_train_state
from .train import checkpoint as ckpt
from .parallel import print0
from .parallel.tensor import check_model_replicas, full_model
from .train.precull import (make_gate_frac_estimator,
                            make_train_support_program, train_precull_active,
                            train_precull_mode)
from .train.chunk import (PROFILE_START, PROFILE_STOP, ChunkSchedule,
                          StagedSteps, chunk_off_reason)
from .train.schedule import schedule_from_cfg
from .utils.logging import MetricLogger
from .utils.spans import setup_span, setup_table, span
from .utils.visualize import visualize_extrinsics


def checkpoint_path(cfg: NerfConfig, step: int) -> str:
    """logs/<exp>/<exp>_<step>.pth.tar (the reference's naming)."""
    return ckpt.checkpoint_path(cfg.logdir, cfg.exp_name, step)


def load_dataset(cfg: NerfConfig):
    """Dataset dispatch (reference main.py:34-58) -> (images, K,
    extrinsics, hw, i_split, render_poses, cfg).  ``render_poses`` is the
    LLFF spiral, else None; for custom data the returned config carries
    the near/far the loader derives from the scene's bounds.  Set-up span
    ``data.load``."""
    with setup_span("data.load"):
        if cfg.data_type == "blender":
            images, (K, ext), hw, i_split = load_blender(
                data_root=cfg.data_root, downsample=cfg.downsample,
                testskip=cfg.testskip, bkg_white=cfg.bkg_white)
            render_poses = None
        elif cfg.data_type == "llff":
            images, (K, ext), hw, i_split, render_poses = load_llff(
                data_root=cfg.data_root, downsample=cfg.downsample,
                testskip=cfg.testskip, colmap_relaunch=cfg.colmap_relaunch)
        elif cfg.data_type == "custom":
            images, (K, ext), hw, i_split, nf = load_custom(
                data_root=cfg.data_root, downsample=cfg.downsample,
                testskip=cfg.testskip, video_batch=cfg.video_batch,
                colmap_relaunch=cfg.colmap_relaunch)
            render_poses = None
            cfg = dataclasses.replace(cfg, near=nf[0], far=nf[1])
        else:
            raise ValueError(cfg.data_type)
        return images, K, ext, hw, i_split, render_poses, cfg


def _llff_render_poses_34(render_poses):
    """The spiral's [M, 3, 5] poses as [M, 3, 4] c2w, or None."""
    if render_poses is None:
        return None
    return render_poses[:, :3, :4]


def load_model(cfg: NerfConfig, step: int, device) -> NeRF:
    model = NeRF(depth=cfg.netDepth, width=cfg.netWidth, L_x=cfg.L_x,
                 L_d=cfg.L_d)
    state = torch.load(checkpoint_path(cfg, step), map_location="cpu",
                       weights_only=True)
    model.load_state_dict(state["model_state_dict"])
    return model.to(device).eval()


class _StepClock:
    """Per-step time without a host sync per step: on the card, device
    time between CUDA events recorded at the chunk boundaries (read once,
    at the end); on the CPU the host clock.  A chunk of K steps
    (``train/chunk.py``) is timed as a whole, and each of its steps is
    given the chunk's time divided by K."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: list = []
        self.lengths: List[int] = []

    def mark(self, steps: int = 0) -> None:
        """A chunk boundary, after ``steps`` steps (0 at the start)."""
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.marks.append(event)
        else:
            self.marks.append(time.perf_counter())
        if steps:
            self.lengths.append(steps)

    def seconds(self) -> List[float]:
        if self.cuda:
            torch.cuda.synchronize()
            spans = [a.elapsed_time(b) / 1e3
                     for a, b in zip(self.marks, self.marks[1:])]
        else:
            spans = [b - a for a, b in zip(self.marks, self.marks[1:])]
        return [t / k for t, k in zip(spans, self.lengths) for _ in range(k)]


class _Profiler:
    """The JAX package's profiler window (``driver.py:307, 378-386``) on
    ``torch.profiler``: started before step ``iter_start + 10``, stopped
    before step ``iter_start + 15`` (or at the end of a shorter run), CPU
    and CUDA activity on the card, CPU activity on the CPU, written as a
    Chrome trace under ``logs/<exp>/profile/``."""

    def __init__(self, cfg, device: torch.device):
        self.dir = os.path.join(cfg.logdir, cfg.exp_name, "profile")
        self.cuda = device.type == "cuda"
        self.prof = None
        self.first = 0

    def start(self, it: int) -> None:
        try:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if self.cuda else [])
            prof = profile(activities=acts)
            prof.start()
        except Exception as e:     # the JAX package's message
            print0(f">> profiler unavailable: {e}")
            return
        self.prof, self.first = prof, it

    def stop(self, it: int) -> None:
        """Stop before step ``it`` and write the trace."""
        if self.prof is None:
            return
        prof, self.prof = self.prof, None
        if self.cuda:
            torch.cuda.synchronize()
        prof.stop()
        os.makedirs(self.dir, exist_ok=True)
        rank = (f"_rank{parallel.rank()}" if parallel.world_size() > 1
                else "")
        path = os.path.join(self.dir,
                            f"trace_{self.first}-{it - 1}{rank}.json")
        prof.export_chrome_trace(path)
        print0(f">> profiler trace written to {path}")


class _SupportPolicy:
    """The refresh of occupancy-gated training: support bounds of both
    modules from the live weights, the predicted skipped share on a fixed
    probe batch, and the decision whether the next steps run gated.

    The probe batch is drawn once with ``np.random.default_rng(seed + 7)``
    exactly as the JAX package's driver draws it (up to 4 training views,
    then pixels of each), at the ray count one rank trains on, so both
    predict the same ``gate_frac``.  Each refresh makes one host read
    (both validity flags and the prediction), appends
    ``iter,bounds_valid,gate_frac_pred,gated`` to
    ``logs/<exp>/precull_policy.csv`` (truncated on a fresh run, appended
    on a resume) and prints the decision when it changes.  Under a
    process group the bounds and the prediction are rank 0's, broadcast,
    so every rank decides alike and gates with the same bounds; rank 0
    alone writes and prints."""

    def __init__(self, cfg, K, extrinsics, hw, i_train, device, n_est: int):
        H, W = hw
        self.cfg = cfg
        self.prog, _ = make_train_support_program(
            cfg, poses=np.asarray(extrinsics)[i_train, :3, :4],
            K=np.asarray(K), hw=(H, W), device=device)
        self.est = make_gate_frac_estimator(cfg)
        rng = np.random.default_rng(cfg.seed + 7)
        sel = rng.choice(i_train, size=min(4, len(i_train)), replace=False)
        eo, ed = [], []
        for p in sel:
            ro, rd = get_rays(H, W, K, torch.as_tensor(
                np.asarray(extrinsics[p])[:3, :4], dtype=torch.float32))
            pix = rng.choice(H * W, size=-(-n_est // len(sel)), replace=False)
            eo.append(ro.reshape(-1, 3).numpy()[pix])
            ed.append(rd.reshape(-1, 3).numpy()[pix])
        self.rays_o = torch.as_tensor(np.concatenate(eo)[:n_est], device=device)
        self.rays_d = torch.as_tensor(np.concatenate(ed)[:n_est], device=device)
        self.gated = None           # the first refresh always prints
        self.path = os.path.join(cfg.logdir, cfg.exp_name,
                                 "precull_policy.csv")
        if parallel.is_main() and (cfg.iter_start == 0
                                   or not os.path.isfile(self.path)):
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            with open(self.path, "w") as f:
                f.write("iter,bounds_valid,gate_frac_pred,gated\n")

    def refresh(self, model, it: int):
        """The bounds to gate with from step ``it`` on, or None (ungated):
        None while the bounds are invalid or the predicted skipped share
        cannot repay the sort and the smaller tiles.  Span
        ``policy.refresh``."""
        with span("policy.refresh"):
            bc, bf = self.prog(model)
            gf = self.est(bc, bf, self.rays_o, self.rays_d)
            if parallel.world_size() > 1:
                for t in (*bc, *bf, gf):
                    parallel.broadcast0(t)
            vc, vf, gfh = torch.stack([bc[3][0].float(), bf[3][0].float(),
                                       gf.float()]).tolist()  # one host read
        valid = bool(vc) and bool(vf)
        on = valid and gfh >= self.cfg.train_precull_min_gate
        if parallel.is_main():
            with open(self.path, "a") as f:
                f.write(f"{it},{int(valid)},{gfh:.4f},{int(on)}\n")
        if on != self.gated:
            self.gated = on
            why = f"predicted gate_frac {gfh:.3f}" if valid \
                else "bounds invalid"
            print0(f">> train_precull -> {'GATED' if on else 'ungated'} "
                   f"({why}) @ iter {it}")
        return (bc, bf) if on else None


def train(cfg: NerfConfig, images, K, extrinsics, hw, i_split,
          device: torch.device, render_poses=None) -> dict:
    """Steps ``iter_start + 1 .. iter_N``; returns the final step, every
    step's loss, time (``step_s``, see ``_StepClock``) and skipped block
    share (``gate_frac``, None where the step ran ungated), the chunks'
    lengths in order (``chunks``), the CUDA graphs captured and the
    steps replayed from them (``graph_captures``, ``graph_replays``) and
    the process's set-up spans (``spans``: ``utils/spans.setup_table``).
    ``render_poses`` (the LLFF spiral, [M, 3, 4]) feed the ``idx_render``
    hook.

    Occupancy-gated training (``train_precull``): the support bounds are
    refreshed before step ``iter_start + 1`` and then every
    ``train_precull_every`` steps, the interval doubling (up to
    ``train_precull_backoff_max`` times) while the policy declines.  A
    resumed run restarts that cadence at its first step, so a gated run's
    resume is not bit-exact with the uninterrupted run (as in the JAX
    package).

    Steps run in chunks (``train/chunk.py``, ``scan_chunk``): the hooks
    fire on a chunk's last step, ``idx_print`` and ``idx_vis`` log from
    the chunk's metric slab after it (one host read a chunk), and on the
    card the steps of a full-length chunk replay a CUDA graph.  The
    trajectory is the same at every ``scan_chunk``.  ``check_nans`` reads
    each chunk's finiteness flags and raises ``FloatingPointError`` at the
    first bad step; ``profile`` traces steps ``iter_start + 10 .. + 14``.
    Under a gloo process group, an NCCL group of more than one rank or
    ``n_model_shards > 1`` chunks have length 1
    (``chunk.chunk_off_reason``)."""
    i_train, _, i_test = i_split
    H, W = hw
    state = create_train_state(cfg, device)
    if cfg.iter_start != 0:
        ckpt.restore_checkpoint(cfg.logdir, cfg.exp_name, cfg.iter_start,
                                state)
        print0(f">> resumed from iter {state.step}")
    else:
        print0(">> training from scratch")
    schedule = schedule_from_cfg(cfg)

    if cfg.global_batch:
        print0(">> [global batch] building the all-image ray pool")
        gen = torch.Generator(device=device).manual_seed(cfg.seed + 1)
        ray_pool = RayPool(build_ray_pool(images, K, extrinsics, i_train,
                                          gen, device), gen)
        if state.step:
            # exact resume: replay the cursor and the epoch reshuffles
            ray_pool.fast_forward(state.step, cfg.N_rays)
            print0(f">> ray pool fast-forwarded to step {state.step} "
                   f"(epoch {ray_pool.epoch}, cursor {ray_pool.i_batch})")
        data = dict(pool=ray_pool)
    else:
        print0(">> per-image sampling mode")
        slot = {int(v): k for k, v in enumerate(i_train)}
        data = dict(
            images=torch.as_tensor(np.asarray(images[i_train], np.float32),
                                   device=device),
            poses=torch.as_tensor(
                np.asarray(extrinsics[i_train], np.float32)[:, :3, :4],
                device=device))

    policy = None
    world = parallel.world_size()
    if train_precull_active(cfg, world):
        policy = _SupportPolicy(cfg, K, extrinsics, hw, i_train, device,
                                n_est=cfg.N_rays // world)
        print0(f">> train_precull on (refresh every "
               f"{cfg.train_precull_every} iters)")
    elif train_precull_mode(cfg) == "on":
        print0(">> train_precull requested but inapplicable here (needs "
               "blender data, the ray-major kernel pair (the kernels' domain, "
               "use_rays_train and its shapes at the per-rank ray count, "
               "which the ranks must split evenly) and a usable support "
               "grid) — running ungated")

    logger = MetricLogger(cfg.logdir, cfg.exp_name,
                          fresh=(cfg.iter_start == 0))
    if cfg.iter_start == 0 and parallel.is_main():
        # the extrinsics plots, once before the loop, as the JAX package
        # draws them: the training cameras, and with idx_vis_cam_param > 0
        # their centre-pixel rays' points too
        vis_dir = os.path.join(cfg.logdir, cfg.exp_name, "_ext_vis")
        visualize_extrinsics(extrinsics, vis_dir, idx_list=i_train,
                             name="train_cameras")
        if cfg.idx_vis_cam_param > 0:
            visualize_extrinsics(extrinsics, vis_dir, idx_list=i_train,
                                 name="train_cameras_rays", K=np.asarray(K),
                                 hw=(H, W), near=float(cfg.near),
                                 far=float(cfg.far))
    rng = np.random.default_rng(cfg.seed + 2)
    if state.step and not cfg.global_batch:
        # exact resume, per-image mode: replay one image choice per step
        for _ in range(state.step):
            rng.choice(i_train)
    test_on = bool(cfg.idx_test and cfg.mode_test and len(i_test) > 0)
    render_on = bool(cfg.idx_render and cfg.mode_render)

    off = chunk_off_reason(cfg, torch.distributed.get_backend()
                           if parallel.is_distributed() else None, world)
    if off is not None and int(cfg.scan_chunk) > 1:
        print0(f">> scan_chunk {cfg.scan_chunk} -> 1 ({off})")
    chunks = ChunkSchedule.from_cfg(cfg, test_on, render_on, off)
    steps = StagedSteps(cfg, state, schedule, device, H, W, K,
                        graphs=chunks.k > 1, **data)
    profiler = _Profiler(cfg, device) if cfg.profile else None

    first = cfg.iter_start + 1
    losses = torch.empty(max(cfg.iter_N - cfg.iter_start, 0), device=device)
    gate_fracs = torch.full_like(losses, float("nan"))   # nan: ungated
    loss_col, gate_col = steps.keys.index("loss"), steps.keys.index(
        "gate_frac")
    support, next_refresh, backoff = None, first, 1
    clock = _StepClock(device)
    clock.mark()
    i = first
    try:
        while i <= cfg.iter_N:
            if policy is not None and i >= next_refresh:
                support = policy.refresh(state.model, i)
                steps.set_support(support)
                # declined refreshes stretch the interval (no bounds are in
                # use while ungated, so staleness costs nothing); engaging
                # resets it
                backoff = 1 if support is not None else min(
                    backoff * 2, max(int(cfg.train_precull_backoff_max), 1))
                next_refresh = i + max(int(cfg.train_precull_every),
                                       1) * backoff
            if profiler is not None:
                if i == cfg.iter_start + PROFILE_START:
                    profiler.start(i)
                elif i == cfg.iter_start + PROFILE_STOP:
                    profiler.stop(i)
            if cfg.global_batch:
                k = chunks.length(i, ray_pool.i_batch, len(ray_pool.pool),
                                  next_refresh if policy else None)
                items = [ray_pool.next_start(cfg.N_rays) for _ in range(k)]
            else:
                k = chunks.length(i, next_refresh=next_refresh if policy
                                  else None)
                items = [slot[int(rng.choice(i_train))] for _ in range(k)]
            slab = steps.run(items, precrop=i < cfg.precrop_iters,
                             gated=support is not None,
                             replay=k == chunks.k and k > 1)
            clock.mark(k)
            losses[i - first:i - first + k] = slab[:, loss_col]  # no sync
            gate_fracs[i - first:i - first + k] = slab[:, gate_col]
            rows = [j for j in range(k)      # JAX driver.py:404-406
                    if (cfg.idx_vis and (i + j) % cfg.idx_vis == 0)
                    or (cfg.idx_print and (i + j) % cfg.idx_print == 0)]
            if rows or cfg.check_nans:
                host = slab.cpu().numpy()            # one host read a chunk
                bad = (steps.first_bad_step(host, i) if cfg.check_nans
                       else None)
                if bad is not None:
                    raise FloatingPointError(
                        f"check_nans: update {bad} gave a non-finite loss, "
                        "gradient or weight")
                for j in rows:
                    e = i + j                # update e ran with schedule(e-1)
                    logger.log(e, {**steps.row_metrics(host[j]),
                                   "lr": schedule(e - 1)},
                               to_stdout=bool(cfg.idx_print
                                              and e % cfg.idx_print == 0),
                               n_rays=cfg.N_rays)
            last = i + k - 1           # the hooks fire on the chunk's last
            if cfg.idx_save and last % cfg.idx_save == 0:
                check_model_replicas(state.model, f"weights at iter {last}")
                path = ckpt.save_checkpoint(cfg.logdir, cfg.exp_name, state)
                print0(f">> checkpoint saved: {path}")
            if test_on and last % cfg.idx_test == 0:
                run_test(last, pack_nerf(full_model(state.model), cfg,
                                         device=device),
                         images[i_test], extrinsics[i_test], K, hw, cfg,
                         device)
            if render_on and last % cfg.idx_render == 0:
                run_render(last, pack_nerf(full_model(state.model), cfg,
                                           device=device), K, hw, cfg,
                           device, render_poses=render_poses)
            i += k
    finally:
        if profiler is not None:
            profiler.stop(i)
        steps.close()
    if chunks.k > 1:
        print0(f">> scan_chunk {chunks.k}: {steps.captures} graph "
               f"capture(s), {steps.replays} replayed step(s)")
    logger.close()
    check_model_replicas(state.model, "final weights")
    lay = parallel.layout()
    if lay.n_model > 1:
        print0(f">> final weights bit-equal over the {lay.n_data} data "
               f"rank(s), the replicated ones over the {lay.n_model} model "
               "ranks")
    elif world > 1:
        print0(f">> final weights bit-equal on all {world} ranks")
    print0(">> training done")
    return dict(step=state.step, loss=losses.tolist(), step_s=clock.seconds(),
                gate_frac=[None if math.isnan(g) else g
                           for g in gate_fracs.tolist()],
                chunks=list(clock.lengths), graph_captures=steps.captures,
                graph_replays=steps.replays, spans=setup_table())


def main_worker(cfg: NerfConfig) -> dict:
    """One run (training, or ``eval_only``/``render_only``) on this
    process's device; under a launch, the process group is made first and
    destroyed at the end.  The kernels' build directory is resolved first
    (``compile_cache``).  The returned dict is rank 0's record (see
    ``train``, ``eval/test.run_test`` and ``eval/render.run_render``)."""
    cache = build.use_build_dir(cfg.compile_cache)
    device, made_group = parallel.maybe_initialize_distributed(cfg.device)
    print0(f">> kernel build cache: {cache}")
    try:
        return _run(cfg, device)
    finally:
        if made_group:
            parallel.destroy()


def _run(cfg: NerfConfig, device: torch.device) -> dict:
    lay = parallel.init_layout(cfg)
    world = parallel.world_size()
    if not (cfg.eval_only or cfg.render_only) and cfg.N_rays < lay.n_data:
        raise ValueError(f"N_rays={cfg.N_rays} is fewer rays than the "
                         f"launch's {lay.n_data} data ranks")
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print0(f">> device: {device} ({name})"
           + (f"; {world} rank(s) over "
              f"{torch.distributed.get_backend()}"
              + (f" ({lay.n_data} data x {lay.n_model} model)"
                 if lay.n_model > 1 else "")
              if parallel.is_distributed() else ""))
    if cfg.iter_start < 0:   # -1 = resume from the latest checkpoint
        latest = ckpt.latest_checkpoint_step(cfg.logdir, cfg.exp_name)
        cfg = dataclasses.replace(cfg, iter_start=latest or 0)
        print0(f">> auto-resume: latest checkpoint is "
               f"{latest if latest is not None else 'absent'} "
               f"-> iter_start={cfg.iter_start}")
    print0(f">> loading dataset [{cfg.data_type}] from {cfg.data_root!r}")
    # LLFF and custom loading may write into the data root (minify's
    # images_{factor}/, COLMAP's poses_bounds.npy, a video's frames): rank 0
    # prepares it, then the other ranks read it without running COLMAP again
    images, K, extrinsics, hw, i_split, render_poses, cfg = \
        parallel.rank0_first(lambda first: load_dataset(
            cfg if first else dataclasses.replace(cfg, colmap_relaunch=False)),
            device)
    render_poses = _llff_render_poses_34(render_poses)
    print0(f">> dataset loaded: images {images.shape}, hw {hw}, "
           f"train/val/test {'/'.join(str(len(i)) for i in i_split)}")
    reason = plain_route_reason(
        cfg, train=not (cfg.eval_only or cfg.render_only))
    print0(f">> field route: {'fused kernels' if reason is None else 'plain'}"
           + (f" ({reason})" if reason else ""))
    if cfg.eval_only or cfg.render_only:
        i_test = i_split[2]
        model = load_model(cfg, cfg.testing_idx, device)
        packed = pack_nerf(model, cfg, device=device)
        res = {}
        if cfg.eval_only:
            res = run_test(cfg.testing_idx, packed, images[i_test],
                           extrinsics[i_test], K, hw, cfg, device)
        if cfg.render_only:
            rendered = run_render(cfg.testing_idx, packed, K, hw, cfg,
                                  device, render_poses=render_poses)
            res = {**res, "render": rendered} if cfg.eval_only else rendered
        return res
    return train(cfg, images, K, extrinsics, hw, i_split, device,
                 render_poses)


def main(argv: Optional[List[str]] = None) -> int:
    main_worker(load_config(argv))
    return 0
