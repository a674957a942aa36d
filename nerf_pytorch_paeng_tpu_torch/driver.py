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
(``train/checkpoint.py``).  What depends on the architecture
(``arch``: NeRF, or Instant-NGP's ``models/ngp.py``) is its module's
under ``arch/`` (``arch.architecture``): the model, the route line, the
frame weights, the run's own checks and the loop's hook between chunks
(NeRF's occupancy policy, Instant-NGP's grid update).  With
``eval_only`` and/or ``render_only`` it restores the weights saved at
``testing_idx``, packs them once for the fused kernels (on the plain
route hands the renderers the modules) and runs the held-out-view
evaluation and/or the novel-view render.  It prints the field route
once: the fused kernels, or the plain MLP and why.  LLFF
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
from .arch import architecture
from .config import NerfConfig, load_config
from .data import load_blender, load_custom, load_llff
from .eval.render import run_render
from .eval.test import run_test
from .kernels import build
from .train import RayPool, build_ray_pool, create_train_state
from .train import checkpoint as ckpt
from .parallel import print0
from .parallel.tensor import check_model_replicas
# port_bench/arch/nerf.py imports the policy from here
from .train.precull import SupportPolicy as _SupportPolicy  # noqa: F401
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


def load_model(cfg: NerfConfig, step: int, device):
    """The architecture's model (a ``NeRF``, or an ``NGP`` with its
    occupancy grid) saved at ``step``, on ``device``."""
    model = architecture(cfg).empty_model(cfg)
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

    Before each chunk the architecture's hook (``chunk_hook``, ``arch/``;
    ``train/chunk.NoHook``) does the work due and names the bounds the
    chunk gates with, and a chunk ends before the hook's next work.
    NeRF's is the occupancy policy of gated training (``train_precull``,
    ``train/precull.SupportPolicy``): the support bounds are refreshed
    before step ``iter_start + 1`` and then every ``train_precull_every``
    steps, the interval doubling (up to ``train_precull_backoff_max``
    times) while the policy declines.  A resumed run restarts that cadence
    at its first step, so a gated run's resume is not bit-exact with the
    uninterrupted run (as in the JAX package).  Instant-NGP's (one
    process, the global pool) updates its occupancy grid before every
    iteration that ``models/ngp.grid_update_due`` names (every
    ``GRID_EVERY`` steps from that step on), so that with ``scan_chunk``
    16 and an update every 16 steps every update falls between chunks; it
    gates nothing.

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

    world = parallel.world_size()
    arch = architecture(cfg)
    arch.check_run(cfg, world)
    hook = arch.chunk_hook(cfg, K, extrinsics, hw, i_train, device, world)

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
    clock = _StepClock(device)
    clock.mark()
    i = first
    try:
        while i <= cfg.iter_N:
            support = hook.before(i, state.model)
            steps.set_support(support)
            if profiler is not None:
                if i == cfg.iter_start + PROFILE_START:
                    profiler.start(i)
                elif i == cfg.iter_start + PROFILE_STOP:
                    profiler.stop(i)
            if cfg.global_batch:
                k = chunks.length(i, ray_pool.i_batch, len(ray_pool.pool),
                                  hook.next_boundary(i))
                items = [ray_pool.next_start(cfg.N_rays) for _ in range(k)]
            else:
                k = chunks.length(i, next_refresh=hook.next_boundary(i))
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
                run_test(last, arch.frame_weights(state.model, cfg, device),
                         images[i_test], extrinsics[i_test], K, hw, cfg,
                         device)
            if render_on and last % cfg.idx_render == 0:
                run_render(last, arch.frame_weights(state.model, cfg,
                                                    device),
                           K, hw, cfg, device, render_poses=render_poses)
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
    arch = architecture(cfg)
    print0(f">> field route: {arch.route_line(cfg)}")
    if cfg.eval_only or cfg.render_only:
        i_test = i_split[2]
        model = load_model(cfg, cfg.testing_idx, device)
        packed = arch.frame_weights(model, cfg, device)
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
