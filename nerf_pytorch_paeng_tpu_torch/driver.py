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
training (``train_precull``) with its refresh policy.  Checkpoints are the
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
the process group first, on the rank's own card, and destroys it at the
end.  Every rank trains on its slice of each batch (``train/step.py``),
renders its part of every frame (``eval/frame.py``) and holds the same
weights, which are checked bit for bit across the ranks at every
checkpoint and at the end; rank 0 alone writes the checkpoints,
``metrics.csv``, ``precull_policy.csv``, the images and the printed logs.
Every rank restores on a resume.
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
from .kernels.fused_mlp import pack_nerf
from .models.nerf import NeRF
from .ops.rays import get_rays
from .ops.render import plain_route_reason
from .train import RayPool, build_ray_pool, create_train_state
from .train import checkpoint as ckpt
from .parallel import print0
from .train.precull import (make_gate_frac_estimator,
                            make_train_support_program, train_precull_active,
                            train_precull_mode)
from .train.schedule import schedule_from_cfg
from .train.step import make_image_train_step, make_train_step
from .utils.logging import MetricLogger


def checkpoint_path(cfg: NerfConfig, step: int) -> str:
    """logs/<exp>/<exp>_<step>.pth.tar (the reference's naming)."""
    return ckpt.checkpoint_path(cfg.logdir, cfg.exp_name, step)


def load_dataset(cfg: NerfConfig):
    """Dataset dispatch (reference main.py:34-58) -> (images, K,
    extrinsics, hw, i_split, render_poses, cfg).  ``render_poses`` is the
    LLFF spiral, else None; for custom data the returned config carries
    the near/far the loader derives from the scene's bounds."""
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
    time between CUDA events recorded at the step boundaries (read once,
    at the end); on the CPU the host clock."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: list = []

    def mark(self) -> None:
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.marks.append(event)
        else:
            self.marks.append(time.perf_counter())

    def seconds(self) -> List[float]:
        if not self.cuda:
            return [b - a for a, b in zip(self.marks, self.marks[1:])]
        torch.cuda.synchronize()
        return [a.elapsed_time(b) / 1e3
                for a, b in zip(self.marks, self.marks[1:])]


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
        cannot repay the sort and the smaller tiles."""
        bc, bf = self.prog(model)
        gf = self.est(bc, bf, self.rays_o, self.rays_d)
        if parallel.world_size() > 1:
            for t in (*bc, *bf, gf):
                parallel.broadcast0(t)
        vc, vf, gfh = torch.stack([bc[3][0].float(), bf[3][0].float(),
                                   gf.float()]).tolist()   # one host read
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
    share (``gate_frac``, None where the step ran ungated).
    ``render_poses`` (the LLFF spiral, [M, 3, 4]) feed the ``idx_render``
    hook.

    Occupancy-gated training (``train_precull``): the support bounds are
    refreshed before step ``iter_start + 1`` and then every
    ``train_precull_every`` steps, the interval doubling (up to
    ``train_precull_backoff_max`` times) while the policy declines.  A
    resumed run restarts that cadence at its first step, so a gated run's
    resume is not bit-exact with the uninterrupted run (as in the JAX
    package)."""
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
        step_fn = make_train_step(cfg, schedule, H, W, float(K[0][0]))
    else:
        print0(">> per-image sampling mode")
        slot = {int(v): k for k, v in enumerate(i_train)}
        train_imgs = torch.as_tensor(np.asarray(images[i_train], np.float32),
                                     device=device)
        train_poses = torch.as_tensor(
            np.asarray(extrinsics[i_train], np.float32)[:, :3, :4],
            device=device)
        step_fn = make_image_train_step(cfg, schedule, H, W, K)

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
    rng = np.random.default_rng(cfg.seed + 2)
    if state.step and not cfg.global_batch:
        # exact resume, per-image mode: replay one image choice per step
        for _ in range(state.step):
            rng.choice(i_train)
    test_on = bool(cfg.idx_test and cfg.mode_test and len(i_test) > 0)
    render_on = bool(cfg.idx_render and cfg.mode_render)

    first = cfg.iter_start + 1
    losses = torch.empty(max(cfg.iter_N - cfg.iter_start, 0), device=device)
    gate_fracs = torch.full_like(losses, float("nan"))   # nan: ungated
    support, next_refresh, backoff = None, first, 1
    clock = _StepClock(device)
    clock.mark()
    for i in range(first, cfg.iter_N + 1):
        if policy is not None and i >= next_refresh:
            support = policy.refresh(state.model, i)
            # declined refreshes stretch the interval (no bounds are in use
            # while ungated, so staleness costs nothing); engaging resets it
            backoff = 1 if support is not None else min(
                backoff * 2, max(int(cfg.train_precull_backoff_max), 1))
            next_refresh = i + max(int(cfg.train_precull_every), 1) * backoff
        if cfg.global_batch:
            metrics = step_fn(state, *ray_pool.next_batch(cfg.N_rays),
                              support=support)
        else:
            k = slot[int(rng.choice(i_train))]
            metrics = step_fn(state, train_imgs[k], train_poses[k],
                              precrop=i < cfg.precrop_iters, support=support)
        clock.mark()
        losses[i - first] = metrics["loss"]     # on the device, no sync
        if "gate_frac" in metrics:
            gate_fracs[i - first] = metrics["gate_frac"]
        show = bool(cfg.idx_print and i % cfg.idx_print == 0)
        if show or (cfg.idx_vis and i % cfg.idx_vis == 0):
            # update i ran with schedule(i - 1)
            logger.log(i, {**metrics, "lr": schedule(i - 1)},
                       to_stdout=show, n_rays=cfg.N_rays)
        if cfg.idx_save and i % cfg.idx_save == 0:
            parallel.check_replicas(state.model.parameters(),
                                    f"weights at iter {i}")
            path = ckpt.save_checkpoint(cfg.logdir, cfg.exp_name, state)
            print0(f">> checkpoint saved: {path}")
        if test_on and i % cfg.idx_test == 0:
            run_test(i, pack_nerf(state.model, cfg, device=device),
                     images[i_test], extrinsics[i_test], K, hw, cfg, device)
        if render_on and i % cfg.idx_render == 0:
            run_render(i, pack_nerf(state.model, cfg, device=device), K, hw,
                       cfg, device, render_poses=render_poses)
    logger.close()
    parallel.check_replicas(state.model.parameters(), "final weights")
    if world > 1:
        print0(f">> final weights bit-equal on all {world} ranks")
    print0(">> training done")
    return dict(step=state.step, loss=losses.tolist(), step_s=clock.seconds(),
                gate_frac=[None if math.isnan(g) else g
                           for g in gate_fracs.tolist()])


def main_worker(cfg: NerfConfig) -> dict:
    """One run (training, or ``eval_only``/``render_only``) on this
    process's device; under a launch, the process group is made first and
    destroyed at the end.  The returned dict is rank 0's record (see
    ``train``, ``eval/test.run_test`` and ``eval/render.run_render``)."""
    device, made_group = parallel.maybe_initialize_distributed(cfg.device)
    try:
        return _run(cfg, device)
    finally:
        if made_group:
            parallel.destroy()


def _run(cfg: NerfConfig, device: torch.device) -> dict:
    parallel.check_data_shards(cfg)
    world = parallel.world_size()
    if not (cfg.eval_only or cfg.render_only) and cfg.N_rays < world:
        raise ValueError(f"N_rays={cfg.N_rays} is fewer rays than the "
                         f"launch's {world} ranks")
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print0(f">> device: {device} ({name})"
           + (f"; {world} rank(s) over "
              f"{torch.distributed.get_backend()}"
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
    reason = plain_route_reason(cfg)
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
