"""Experiment driver: dataset -> state -> train loop -> test and save hooks,
or the standalone evaluation of a saved checkpoint.

Counterpart of the JAX package's ``driver.main_worker`` on blender data:
the coarse+fine model, Adam under the warmup-cosine schedule, global ray
batching or per-image sampling, resume (``iter_start``, ``-1`` for the
latest checkpoint) and the loop with the ``idx_print``, ``idx_vis``,
``idx_save`` and ``idx_test`` hooks.  Checkpoints are the reference
format, ``logs/<exp>/<exp>_<step>.pth.tar`` (``train/checkpoint.py``).
With ``eval_only`` it restores the weights saved at ``testing_idx``, packs
them once for the fused kernels and runs the held-out-view evaluation.

Not ported yet, and refused by ``main`` with a message: novel-view
rendering (``render_only``; the ``idx_render`` hook is skipped) and the
LLFF and custom loaders.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from .config import NerfConfig, load_config
from .data import load_blender
from .eval.test import run_test
from .kernels.fused_mlp import pack_nerf
from .models.nerf import NeRF
from .train import RayPool, build_ray_pool, create_train_state
from .train import checkpoint as ckpt
from .train.schedule import schedule_from_cfg
from .train.step import make_image_train_step, make_train_step
from .utils.device import resolve_device
from .utils.logging import MetricLogger


def checkpoint_path(cfg: NerfConfig, step: int) -> str:
    """logs/<exp>/<exp>_<step>.pth.tar (the reference's naming)."""
    return ckpt.checkpoint_path(cfg.logdir, cfg.exp_name, step)


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


def train(cfg: NerfConfig, images, K, extrinsics, hw, i_split,
          device: torch.device) -> dict:
    """Steps ``iter_start + 1 .. iter_N``; returns the final step, every
    step's loss and time (``step_s``, see ``_StepClock``)."""
    i_train, _, i_test = i_split
    H, W = hw
    state = create_train_state(cfg, device)
    if cfg.iter_start != 0:
        ckpt.restore_checkpoint(cfg.logdir, cfg.exp_name, cfg.iter_start,
                                state)
        print(f">> resumed from iter {state.step}")
    else:
        print(">> training from scratch")
    schedule = schedule_from_cfg(cfg)

    if cfg.global_batch:
        print(">> [global batch] building the all-image ray pool")
        gen = torch.Generator(device=device).manual_seed(cfg.seed + 1)
        ray_pool = RayPool(build_ray_pool(images, K, extrinsics, i_train,
                                          gen, device), gen)
        if state.step:
            # exact resume: replay the cursor and the epoch reshuffles
            ray_pool.fast_forward(state.step, cfg.N_rays)
            print(f">> ray pool fast-forwarded to step {state.step} "
                  f"(epoch {ray_pool.epoch}, cursor {ray_pool.i_batch})")
        step_fn = make_train_step(cfg, schedule)
    else:
        print(">> per-image sampling mode")
        slot = {int(v): k for k, v in enumerate(i_train)}
        train_imgs = torch.as_tensor(np.asarray(images[i_train], np.float32),
                                     device=device)
        train_poses = torch.as_tensor(
            np.asarray(extrinsics[i_train], np.float32)[:, :3, :4],
            device=device)
        step_fn = make_image_train_step(cfg, schedule, H, W, K)

    logger = MetricLogger(cfg.logdir, cfg.exp_name,
                          fresh=(cfg.iter_start == 0))
    rng = np.random.default_rng(cfg.seed + 2)
    if state.step and not cfg.global_batch:
        # exact resume, per-image mode: replay one image choice per step
        for _ in range(state.step):
            rng.choice(i_train)
    test_on = bool(cfg.idx_test and cfg.mode_test and len(i_test) > 0)
    if cfg.idx_render and cfg.mode_render:
        print(">> idx_render: novel-view rendering is not ported yet; the "
              "render hook is skipped")

    first = cfg.iter_start + 1
    losses = torch.empty(max(cfg.iter_N - cfg.iter_start, 0), device=device)
    clock = _StepClock(device)
    clock.mark()
    for i in range(first, cfg.iter_N + 1):
        if cfg.global_batch:
            metrics = step_fn(state, *ray_pool.next_batch(cfg.N_rays))
        else:
            k = slot[int(rng.choice(i_train))]
            metrics = step_fn(state, train_imgs[k], train_poses[k],
                              precrop=i < cfg.precrop_iters)
        clock.mark()
        losses[i - first] = metrics["loss"]     # on the device, no sync
        show = bool(cfg.idx_print and i % cfg.idx_print == 0)
        if show or (cfg.idx_vis and i % cfg.idx_vis == 0):
            # update i ran with schedule(i - 1)
            logger.log(i, {**metrics, "lr": schedule(i - 1)},
                       to_stdout=show, n_rays=cfg.N_rays)
        if cfg.idx_save and i % cfg.idx_save == 0:
            path = ckpt.save_checkpoint(cfg.logdir, cfg.exp_name, state)
            print(f">> checkpoint saved: {path}")
        if test_on and i % cfg.idx_test == 0:
            run_test(i, pack_nerf(state.model, cfg, device=device),
                     images[i_test], extrinsics[i_test], K, hw, cfg, device)
    logger.close()
    print(">> training done")
    return dict(step=state.step, loss=losses.tolist(), step_s=clock.seconds())


def main_worker(cfg: NerfConfig) -> dict:
    device = resolve_device(cfg.device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f">> device: {device} ({name})")
    if cfg.data_type != "blender":
        raise NotImplementedError(
            f"data_type={cfg.data_type!r}: only the blender loader is ported")
    if cfg.iter_start < 0:   # -1 = resume from the latest checkpoint
        latest = ckpt.latest_checkpoint_step(cfg.logdir, cfg.exp_name)
        cfg = dataclasses.replace(cfg, iter_start=latest or 0)
        print(f">> auto-resume: latest checkpoint is "
              f"{latest if latest is not None else 'absent'} "
              f"-> iter_start={cfg.iter_start}")
    print(f">> loading dataset [{cfg.data_type}] from {cfg.data_root!r}")
    images, (K, extrinsics), hw, i_split = load_blender(
        data_root=cfg.data_root, downsample=cfg.downsample,
        testskip=cfg.testskip, bkg_white=cfg.bkg_white)
    print(f">> dataset loaded: images {images.shape}, hw {hw}, "
          f"train/val/test {'/'.join(str(len(i)) for i in i_split)}")
    if cfg.eval_only:
        i_test = i_split[2]
        model = load_model(cfg, cfg.testing_idx, device)
        packed = pack_nerf(model, cfg, device=device)
        return run_test(cfg.testing_idx, packed, images[i_test],
                        extrinsics[i_test], K, hw, cfg, device)
    return train(cfg, images, K, extrinsics, hw, i_split, device)


def main(argv: Optional[List[str]] = None) -> int:
    cfg = load_config(argv)
    unported = None
    if cfg.render_only:
        unported = "novel-view rendering (--render_only)"
    elif cfg.data_type != "blender":
        unported = f"the {cfg.data_type} loader"
    if unported:
        print(f"nerf_pytorch_paeng_tpu_torch: {unported} is not ported yet; "
              "the JAX package (main.py) runs it", file=sys.stderr)
        return 2
    main_worker(cfg)
    return 0
