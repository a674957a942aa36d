"""Held-out-view evaluation ("test" in the reference's vocabulary).

Counterpart of the JAX package's ``eval/test.run_test``: render every test
pose full-frame through the exact dense renderer, write ``{i:03d}.png`` and
``{i:03d}_disp.png`` (disparity normalised by its max), compute
PSNR/SSIM/LPIPS, and write ``_result.txt`` with per-view lines plus best
and mean summaries in the reference format.  Under a process group every
rank renders its part of each frame (``eval/frame.py``) and rank 0 alone
scores the frames and writes the images, the logs and ``_result.txt``.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from .. import parallel
from ..utils.image import imwrite
from ..utils.metrics import to8b
from .frame import make_frame_renderer
from .metrics import load_lpips_params, lpips_tensor, ssim_tensor
from .pipeline import pipelined_frames, to_host


def run_test(idx: int, packed, test_imgs, test_poses, K, hw, cfg,
             device, save_dir: Optional[str] = None, verbose: bool = True):
    """Evaluate on the held-out split; returns the per-view metrics dict
    (plus ``frame_s``, each frame's render time: on the card the device
    time between CUDA events around the frame, on the CPU the host clock).

    ``packed``: both MLPs from ``kernels.fused_mlp.pack_nerf``;
    ``test_imgs`` [T, H, W, 3] numpy, ``test_poses`` [T, 3or4, 4].
    Metric-reporting evaluation always renders through the exact dense
    path (``render_cull="none"``), as the JAX package does.

    On the card, frame i's SSIM and LPIPS and its copies to pinned host
    memory are queued right behind its render, and frame i+1 is queued
    before frame i is drained (PSNR, PNG encoding), so that host work
    overlaps the next frame's device work.  Under a process group the
    other ranks render and return only ``frame_s``."""
    H, W = hw
    device = torch.device(device)
    main = parallel.is_main()
    if save_dir is None:
        save_dir = os.path.join(cfg.logdir, cfg.exp_name,
                                f"{cfg.exp_name}_{idx}", "test_result")
    if main:
        os.makedirs(save_dir, exist_ok=True)
    renderer = make_frame_renderer(
        dataclasses.replace(cfg, render_cull="none"), H, W, K, device)
    # every rank loads (and so validates) the weights: a bad path must
    # stop every rank, not leave the others waiting in a collective
    lpips_params = load_lpips_params(cfg.lpips_weights, device)

    poses = np.asarray(test_poses)
    if len(poses) == 0:
        if main:
            with open(os.path.join(save_dir, "_result.txt"), "w") as f:
                f.write("no test views\n")
        return dict(mse=[], psnr=[], ssim=[], lpips=[], frame_s=[],
                    mean_psnr=float("nan"), mean_ssim=float("nan"),
                    mean_lpips=float("nan"))

    n = len(poses)
    psnrs, ssims, lpipss, losses = [0.0] * n, [0.0] * n, [0.0] * n, [0.0] * n
    frame_s = [0.0] * n
    generator = torch.Generator(device).manual_seed(cfg.seed + idx)

    def _scores(rgb, gt):
        """SSIM and LPIPS as device tensors (no LPIPS without weights)."""
        if lpips_params is None:
            return (ssim_tensor(rgb, gt),)
        return ssim_tensor(rgb, gt), lpips_tensor(rgb, gt, lpips_params)

    def _render(i, pose):
        c2w = torch.as_tensor(pose[:3, :4])
        gt = None
        if main:
            # a pageable upload: waits until the previous frame has drained
            gt = torch.as_tensor(np.asarray(test_imgs[i], np.float32),
                                 device=device)
        if device.type == "cpu":
            t0 = time.perf_counter()
            rgb, disp = renderer(packed, c2w, generator)
            frame_s[i] = time.perf_counter() - t0
            return None if gt is None else (rgb, disp, _scores(rgb, gt),
                                             None)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        rgb, disp = renderer(packed, c2w, generator)
        end.record()
        if gt is None:
            return None, None, None, (start, end, end)
        host = [to_host(t) for t in (rgb, disp, *_scores(rgb, gt))]
        copied = torch.cuda.Event()
        copied.record()
        return host[0], host[1], host[2:], (start, end, copied)

    def _drain(i, out, submit):
        if out is None:
            return
        rgb, disp, scores, events = out
        if events is not None:
            start, end, copied = events
            copied.synchronize()
            frame_s[i] = start.elapsed_time(end) / 1e3
        if not main:
            return
        rgb_np, disp_np = rgb.float().numpy(), disp.float().numpy()
        submit(imwrite, os.path.join(save_dir, f"{i:03d}.png"),
               to8b(rgb_np))
        dmax = np.nanmax(disp_np)
        submit(imwrite, os.path.join(save_dir, f"{i:03d}_disp.png"),
               to8b(disp_np / dmax if dmax > 0 else disp_np))

        gt = np.asarray(test_imgs[i], np.float32)
        mse = float(np.mean((rgb_np - gt) ** 2))
        psnr = -10.0 * np.log10(mse)
        ssim = float(scores[0])
        lpips = float(scores[1]) if len(scores) > 1 else float("nan")
        losses[i], psnrs[i], ssims[i], lpipss[i] = mse, psnr, ssim, lpips
        if verbose:
            print(f"test view {i}: mse={mse:.6f} psnr={psnr:.2f} "
                  f"ssim={ssim:.4f} lpips={lpips:.4f} "
                  f"frame={frame_s[i] * 1e3:.1f} ms")

    pipelined_frames(poses, _render, _drain)
    if not main:
        return dict(frame_s=frame_s)

    # _result.txt in the reference's format (test.py:92-108)
    with open(os.path.join(save_dir, "_result.txt"), "w") as f:
        for i in range(n):
            f.write(f"idx:{i}\tloss:{losses[i]}\tpsnr:{psnrs[i]}\t"
                    f"ssim:{ssims[i]}\tlpips:{lpipss[i]}\n")
        best = dict(psnr=max(psnrs), ssim=max(ssims),
                    lpips=min(lpipss) if not np.isnan(lpipss).all() else
                    float("nan"))
        f.write(f"\nBest Value ) PSNR : {best['psnr']}\tSSIM : "
                f"{best['ssim']}\tLPIPS : {best['lpips']}\n")
        f.write(f"Mean Value ) PSNR : {np.mean(psnrs)}\tSSIM : "
                f"{np.mean(ssims)}\tLPIPS : {np.mean(lpipss)}")

    return dict(mse=losses, psnr=psnrs, ssim=ssims, lpips=lpipss,
                frame_s=frame_s, mean_psnr=float(np.mean(psnrs)),
                mean_ssim=float(np.mean(ssims)),
                mean_lpips=float(np.mean(lpipss)))
