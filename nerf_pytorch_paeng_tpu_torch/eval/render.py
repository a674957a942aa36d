"""Novel-view rendering and video export.

Counterpart of the JAX package's ``eval/render.run_render``: the orbit
poses of ``data/render_pose.get_render_pose`` for blender and custom
data, the dataset's spiral (``render_poses`` from ``data/llff.py``) for
LLFF, each frame through the frame renderer the config selects (the
culled one by default), ``{i}_rgb.png`` and ``{i}_disp.png`` per frame
(disparity normalised by its max), and ``_rgb`` / ``_disp`` as a gif or
an mp4.  ``single_angle != -1`` renders one still, written twice, as the
reference does.

The machine the port targets has no imageio, so a gif goes through
Pillow (40 ms a frame, looping) and an mp4 through OpenCV's
``VideoWriter`` (``mp4v``, 30 fps).  imageio's ``quality=8`` has no
counterpart there: OpenCV's mp4v writer takes no quality setting.

Under a process group every rank renders its part of each frame
(``eval/frame.py``) and holds the whole frames; rank 0 alone writes the
images and videos and prints.
"""
from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from .. import parallel
from ..data.render_pose import get_render_pose
from ..utils.image import imwrite
from ..utils.metrics import to8b
from ..utils.spans import setup_table
from .frame import make_frame_renderer
from .pipeline import pipelined_frames, to_host


def write_gif(path: str, frames: np.ndarray, ms_per_frame: int = 40) -> None:
    """uint8 [T, H, W(, 3)] -> a looping gif."""
    from PIL import Image
    images = [Image.fromarray(np.ascontiguousarray(f)) for f in frames]
    images[0].save(path, save_all=True, append_images=images[1:],
                   duration=ms_per_frame, loop=0)


def write_mp4(path: str, frames: np.ndarray, fps: int = 30) -> None:
    """uint8 [T, H, W(, 3)] RGB or grey -> an mp4 (``mp4v``)."""
    import cv2
    h, w = frames.shape[1:3]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (w, h))
    if not writer.isOpened():
        raise RuntimeError(f"cv2.VideoWriter could not open {path}")
    try:
        for f in frames:
            bgr = (cv2.cvtColor(f, cv2.COLOR_GRAY2BGR) if f.ndim == 2
                   else cv2.cvtColor(np.ascontiguousarray(f),
                                     cv2.COLOR_RGB2BGR))
            writer.write(bgr)
    finally:
        writer.release()


def run_render(idx: int, packed, K, hw, cfg, device,
               render_poses: Optional[np.ndarray] = None,
               save_dir: Optional[str] = None, verbose: bool = True) -> dict:
    """Render the novel-view path with the weights ``packed``
    (``kernels.fused_mlp.pack_nerf``) and write the frames and videos.

    Returns ``{"rgbs" [T, H, W, 3], "disps" [T, H, W] (normalised), the
    numpy frames; "frame_s": each frame's render time (on the card the
    device time between CUDA events around the frame, on the CPU the host
    clock); "stats": the culled renderer's per-frame records (empty for
    the dense one); "save_dir"; "spans": the process's set-up spans,
    ``utils/spans.setup_table``}``."""
    H, W = hw
    device = torch.device(device)
    if cfg.data_type in ("blender", "custom"):
        render_poses = get_render_pose(n_angle=cfg.n_angle,
                                       single_angle=cfg.single_angle,
                                       phi=cfg.phi, nf=cfg.nf)
    if render_poses is None:
        raise ValueError(f"data_type={cfg.data_type!r} needs render_poses")
    if save_dir is None:
        save_dir = os.path.join(cfg.logdir, cfg.exp_name,
                                f"{cfg.exp_name}_{idx}", "render_result")
    main = parallel.is_main()
    if main:
        os.makedirs(save_dir, exist_ok=True)

    renderer = make_frame_renderer(cfg, H, W, K, device)
    generator = torch.Generator(device).manual_seed(cfg.seed + idx + 1)
    poses = np.asarray(render_poses)
    n = len(poses)
    rgbs, disps, frame_s = [None] * n, [None] * n, [0.0] * n

    def _render(i, pose):
        c2w = torch.as_tensor(pose[:3, :4])
        if device.type == "cpu":
            t0 = time.perf_counter()
            rgb, disp = renderer(packed, c2w, generator)
            frame_s[i] = time.perf_counter() - t0
            return rgb, disp, None
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        rgb, disp = renderer(packed, c2w, generator)
        end.record()
        host = [to_host(t) for t in (rgb, disp)]
        copied = torch.cuda.Event()
        copied.record()
        return (*host, (start, end, copied))

    def _drain(i, out, submit):
        rgb, disp, events = out
        if events is not None:
            start, end, copied = events
            copied.synchronize()
            frame_s[i] = start.elapsed_time(end) / 1e3
        rgb_np, disp_np = rgb.float().numpy(), disp.float().numpy()
        dmax = np.nanmax(disp_np)
        disp_np = disp_np / dmax if dmax > 0 else disp_np
        rgbs[i], disps[i] = rgb_np, disp_np
        if not main:
            return
        if verbose:
            print(f"render view {i}/{n}: frame {frame_s[i] * 1e3:.1f} ms")
        # a still is written twice, named and numbered, as the reference
        # does (its numbered copy is not to8b'd; this one is)
        if cfg.single_angle != -1:
            submit(imwrite, os.path.join(
                save_dir, f"{cfg.single_angle}_{cfg.phi}_{cfg.nf}_rgb.png"),
                to8b(rgb_np))
        submit(imwrite, os.path.join(save_dir, f"{i}_rgb.png"), to8b(rgb_np))
        submit(imwrite, os.path.join(save_dir, f"{i}_disp.png"),
               to8b(disp_np))

    pipelined_frames(poses, _render, _drain)
    rgbs, disps = np.stack(rgbs, 0), np.stack(disps, 0)
    if cfg.single_angle == -1 and main:
        write = write_mp4 if cfg.render_type == "mp4" else write_gif
        for name, frames in (("_rgb", rgbs), ("_disp", disps)):
            write(os.path.join(save_dir, f"{name}.{cfg.render_type}"),
                  to8b(frames))
    return dict(rgbs=rgbs, disps=disps, frame_s=frame_s,
                stats=list(getattr(renderer, "stats", [])),
                save_dir=save_dir, spans=setup_table())
