"""Experiment driver: the standalone evaluation of a saved checkpoint.

Counterpart of the ``eval_only`` branch of the JAX package's
``driver.main_worker``: load the dataset, restore the weights saved at
``testing_idx``, pack them once for the fused kernels and run the
held-out-view evaluation.  The checkpoint is the reference format,
``logs/<exp>/<exp>_<testing_idx>.pth.tar`` holding ``model_state_dict``
(what ``tools/export_reference_ckpt.py`` writes, and what
``NeRF.state_dict()`` is).

Training and novel-view rendering are not ported yet; asking for them
exits non-zero with a message.
"""
from __future__ import annotations

import os
import sys
from typing import List, Optional

import torch

from .config import NerfConfig, load_config
from .data import load_blender
from .eval.test import run_test
from .kernels.fused_mlp import pack_nerf
from .models.nerf import NeRF
from .utils.device import resolve_device


def checkpoint_path(cfg: NerfConfig, step: int) -> str:
    """logs/<exp>/<exp>_<step>.pth.tar (the reference's naming)."""
    return os.path.join(cfg.logdir, cfg.exp_name,
                        f"{cfg.exp_name}_{step}.pth.tar")


def load_model(cfg: NerfConfig, step: int, device) -> NeRF:
    model = NeRF(depth=cfg.netDepth, width=cfg.netWidth, L_x=cfg.L_x,
                 L_d=cfg.L_d)
    ckpt = torch.load(checkpoint_path(cfg, step), map_location="cpu",
                      weights_only=True)
    model.load_state_dict(ckpt["model_state_dict"])
    return model.to(device).eval()


def main_worker(cfg: NerfConfig) -> dict:
    device = resolve_device(cfg.device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f">> device: {device} ({name})")
    if cfg.data_type != "blender":
        raise NotImplementedError(
            f"data_type={cfg.data_type!r}: only the blender loader is ported")
    print(f">> loading dataset [{cfg.data_type}] from {cfg.data_root!r}")
    images, (K, extrinsics), hw, i_split = load_blender(
        data_root=cfg.data_root, downsample=cfg.downsample,
        testskip=cfg.testskip, bkg_white=cfg.bkg_white)
    i_test = i_split[2]
    print(f">> dataset loaded: images {images.shape}, hw {hw}, "
          f"test views {len(i_test)}")
    model = load_model(cfg, cfg.testing_idx, device)
    packed = pack_nerf(model, cfg, device=device)
    return run_test(cfg.testing_idx, packed, images[i_test],
                    extrinsics[i_test], K, hw, cfg, device)


def main(argv: Optional[List[str]] = None) -> int:
    cfg = load_config(argv)
    if cfg.render_only or not cfg.eval_only:
        what = "novel-view rendering" if cfg.render_only else "training"
        print(f"nerf_pytorch_paeng_tpu_torch: {what} is not ported yet; "
              "run with --eval_only true (the JAX package, main.py, does "
              "the rest)", file=sys.stderr)
        return 2
    main_worker(cfg)
    return 0
