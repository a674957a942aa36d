#!/usr/bin/env python3
"""A/B of the eager train step's host syncs on one GPU.

    python3 tools/torch_step_sync_ab.py [--steps 64] [--out FILE]

Runs the port's training entry (``driver.main_worker``) with lego's
configuration at full width (4,096 rays, 64+128 samples, per-image) on a
synthetic 800x800 scene at lego's field of view, ``--scan_chunk 1`` (every
step eager), in four variants that put back, in this process, the host
syncs that the eager step no longer makes:

- ``now``: the port as it is;
- ``cumprod``: the transmittance through ``torch.cumprod``, whose backward
  checks its input for zeros with a host read (one a pass, two a step),
  instead of ``ops/volume._Cumprod``;
- ``copies``: the embedding permutation (``kernels/fused_mlp.emb_perm``,
  twice a packing, two packings a step) and the intrinsics ``K`` (once a
  step) copied from the host at every step, instead of once; a copy from
  pageable host memory waits for the stream;
- ``both``.

And ``graphs``: the port as it is at ``--scan_chunk 16``.  The order is
now, cumprod, copies, both, graphs, graphs, both, copies, cumprod, now.
Each run prints its median step over steps 17 to the end (``step_s``: CUDA
events at chunk boundaries, a chunk's time over its steps), its losses'
agreement with the first ``now`` run, and at the end one JSON line (also
written to ``--out``).  Prints the card's name and power limit first.
Needs the card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import types
from unittest import mock

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
LEGO_CAMERA_ANGLE_X = 0.6911112070083618       # lego's transforms_*.json
FIRST = 16                                     # steps left out of a median
ORDER = ("now", "cumprod", "copies", "both", "graphs",
         "graphs", "both", "copies", "cumprod", "now")


@contextlib.contextmanager
def variant(name: str):
    """The patches of one variant (none for ``now`` and ``graphs``)."""
    from nerf_pytorch_paeng_tpu_torch.kernels import fused_mlp
    from nerf_pytorch_paeng_tpu_torch.ops import volume
    from nerf_pytorch_paeng_tpu_torch.train import step
    with contextlib.ExitStack() as stack:
        if name in ("cumprod", "both"):
            stack.enter_context(mock.patch.object(
                volume, "_Cumprod", types.SimpleNamespace(apply=torch.cumprod)))
        if name in ("copies", "both"):
            stack.enter_context(mock.patch.object(
                fused_mlp, "_emb_index", lambda L, device: torch.as_tensor(
                    fused_mlp.emb_perm(L), device=device)))
            host_k = {}
            get_rays = step.get_rays

            def get_rays_from_host(H, W, K, pose):
                if id(K) not in host_k:              # once, before timing
                    host_k[id(K)] = K.cpu().numpy().astype(np.float64)
                return get_rays(H, W, host_k[id(K)], pose)
            stack.enter_context(mock.patch.object(step, "get_rays",
                                                  get_rays_from_host))
        yield


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_step_sync_ab: needs a CUDA device", file=sys.stderr)
        return 1
    from nerf_pytorch_paeng_tpu_torch import driver
    from nerf_pytorch_paeng_tpu_torch.config import load_config
    from nerf_pytorch_paeng_tpu_torch.kernels import build
    from nerf_pytorch_paeng_tpu_torch.utils.synth import \
        save_as_blender_dataset

    card = card_line()
    print(f"card: {card}; torch {torch.__version__} CUDA {torch.version.cuda}",
          flush=True)
    build.build_all(("fused_mlp", "fused_mlp_vjp"))
    work = tempfile.mkdtemp(prefix="step_sync_ab_")
    data_root = os.path.join(work, "lego_synth")
    save_as_blender_dataset(data_root, n_train=4, n_val=1, n_test=1, H=800,
                            W=800, camera_angle_x=LEGO_CAMERA_ANGLE_X)
    runs, ref = [], None
    for j, name in enumerate(ORDER):
        chunk = 16 if name == "graphs" else 1
        cfg = load_config([
            "--config", os.path.join(ROOT, "configs/blender/lego.txt"),
            "--data_root", data_root, "--log_dir", os.path.join(work, "logs"),
            "--exp_name", f"{name}_{j}", "--iter_N", str(args.steps),
            "--iter_warmup", "0", "--idx_test", "0", "--idx_vis", "0",
            "--idx_print", "0", "--idx_save", "0",
            "--scan_chunk", str(chunk)])
        with variant(name):
            res = driver.main_worker(cfg)
        ms = [t * 1e3 for t in res["step_s"]]
        if ref is None:
            ref = res["loss"]
        run = dict(variant=name, scan_chunk=chunk,
                   median_step_ms=statistics.median(ms[FIRST:]),
                   min_step_ms=min(ms[FIRST:]), max_step_ms=max(ms[FIRST:]),
                   losses_equal_now=res["loss"] == ref,
                   replays=res["graph_replays"])
        runs.append(run)
        print(f"ab {name:8s} scan_chunk {chunk:2d}: median step "
              f"{run['median_step_ms']:.3f} ms (steps {FIRST + 1}-"
              f"{args.steps}, {run['min_step_ms']:.3f}-"
              f"{run['max_step_ms']:.3f}); losses equal to now: "
              f"{run['losses_equal_now']}; {card}", flush=True)
    out = {"step_sync_ab": {"card": card, "steps": args.steps,
                            "runs": runs}}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
