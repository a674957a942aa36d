#!/usr/bin/env python3
"""A/B of a change to the port's forward kernel source on one GPU.

    python3 tools/torch_kernel_ab.py --file hopper_mlp.cuh \\
        --replace "constexpr int CH_STAGES = 3;" "constexpr int CH_STAGES = 4;"

Copies ``nerf_pytorch_paeng_tpu_torch/kernels/csrc`` to
``build/kernel_ab/``, applies each ``--replace OLD NEW`` to ``--file``
there (OLD must occur exactly once), builds that copy's ``fused_mlp.cu``
with the port's nvcc flags, and times the forward kernels of the committed
build (base) and of the copy (variant) in turns, base, variant, variant,
base: K1 with bf16 outputs at 131072 x 192, K3 at 131072 x 64, K1 with
float32 outputs at 4096 x 192 and 4096 x 64, K7 on the 128^3 support
grid, K8 with bf16 outputs at 131072 x 164 points and with float32
outputs at 4096 x 192 (CUDA-event medians of 5 after one warm-up, seeded
inputs and weights as ``chip_smoke.py``'s).
Each variant row says whether its outputs equal the base's bit for bit.
Prints the card's name and power limit first.  Needs the card; the
backward's library is not touched.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import pathlib
import shutil
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from nerf_pytorch_paeng_tpu_torch.config import NerfConfig  # noqa: E402
from nerf_pytorch_paeng_tpu_torch.kernels import build  # noqa: E402
from nerf_pytorch_paeng_tpu_torch.kernels import fused_mlp as fm  # noqa: E402
from nerf_pytorch_paeng_tpu_torch.models.nerf import init_nerf  # noqa: E402
from nerf_pytorch_paeng_tpu_torch.ops.occupancy import (  # noqa: E402
    grid_points)


def variant_library(file: str, replacements):
    """The patched copy of csrc, built; a loader in ``fm._library``'s
    shape (the forward entry points' C signatures)."""
    d = ROOT / "build" / "kernel_ab"
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(build.SRC_DIR, d)
    path = d / file
    text = path.read_text()
    for old, new in replacements:
        if text.count(old) != 1:
            raise SystemExit(f"{old!r} occurs {text.count(old)} times in {file}")
        text = text.replace(old, new)
    path.write_text(text)
    out = d / "libfused_mlp.so"
    r = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                        str(d / "fused_mlp.cu")], stdout=subprocess.PIPE,
                       stderr=subprocess.STDOUT, text=True)
    if r.returncode:
        raise SystemExit(f"nvcc failed:\n{r.stdout[-4000:]}")
    for kernel, line in cs.ptxas_lines(r.stdout):
        if "wgmma" in kernel:
            print(f"variant ptxas {kernel}: {line}")
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.nerf_sigma_rays.argtypes = [p, p, p, p, p, i, i, i, i, p, p]
    lib.nerf_eval_rays.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i,
                                   p, p]
    lib.nerf_sigma_points.argtypes = [p, p, p, p, i, i, i, p]
    lib.nerf_eval_points.argtypes = [p, p, p, p, p, i, i, i, i, p]
    lib.nerf_sigma_rays.restype = lib.nerf_eval_rays.restype = i
    lib.nerf_sigma_points.restype = lib.nerf_eval_points.restype = i
    return lambda: lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--file", required=True,
                    help="a file of kernels/csrc, e.g. hopper_mlp.cuh")
    ap.add_argument("--replace", nargs=2, action="append", required=True,
                    metavar=("OLD", "NEW"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    os.chdir(ROOT)
    print(f"card: {cs.card_line()}", flush=True)
    base = fm._library
    base()                                  # the committed build
    variant = variant_library(args.file, args.replace)
    dev = torch.device("cuda")
    cfg = NerfConfig()
    packed = fm.pack_nerf(init_nerf(cfg, seed=1, device=dev), cfg,
                          device=dev)
    grid = grid_points(float(cfg.far), cs.SUPPORT_GRID, dev)
    plane_eval = cs.seeded_planes(131072, 164, seed=7000, device=dev)
    plane_train = cs.seeded_planes(4096, 192, seed=8192, device=dev)
    cases = [("K1 bf16 131072x192", fm.fused_mlp_eval_rays, "fine",
              cs.seeded_rays(131072, 192, seed=192, device=dev),
              torch.bfloat16),
             ("K3 bf16 131072x64", fm.fused_mlp_sigma_rays, "coarse",
              cs.seeded_rays(131072, 64, seed=64, device=dev),
              torch.bfloat16),
             ("K1 f32 4096x192", fm.fused_mlp_eval_rays, "fine",
              cs.seeded_rays(4096, 192, seed=192, device=dev), torch.float32),
             ("K1 f32 4096x64", fm.fused_mlp_eval_rays, "fine",
              cs.seeded_rays(4096, 64, seed=64, device=dev), torch.float32),
             ("K7 bf16 128^3", fm.fused_mlp_sigma, "coarse", (grid,),
              torch.bfloat16),
             ("K8 bf16 131072x164", fm.fused_mlp_eval, "fine", plane_eval,
              torch.bfloat16),
             ("K8 f32 4096x192", fm.fused_mlp_eval, "fine", plane_train,
              torch.float32)]
    ref = {}
    try:
        for label, lib in (("base", base), ("variant", variant),
                           ("variant", variant), ("base", base)):
            fm._cuda_lib.__defaults__ = (lib,)
            row = []
            for name, fn, which, inputs, dt in cases:
                ms, out = cs.cuda_ms(
                    lambda: fn(*inputs, packed[which], out_dtype=dt), reps=5)
                out = out if isinstance(out, tuple) else (out,)
                same = all(torch.equal(a, b)
                           for a, b in zip(out, ref.setdefault(name, out)))
                row.append(f"{name} {ms:.3f} ms"
                           + ("" if same else " (bits differ from base)"))
            print(f"{label}: " + "; ".join(row), flush=True)
    finally:
        fm._cuda_lib.__defaults__ = (base,)
    return 0


if __name__ == "__main__":
    sys.exit(main())
