#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

1. Builds the port's CUDA kernels from the sources in the checkout.
2. Kernel phase: each kernel of the eval path at the shapes that path
   gives it (one block of 131072 rays; 64 coarse samples for the sigma
   kernel, 64+128 merged samples for the full-field kernel), seeded
   inputs and seeded weights: the kernel against its plain PyTorch
   version on the same inputs (stated tolerance), kernel and plain times
   (CUDA events, median after warm-up) and the least time the card could
   take for the work.
3. Slice phase: writes a synthetic 800x800 scene in the blender layout and
   a seeded reference-format checkpoint, then runs the port's
   ``--eval_only`` entry on configs/blender/lego.txt (8x256 MLP, 64+128
   samples, full resolution) with every launch counter at 0 before and
   read after; then renders one view again with the plain versions on
   the card and holds the two frames together (PSNR >= 35 dB).

Prints the card's name and power limit, one ``{"kernels": [...]}`` line,
and as its last line ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero before that line; so does a machine without CUDA or a directory
without the port.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12          # H100 SXM HBM3 rate
BLOCK = 131072
KERNEL_TOL = dict(max_abs=5e-2, rel_l2=1e-2)   # bf16 activation rounding
FRAME_PSNR_MIN = 35.0


def log(*a):
    print(*a, flush=True)


def check(ok: bool, what) -> None:
    """A failed check ends the run (asserts would vanish under -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1):
    """Median milliseconds of ``fn()`` over ``reps`` runs (CUDA events),
    and the last result."""
    for _ in range(warmup):
        out = fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), out


def errors(got, want):
    got = torch.stack([g.float() for g in got])
    want = torch.stack([w.float() for w in want])
    d = got - want
    return float(d.abs().max()), float(d.norm() / want.norm())


def seeded_rays(n: int, s: int, seed: int, device):
    """od [8, n] (origins on a radius-4 orbit shell, unnormalised
    directions through the scene centre region), sorted z_t [s, n] in
    [2, 6]: the shapes and value ranges of a blender block."""
    g = torch.Generator(device).manual_seed(seed)
    o = torch.randn(3, n, generator=g, device=device)
    o = 4.0 * o / o.norm(dim=0, keepdim=True)
    d = -o / 4.0 + 0.3 * torch.randn(3, n, generator=g, device=device)
    od = torch.cat([o, d, torch.zeros(2, n, device=device)]).contiguous()
    z = torch.sort(2.0 + 4.0 * torch.rand(s, n, generator=g, device=device),
                   0).values.contiguous()
    return od, z


def kernel_phase(fm, packed, cfg, device):
    """Every kernel against its plain version at main-path shapes."""
    rows = {}
    specs = (
        ("fused_mlp_sigma_rays", fm.fused_mlp_sigma_rays,
         fm.fused_mlp_sigma_rays_plain, packed["coarse"], 64,
         "nerf_pytorch_paeng_tpu/kernels/fused_mlp.py:277"),
        ("fused_mlp_eval_rays", fm.fused_mlp_eval_rays,
         fm.fused_mlp_eval_rays_plain, packed["fine"], 192,
         "nerf_pytorch_paeng_tpu/kernels/fused_mlp.py:446"),
    )
    for name, kern, plain, p, s, tpu_at in specs:
        od, z = seeded_rays(BLOCK, s, seed=s, device=device)
        kw = dict(out_dtype=torch.bfloat16)
        k_ms, k_out = cuda_ms(lambda: kern(od, z, p, **kw), reps=5)
        p_ms, p_out = cuda_ms(lambda: plain(od, z, p, **kw), reps=3)
        k_out = k_out if isinstance(k_out, tuple) else (k_out,)
        p_out = p_out if isinstance(p_out, tuple) else (p_out,)
        max_abs, rel_l2 = errors(k_out, p_out)
        # what bf16 operands cost against float32 on the same inputs (a
        # chunk of rays): the scale the kernel tolerance is set from
        chunk = slice(0, 8192)
        odc, zc = od[:, chunk].contiguous(), z[:, chunk].contiguous()
        ref = plain(odc, zc, fm.with_weight_dtype(p, torch.float32),
                    out_dtype=torch.float32)
        ref = ref if isinstance(ref, tuple) else (ref,)
        bf16_abs, bf16_rel = errors([o[:, chunk] for o in p_out], ref)
        n_out = len(k_out)
        flop = (fm.sigma_flop_per_sample(cfg.L_x) if n_out == 1
                else fm.eval_flop_per_sample(cfg.L_x)) * s * BLOCK
        if n_out == 4:
            flop += fm.eval_flop_per_ray(cfg.L_d) * BLOCK
        nbytes = (od.numel() * 4 + z.numel() * 4 + p["w"].numel() * 2
                  + p["b"].numel() * 4 + n_out * s * BLOCK * 2)
        t_ops, t_bytes = flop / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        log(f"kernel {name}: N={BLOCK} S={s} max_abs={max_abs:.3e} "
            f"rel_l2={rel_l2:.3e} (tolerance {KERNEL_TOL}; plain bf16 vs "
            f"float32: max_abs={bf16_abs:.3e} rel_l2={bf16_rel:.3e}) "
            f"ms={k_ms:.3f} plain_ms={p_ms:.3f} bound_ms={max(t_ops, t_bytes):.3f} "
            f"({flop / k_ms / 1e9:.1f} TFLOP/s)")
        check(max_abs <= KERNEL_TOL["max_abs"]
              and rel_l2 <= KERNEL_TOL["rel_l2"],
              f"{name} disagrees with its plain version")
        rows[name] = {
            "name": name, "route": "cuda",
            "source": "nerf_pytorch_paeng_tpu_torch/kernels/csrc/fused_mlp.cu",
            "replaces": tpu_at, "launches": None,
            "max_abs_err": max_abs, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None}
    return rows


def psnr(a, b) -> float:
    mse = float(torch.mean((a.float() - b.float()) ** 2))
    return math.inf if mse == 0 else -10.0 * math.log10(mse)


def profile_frame(render, packed, pose, seed: int, device) -> dict:
    """One frame under torch.profiler: device time by kernel and the
    device's idle share of the frame's wall time."""
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device).manual_seed(seed)
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render(packed, pose, gen)
        torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = {}     # device kernels only: CPU-op rows repeat their time
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0)) / 1e3
        if ms > 0:
            by_kernel[e.key] = (ms, e.count)
    busy = sum(ms for ms, _ in by_kernel.values())
    if busy == 0:
        log("profile: the profiler saw no device time (not measured)")
        return {"wall_ms": wall_ms, "device_busy_ms": None}
    log(f"profile: frame wall {wall_ms:.1f} ms under the profiler, device "
        f"busy {busy:.1f} ms, idle share {1 - busy / wall_ms:.3f}")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:8]
    for key, (ms, count) in top:
        log(f"  {ms:9.2f} ms {100 * ms / busy:5.1f}%  x{count:<4d} {key[:90]}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": 1 - busy / wall_ms,
            "top": [[k[:90], ms, n] for k, (ms, n) in top]}


def slice_phase(fm, work: str, device):
    from nerf_pytorch_paeng_tpu_torch import driver
    from nerf_pytorch_paeng_tpu_torch.config import load_config
    from nerf_pytorch_paeng_tpu_torch.eval.frame import make_frame_renderer
    from nerf_pytorch_paeng_tpu_torch.models.nerf import init_nerf
    from nerf_pytorch_paeng_tpu_torch.utils.synth import \
        save_as_blender_dataset

    data_root = os.path.join(work, "lego_synth")
    t0 = time.perf_counter()
    save_as_blender_dataset(data_root, n_train=1, n_val=1, n_test=3,
                            H=800, W=800)
    log(f"slice: synthetic 800x800 blender scene written "
        f"({time.perf_counter() - t0:.1f} s)")
    argv = ["--config", os.path.join(HERE, "configs/blender/lego.txt"),
            "--eval_only", "true", "--testing_idx", "1",
            "--data_root", data_root, "--log_dir", os.path.join(work, "logs")]
    cfg = load_config(argv)
    ckpt = driver.checkpoint_path(cfg, cfg.testing_idx)
    os.makedirs(os.path.dirname(ckpt), exist_ok=True)
    torch.save({"idx": cfg.testing_idx,
                "model_state_dict": init_nerf(cfg, seed=0).state_dict()}, ckpt)

    fm.fused_mlp_sigma_rays.launches = 0
    fm.fused_mlp_eval_rays.launches = 0
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    res = driver.main_worker(cfg)              # the --eval_only entry
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    launches = {"fused_mlp_sigma_rays": fm.fused_mlp_sigma_rays.launches,
                "fused_mlp_eval_rays": fm.fused_mlp_eval_rays.launches}
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    log(f"slice: launches {launches}, eval wall {wall:.2f} s, "
        f"peak device memory {peak_gb:.2f} GB")

    n_views = len(res["psnr"])
    per_frame = -(-800 * 800 // BLOCK)
    check(n_views == 3, f"{n_views} test views")
    for name, n in launches.items():
        check(n == n_views * per_frame, (name, n, n_views * per_frame))
    result_txt = os.path.join(cfg.logdir, cfg.exp_name,
                              f"{cfg.exp_name}_{cfg.testing_idx}",
                              "test_result", "_result.txt")
    check(os.path.isfile(result_txt), result_txt)
    check(all(math.isfinite(v) for v in res["psnr"] + res["ssim"]),
          "non-finite test metrics")
    frame_ms = [t * 1e3 for t in res["frame_s"]]
    log(f"slice: frame device ms {['%.1f' % t for t in frame_ms]} "
        f"(CUDA events; first includes warm-up), their sum "
        f"{sum(frame_ms) / 1e3:.2f} s of the eval wall {wall:.2f} s; "
        f"test PSNR {res['psnr']} SSIM {res['ssim']} LPIPS {res['lpips']}")

    # one view again, kernels and plain versions on the card, same draws
    from nerf_pytorch_paeng_tpu_torch.data import load_blender
    from nerf_pytorch_paeng_tpu_torch.kernels.fused_mlp import pack_nerf
    model = driver.load_model(cfg, cfg.testing_idx, device)
    packed = pack_nerf(model, cfg, device=device)
    _, (K, ext), (H, W), i_split = load_blender(
        data_root, cfg.bkg_white, cfg.downsample, cfg.testskip)
    pose = torch.as_tensor(ext[i_split[2][0]][:3, :4])
    frames = {}
    for label, kw in (("kernels", {}),
                      ("plain", dict(sigma_fn=fm.fused_mlp_sigma_rays_plain,
                                     field_fn=fm.fused_mlp_eval_rays_plain))):
        render = make_frame_renderer(cfg, H, W, K, device, **kw)
        gen = torch.Generator(device).manual_seed(cfg.seed + cfg.testing_idx)
        t0 = time.perf_counter()
        frames[label] = render(packed, pose, gen)
        torch.cuda.synchronize(device)
        frames[label + "_s"] = time.perf_counter() - t0
    rgb_k, disp_k = frames["kernels"]
    rgb_p, disp_p = frames["plain"]
    check(rgb_k.shape == (H, W, 3) and bool(torch.isfinite(rgb_k).all())
          and bool(torch.isfinite(disp_k).all()), "frame shape or finiteness")
    p_rgb = psnr(rgb_k, rgb_p)
    log(f"slice: view 0 kernels vs plain PSNR {p_rgb:.2f} dB "
        f"(min {FRAME_PSNR_MIN}), disp max abs "
        f"{float((disp_k - disp_p).abs().max()):.3e}; frame "
        f"{frames['kernels_s'] * 1e3:.1f} ms kernels, "
        f"{frames['plain_s'] * 1e3:.1f} ms plain")
    check(p_rgb >= FRAME_PSNR_MIN, f"kernels vs plain frame {p_rgb} dB")
    render = make_frame_renderer(cfg, H, W, K, device)
    prof = profile_frame(render, packed, pose, cfg.seed + cfg.testing_idx,
                         device)
    return launches, dict(profile=prof, frame_ms=frame_ms, eval_wall_s=wall,
                          psnr=res["psnr"],
                          ssim=res["ssim"], kernels_vs_plain_psnr=p_rgb,
                          peak_gb=peak_gb, H=H, W=W,
                          launches_per_frame=per_frame)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from nerf_pytorch_paeng_tpu_torch.config import NerfConfig
    from nerf_pytorch_paeng_tpu_torch.kernels import build
    from nerf_pytorch_paeng_tpu_torch.kernels import fused_mlp as fm
    from nerf_pytorch_paeng_tpu_torch.models.nerf import init_nerf

    torch.backends.cuda.matmul.allow_tf32 = False     # plain versions: fp32
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    lib = build.build("fused_mlp")
    log(f"build: fused_mlp.cu in {time.perf_counter() - t0:.1f} s")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas:", line.strip())

    cfg = NerfConfig()
    packed = fm.pack_nerf(init_nerf(cfg, seed=1, device=device), cfg,
                          device=device)
    rows = kernel_phase(fm, packed, cfg, device)

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        launches, stats = slice_phase(fm, work, device)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for name, n in launches.items():
        check(n > 0, f"{name} never launched on the main path")
        rows[name]["launches"] = n

    log(json.dumps({"slice": stats}))
    log(json.dumps({"kernels": list(rows.values())}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
