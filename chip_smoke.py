#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

1. Builds the port's CUDA kernels from the sources in the checkout (one
   nvcc per source, all at once).
2. Kernel phase: each kernel at the shapes its paths give it, seeded
   inputs and seeded weights, against its plain PyTorch version on the
   same inputs (stated tolerance), with kernel and plain times (CUDA
   events, median after warm-up) and the least time the card could take
   for the work: the sigma kernel (K3) and the full-field kernel (K1) at
   the eval block (131072 rays; 64, and 64+128 merged samples); K1 with
   float32 outputs and the backward kernel (K2) at the training batch
   (4096 rays; 64 and 192 samples); K2 launched twice must give the same
   bits.
3. Eval phase: writes a synthetic 800x800 scene in the blender layout and
   a seeded reference-format checkpoint, then runs the port's
   ``--eval_only`` entry on configs/blender/lego.txt (8x256 MLP, 64+128
   samples, full resolution); then renders one view again with the plain
   versions on the card and holds the two frames together (PSNR >= 35 dB).
4. Training phase: the port's training entry (``driver.main_worker``) on
   configs/blender/lego.txt at full width (4096 rays, 64+128 samples,
   per-image sampling) on the same scene: every step must launch K1 and
   K2 twice (once per pass), the losses must be finite and fall; step
   times, one step under the profiler and the peak device memory.  Then
   N steps, a checkpoint, a resume to 2N in a fresh ``main_worker``,
   against 2N uninterrupted steps: the saved states must be bit-equal.

Each path runs with every launch counter at 0 before and is read after.
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
TRAIN_RAYS = 4096
KERNEL_TOL = dict(max_abs=5e-2, rel_l2=1e-2)   # bf16 activation rounding
# K2 against its plain version on the card, per packed tensor: cosine at
# least 0.999 and relative L2 at most 1e-2, or three times the floor where
# that is more.  Both round at the same points and differ only in
# summation order, but a bf16 rounding that flips with the order travels
# down the chain; the floor is that effect on the plain version alone, its
# distance to the same computation on the CPU, measured in the same run
# (the kernel's distance is another draw of the same noise).
GRAD_TOL = dict(rel_l2=1e-2, floor_factor=3.0, cos=0.999)
FRAME_PSNR_MIN = 35.0
TRAIN_STEPS = 60
RESUME_STEPS = 5


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


def grad_errors(fm, got, want, other):
    """Per packed tensor of (dw, db): the relative L2 and cosine of ``got``
    against ``want``, and the floor (``other`` against ``want``).  Returns
    the worst tensor's (rel, its limit, name), the lowest cosine and the
    max abs difference over all of them."""
    g, w, o = (fm._with_views(*(t.cpu() for t in x))
               for x in (got, want, other))
    worst, worst_cos = (0.0, 0.0, None), 1.0
    for name in g:
        if name in ("w", "b"):
            continue
        a, b, c = (x[name].double().flatten() for x in (g, w, o))
        if float(b.norm()) == 0.0:
            check(float(a.norm()) == 0.0, f"K2 {name}: nonzero where plain is 0")
            continue
        rel = float((a - b).norm() / b.norm())
        limit = max(GRAD_TOL["rel_l2"],
                    GRAD_TOL["floor_factor"] * float((c - b).norm() / b.norm()))
        if rel / limit > worst[0] / max(worst[1], 1e-30):
            worst = (rel, limit, name)
        worst_cos = min(worst_cos, float(a @ b / (a.norm() * b.norm())))
    max_abs = max(float((x - y).abs().max()) for x, y in zip(got, want))
    return worst, worst_cos, max_abs


def loss_like_cotangents(outs, seed: int, device):
    """Cotangents shaped like a training loss's: d/d logit of a mean
    squared error of sigmoid(logit) against a seeded per-ray target."""
    g = torch.Generator(device).manual_seed(seed)
    s, n = outs[0].shape
    tgt = torch.rand(4, n, generator=g, device=device)
    cots = []
    for i, o in enumerate(outs):
        sg = torch.sigmoid(o)
        cots.append(((sg - tgt[i]) * sg * (1 - sg) * (2.0 / (n * s)))
                    .contiguous())
    return cots


def train_kernel_phase(fm, fv, packed, cfg, device):
    """K1 (float32 outputs) and K2 at the training batch: 4096 rays, the
    coarse pass's 64 and the fine pass's 192 samples."""
    n = TRAIN_RAYS
    shapes, k2_row = [], None
    for s in (cfg.N_samples_c, cfg.N_samples_c + cfg.N_samples_f):
        od, z = seeded_rays(n, s, seed=1000 + s, device=device)
        p = packed["fine"]
        k1_ms, outs = cuda_ms(lambda: fm.fused_mlp_eval_rays(od, z, p), reps=5)
        k1_plain_ms, plain_outs = cuda_ms(
            lambda: fm.fused_mlp_eval_rays_plain(od, z, p), reps=3)
        k1_abs, k1_rel = errors(outs, plain_outs)
        check(k1_abs <= KERNEL_TOL["max_abs"] and k1_rel <= KERNEL_TOL["rel_l2"],
              f"K1 float32 at ({n}, {s}) disagrees with its plain version")
        k1_flop = (fm.eval_flop_per_sample(cfg.L_x) * s
                   + fm.eval_flop_per_ray(cfg.L_d)) * n
        k1_bound = k1_flop / PEAK_BF16_FLOPS * 1e3

        cots = loss_like_cotangents(outs, seed=2000 + s, device=device)
        k2_ms, got = cuda_ms(lambda: fv.fused_mlp_bwd_rays(od, z, *cots, p),
                             reps=5)
        again = fv.fused_mlp_bwd_rays(od, z, *cots, p)
        torch.cuda.synchronize()
        check(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]),
              f"K2 at ({n}, {s}): two launches differ")
        k2_plain_ms, want = cuda_ms(
            lambda: fv.fused_mlp_bwd_rays_plain(od, z, *cots, p), reps=1)
        other = fv.fused_mlp_bwd_rays_plain(
            od.cpu(), z.cpu(), *(c.cpu() for c in cots),
            fm._with_views(p["w"].cpu(), p["b"].cpu()))
        (rel, limit, at), cos, max_abs = grad_errors(fm, got, want, other)
        flop = fm.bwd_flop_per_sample(cfg.L_x, cfg.L_d) * s * n
        nbytes = (od.numel() + 5 * z.numel()) * 4 + p["w"].numel() * 2 \
            + p["b"].numel() * 4 + (fm.W_TOTAL + fm.B_TOTAL) * 4
        t_ops, t_bytes = flop / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        log(f"kernel fused_mlp_eval_rays (float32 out): N={n} S={s} "
            f"max_abs={k1_abs:.3e} rel_l2={k1_rel:.3e} ms={k1_ms:.3f} "
            f"plain_ms={k1_plain_ms:.3f} bound_ms={k1_bound:.3f} "
            f"({k1_flop / k1_ms / 1e9:.1f} TFLOP/s)")
        log(f"kernel fused_mlp_bwd_rays: N={n} S={s} worst rel_l2={rel:.3e} "
            f"against its limit {limit:.3e} ({at}) min cos={cos:.6f} "
            f"max_abs={max_abs:.3e} (tolerance {GRAD_TOL}; two launches "
            f"bit-identical) ms={k2_ms:.3f} "
            f"plain_ms={k2_plain_ms:.3f} bound_ms={max(t_ops, t_bytes):.3f} "
            f"({flop / k2_ms / 1e9:.1f} TFLOP/s of gradient products)")
        check(rel <= limit and cos >= GRAD_TOL["cos"],
              f"K2 at ({n}, {s}) disagrees with its plain version")
        shapes.append(dict(N=n, S=s, k1_ms=k1_ms, k1_plain_ms=k1_plain_ms,
                           k1_bound_ms=k1_bound, k1_max_abs=k1_abs,
                           k2_ms=k2_ms, k2_plain_ms=k2_plain_ms,
                           k2_bound_ms=max(t_ops, t_bytes), k2_rel_l2=rel,
                           k2_rel_l2_limit=limit, k2_worst=at, k2_cos=cos,
                           k2_max_abs=max_abs))
        k2_row = {
            "name": "fused_mlp_bwd_rays", "route": "cuda",
            "source": "nerf_pytorch_paeng_tpu_torch/kernels/csrc/fused_mlp_vjp.cu",
            "replaces": "nerf_pytorch_paeng_tpu/kernels/fused_mlp_vjp.py:251",
            "launches": None, "max_abs_err": max_abs, "ms": k2_ms,
            "plain_ms": k2_plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None}
    return k2_row, shapes


def psnr(a, b) -> float:
    mse = float(torch.mean((a.float() - b.float()) ** 2))
    return math.inf if mse == 0 else -10.0 * math.log10(mse)


def profile_call(fn, what: str, device) -> dict:
    """``fn()`` under torch.profiler: device time by kernel and the
    device's idle share of the call's wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
    log(f"profile: {what} wall {wall_ms:.1f} ms under the profiler, device "
        f"busy {busy:.1f} ms, idle share {1 - busy / wall_ms:.3f}")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:8]
    for key, (ms, count) in top:
        log(f"  {ms:9.2f} ms {100 * ms / busy:5.1f}%  x{count:<4d} {key[:90]}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": 1 - busy / wall_ms,
            "top": [[k[:90], ms, n] for k, (ms, n) in top]}


def launch_counters() -> dict:
    """Every kernel wrapper of the port, by name."""
    from nerf_pytorch_paeng_tpu_torch.kernels import fused_mlp as fm
    from nerf_pytorch_paeng_tpu_torch.kernels import fused_mlp_vjp as fv
    return {"fused_mlp_sigma_rays": fm.fused_mlp_sigma_rays,
            "fused_mlp_eval_rays": fm.fused_mlp_eval_rays,
            "fused_mlp_bwd_rays": fv.fused_mlp_bwd_rays}


def zero_launches() -> None:
    for fn in launch_counters().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in launch_counters().items()}


def slice_phase(fm, work: str, data_root: str, device):
    from nerf_pytorch_paeng_tpu_torch import driver
    from nerf_pytorch_paeng_tpu_torch.config import load_config
    from nerf_pytorch_paeng_tpu_torch.eval.frame import make_frame_renderer
    from nerf_pytorch_paeng_tpu_torch.models.nerf import init_nerf

    argv = ["--config", os.path.join(HERE, "configs/blender/lego.txt"),
            "--eval_only", "true", "--testing_idx", "1",
            "--data_root", data_root, "--log_dir", os.path.join(work, "logs")]
    cfg = load_config(argv)
    ckpt = driver.checkpoint_path(cfg, cfg.testing_idx)
    os.makedirs(os.path.dirname(ckpt), exist_ok=True)
    torch.save({"idx": cfg.testing_idx,
                "model_state_dict": init_nerf(cfg, seed=0).state_dict()}, ckpt)

    zero_launches()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    res = driver.main_worker(cfg)              # the --eval_only entry
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    log(f"slice: launches {launches}, eval wall {wall:.2f} s, "
        f"peak device memory {peak_gb:.2f} GB")

    n_views = len(res["psnr"])
    per_frame = -(-800 * 800 // BLOCK)
    check(n_views == 3, f"{n_views} test views")
    for name in ("fused_mlp_sigma_rays", "fused_mlp_eval_rays"):
        check(launches[name] == n_views * per_frame,
              (name, launches[name], n_views * per_frame))
    check(launches["fused_mlp_bwd_rays"] == 0, "the eval ran the backward")
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
    gen = torch.Generator(device).manual_seed(cfg.seed + cfg.testing_idx)
    prof = profile_call(lambda: render(packed, pose, gen), "frame", device)
    return launches, dict(profile=prof, frame_ms=frame_ms, eval_wall_s=wall,
                          psnr=res["psnr"],
                          ssim=res["ssim"], kernels_vs_plain_psnr=p_rgb,
                          peak_gb=peak_gb, H=H, W=W,
                          launches_per_frame=per_frame)


def train_args(work: str, data_root: str, exp: str, iters: int, *extra):
    """The lego config at full width on the synthetic scene, no warmup,
    no held-out evaluation during training."""
    return ["--config", os.path.join(HERE, "configs/blender/lego.txt"),
            "--data_root", data_root, "--log_dir", os.path.join(work, "logs"),
            "--exp_name", exp, "--iter_N", str(iters), "--iter_warmup", "0",
            "--idx_test", "0", "--idx_vis", "0", *extra]


def train_phase(work: str, data_root: str, device):
    """The training entry at full width; returns its launch counts and
    its step statistics."""
    from nerf_pytorch_paeng_tpu_torch import driver
    from nerf_pytorch_paeng_tpu_torch.config import load_config
    from nerf_pytorch_paeng_tpu_torch.data import load_blender
    from nerf_pytorch_paeng_tpu_torch.train import create_train_state
    from nerf_pytorch_paeng_tpu_torch.train.schedule import schedule_from_cfg
    from nerf_pytorch_paeng_tpu_torch.train.step import make_image_train_step

    cfg = load_config(train_args(work, data_root, "smoke_train", TRAIN_STEPS,
                                 "--idx_print", "20", "--idx_save", "0"))
    check(not cfg.global_batch and cfg.N_rays == TRAIN_RAYS
          and (cfg.N_samples_c, cfg.N_samples_f) == (64, 128)
          and (cfg.netDepth, cfg.netWidth) == (8, 256),
          "lego.txt is not the full-width per-image config")
    zero_launches()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    res = driver.main_worker(cfg)              # the training entry
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    for name in ("fused_mlp_eval_rays", "fused_mlp_bwd_rays"):
        check(launches[name] == 2 * TRAIN_STEPS,
              f"{name}: {launches[name]} launches in {TRAIN_STEPS} steps")
    losses = res["loss"]
    check(len(losses) == TRAIN_STEPS and all(map(math.isfinite, losses)),
          "non-finite training losses")
    first, last = statistics.mean(losses[:10]), statistics.mean(losses[-10:])
    check(last < first, f"loss did not fall: first 10 {first}, last 10 {last}")
    step_ms = [t * 1e3 for t in res["step_s"]]
    steady = statistics.median(step_ms[5:])
    log(f"train: launches {launches} in {TRAIN_STEPS} steps; loss first 10 "
        f"{first:.5f} -> last 10 {last:.5f}; step device ms (CUDA events): "
        f"first {step_ms[0]:.1f}, median of 6.. {steady:.2f} "
        f"(min {min(step_ms[5:]):.2f}, max {max(step_ms[5:]):.2f}); "
        f"{1e3 / steady:.2f} steps/s, {TRAIN_RAYS * 1e3 / steady:.0f} rays/s; "
        f"wall {wall:.1f} s; peak device memory {peak_gb:.2f} GB")

    # one more step under the profiler, on a state built as main_worker
    # builds it (not counted above)
    images, (K, ext), (H, W), i_split = load_blender(
        data_root, cfg.bkg_white, cfg.downsample, cfg.testskip)
    state = create_train_state(cfg, device)
    step = make_image_train_step(cfg, schedule_from_cfg(cfg), H, W, K)
    i0 = int(i_split[0][0])
    img = torch.as_tensor(images[i0], device=device)
    pose = torch.as_tensor(ext[i0][:3, :4], device=device)
    step(state, img, pose)                     # warm-up
    prof = profile_call(lambda: step(state, img, pose), "train step", device)
    return launches, dict(losses=losses, step_ms=step_ms,
                          median_step_ms=steady,
                          steps_per_s=1e3 / steady,
                          rays_per_s=TRAIN_RAYS * 1e3 / steady,
                          wall_s=wall, peak_gb=peak_gb, profile=prof)


def resume_phase(work: str, data_root: str, device) -> dict:
    """N steps, a checkpoint, a resume to 2N in a fresh main_worker,
    against 2N uninterrupted steps: bit-equal weights and Adam moments."""
    from nerf_pytorch_paeng_tpu_torch import driver
    from nerf_pytorch_paeng_tpu_torch.config import load_config

    n = RESUME_STEPS

    def run(exp, *extra):
        cfg = load_config(train_args(work, data_root, exp, 2 * n,
                                     "--idx_print", "0", *extra))
        driver.main_worker(cfg)
        return cfg

    cfg_a = run("resume_a", "--idx_save", str(n))     # saves at N and 2N
    b_dir = os.path.join(work, "logs", "resume_b")
    os.makedirs(b_dir, exist_ok=True)
    shutil.copy(driver.checkpoint_path(cfg_a, n),
                os.path.join(b_dir, f"resume_b_{n}.pth.tar"))
    cfg_b = run("resume_b", "--idx_save", str(2 * n), "--iter_start", "-1")
    a, b = (torch.load(driver.checkpoint_path(c, 2 * n), map_location=device,
                       weights_only=True) for c in (cfg_a, cfg_b))
    check(a["idx"] == b["idx"] == 2 * n, (a["idx"], b["idx"]))
    differ = [k for k, v in a["model_state_dict"].items()
              if not torch.equal(v, b["model_state_dict"][k])]
    sa, sb = a["optimizer_state_dict"]["state"], b["optimizer_state_dict"]["state"]
    differ += [f"adam {k}.{m}" for k in sa for m in sa[k]
               if not torch.equal(sa[k][m], sb[k][m])]
    log(f"resume: {n} steps, save, resume to {2 * n} vs {2 * n} uninterrupted: "
        f"{len(differ)} tensors differ {differ[:5]}")
    check(not differ, f"resume is not bit-exact: {differ[:5]}")
    return {"steps": 2 * n, "resumed_at": n, "bit_equal": True}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from nerf_pytorch_paeng_tpu_torch.config import NerfConfig
    from nerf_pytorch_paeng_tpu_torch.kernels import build
    from nerf_pytorch_paeng_tpu_torch.kernels import fused_mlp as fm
    from nerf_pytorch_paeng_tpu_torch.kernels import fused_mlp_vjp as fv
    from nerf_pytorch_paeng_tpu_torch.models.nerf import init_nerf
    from nerf_pytorch_paeng_tpu_torch.utils.synth import \
        save_as_blender_dataset

    torch.backends.cuda.matmul.allow_tf32 = False     # plain versions: fp32
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    sources = ("fused_mlp", "fused_mlp_vjp")
    libs = build.build_all(sources)
    log(f"build: {', '.join(s + '.cu' for s in sources)} in "
        f"{time.perf_counter() - t0:.1f} s (one nvcc each, in parallel)")
    for src, lib in zip(sources, libs):
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {src}:", line.strip())

    cfg = NerfConfig()
    packed = fm.pack_nerf(init_nerf(cfg, seed=1, device=device), cfg,
                          device=device)
    rows = kernel_phase(fm, packed, cfg, device)
    rows["fused_mlp_bwd_rays"], train_shapes = train_kernel_phase(
        fm, fv, packed, cfg, device)

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        data_root = os.path.join(work, "lego_synth")
        t0 = time.perf_counter()
        save_as_blender_dataset(data_root, n_train=4, n_val=1, n_test=3,
                                H=800, W=800)
        log(f"synthetic 800x800 blender scene written "
            f"({time.perf_counter() - t0:.1f} s)")
        eval_launches, stats = slice_phase(fm, work, data_root, device)
        train_launches, train_stats = train_phase(work, data_root, device)
        resume = resume_phase(work, data_root, device)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # each path's own run, counters at 0 before it: K3 and K1 on the eval
    # path, K1 and K2 on the training path
    for name, row in rows.items():
        row["launches"] = eval_launches[name] + train_launches[name]
        check(row["launches"] > 0, f"{name} never launched on a main path")

    log(json.dumps({"slice": stats}))
    log(json.dumps({"train": {**train_stats, "launches": train_launches,
                              "kernel_shapes": train_shapes,
                              "resume": resume}}))
    log(json.dumps({"kernels": list(rows.values())}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
