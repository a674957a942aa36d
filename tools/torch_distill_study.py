#!/usr/bin/env python3
"""How the blob-field distillation behaves on one GPU, beyond the one fit
of each scene that ``chip_smoke.py`` runs (phase 16), and how the JAX
package's fits from the same initial weights compare.

    python3 tools/torch_distill_study.py --export-inits DIR
    python3 tools/torch_distill_study.py [--jax-fits DIR] [--hard-seeds S ...]
        [--sections trajectory port jax mechanisms schedules]
        [--schedules NAME ...] [--soft-seeds S ...] [--out study.json]

``--export-inits DIR`` (no card needed) writes the port's ``init_nerf``
weights of the lego model for the ``--hard-seeds`` as
``DIR/init_seed<S>.npz``, the
flax params tree flattened to ``coarse.trunk_0.kernel`` keys, which
``tools/jax_blob_fit_reference.py`` fits with the JAX package on the CPU.

Otherwise, on the card, every fitted field is read the same way
(``readings``): the loss the fit returned, the distillation loss of the
returned weights on fresh draws of the main and the polish phase
(``chip_smoke.held_out_losses``), and pose 0's 800x800 dense frame
against the analytic frame of the scene's blob and the culled frame
against the dense one, as ``chip_smoke.py``'s phase 16 reads them.

1. The port's fits at the JAX function's constant learning rate
   (``lr_schedule="constant"``), through K8/K9 (the fit's generator
   seeded 1): the
   hard scene from init seeds ``--hard-seeds`` (default 0-3), and from
   those seeds on the plain route (``use_pallas`` false, bf16 products;
   seed 0 also float32); the std and hi scenes from seeds 0-3.  Each also
   with its main phase's loss curve (the mean of each 100 steps).
2. The JAX package's fits listed in ``--jax-fits DIR``'s
   ``jax_fits.jsonl`` (with their ``jax_<scene>_<init>.npz``, as
   ``tools/jax_blob_fit_reference.py`` writes them), carried into the
   port's ``NeRF`` and read as in 1.
3. The culled frame against the dense one, mechanism by mechanism (the tau
   cull, the sample truncation, the gates) on the hard fits from seeds 0
   and 1 and the std fit from seed 0.
4. The hard fit's main phase from init seed 0 replayed step by step as
   ``fit_field_to_blob`` takes it (bit-equal: the last step's loss is the
   one the fit returns), the plain pair's gradients (K8/K9's plain
   versions on the card, ``chip_smoke._PlainPoints``) beside the kernel
   pair's every ``TRAJ_EVERY`` steps; and from steps ``FORKS`` on, the rest
   of the main phase once more through the kernel pair (the control:
   it must repeat the trajectory) and through the plain pair, on the
   same draws.
5. The learning-rate schedules (``SCHEDULES``: the two of
   ``synth.fit_learning_rates`` and the variants that chose its default),
   each ``--schedules`` entry on the hard scene from ``--hard-seeds`` and
   on std and hi from ``--soft-seeds`` (default 0), read as in 1.

Sections 1 and 3 fit at the constant rate, as they were measured.

Prints the card's name and power limit first, and the whole record as
JSON to ``--out`` where given.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import pathlib
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from nerf_pytorch_paeng_tpu_torch.config import NerfConfig  # noqa: E402
from nerf_pytorch_paeng_tpu_torch.eval.frame import \
    make_frame_renderer  # noqa: E402
from nerf_pytorch_paeng_tpu_torch.kernels import build  # noqa: E402
from nerf_pytorch_paeng_tpu_torch.kernels import fused_mlp as fm  # noqa: E402
from nerf_pytorch_paeng_tpu_torch.models.nerf import (NeRF,  # noqa: E402
                                                      init_nerf)
from nerf_pytorch_paeng_tpu_torch.utils import interop, synth  # noqa: E402

SCENES = dict(cs.DISTILLED_SCENES)
SEEDS = (0, 1, 2, 3)
VARIANTS = {"truncation_off": dict(render_trunc_eps=0.0),
            "tau_0": dict(render_cull_tau=0.0),
            "gates_off": dict(render_precull="off", render_gate_fine="off"),
            "tau_0_truncation_off": dict(render_cull_tau=0.0,
                                         render_trunc_eps=0.0)}


SECTIONS = ("trajectory", "port", "jax", "mechanisms", "schedules")


RATES = synth.fit_learning_rates


def _rates(lr_end=None, polish_lr=None):
    """A learning-rate schedule in ``synth.fit_learning_rates``' place: the
    main phase's half cosine from lr down to ``lr_end`` (None: constant),
    the polish phase at ``polish_lr`` (None: lr)."""
    def rates(n_steps, lr):
        main = [lr if lr_end is None else lr_end + 0.5 * (lr - lr_end) * (
            1 + math.cos(math.pi * i / max(n_steps - 1, 1)))
            for i in range(n_steps)]
        return main, lr if polish_lr is None else polish_lr
    return rates


# the fit's learning-rate schedules: the two of ``synth.fit_learning_rates``
# (the JAX function's constant rate and the port's default) and the
# variants measured before the default was chosen
SCHEDULES = {"cosine": lambda n, lr: RATES(n, lr, "cosine"),
             "constant": lambda n, lr: RATES(n, lr, "constant"),
             "cos_main": _rates(2e-5),
             "cos_main_polish_2e-4": _rates(2e-5, 2e-4),
             "const_main_polish_2e-4": _rates(None, 2e-4),
             "cos_main_to_2e-4": _rates(2e-4, 2e-4)}
MECHANISM_FITS = (("hard", 0), ("hard", 1), ("std", 0))
TRAJ_EVERY = 25
FORKS = (600, 1100)


def _means(losses) -> list:
    return torch.stack(losses).reshape(-1, 100).mean(1).tolist()


def trajectory(device, seed: int = 0) -> dict:
    import copy
    blob, n = _blob("hard"), SCENES["hard"]["n_steps"]
    model = init_nerf(NerfConfig(), seed=seed, device=device)

    def adam(m):
        return torch.optim.Adam(m.parameters(), lr=2e-3, betas=(0.9, 0.999),
                                eps=1e-8)

    def step(fields, m, opt, d):
        opt.zero_grad(set_to_none=True)
        loss = synth.blob_fit_loss(fields, *synth.orbit_ray_points(
            d, cs.FIT_UNIFORM_FRAC), **blob)
        loss.backward()
        opt.step()
        return loss.detach()

    opt, params = adam(model), list(model.parameters())
    kern = synth.blob_fit_fields(model)
    plain = synth.blob_fit_fields(model, train_fn=cs._PlainPoints.apply)
    g = torch.Generator(device).manual_seed(1)
    draws, losses, cmp, snaps = [], [], [], {}
    for i in range(n):
        d = synth.orbit_draws(cs.FIT_PTS, cs.FIT_UNIFORM_FRAC, g, device)
        draws.append(d)
        if i in FORKS:
            snaps[i] = (copy.deepcopy(model.state_dict()),
                        copy.deepcopy(opt.state_dict()))
        if i % TRAJ_EVERY == 0:
            pts, dirs = synth.orbit_ray_points(d, cs.FIT_UNIFORM_FRAC)
            a, b = (torch.cat([x.flatten() for x in torch.autograd.grad(
                synth.blob_fit_loss(f, pts, dirs, **blob), params)])
                for f in (kern, plain))
            cmp.append(torch.stack([(a - b).norm() / b.norm(),
                                    a @ b / (a.norm() * b.norm()),
                                    b.norm()]))
        losses.append(step(kern, model, opt, d))
    out = dict(last=float(losses[-1]), curve=_means(losses),
               grads=[dict(step=i * TRAJ_EVERY, rel_l2=r, cos=c, norm=nm)
                      for i, (r, c, nm) in enumerate(torch.stack(cmp)
                                                     .tolist())],
               forks={})
    for at, (sd, osd) in snaps.items():
        for route, train_fn in (("kernels", None),
                                ("plain", cs._PlainPoints.apply)):
            m = NeRF().to(device)
            m.load_state_dict(sd)
            o = adam(m)
            o.load_state_dict(osd)
            fields = synth.blob_fit_fields(m, train_fn=train_fn)
            tail = [step(fields, m, o, d) for d in draws[at:]]
            out["forks"][f"{route}_from_{at}"] = dict(
                last=float(tail[-1]),
                curve=_means(losses[:at] + tail)[at // 100:],
                equal_to_main=bool(torch.equal(torch.stack(tail),
                                               torch.stack(losses[at:]))))
    return out


def export_inits(out: str, seeds) -> None:
    os.makedirs(out, exist_ok=True)
    for s in seeds:
        p = interop.jax_params_from_state_dict(
            init_nerf(NerfConfig(), seed=s, device="cpu").state_dict())
        np.savez(os.path.join(out, f"init_seed{s}.npz"),
                 **{f"{m}.{layer}.{k}": v for m, layers in p.items()
                    for layer, kv in layers.items() for k, v in kv.items()})


def readings(sd, loss: float, name: str, device) -> dict:
    model = NeRF().to(device)
    model.load_state_dict(sd)
    held = cs.held_out_losses(model, _blob(name), device)
    cfg, H, W, K, pose = cs.distilled_frame_setup(device)
    packed = fm.pack_nerf(model, cfg, device=device)
    culled, dense = (make_frame_renderer(c, H, W, K, device,
                                         stratified=False)(packed, pose)[0]
                     for c in (cfg, dataclasses.replace(cfg,
                                                        render_cull="none")))
    gt = cs.blob_frame(_blob(name), H, W, K, pose, device)
    # where the culled frame leaves the dense one: the pixels more than
    # 0.05 apart, by their distance from the frame's centre (the blob's)
    off = (culled - dense).abs().amax(-1) > 0.05
    yy, xx = torch.meshgrid(torch.arange(H, device=device),
                            torch.arange(W, device=device), indexing="ij")
    rad = torch.sqrt((xx - W / 2 + 0.5) ** 2 + (yy - H / 2 + 0.5) ** 2)[off]
    q = (torch.quantile(rad.float(), torch.tensor(
        [0.1, 0.5, 0.9], device=device)).tolist() if rad.numel() else [])
    return dict(fit_loss=loss, held_out_main=held["main"],
                held_out_polish=held["polish"],
                dense_vs_blob_psnr=cs.psnr(dense, gt),
                culled_vs_blob_psnr=cs.psnr(culled, gt),
                culled_vs_dense_psnr=cs.psnr(culled, dense),
                off_pixels=int(off.sum()), off_radius_q10_50_90=q,
                grid={m: cs.grid_stragglers(fm, packed[m], cfg, device,
                                            _blob(name)["blob_cutoff"])
                      for m in ("coarse", "fine")})


def port_fit(name: str, seed: int, cfg, device,
             schedule: str = "constant") -> tuple:
    """One fit, every main step's loss recorded on the device by wrapping
    ``synth.blob_fit_loss`` -> (state dict, returned loss, seconds, the
    mean loss of each 100 main steps)."""
    losses, loss_fn = [], synth.blob_fit_loss

    def recorded(*a, **kw):
        loss = loss_fn(*a, **kw)
        if not kw.get("polish"):
            losses.append(loss.detach())
        return loss
    synth.blob_fit_loss = recorded
    synth.fit_learning_rates = (
        lambda n, lr, _="cosine": SCHEDULES[schedule](n, lr))
    try:
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        sd, loss = synth.fit_field_to_blob(
            init_nerf(NerfConfig(), seed=seed, device=device),
            n_pts=cs.FIT_PTS, uniform_frac=cs.FIT_UNIFORM_FRAC,
            generator=torch.Generator(device).manual_seed(1), cfg=cfg,
            **SCENES[name])
        torch.cuda.synchronize(device)
        s = time.perf_counter() - t0
    finally:
        synth.blob_fit_loss = loss_fn
        synth.fit_learning_rates = RATES
    curve = torch.stack(losses).reshape(-1, 100).mean(1).tolist()
    return sd, loss, s, curve


def mechanisms(name: str, sd, device) -> dict:
    """The culled frame against the dense one with each mechanism off."""
    model = NeRF().to(device)
    model.load_state_dict(sd)
    cfg, H, W, K, pose = cs.distilled_frame_setup(device)
    packed = fm.pack_nerf(model, cfg, device=device)
    gt = cs.blob_frame(_blob(name), H, W, K, pose, device)
    frames = {}
    for label, over in dict(dense=dict(render_cull="none"), culled={},
                            **VARIANTS).items():
        render = make_frame_renderer(dataclasses.replace(cfg, **over), H, W,
                                     K, device, stratified=False)
        rgb = render(packed, pose)[0]
        st = render.stats[-1] if getattr(render, "stats", None) else {}
        frames[label] = (rgb, st)
    dense = frames["dense"][0]
    return {label: dict(vs_dense=cs.psnr(rgb, dense), vs_blob=cs.psnr(rgb, gt),
                        off_pixels=int(((rgb - dense).abs().amax(-1)
                                        > 0.05).sum()),
                        n_act=st.get("n_act"), n_trunc=st.get("n_trunc"))
            for label, (rgb, st) in frames.items() if label != "dense"}


def _blob(name: str) -> dict:
    return {k: v for k, v in SCENES[name].items() if k != "n_steps"}


def _show(label: str, r: dict) -> None:
    print(f"{label}: returned loss {r['fit_loss']:.4f}, held-out main "
          f"{r['held_out_main']:.4f} polish {r['held_out_polish']:.4f}; "
          f"dense vs blob {r['dense_vs_blob_psnr']:.2f} dB, culled vs dense "
          f"{r['culled_vs_dense_psnr']:.2f} dB ({r['off_pixels']} pixels "
          f"off, at radius {[round(v) for v in r['off_radius_q10_50_90']]}"
          f" px); grids (occupied, outer, far-field max raw) "
          f"{ {m: tuple(round(x, 3) for x in g.values()) for m, g in r['grid'].items()} }"
          + f"; 100-step means {[round(v, 4) for v in r['curve']]}",
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--export-inits", metavar="DIR")
    ap.add_argument("--jax-fits", metavar="DIR",
                    help="read the JAX package's fits found here too")
    ap.add_argument("--hard-seeds", type=int, nargs="*", default=list(SEEDS))
    ap.add_argument("--sections", nargs="*", choices=SECTIONS,
                    default=list(SECTIONS))
    ap.add_argument("--schedules", nargs="*", choices=list(SCHEDULES),
                    default=list(SCHEDULES))
    ap.add_argument("--soft-seeds", type=int, nargs="*", default=[0])
    ap.add_argument("--out", help="write the record here as JSON")
    args = ap.parse_args()
    if args.export_inits:
        export_inits(args.export_inits, args.hard_seeds)
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    build.build_all(("fused_mlp", "fused_mlp_vjp"))
    device = torch.device("cuda")
    out = {}
    if "trajectory" in args.sections:
        out["trajectory"] = t = trajectory(device)
        worst = max(t["grads"], key=lambda r: r["rel_l2"])
        print(f"trajectory [hard, seed 0]: last step {t['last']:.4f}; "
              f"gradients vs the plain pair every {TRAJ_EVERY} steps: worst "
              f"rel L2 {worst['rel_l2']:.2e} at step {worst['step']}, min "
              f"cos {min(r['cos'] for r in t['grads']):.6f}; 100-step means "
              f"{[round(v, 4) for v in t['curve']]}", flush=True)
        for k, v in t["forks"].items():
            print(f"  fork {k}: last step {v['last']:.4f}, equal to the "
                  f"main run {v['equal_to_main']}; 100-step means from "
                  f"there {[round(x, 4) for x in v['curve']]}", flush=True)
    if "port" in args.sections:
        plain = NerfConfig(use_pallas=False)
        runs = [("hard", s, "kernels", None) for s in args.hard_seeds]
        runs += [("hard", s, "plain_bf16", plain) for s in args.hard_seeds]
        runs += [("hard", 0, "plain_f32",
                  dataclasses.replace(plain, compute_dtype="float32"))]
        runs += [(n, s, "kernels", None) for n in ("std", "hi")
                 for s in SEEDS]
        out["port"] = {}
        for name, seed, route, cfg in runs:
            sd, loss, s, curve = port_fit(name, seed, cfg, device)
            label = f"{name}_seed{seed}_{route}"
            out["port"][label] = r = dict(fit_s=s, curve=curve,
                                          **readings(sd, loss, name, device))
            _show(f"port {label}", r)
    if "jax" in args.sections and args.jax_fits:
        with open(os.path.join(args.jax_fits, "jax_fits.jsonl")) as f:
            fits = [json.loads(line) for line in f]
        out["jax"] = {}
        for rec in fits:
            flat = np.load(os.path.join(args.jax_fits,
                                        os.path.basename(rec["path"])))
            tree: dict = {}
            for k in flat.files:
                m, layer, leaf = k.split(".")
                tree.setdefault(m, {}).setdefault(layer, {})[leaf] = flat[k]
            sd = interop.state_dict_from_jax_params(tree)
            label = f"{rec['scene']}_{rec['init']}"
            out["jax"][label] = r = dict(
                curve=rec["curve"], cpu_s=rec["cpu_s"],
                **readings(sd, rec["loss"], rec["scene"], device))
            _show(f"jax {label}", r)
    if "mechanisms" in args.sections:
        out["mechanisms"] = {}
        for name, seed in MECHANISM_FITS:
            sd = port_fit(name, seed, None, device)[0]
            out["mechanisms"][f"{name}_seed{seed}"] = r = mechanisms(
                name, sd, device)
            print(f"mechanisms [{name}, seed {seed}]: " + "; ".join(
                f"{k} {v['vs_dense']:.2f} dB vs dense, {v['vs_blob']:.2f} "
                f"vs blob, {v['off_pixels']} off, act {v['n_act']} trunc "
                f"{v['n_trunc']}" for k, v in r.items()), flush=True)
    if "schedules" in args.sections:
        out["schedules"] = {}
        runs = [("hard", s, v) for v in args.schedules
                for s in args.hard_seeds]
        runs += [(n, s, v) for v in args.schedules for n in ("std", "hi")
                 for s in args.soft_seeds]
        for name, seed, v in runs:
            sd, loss, s, curve = port_fit(name, seed, None, device, v)
            label = f"{name}_seed{seed}_{v}"
            out["schedules"][label] = r = dict(
                fit_s=s, curve=curve, **readings(sd, loss, name, device))
            _show(f"schedule {label}", r)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
