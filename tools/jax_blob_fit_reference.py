#!/usr/bin/env python3
"""The JAX package's blob-field distillation (``utils/synth.fit_field_to_blob``)
on the CPU, from given initial weights: the reference run that the PyTorch
port's fits on the card are read against.

    python3 tools/jax_blob_fit_reference.py --inits DIR [--scenes hard ...]
        [--seeds 0 1 ...] [--jax-init] [--out DIR]

Each initial weight set is ``DIR/init_seed<S>.npz`` (flax params tree of
the lego model, 8x256, L_x 10, L_d 4, flattened to ``coarse.trunk_0.kernel``
keys; ``tools/torch_distill_study.py --export-inits DIR`` writes the port's
``init_nerf`` weights there); ``--jax-init`` adds the JAX package's own
``init_nerf`` at ``PRNGKey(0)``, as ``bench.py`` initialises.  Every fit is
``bench.py``'s (``_train_blob_model``): fit key ``PRNGKey(1)``, 8192 ray
points and ``uniform_frac`` 0.25, the scene's blob and step count, bf16
products.  Writes ``<out>/jax_<scene>_<init>.npz`` (the fitted params, same
layout) and one JSON line a fit, printed and appended to
``<out>/jax_fits.jsonl``: the loss the function returns, the mean loss of
each 100 main steps and the fit's wall time on this host's CPU.  The
function returns only its last step's loss: the script reads every main
step's loss by wrapping ``jax.lax.scan`` for the call (the wrapper hands
the scan's stacked losses to ``jax.debug.callback``) and changes nothing
the function computes.  Imports nothing of the port.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from nerf_pytorch_paeng_tpu.config import NerfConfig  # noqa: E402
from nerf_pytorch_paeng_tpu.models import init_nerf  # noqa: E402
from nerf_pytorch_paeng_tpu.utils.synth import \
    fit_field_to_blob  # noqa: E402

# bench.py's three distilled scenes (_train_blob_model's arguments)
SCENES = {
    "std": dict(blob_r=0.45, blob_cutoff=1.35, blob_amp=8.0,
                blob_hard_w=0.0, n_steps=300),
    "hi": dict(blob_r=0.54, blob_cutoff=1.62, blob_amp=8.0,
               blob_hard_w=0.0, n_steps=300),
    "hard": dict(blob_r=0.45, blob_cutoff=1.35, blob_amp=60.0,
                 blob_hard_w=0.08, n_steps=1500)}


def flatten(params) -> dict:
    return {f"{m}.{layer}.{k}": np.asarray(v, np.float32)
            for m, layers in params.items() for layer, kv in layers.items()
            for k, v in kv.items()}


def unflatten(flat) -> dict:
    out: dict = {}
    for name, v in flat.items():
        m, layer, k = name.split(".")
        out.setdefault(m, {}).setdefault(layer, {})[k] = np.asarray(v)
    return out


def _recording_scan(curves: list):
    """``jax.lax.scan`` that also hands each scan's stacked per-step
    outputs to the host: the fit's main phase is its first scan."""
    scan = jax.lax.scan

    def wrapped(f, init, xs, *a, **kw):
        carry, ys = scan(f, init, xs, *a, **kw)
        jax.debug.callback(lambda y: curves.append(np.asarray(y)), ys)
        return carry, ys
    return scan, wrapped


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--inits", help="directory of init_seed<S>.npz")
    ap.add_argument("--seeds", type=int, nargs="*", default=[0])
    ap.add_argument("--jax-init", action="store_true",
                    help="also fit from the JAX package's own init")
    ap.add_argument("--scenes", nargs="*", default=["hard"],
                    choices=sorted(SCENES))
    ap.add_argument("--out", default="build/blob_fits")
    args = ap.parse_args()
    cfg = NerfConfig()
    model, jax_params = init_nerf(cfg, jax.random.PRNGKey(0))
    inits = [(f"seed{s}", unflatten(np.load(
        os.path.join(args.inits, f"init_seed{s}.npz"))))
        for s in (args.seeds if args.inits else [])]
    if args.jax_init:
        inits.append(("jaxinit", jax_params))
    os.makedirs(args.out, exist_ok=True)
    for scene in args.scenes:
        for label, params0 in inits:
            curves: list = []
            scan, jax.lax.scan = _recording_scan(curves)
            t0 = time.perf_counter()
            try:
                params, loss = fit_field_to_blob(
                    model, params0, jax.random.PRNGKey(1), n_pts=8192,
                    L_x=cfg.L_x, L_d=cfg.L_d, uniform_frac=0.25,
                    **SCENES[scene])
            finally:
                jax.lax.scan = scan
            s = time.perf_counter() - t0
            main_losses = curves[0]
            assert float(main_losses[-1]) == loss
            path = os.path.join(args.out, f"jax_{scene}_{label}.npz")
            np.savez(path, **flatten(jax.tree_util.tree_map(np.asarray,
                                                            params)))
            line = json.dumps(dict(
                scene=scene, init=label, loss=loss,
                curve=main_losses.reshape(-1, 100).mean(1).tolist(),
                cpu_s=s, path=path))
            print(line, flush=True)
            with open(os.path.join(args.out, "jax_fits.jsonl"), "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
