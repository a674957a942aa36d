"""Cells of kind ``train``: the program's train loop over a time window,
and the check of its first three steps against the reference.

The cell's architecture (``arch/<name>.py``, named by its configuration)
gives what runs: the fresh weights from the seed, the program's train
loop (``TrainLoop``: ``driver.train``'s loop without its hooks and
logging, on one ``TrainState`` and one ``StagedSteps``), the reference's
steps and the counts the metric readers take.  This module gives how it
is measured.  Set-up builds the scene and the loop and drives the first
chunks through the loop exactly as the window will: the first chunk's
two eager steps, its graph capture and its replays.  The window runs a
fixed amount of work, the steps that the last warm-up chunk's pace fits
into ``seconds`` rounded to whole chunks of 16 (a window that stopped on
the clock would end a chunk early in some runs and not in others: 1.4%
of the work, which moved the rate by 0.9%), and ends at a device
synchronisation: the steps are dispatched ahead, so the rate is every
step's rays over the host clock's time until the last one finished.

The check: the learning-rate schedule handed to the loop is wrapped
(``_Probe``), so that at the start of update 2 it keeps Adam's first
moment (the first gradient times 0.1) and at the start of update 4 the
weights; the slab gives the first three losses.  After the window and
the program's state are gone, the reference repeats the three updates
from the same weights, pixels, rays and uniforms, worked out again from
the seeds.
"""
from __future__ import annotations

import dataclasses
import gc
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from .. import arch
from .common import Checks, leaf_norm_gaps, relative_gap, sync
from .scenes import SCENES
from .trace import Trace

BETA1 = 0.9                     # the program's Adam, as the reference's
CHUNK = 16                      # the window's work is whole chunks of steps
WARMUP_CHUNKS = 2               # the first captures the graph
TRACE_CHUNKS = 2                # profiled after the window
# the numbers ``compare`` gives that a cell's limits may hold
LIMIT_KEYS = ("loss_gap", "grad_gap", "grad_gap_median", "grad_noise_ratio",
              "change_gap", "change_gap_median")
ARCH_NEEDS = ("train_weights", "TrainLoop", "first_items", "reference_steps",
              "train_counts", "ROUND_CONTROL", "ROUND_OWN")


class _Probe:
    """The learning-rate schedule with snapshots: called with the count of
    completed updates before each update, so at 1, 2 and 3 the first three
    updates' Adam moments are final (each update's gradient follows from
    two of them) and at 3 the third update's weights."""

    def __init__(self, schedule, state):
        self.schedule, self.state = schedule, state
        self.moments: Dict[int, Dict[str, torch.Tensor]] = {}
        self.theta3: Dict[str, torch.Tensor] = {}

    def __call__(self, step: int) -> float:
        if step in (1, 2, 3) and step not in self.moments:
            # a step that left Adam untouched has no moments: zero
            opt = self.state.optimizer
            self.moments[step] = {n: opt.state.get(p, {}).get(
                "exp_avg", torch.zeros_like(p)).clone()
                for n, p in self.state.model.named_parameters()}
        if step == 3 and not self.theta3:
            self.theta3 = {n: p.detach().clone()
                           for n, p in self.state.model.named_parameters()}
        return self.schedule(step)

    def grads(self) -> List[Dict[str, torch.Tensor]]:
        """The first three updates' gradients as Adam received them:
        m_k = beta1 m_(k-1) + (1 - beta1) g_k."""
        out, prev = [], None
        for k in (1, 2, 3):
            m = self.moments[k]
            out.append({n: (v - (BETA1 * prev[n] if prev else 0.0))
                        / (1.0 - BETA1) for n, v in m.items()})
            prev = m
        return out


def _program(ctx, scene, sd) -> dict:
    """Set-up, window and (with ``ctx.trace``) the profiled chunks of the
    program; returns what the metrics and the check read."""
    from nerf_pytorch_paeng_tpu_torch import kernels

    dev = ctx.device
    loop = arch.of(ctx.config).TrainLoop(ctx.cfg, scene, sd, dev, _Probe)
    probe = loop.schedule
    try:
        # set-up: the first chunks (the first full one captures the
        # graph), at least the check's four updates
        first = dict(losses=[], items=[])
        warm = done = 0
        while warm < WARMUP_CHUNKS or done < 4:
            sync(dev)
            t_chunk = time.perf_counter()
            k, slab, items = loop.chunk()
            if len(first["items"]) < 3:
                first["losses"] += slab[:, loop.loss_col].tolist()
                first["items"] += items
            sync(dev)
            t_step = (time.perf_counter() - t_chunk) / k
            warm += 1
            done += k
        del first["losses"][3:], first["items"][3:]
        # the window's work: the whole chunks that the last warm-up chunk's
        # pace fits into ``seconds``, the same in every run at that pace
        n_target = CHUNK * max(1, round(ctx.seconds / (CHUNK * t_step)))
        t0 = time.perf_counter()
        setup_s = t0 - ctx.t_start
        replays0, gated0 = loop.replays, loop.gated
        n_steps = 0
        while n_steps < n_target:
            n_steps += loop.chunk()[0]
        sync(dev)
        window_s = time.perf_counter() - t0
        rec = dict(kind="train", steps=n_steps, window_s=window_s,
                   replays=loop.replays - replays0,
                   gated_steps=loop.gated - gated0)
        if ctx.trace:
            before = loop.replays
            launches0 = kernels.launch_counts()
            with Trace(dev) as tr:
                n_traced = sum(loop.chunk()[0] for _ in range(TRACE_CHUNKS))
            rec.update(trace=tr, trace_steps=n_traced,
                       trace_replays=loop.replays - before,
                       trace_launches=[b - a for a, b in zip(
                           launches0, kernels.launch_counts())])
        rec["memory_peak_bytes"] = (int(torch.cuda.max_memory_allocated(dev))
                                    if dev.type == "cuda" else 0)
        if len(probe.moments) < 3 or not probe.theta3:
            raise RuntimeError("set-up ran fewer than 4 updates")
        first.update(grads=probe.grads(), theta3=probe.theta3)
    finally:
        loop.close()
    return dict(setup_s=setup_s, rec=rec, first=first)


def compare(prog: dict, refr: dict, sd) -> Dict[str, float]:
    """The numbers of the check (see PERF.md), over the leaves whose
    first reference gradient is at least a thousandth of the median
    leaf's (the others move by round-off alone).

    - loss_gap: the largest relative gap of the three losses;
    - grad_gap, grad_gap_median: the first update's gradient, each leaf's
      gap between the program's norm and the reference's over the larger
      of that leaf's reference norm and the median leaf's, the worst
      leaf's and the median leaf's;
    - grad_noise_ratio: for each leaf, the norm of the three updates'
      gradients' difference from the reference's over the norm of the
      difference between the reference's gradients of each batch's two
      halves, i.e. the program's error in units of the batch's own
      sampling noise (a gradient of half the batch reads 0.5); the
      median leaf's;
    - change_gap, change_gap_median: the three updates' change of the
      weights, each leaf's gap of norms as for the gradient;
    - look (not compared): where the worst leaves' gaps come from
      (``_leaf_look``, ``_grad_rows``; PERF.md reads them)."""
    keys = sorted(refr["grads"][0])
    gnorm = {k: float(torch.linalg.norm(refr["grads"][0][k])) for k in keys}
    med = float(np.median(list(gnorm.values())))
    moved = [k for k in keys if gnorm[k] >= 1e-3 * med]
    change = prog.get("change") or {
        k: prog["theta3"][k].float() - sd[k].float() for k in keys}
    grad = leaf_norm_gaps(prog["grads"][0], refr["grads"][0], moved)
    moves = leaf_norm_gaps(change, refr["change"], moved)

    def pooled(steps, k):
        return torch.cat([g[k].reshape(-1) for g in steps]).double()
    ratio = {k: float(torch.linalg.norm(pooled(prog["grads"], k)
                                        - pooled(refr["grads"], k))
                      / torch.linalg.norm(pooled(refr["noise"], k)))
             for k in moved}
    worst = max(moves, key=moves.get)
    look = {"leaf": worst, **_leaf_look(
        change[worst].float(), refr["change"][worst],
        [g[worst] for g in prog["grads"]], [g[worst] for g in refr["grads"]],
        moves[worst])}
    look["grad"] = _grad_rows(prog["grads"][0], refr["grads"][0],
                              refr["noise"][0], max(grad, key=grad.get))
    return {
        "loss_gap": max(relative_gap(a, b) for a, b in
                        zip(prog["losses"], refr["losses"])),
        "grad_gap": max(grad.values()),
        "grad_gap_median": float(np.median(list(grad.values()))),
        "grad_noise_ratio": float(np.median(list(ratio.values()))),
        "change_gap": max(moves.values()),
        "change_gap_median": float(np.median(list(moves.values()))),
        "worst_leaves": [max(d, key=d.get) for d in (grad, ratio, moves)],
        "look": look}


def _grad_rows(g_prog, g_ref, noise, key) -> dict:
    """The first gradient of leaf ``key`` row by row: each row's error
    (program minus reference) over its sampling noise (the difference of
    the batch halves' gradients), the median row's and the eight worst
    rows' with their ratio of norms (program over reference) and each
    side's norm over the reference's median row's."""
    def rows(t):
        t = t.double()
        return torch.linalg.norm(t.reshape(t.shape[0], -1), dim=1)
    err = rows(g_prog[key] - g_ref[key]) / rows(noise[key]).clamp(
        min=1e-30)
    scale = rows(g_prog[key]) / rows(g_ref[key]).clamp(min=1e-30)
    med = rows(g_ref[key]).median().clamp(min=1e-30)
    top = err.argsort(descending=True)[:8]
    return {"leaf": key, "err_over_noise_median": float(err.median()),
            "worst_rows": [[int(r), float(err[r]), float(scale[r]),
                            float(rows(g_ref[key])[r] / med),
                            float(rows(g_prog[key])[r] / med)]
                           for r in top]}


def _leaf_look(d_prog, d_ref, g_prog, g_ref, gap) -> dict:
    """Where one leaf's gap of change norms comes from: the elements
    whose largest reference gradient over the three updates is under a
    thousandth of the leaf's median element's, or under ten times Adam's
    epsilon (1e-8), and the leaf's gap with each set left out; the
    elements whose program gradient has another sign in some update;
    the rows (units) that carry most of the difference of squared
    norms."""
    gr = torch.stack([g.double() for g in g_ref]).abs().amax(0)
    gp = torch.stack([g.double() for g in g_prog])
    dp, dr = d_prog.double(), d_ref.double()
    # the leaf's own denominator (``leaf_norm_gaps``)
    denom = (abs(float(torch.linalg.norm(dp)) - float(torch.linalg.norm(dr)))
             / gap if gap > 0 else float("inf"))

    def gap_without(mask):
        a, b = float(torch.linalg.norm(dp[~mask])), float(
            torch.linalg.norm(dr[~mask]))
        return abs(a - b) / denom
    tiny = gr < 1e-3 * gr.median()
    eps = gr < 1e-7
    flips = (torch.sign(gp) != torch.sign(torch.stack(
        [g.double() for g in g_ref]))).any(0)
    out = {"elements": int(dr.numel()), "tiny": int(tiny.sum()),
           "gap_without_tiny": gap_without(tiny), "eps_regime": int(eps.sum()),
           "gap_without_eps": gap_without(eps),
           "grad_sign_flips": int(flips.sum()),
           "norm_prog": float(torch.linalg.norm(dp)),
           "norm_ref": float(torch.linalg.norm(dr)), "gap": gap}
    if dr.dim() == 2:
        rows = dp.square().sum(1) - dr.square().sum(1)
        top = rows.abs().argsort(descending=True)[:4]
        out["top_rows"] = [[int(r), float(rows[r]) / float(
            dr.square().sum())] for r in top]
    return out


def run(ctx) -> dict:
    cfg, dev = ctx.cfg, ctx.device
    a = arch.of(ctx.config)
    spec = {**ctx.config["scene"], **(ctx.scene_overrides or {})}
    scene = SCENES[spec["kind"]](spec, ctx.seed, dev)
    sd = a.train_weights(cfg, torch.Generator(device=dev).manual_seed(
        ctx.seed), dev)
    with tempfile.TemporaryDirectory() as logs:
        ctx.cfg = cfg = dataclasses.replace(cfg, log_dir=logs)
        out = _program(ctx, scene, sd)
    rec, first = out["rec"], out["first"]
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # the check: after the window, with the program's state freed
    refr = a.reference_steps(sd, scene, cfg, first["items"], dev)
    checks = Checks()
    limits = ctx.workload["check"]["limits"]
    numbers = compare(first, refr, sd)
    worst = numbers.pop("worst_leaves")
    look = numbers.pop("look")
    for name, value in numbers.items():
        if name in limits:
            checks.add(name, value, limits[name])
    n = cfg.N_rays
    rec.update(n_rays=n, **a.train_counts(cfg))
    return dict(
        e2e={"train_rays_per_s": rec["steps"] * n / rec["window_s"],
             "setup_s": out["setup_s"]},
        rec=rec, checks=checks, readings=numbers, attempted=rec["steps"],
        failed=0,
        notes={"gated_steps": rec["gated_steps"],
               "graph_replays": rec["replays"], "worst_leaves": worst,
               "look": look,
               "readings": numbers})
