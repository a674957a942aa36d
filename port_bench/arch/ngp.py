"""Instant-NGP's NeRF (Mueller et al., SIGGRAPH 2022) as the program runs
it (``models/ngp.NGP``): the multiresolution hash encoding, two bias-free
width-64 MLPs, the occupancy-grid marcher with its sample budget, on the
port's hash, marching and compositing kernels.

What the ``train`` kind takes from an architecture (``arch/__init__.py``):
the program's model and train loop, the weights the cell draws, the
reference's steps (``reference/ngp.py``) and the counts the metric
readers take: the frozen operation and byte counts of the new kernels
below, their kernels' names and the window's counts of rays and samples
(``TrainLoop``).  The program is imported inside the functions that call
it, so that a fault planted in it reaches the run.

The kind's check compares the first three updates, which run on a full
grid (its first update falls after step 16).  What they cannot see, the
grid's update and the marcher on a grid that is no longer full, is held
by the loop's own check when it closes (``grid_march_readings``): one
more grid update from the program's grid and weights as the window left
them, and the marcher on the grid it gives, each against the reference
from the same state and draws.  The kind's ``checks`` take only its own
numbers (``harness/train.compare``), so these readings are printed on
standard error beside their limits (``GRID_CHECK_LIMITS``) and one over
its limit fails the run.
"""
from __future__ import annotations

import math
import sys
from typing import Dict, List

import numpy as np
import torch

from ..reference import nerf as ref_nerf
from ..reference import ngp as ref

ROUND_CONTROL = ref_nerf.round_fp8
ROUND_OWN = ref_nerf.round_bf16

HASH_FWD_KERNELS = ("hash_encode_fwd_kernel",)
HASH_BWD_KERNELS = ("hash_encode_bwd_kernel",)
MARCH_KERNELS = ("march_count_kernel", "march_scan_kernel",
                 "march_compact_kernel")

# The frozen counts (multiply-add = 2).  Both MLPs: 32*64 + 64*16 (density)
# + 32*64 + 64*64 + 64*3 (colour) = 9,408 multiply-adds a sample, forward;
# the backward twice that (the inputs' and the weights' gradients).
MLP_MACS = 9408
# The encoding's interpolation, a level: 8 corners, each 2 multiplies for
# its weight and 2 multiply-adds for the 2 features; the backward the same
# (weight, then weight x gradient added to the table).
HASH_FLOP_PER_LEVEL = 8 * (2 + 2 * 2)
# The bytes a point must stream through device memory: its position in
# (12) and its 2 L float32 features out (forward) or their gradients in
# (backward).  The table gathers and the backward's atomics are not
# counted: the 48.8 MB of tables fit the 50 MB L2, so counting them at
# HBM speed could put the bound above the time.
POS_BYTES = 12
PEAK_FP32_FLOPS = 67e12          # H100 SXM, outside the tensor cores

# The loop's own check (see the module's docstring; readings and how the
# limits were set: PERF.md section 2).  The grid's values after one update:
# the norm of their difference from the reference's over the reference's;
# among the cells the update did not sample, the share whose value differs
# from the reference's (both the decayed value, bit for bit); the share of
# cells whose occupancy differs from the reference's rule, above min(0.01,
# the mean), applied to the program's own values (the same comparison in
# float32).  The marcher: the kept rays that differ from the reference's
# and the gap of the kept samples' counts.  A sound program reads 0 on all
# but the first.
GRID_CHECK_LIMITS = {"grid_value_gap": 0.025, "grid_decay_mismatch": 0.001,
                     "grid_rule_mismatch": 0.001, "march_kept_mismatch": 0.5,
                     "march_samples_gap": 0.5}

_WINDOW: Dict[str, float] = {}   # the last closed loop's window counts


def _levels(cfg) -> List[ref.Level]:
    return ref.levels(int(cfg.ngp_levels), int(cfg.ngp_log2_table),
                      ref.N_MIN, ref.N_MAX)


def _param_names(cfg) -> List[str]:
    return ref.table_names(int(cfg.ngp_levels)) + list(ref.MLP)


def _mlp_shapes(cfg) -> Dict[str, tuple]:
    w, f = ref.WIDTH, 2 * int(cfg.ngp_levels)
    return {"sigma_w0": (w, f), "sigma_w1": (16, w), "color_w0": (w, 32),
            "color_w1": (w, w), "color_w2": (3, w)}


# ---------------------------------------------------------------- train


def train_weights(cfg, generator: torch.Generator, device) -> Dict[
        str, torch.Tensor]:
    """Fresh weights from ``generator``: each table U(-1e-4, 1e-4), then
    each MLP weight Xavier-uniform, in that order."""
    sd = {}
    for name, (_, size, _) in zip(ref.table_names(int(cfg.ngp_levels)),
                                  _levels(cfg)):
        sd[name] = (torch.rand((size, 2), generator=generator,
                               device=device) * 2.0 - 1.0) * 1e-4
    for name, shape in _mlp_shapes(cfg).items():
        a = float(np.sqrt(6.0 / (shape[0] + shape[1])))
        sd[name] = (torch.rand(shape, generator=generator, device=device)
                    * 2.0 - 1.0) * a
    return sd


class TrainLoop:
    """``driver.train``'s NGP loop without its hooks and logging: chunks
    from ``ChunkSchedule`` over the pool's cursor, the occupancy grid's
    update before the chunk it falls on, each chunk run by one
    ``StagedSteps`` on one ``TrainState``.

    The first call runs the loop from step 1 through the grid's warm-up
    and one update after it (``GRID_WARMUP + GRID_EVERY`` steps),
    so that the call after it, whose pace sizes the window
    (``harness/train.py``), runs as the window's chunks do: after every
    cell's updates and the first of the half-grid ones, on a grid that
    holds the field.  A first chunk of 16 steps on a full grid sized the
    window at 9-16 s of its 20.

    The kind reads ``gated`` once at the start of the timed window and
    once at its end; each read takes a device copy of the steps' counts
    (``train/step.NGPCounters``, no host read) and restarts their
    per-step minimum.  ``train_counts(cfg)`` is the kind's only way from
    the architecture into its record, so ``close`` leaves the window's
    counts in ``_WINDOW`` for it; it also runs the loop's check."""

    def __init__(self, cfg, scene, sd, device, probe):
        from nerf_pytorch_paeng_tpu_torch.models.ngp import NGP
        from nerf_pytorch_paeng_tpu_torch.train.batching import (
            RayPool, build_ray_pool)
        from nerf_pytorch_paeng_tpu_torch.train.chunk import (ChunkSchedule,
                                                              StagedSteps)
        from nerf_pytorch_paeng_tpu_torch.train.schedule import \
            schedule_from_cfg
        from nerf_pytorch_paeng_tpu_torch.train.state import (TrainState,
                                                              make_optimizer)

        self.cfg = cfg
        H, W = scene["hw"]
        model = NGP(cfg).to(device)
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(sd[name])
        self.state = TrainState(model, make_optimizer(model, cfg), 0)
        self.schedule = probe(schedule_from_cfg(cfg), self.state)
        gen = torch.Generator(device=device).manual_seed(cfg.seed + 1)
        self.pool = RayPool(build_ray_pool(
            scene["images"].cpu().numpy(), scene["K"], scene["poses"],
            scene["i_train"], gen, device), gen)
        self.chunks = ChunkSchedule.from_cfg(cfg, False, False, None)
        self.steps = StagedSteps(cfg, self.state, self.schedule, device, H,
                                 W, scene["K"], graphs=self.chunks.k > 1,
                                 pool=self.pool)
        self.i = 1
        self.loss_col = self.steps.keys.index("loss")
        self.marks: List[torch.Tensor] = []

    @property
    def replays(self) -> int:
        return self.steps.replays

    @property
    def gated(self) -> int:
        counters = self.steps.counters
        self.marks.append(counters.t.clone())
        counters.reset_min()
        return 0

    def chunk(self):
        """The first call: the loop's chunks through the grid's warm-up;
        every later call one chunk.  Returns (steps, slab, items)."""
        from nerf_pytorch_paeng_tpu_torch.models import ngp as model_ngp
        if self.i > 1:
            return self._chunk()
        warm = model_ngp.GRID_WARMUP + model_ngp.GRID_EVERY
        n, slabs, items = 0, [], []
        while self.i <= warm:
            k, slab, its = self._chunk()
            n += k
            slabs.append(slab)
            items += its
        return n, torch.cat(slabs), items

    def _chunk(self):
        """One chunk of ``driver.train``'s NGP loop."""
        from nerf_pytorch_paeng_tpu_torch.models.ngp import (
            grid_update_due, next_grid_update)
        from nerf_pytorch_paeng_tpu_torch.train.step import ngp_grid_update
        cfg, i, pool = self.cfg, self.i, self.pool
        if grid_update_due(i):
            ngp_grid_update(self.state.model, cfg, i - 1)
        k = self.chunks.length(i, pool.i_batch, len(pool.pool),
                               next_grid_update(i))
        items = [pool.next_start(cfg.N_rays) for _ in range(k)]
        slab = self.steps.run(items, replay=k == self.chunks.k and k > 1)
        self.i += k
        return k, slab, items

    def close(self) -> None:
        """The window's counts, then (after a window) the loop's check,
        which fails the run where a reading passes its limit."""
        _WINDOW.clear()
        readings = None
        try:
            if len(self.marks) >= 2:
                a, b = (m.tolist() for m in self.marks[:2])
                _WINDOW.update(rays_drawn=b[0] - a[0], rays_kept=b[1] - a[1],
                               samples_kept=b[2] - a[2],
                               min_step_samples=b[3])
                readings = grid_march_readings(
                    self.state.model, self.cfg, self.pool.pool,
                    self.state.step)
        finally:
            self.steps.close()
        if readings is not None:
            hold_grid_check(readings)


def grid_march_readings(model, cfg, rays: torch.Tensor, step: int,
                        rnd=None) -> Dict[str, float]:
    """The loop's check on the program's ``model`` as it stands: one grid
    update after ``step`` completed updates (``train/step.ngp_grid_update``,
    its draws from the step's generator) against ``reference.grid_update``
    from the same values, occupancy, weights and draws, and the
    occupancy it leaves against the rule on its own values; then the first
    ``N_rays`` of ``rays`` (the pool, [M, 3, 3]) with update ``step``'s
    uniforms through the step's ``ops/ngp.render_rays_ngp`` against
    ``reference.lattice``, both on the occupancy the program's update
    left.  ``rnd``: the reference density's operand rounding (None:
    float32).  Leaves the model's grid updated."""
    from nerf_pytorch_paeng_tpu_torch.kernels.ngp_march import MarchParams
    from nerf_pytorch_paeng_tpu_torch.ops import ngp as ops_ngp
    from nerf_pytorch_paeng_tpu_torch.train.step import (ngp_draws,
                                                         ngp_grid_update)
    dev = model.grid_values.device
    G, M = int(cfg.ngp_grid_res), ref.MARCH_STEPS
    with torch.no_grad():
        ref_values = model.grid_values.clone()
        bits = model.grid_bits.clone()
        params = {n: p.detach().float() for n, p in model.named_parameters()}
        ngp_grid_update(model, cfg, step)
        ref.strict_float32()
        unsampled = torch.ones(G ** 3, dtype=torch.bool, device=dev)
        unsampled[ref.grid_cells(bits, step, G, ref.GRID_WARMUP,
                                 ref_nerf.step_generator(cfg.seed + 5, step,
                                                         dev))] = False
        ref.grid_update(
            params, _levels(cfg), ref_values, bits, step, grid=G, steps=M,
            warmup=ref.GRID_WARMUP,
            generator=ref_nerf.step_generator(cfg.seed + 5, step, dev),
            rnd=rnd or ref.identity)
        got = model.grid_values.double()
        value_gap = float(torch.linalg.norm(got - ref_values.double())
                          / torch.linalg.norm(ref_values.double()))
        decay_mismatch = float((model.grid_values[unsampled]
                                != ref_values[unsampled]).double().mean()
                               ) if bool(unsampled.any()) else 0.0
        vals = model.grid_values
        rule = vals > min(ref.GRID_THRESH, float(vals.mean()))
        rule_mismatch = float((model.grid_bits != rule.to(torch.uint8))
                              .double().mean())
        batch = rays[:int(cfg.N_rays)]
        o, d = batch[:, 0].contiguous(), batch[:, 1].contiguous()
        u = ngp_draws(cfg, step, o.shape[0], dev)
        out = ops_ngp.render_rays_ngp(model, o, d, u, MarchParams.from_cfg(cfg))
        lat = ref.lattice(o, d, u, model.grid_bits, steps=M, grid=G,
                          budget=float(cfg.ngp_budget))
        kept = lat["kept"]
        kept_mismatch = int((out["kept"] != kept).sum())
        samples_gap = abs(int(out["stats"][1]) - int(lat["count"][kept].sum()))
    return {"grid_value_gap": value_gap,
            "grid_decay_mismatch": decay_mismatch,
            "grid_rule_mismatch": rule_mismatch,
            "march_kept_mismatch": float(kept_mismatch),
            "march_samples_gap": float(samples_gap)}


def hold_grid_check(readings: Dict[str, float]) -> None:
    """Print each reading beside its limit on standard error; raise where
    one is over its limit or not finite."""
    over = []
    for name, limit in GRID_CHECK_LIMITS.items():
        value = readings[name]
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
        if not (math.isfinite(value) and value <= limit):
            over.append(name)
    sys.stderr.flush()
    if over:
        raise RuntimeError(f"the NGP loop's check failed: {', '.join(over)} "
                           f"over the limit ({readings})")


def first_items(cfg, scene) -> List[int]:
    """The first three steps' pool offsets in its first shuffle."""
    return [k * cfg.N_rays for k in range(3)]


def reference_steps(sd, scene, cfg, items: List[int], device, rnd=None,
                    n: int = 3, keep: int = 0) -> dict:
    """The reference's first ``n`` updates from ``sd`` on the pool's
    batches (``items``: their offsets in the first shuffle), the grid
    full (its first update falls after step 16) -> losses, gradients (as
    Adam receives them, with the L2 terms), the difference of the
    gradients of the kept rays' two halves, and the weights' change.
    ``rnd``: the MLPs' operand rounding (None: float32).  ``keep`` > 0
    marches the batch's first ``keep`` rays alone (a fault's reading)."""
    ref.strict_float32()
    rnd = rnd or ref.identity
    H, W = scene["hw"]
    Kt = torch.as_tensor(scene["K"], dtype=torch.float32, device=device)
    dirs = ref_nerf.pixel_dirs(H, W, Kt).reshape(-1, 3)
    poses = torch.as_tensor(scene["poses"][scene["i_train"]][:, :3, :4],
                            dtype=torch.float32, device=device)
    images = scene["images"][torch.as_tensor(scene["i_train"])].reshape(
        len(scene["i_train"]), H * W, 3)
    N = cfg.N_rays
    order = ref_nerf.pool_order(cfg.seed + 1, len(scene["i_train"]) * H * W,
                                device)
    lv = _levels(cfg)
    march = dict(steps=ref.MARCH_STEPS, grid=int(cfg.ngp_grid_res))
    bits = torch.ones(int(cfg.ngp_grid_res) ** 3, dtype=torch.uint8,
                      device=device)
    params = {k: sd[k].detach().clone().float() for k in _param_names(cfg)}
    adam = ref.Adam(params, l2={k: ref.L2 for k in ref.MLP})
    losses, grads_k, noise_k = [], [], []
    for k in range(n):
        g = ref_nerf.step_generator(cfg.seed + 3, k, device)
        u = torch.rand((N,), generator=g, device=device)
        idx = order[items[k]:items[k] + N]
        view, pix = idx // (H * W), idx % (H * W)
        o, d = ref_nerf.camera_rays(dirs[pix], poses[view])
        target = images[view, pix]
        if keep:
            o, d, target, u = (t[:keep] for t in (o, d, target, u))
        with torch.no_grad():
            kept = ref.lattice(o, d, u, bits, budget=float(cfg.ngp_budget),
                               **march)["kept"]
        n_kept = int(kept.sum())
        # the kept rays' two halves apart (the loss is their mean): their
        # gradients' difference is the batch's own sampling noise
        h = n_kept // 2
        (l1, g1), (l2, g2) = (ref.loss_and_grads(
            params, lv, *(t[part] for t in (o, d, u, target)), bits,
            rnd=rnd, **march) for part in (slice(0, h), slice(h, n_kept)))
        a = h / n_kept
        loss = a * l1 + (1.0 - a) * l2
        grads = adam.with_l2(params, {q: a * g1[q] + (1.0 - a) * g2[q]
                                      for q in g1})
        losses.append(float(loss))
        grads_k.append(grads)
        noise_k.append({q: g1[q] - g2[q] for q in g1})
        adam.step(params, grads, ref.lr_at(k, float(cfg.lr)))
    return dict(losses=losses, grads=grads_k, noise=noise_k,
                change={q: params[q] - sd[q].float() for q in params})


def hash_point_bound_s(cfg) -> float:
    """The least time of one point through the encoding, forward or
    backward: the larger of its interpolation's FP32 operations at the
    non-tensor-core peak and its streamed bytes at HBM speed."""
    from ..harness.flops import PEAK_HBM_BYTES
    L = int(cfg.ngp_levels)
    flop = HASH_FLOP_PER_LEVEL * L
    nbytes = POS_BYTES + 2 * L * 4
    return max(flop / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES)


def train_flop_per_step(cfg) -> float:
    """A step's model operations: both MLPs forward and backward (x3) and
    the encoding's interpolation forward and backward, over the budget's
    B samples."""
    per_sample = 2 * MLP_MACS * 3 + 2 * HASH_FLOP_PER_LEVEL * int(
        cfg.ngp_levels)
    return float(per_sample * int(cfg.ngp_budget))


def train_counts(cfg) -> dict:
    """A step's model operations, the encoding's bound a point, the new
    kernels' names, the budget and the last loop's window counts."""
    return dict(arch="ngp", flop_per_step=train_flop_per_step(cfg),
                hash_point_s=hash_point_bound_s(cfg),
                hash_fwd_kernels=HASH_FWD_KERNELS,
                hash_bwd_kernels=HASH_BWD_KERNELS,
                march_kernels=MARCH_KERNELS, budget=int(cfg.ngp_budget),
                ngp_window=dict(_WINDOW))
