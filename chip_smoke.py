#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

1. Builds the port's CUDA kernels from the sources in the checkout (one
   nvcc per source, all at once) and prints each kernel's registers and
   spills as ``-Xptxas -v`` reported them; the ray kernels' launch plan
   (persistent blocks, shared memory a block, ring stages, blocks an SM
   holds) and the host time to encode their tensor maps.
2. Kernel phase: each kernel at the shapes its paths give it, seeded
   inputs and seeded weights, against its plain PyTorch version on the
   same inputs (stated tolerance), with kernel and plain times (CUDA
   events, median after warm-up) and the least time the card could take
   for the work: the sigma kernel (K3) and the full-field kernel (K1) at
   the eval block (131072 rays; 64, and 64+128 merged samples), each
   beside its bf16 products alone as chained ``torch.mm`` at the row's own
   points (``library_ms``, a yardstick the port never calls), and K3's
   sigma bit-equal to K1's; K1 with float32 outputs (two launches
   bit-equal) and the backward kernel (K2) at the training batch (4096
   rays; 64 and 192 samples); K2 launched twice must give the same
   bits, and its three launches (chain, weight-gradient, reduction) are
   timed apart under the profiler, each beside its own bound, and the
   weight-gradient products beside the same 12 products as ``torch.mm``
   (the K2 row's ``library_ms``, a yardstick the port never calls); the gated kernels K4 (64 samples) and K5 (192) at the eval block
   with a seeded gate that leaves about half the (128-ray tile, 8-sample
   row) blocks on: gated blocks exactly 0, active blocks bit-equal to the
   ungated kernel and within the tolerance of the gated plain version,
   timed at that gate and at an all-on gate (bit-equal to the ungated
   kernel) beside the bound of the
   active work; the points kernel K7 on the 128^3 support grid (its sigma
   bit-equal to K3's at depth 0; beside its products alone as chained
   ``torch.mm``, a yardstick the port never calls); the gated
   training pair at the training batch (4096 rays; 64 and 192 samples)
   under an all-on, a seeded half-on and an all-off gate: K5 with float32
   outputs (gated blocks 0, active blocks bit-equal to K1, within the
   tolerance of the gated plain version) and the gated backward K6 (all on
   bit-equal to K2, half on within K2's tolerance of the gated plain
   version and of K2 with the gated samples' cotangents zeroed, all off
   zero, two launches bit-equal), each timed beside the active work's
   bound.
3. Eval phase: writes a synthetic 800x800 scene in the blender layout, at
   lego's field of view, and a seeded reference-format checkpoint, then
   runs the port's
   ``--eval_only`` entry on configs/blender/lego.txt (8x256 MLP, 64+128
   samples, full resolution); then renders one view again with the plain
   versions on the card and holds the two frames together (PSNR >= 35 dB).
4. Training phase: the port's training entry (``driver.main_worker``) on
   configs/blender/lego.txt at full width (4096 rays, 64+128 samples,
   per-image sampling) on the same scene: every step must launch K1 and
   K2 twice (once per pass), the losses must be finite and fall; the
   training pre-cull's policy (``train_precull auto``) measures the
   random weights' support once (two K7 launches) and must keep them
   ungated; step times, one step under the profiler and the peak device
   memory.  Then N steps, a checkpoint, a resume to 2N in a fresh
   ``main_worker``, against 2N uninterrupted steps: the saved states must
   be bit-equal (with ``--train_precull off``: a gated run restarts the
   refresh cadence at the resumed step, so its resume is not bit-exact,
   as in the JAX package).  Then ``--compute_dtype float32``: two training
   steps and one dense test view must equal the bfloat16 run bit for bit
   (the card's kernels take bf16 weights at either type).
5. Render phase: a checkpoint of the hand-built compact field
   (``utils/synth.compact_field_state_dict``, an L1 ball of radius 1.5),
   then the port's ``--render_only`` entry on configs/blender/lego.txt at
   800x800 with 12 orbit views through the culled renderer: K7 must build
   the two support grids once, K4 and K5 must render every frame and K3
   and K1 must not run, the gates must skip work, and the gif and PNGs
   must be written.  Then one pose, deterministic sampling: the culled
   frame against the dense one (PSNR >= 40 dB), with gates against
   without (1e-5), kernels against plain versions (>= 35 dB); culled and
   dense frame times, and one culled frame under the profiler.  Last, K4
   and K5 on the very inputs that pose and the first orbit view gave them
   (K4 over the 640,000 rays, K5 on each cover block and sample class,
   some with fewer ray tiles than the card has SMs) with the seeded random
   weights, every unit live: gated blocks 0, active blocks bit-equal to
   the ungated kernel and within the tolerance of the plain version.
6. Gated training phase: the training entry resumes from a checkpoint of
   the compact field (an L1 ball of radius 1.0) with a fresh Adam state and
   trains 60 steps with ``--train_precull auto --train_precull_every 20``:
   the first refresh must decide GATED, every gated step must launch K5
   and K6 twice, the losses must be finite; the same 60 steps with
   ``--train_precull off``, with ``--train_precull_tile 128`` and on the
   radius-1.5 ball (whose predicted skipped share is near the policy's
   floor; its decision is reported) for the step times; one gated step
   under the profiler.  One step from the same state, gated against
   ungated: the loss bit-equal, the updated weights within two learning
   rates (Adam's first step moves a weight by about lr times the sign of
   its gradient, and the sum order differs).  Last, K5 and K6 on the very
   inputs of that gated step (rays, depths, cotangents, gates) with the
   seeded random weights, against their plain versions.

7. Plane kernels (in the kernel phase): K8 (``fused_mlp_eval``) with bf16
   outputs at the eval block's plane (131072 rays x 164 samples, the
   merged count of ``--N_samples_f 100``) and with float32 outputs at the
   training planes (4096 x 64 and 4096 x 192), K9 (``fused_mlp_bwd``) at
   the training planes with loss-like cotangents, against their plain
   versions (K9 with K2's tolerance and floor, two launches bit-equal),
   timed beside their bounds, K8 also beside its products alone as
   chained ``torch.mm``; K8's sigma row bit-equal to K7's and, at depth 0,
   to K1's.
8. Plane training phase: the training entry with ``--use_rays_train
   false`` (30 steps) and at ``--N_rays 4000`` (10 steps): every step must
   launch K8 and K9 twice and nothing else, the losses must be finite
   (and fall over the 30); step times and one profiled plane step.  One
   step from the same state and draws through the ray pair and the plane
   pair: the losses within ``PLANE_AB_LOSS_RTOL``, the updates within two
   learning rates.  Then K8 and K9 on that step's own planes and
   cotangents with the seeded weights, against their plain versions.
9. Plane frames: ``--eval_only`` with ``--N_samples_f 0`` (coarse only:
   K8) and ``--N_samples_f 100`` (K7 for the coarse density, K8), and
   ``--render_only --N_samples_f 100`` (3 orbit views of the compact field
   through the culled renderer's plane branches): launches K7 and K8 only,
   frame times beside the ray route's of this run, one frame of each
   against the plain versions (>= 35 dB) and once more under the profiler.
10. LLFF phase: a synthetic forward-facing capture in the LLFF layout
   (``utils/synth.save_as_llff_dataset``: 10 views at 378x504, fern's
   downsample-8 size, so ``--downsample 0`` is the one cut) through
   configs/llff/fern.txt at full width: 60 training steps from the global
   ray pool with NDC rays (every step K1 and K2 twice, nothing else; the
   pre-cull never engages; losses finite and falling; step times, one
   profiled step, peak memory); ``--eval_only`` on the held-out views
   (testskip 8) through the dense renderer, two blocks a frame (131072
   rays and a ragged 59440), one view against the plain versions (>= 35
   dB); ``--render_only`` of the whole 120-view spiral through the culled
   renderer (K3 once a frame, K1 once a cover block, nothing else), one
   spiral pose at ``perturb 0`` culled against dense (>= 40 dB).  K1
   (float32) and K2 on one pool step's own NDC rays, depths and
   cotangents (K2 twice, the same bits), K3 and K1 (bf16) on one dense
   frame's blocks, the ragged one included, all with the seeded random
   weights, against their plain versions under ``KERNEL_TOL`` and
   ``GRAD_TOL``.  Then the same capture as ``data_type custom``
   (poses_bounds.npy in place, no COLMAP): the loader's near/far, 5
   steps and one orbit frame.

11. Plain-MLP route (``--use_pallas false``, no kernel on it): the lego
   config at full width, 30 per-image steps (loss falls; median step,
   idle share, peak memory beside the kernel route's step of this call),
   ``--eval_only`` of one 800x800 view, the same view at ``perturb 0``
   through the kernels and the plain route (>= 35 dB) and the plain route
   with and without TF32 in its forward products (time, PSNR),
   ``--render_only`` of 3 orbit views of the compact field through the
   culled renderer's plain branches, and ``--netDepth 4 --netWidth 128
   --L_x 0 --L_d 0`` (10 steps and a dense frame); every launch counter
   stays 0 through the phase (the kernels' reference frame is rendered
   before they are zeroed).

12. LPIPS (``eval/metrics.lpips_tensor``) on seeded random VGG16 weights
   at the ``_LPIPS_KEYS`` shapes: one 800x800 pair on the card against
   the CPU (1e-4 relative, TF32 off), the TF32-on reading beside it, one
   pair's time; ``--eval_only`` with ``lpips_weights`` set logs a finite
   LPIPS for every view.
13. Data parallelism (``parallel/``) at world size 1 over NCCL (the
   machine has one card): ``driver.main_worker`` under the launch
   contract's variables, 10 lego steps in each batch mode and one
   ``--eval_only`` frame, bit-equal to the same runs without them (K1 and
   K2, K3 and K1 launched), step times beside the plain launch's (plain,
   launched, launched, plain); then
   ``torch.distributed.run --standalone --nproc_per_node 1`` on the CLI
   with ``--n_data_shards 1``: exit 0 and rank 0's checkpoint.
14. The mesh's model axis (``mesh_phase``): two ranks share the one card
   over gloo (NCCL takes one rank a GPU; this shows the semantics and the
   kernels on the card, not a 2-GPU speed), each a ``chip_smoke.py
   --mesh-worker`` process that makes its group and calls
   ``driver.main_worker``: ``--n_model_shards 2`` training of lego at full
   width (3 steps a batch mode at 512 rays, float32: step 1's loss within
   1e-5 of the one-process plain-route step, no kernel, the replicated
   weights bit-equal), ``--eval_only`` of one 800x800 view of its gathered
   checkpoint (K3 and K1; the frame within 1e-5 of one process's), and
   with ``--sp_shards 2`` (K8 alone; at ``perturb 0`` >= 35 dB against
   the dense kernel frame; K8 on one rank's coarse and fine planes of a
   block within ``KERNEL_TOL`` of its plain version, timed one rank at a
   time).

15. ``scan_chunk`` (``chunk_phase``, run after the LLFF phase): the lego
   ray step (K1/K2), the gated step from the compact field (K5/K6, a
   refresh every 16 steps), the plane step (K8/K9) and fern's pool step
   (K1/K2 on NDC rays), 48 steps each at ``--scan_chunk 16`` (three full
   chunks: CUDA graphs of the staged step, captured once a kind and
   replayed) and at ``--scan_chunk 1``: losses, weights and Adam's state
   bit-equal, the launch counts equal, the captures and replays printed
   (a run without a replay fails); the ray step again under a world-1
   NCCL group (its all-reduces captured), bit-equal; the median step of
   steps 17-48 of both beside the card's name and power limit; one
   replayed chunk of 16 ray steps and the same steps eager under the
   profiler (idle shares; each kernel's launches in the device trace
   equal to the launch counters' change, so the counts a replay adds are
   true); a ``--profile true`` run whose Chrome trace names K1 and K2.  The earlier phases run at the default
   ``scan_chunk 16`` too: the 60-step runs replay graphs, and the launch
   counters stay true (each replay adds the launches its capture
   recorded).

16. The distilled fields (``distilled_phase``): the JAX bench's three
   blob scenes (std, hi, hard: ``DISTILLED_SCENES``) distilled into a
   lego-width NeRF by ``utils/synth.fit_field_to_blob`` through K8/K9
   (8192 ray points and a quarter as many uniform ones, then the polish
   phase; the fit's default learning rates): each fit's time and ms a
   step, exactly 2 K8 + 2 K9 launches a step and no other kernel, the
   first step's
   gradients through K8/K9 against the plain pair on the card within
   ``GRAD_TOL`` (the floor: the plain pair on the CPU); K8 (float32) and
   K9 at the fit's two shapes against their plain versions and bounds;
   both modules' support grids (K7): valid or not, occupied cells, those
   in the cube's outer layers, the largest far-field density logit; pose
   0 of the synthetic orbit at 800x800 (focal 0.9 W) through the culled
   and the dense renderer at ``perturb 0`` (CUDA events, median of 3
   after a warm-up), with the culled frame's active
   share, cover blocks, truncated share and gate skip shares, and (std)
   ``ops.render_frame`` of the frame's rays in 131072-ray blocks on K7 and
   K8 (one launch of each a block; >= 35 dB against the dense ray-kernel
   frame); on the hard
   and std scenes 60 eager train steps on 4096 pixel rays of that pose,
   gated by the fitted field's bounds and ungated (median of steps
   17-60, ``gate_frac``, whether the bounds were valid).  Each returned
   field is gated: the loss the fit returns < 0.1 (the JAX fixtures'
   limit), the polish-phase loss of the returned weights on fresh draws
   < 0.1, the dense frame >= 22 dB against the analytic frame of the
   scene's blob (the JAX fixtures' floor), the culled frame >= 40 dB from
   the dense one and no further from the blob than the JAX package's
   guards allow (0.05 dB on the soft scenes, 0.3 dB on the hard one).  A
   failed gate is printed, the later phases still run, and the run fails
   at its end.
17. The multi-rank dry run (``dryrun_phase``): ``python -m
   nerf_pytorch_paeng_tpu_torch.dryrun 2`` with both ranks on the card
   over gloo: six ``OK`` lines and each phase's launches summed over the
   ranks (none on the plain route, K1/K2 on the data-parallel steps, K7
   then K4/K5 on the culled frame, K5/K6 on the gated step).
18. The culled renderer's phase 0 (``phase0_phase``: ``render_precull on``
   off the ray kernels) on phase 16's three fields, pose 0 at 800x800,
   ``perturb 0``: the plane route at 64+100 samples (dense, culled with
   the pre-cull off and on; median of 3, CUDA events) and the plain route
   (``--use_pallas false``, 64+128; culled off and on on std and hard, one
   frame each).  The missed share of the coarse bounds, ``renderer.stats``
   and the launches (plane route: K7 once for the grid and once a phase-1
   block, K8 once a cover block; plain route: none).  Gates: on against
   off within 1e-5 rgb and 1e-4 disp (plane) or 50 dB (plain), on against
   dense >= 40 dB, a missed share above 0.

NGP phase (Instant-NGP's kernels, ``kernels/hash_grid.py`` and
``kernels/ngp_march.py``), at the training step's shapes (4,096 rays, a
budget of 2^18 samples, the published 16 levels of 2^19 entries and
128^3 grid) on a grid after two updates of a field whose density spans
many decades: the marcher (count, scan, compact) bit-equal to
``march_plain``; the hash encoding's forward within 1e-5 of
``hash_encode_plain`` and its atomic backward within 1e-5 relative L2 a
table (the atomics add in another order); the compositing forward within
2e-5 of ``composite_plain`` and its backward within 1e-4 relative L2;
each timed beside its plain twin and the least time of its streamed
bytes or its FP32 operations.  Then ``driver.main_worker`` trains the
NGP config (``configs/blender_lego_ngp.txt``) for three chunks of 16 on
a synthetic scene, the NGP counters at 0 before: one launch of each
kernel a step, and the encoding's forward eight times more in each of
the two grid updates.  ``python3 chip_smoke.py --ngp`` runs this phase
alone.

Each path runs with every launch counter at 0 before and is read after.
Prints the card's name and power limit, one ``{"kernels": [...]}`` line,
and as its last line ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero before that line; so does a machine without CUDA or a directory
without the port.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
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
CULLED_VS_DENSE_PSNR_MIN = 40.0   # the cull and the truncation move O(1e-3)
GATED_VS_UNGATED_MAX = 1e-5       # gated samples carry zero weight
RENDER_VIEWS = 12                 # the lego orbit's 120, cut to 12
SUPPORT_GRID = 128                # the support grid on the card (eval/frame.py)
LEGO_CAMERA_ANGLE_X = 0.6911112070083618   # lego's transforms_*.json
TRAIN_STEPS = 60
RESUME_STEPS = 5
GATED_START = 1000                # the compact field's checkpoint step
GATED_EVERY = 20                  # --train_precull_every of the gated phase
# the gated phase's compact field: an L1 ball of radius 1.0.  The render
# phase's radius 1.5 fills most of a training view at lego's field of view,
# so the policy predicts a skipped share below its 0.15 floor and declines
# (0.133 on a 64^3 grid, CPU estimate); that run is kept as the policy's
# fallback case.
GATED_RADIUS = 1.0
PLANE_FINE = 100                  # --N_samples_f of the plane frames: 164
PLANE_STEPS = 30                  # --use_rays_train false
PLANE_SHAPE_STEPS = 10            # --N_rays 4000
PLANE_RENDER_VIEWS = 3
# the ray and the plane pair on one step from the same state and draws:
# both bf16, but positions, directions and sums round at other points
PLANE_AB_LOSS_RTOL = 1e-2
# the LLFF phase: a synthetic forward-facing capture at fern's downsample-8
# size; the ground truth is rendered with 128 samples a ray (the JAX
# package's writer takes 256) to keep the capture's writing short
LLFF_HW = (378, 504)
LLFF_VIEWS = 10
LLFF_GT_SAMPLES = 128
LLFF_STEPS = 60
LLFF_SPIRAL = 120                 # load_llff's spiral: every view rendered
CUSTOM_STEPS = 5
# the library_ms of the forward kernels' rows (``products_ms``)
PRODUCTS_ONLY = "its bf16 products alone as chained torch.mm at this row's points"
ACTIVE_PRODUCTS_ONLY = ("its bf16 products alone as chained torch.mm at the "
                        "gate's active points")
WGRAD_ONLY = ("torch.mm(A.t(), G) per weight-gradient product, the products "
              "alone, at this row's points")
# the plain-MLP route (``--use_pallas false``): no kernel runs on it
PLAIN_STEPS = 30
PLAIN_RENDER_VIEWS = 3
PLAIN_SHAPE = ("--netDepth", "4", "--netWidth", "128", "--L_x", "0",
               "--L_d", "0")              # outside the kernels' domain
PLAIN_SHAPE_STEPS = 10
# the chunk phase: --scan_chunk CHUNK against 1, three full chunks a run
CHUNK = 16
CHUNK_STEPS = 48
# the mesh phase: two ranks on the one card over gloo, which stages every
# collective through the host; the width-sharded steps' batch is cut from
# 4096 rays (one row-parallel activation all-reduce at 4096 x 192 points
# is 805 MB)
MESH_RAYS = 512
MESH_STEPS = 3
MESH_TIMEOUT_S = 600
# phase 16: the JAX bench's three distilled scenes (bench.py:125-157), fit
# at lego's width through K8/K9 from init seed 0 with the fit's generator
# seeded 1, at the fit's default learning rates (``fit_learning_rates``:
# the JAX function's constant rate can leave the hard scene's fit inside a
# loss spike and its long polish grows a halo round the blob)
DISTILLED_SCENES = (
    ("std", dict(blob_r=0.45, blob_cutoff=1.35, blob_amp=8.0,
                 blob_hard_w=0.0, n_steps=300)),
    ("hi", dict(blob_r=0.54, blob_cutoff=1.62, blob_amp=8.0,
                blob_hard_w=0.0, n_steps=300)),
    ("hard", dict(blob_r=0.45, blob_cutoff=1.35, blob_amp=60.0,
                  blob_hard_w=0.08, n_steps=1500)))
FIT_PTS = 8192
FIT_UNIFORM_FRAC = 0.25
# the gates on each returned field (``gate``: a failure is printed, the
# other phases still run, the run fails at its end).  The loss a fit
# returns (its last main step's) below FIT_LOSS_MAX, the JAX fixtures'
# limit (tests/test_render_culled.py); the polish-phase loss of the
# returned weights on fresh draws (the objective they were last trained
# on) below the same limit; the dense frame of pose 0 against the
# analytic frame of the blob at least DENSE_VS_BLOB_PSNR_MIN, the JAX
# fixtures' floor; the culled frame CULLED_VS_DENSE_PSNR_MIN from the
# dense one, and against the blob no more than CULLED_VS_BLOB_LOSS_MAX
# further from it than the dense one: the JAX package's guards, 0.05 dB on
# its soft scene and 0.3 dB on its hard one, where separately distilled
# coarse and fine modules disagree on the silhouette
FIT_LOSS_MAX = 0.1
HELD_OUT_DRAWS = 4
DENSE_VS_BLOB_PSNR_MIN = 22.0
GT_SAMPLES = 256          # the analytic frame of a distilled scene's blob
DISTILLED_HW = 800        # the JAX bench's frame: pose 0, focal 0.9 W
CULLED_VS_BLOB_LOSS_MAX = {"std": 0.05, "hi": 0.05, "hard": 0.3}
DISTILLED_GATED = ("hard", "std")
DISTILLED_STEPS = 60      # gated and ungated steps on 4096 pixel rays
DISTILLED_MEDIAN_FROM = 17
DRYRUN_RANKS = 2
DRYRUN_TIMEOUT_S = 300
# phase 18: the culled renderer's phase 0 (render_precull on off the ray
# kernels) on phase 16's fields.  Pre-cull on against off: the JAX
# package's tests/test_precull.py tolerances on the plane route (K7
# evaluates each point alone, so the hit rays' weights are the same bits),
# PSNR on the plain route (cuBLAS may pick another algorithm for a block of
# another row count)
PHASE0_RGB_MAX = 1e-5
PHASE0_DISP_MAX = 1e-4
PHASE0_PLAIN_PSNR_MIN = 50.0
PHASE0_PLAIN_SCENES = ("std", "hard")
# the NGP phase: the kernels' tolerances against their plain twins (the
# card tests' own), the peaks of their bounds, the trained chunks
NGP_HASH_TOL = 1e-5               # forward abs/rel; backward rel L2 a table
NGP_COMPOSITE_TOL = dict(atol=2e-5, rtol=1e-5, bwd_rel_l2=1e-4)
PEAK_FP32_FLOPS = 67e12           # H100 SXM, outside the tensor cores
NGP_CHUNKS = 3
NGP_SCENE_HW = 200


def log(*a):
    print(*a, flush=True)


def check(ok: bool, what) -> None:
    """A failed check ends the run (asserts would vanish under -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


FAILED_GATES: list = []


def gate(ok: bool, what) -> None:
    """A failed gate on what a path produced (a fitted field): printed at
    once and again at the end, where it fails the run after every phase
    has run and printed its numbers."""
    if not ok:
        log(f"chip_smoke gate failed: {what}")
        FAILED_GATES.append(str(what))


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
        lib_ms = products_ms(p, BLOCK * s, full=n_out == 4)
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
            f"({flop / k_ms / 1e9:.1f} TFLOP/s); its products alone as "
            f"torch.mm over the same {BLOCK * s} points {lib_ms:.3f} ms")
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
            "library_ms": lib_ms, "library": PRODUCTS_ONLY,
            "plan": fm.rays_plan(BLOCK, s)}
    # K3 and K1 share the trunk and the density head: their sigma bits agree
    od, z = seeded_rays(BLOCK, 192, seed=192, device=device)
    check(torch.equal(fm.fused_mlp_sigma_rays(od, z, packed["fine"]),
                      fm.fused_mlp_eval_rays(od, z, packed["fine"])[3]),
          "K3's sigma differs from K1's on the same inputs and weights")
    maps_us = fm._library().nerf_fwd_maps_us(packed["fine"]["w"].data_ptr(),
                                              1000)
    log(f"kernel phase: K3's sigma equals K1's bit for bit at ({BLOCK}, 192); "
        f"host time to encode a ray launch's two tensor maps {maps_us:.2f} "
        f"us (mean of 1000); plan at ({BLOCK}, 192) "
        f"{rows['fused_mlp_eval_rays']['plan']}")
    rows["fused_mlp_eval_rays"]["tma_encode_us"] = maps_us
    return rows


def bound(flop: float, nbytes: float):
    """(least ms for the work on this card, what sets it)."""
    t_ops, t_bytes = flop / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def products_ms(p, points: int, full: bool, chunk: int = 1 << 20) -> float:
    """The ray kernels' bf16 products alone as chained ``torch.mm`` calls
    (bf16 in and out; no embedding, bias, activation or rounding of its
    own): the trunk (the skip layer as ``mm`` + ``addmm``) and the density
    head, and for the full field the feature, view (``mm`` + ``addmm``)
    and colour products, over ``points`` points in chunks of ``chunk``:
    timed at the row's own point count (CUDA events), not scaled.  A
    yardstick the port never calls (the K1/K3 rows' ``library_ms``)."""
    dev = p["w"].device
    m = min(points, chunk)
    g = torch.Generator(dev).manual_seed(0)
    embx = torch.randn(m, 64, generator=g, device=dev).bfloat16()
    embd = torch.randn(m, 32, generator=g, device=dev).bfloat16()
    h = [torch.empty(m, 256, dtype=torch.bfloat16, device=dev)
         for _ in range(3)]
    hv = [torch.empty(m, 128, dtype=torch.bfloat16, device=dev)
          for _ in range(2)]
    dens = torch.empty(m, 1, dtype=torch.bfloat16, device=dev)
    col = torch.empty(m, 3, dtype=torch.bfloat16, device=dev)
    wdens = p["wdens"][:, None]

    def run():
        for i in range(0, points, m):
            r = min(m, points - i)
            a, b, c = (t[:r] for t in h)
            torch.mm(embx[:r], p["w0"], out=a)
            for name in ("w1", "w2", "w3", "w4"):
                torch.mm(a, p[name], out=b)
                a, b = b, a
            torch.mm(embx[:r], p["w5e"], out=b)
            torch.addmm(b, a, p["w5h"], out=c)
            torch.mm(c, p["w6"], out=a)
            torch.mm(a, p["w7"], out=b)
            torch.mm(b, wdens, out=dens[:r])
            if full:
                torch.mm(b, p["wfeat"], out=a)
                torch.mm(embd[:r], p["wvd"], out=hv[0][:r])
                torch.addmm(hv[0][:r], a, p["wvf"], out=hv[1][:r])
                torch.mm(hv[1][:r], p["wcol"], out=col[:r])

    ms, _ = cuda_ms(run, reps=3)
    return ms


def gated_flop(gate, n: int, s: int, per_sample: int, per_ray: int = 0):
    """FLOP of a gated launch: 8 samples of every ray of each active
    (128-ray tile, 8-sample row) block, and the per-ray term of every
    tile with an active row."""
    tiles = -(-n // 128)
    on = (gate.view(tiles, s // 8) != 0).cpu()
    rays = torch.clamp(n - 128 * torch.arange(tiles), max=128)
    return (int((on.sum(1) * rays).sum()) * 8 * per_sample
            + int(rays[on.any(1)].sum()) * per_ray)


def gated_kernel_phase(fm, packed, cfg, device):
    """K4 and K5 at the eval block with a seeded gate of about half its
    blocks on, against the ungated kernel and the gated plain version;
    times at that gate and at an all-on gate, beside the active work's
    bound."""
    rows = {}
    specs = (
        ("fused_mlp_sigma_rays_gated", fm.fused_mlp_sigma_rays,
         fm.fused_mlp_sigma_rays_plain, packed["coarse"], 64,
         fm.sigma_flop_per_sample(cfg.L_x), 0,
         "nerf_pytorch_paeng_tpu/kernels/fused_mlp.py:283"),
        ("fused_mlp_eval_rays_gated", fm.fused_mlp_eval_rays,
         fm.fused_mlp_eval_rays_plain, packed["fine"], 192,
         fm.eval_flop_per_sample(cfg.L_x), fm.eval_flop_per_ray(cfg.L_d),
         "nerf_pytorch_paeng_tpu/kernels/fused_mlp.py:453"),
    )
    for name, kern, plain, p, s, per_sample, per_ray, tpu_at in specs:
        od, z = seeded_rays(BLOCK, s, seed=s, device=device)
        size = -(-BLOCK // 128) * (s // 8)
        g = torch.Generator(device).manual_seed(3000 + s)
        half = (torch.rand(size, generator=g, device=device) < 0.5).to(
            torch.int32)
        all_on = torch.ones(size, dtype=torch.int32, device=device)
        on = fm.gate_mask(half, s, BLOCK)
        kw = dict(out_dtype=torch.bfloat16)
        k_ms, k_out = cuda_ms(lambda: kern(od, z, p, gate=half, **kw), reps=5)
        on_ms, on_out = cuda_ms(lambda: kern(od, z, p, gate=all_on, **kw),
                                reps=3)
        ungated = kern(od, z, p, **kw)
        on_out = on_out if isinstance(on_out, tuple) else (on_out,)
        check(all(torch.equal(a, b) for a, b in zip(
            on_out, ungated if isinstance(ungated, tuple) else (ungated,))),
            f"{name}: an all-on gate does not give the ungated kernel's bits")
        p_ms, p_out = cuda_ms(lambda: plain(od, z, p, gate=half, **kw),
                              reps=1)
        k_out, ungated, p_out = (x if isinstance(x, tuple) else (x,)
                                 for x in (k_out, ungated, p_out))
        for got, ung in zip(k_out, ungated):
            check(not bool(got[~on].any()), f"{name}: a gated block is not 0")
            check(torch.equal(got[on], ung[on]),
                  f"{name}: active blocks differ from the ungated kernel")
        max_abs, rel_l2 = errors([o[on] for o in k_out],
                                 [o[on] for o in p_out])
        check(max_abs <= KERNEL_TOL["max_abs"]
              and rel_l2 <= KERNEL_TOL["rel_l2"],
              f"{name} disagrees with its plain version")
        nbytes = (od.numel() * 4 + z.numel() * 4 + size * 4
                  + p["w"].numel() * 2 + p["b"].numel() * 4
                  + len(k_out) * s * BLOCK * 2)
        flop = gated_flop(half, BLOCK, s, per_sample, per_ray)
        flop_on = gated_flop(all_on, BLOCK, s, per_sample, per_ray)
        b_ms, b_by = bound(flop, nbytes)
        b_on_ms, _ = bound(flop_on, nbytes)
        share = float(on.float().mean())
        lib_ms = products_ms(p, int(on.sum()), full=len(k_out) == 4)
        log(f"kernel {name}: N={BLOCK} S={s} gate on {share:.3f} of the "
            f"blocks: gated blocks 0, active blocks bit-equal to the "
            f"ungated kernel, vs plain max_abs={max_abs:.3e} "
            f"rel_l2={rel_l2:.3e} (tolerance {KERNEL_TOL}); ms={k_ms:.3f} "
            f"plain_ms={p_ms:.3f} bound_ms={b_ms:.3f} "
            f"({flop / k_ms / 1e9:.1f} TFLOP/s); all on (bit-equal to the "
            f"ungated kernel): ms={on_ms:.3f} "
            f"bound_ms={b_on_ms:.3f} ({flop_on / on_ms / 1e9:.1f} TFLOP/s); "
            f"its products alone as torch.mm over the {int(on.sum())} "
            f"active points {lib_ms:.3f} ms")
        rows[name] = {
            "name": name, "route": "cuda",
            "source": "nerf_pytorch_paeng_tpu_torch/kernels/csrc/fused_mlp.cu",
            "replaces": tpu_at, "launches": None,
            "max_abs_err": max_abs, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "library": ACTIVE_PRODUCTS_ONLY,
            "gate_on_share": share, "all_on_ms": on_ms,
            "all_on_bound_ms": b_on_ms}
    return rows


def depth0_rays(x, d=None):
    """The points x [3, P] as rays at depth 0: od [8, P] with origin x and
    direction d (default (1, 0, 0)), z_t [1, P] of zeros; x = o + d 0 = o
    exactly, so the ray kernels' sigma must equal the points kernels'."""
    n = x.shape[1]
    od = torch.zeros(8, n, device=x.device)
    od[0:3] = x
    if d is None:
        od[3] = 1.0
    else:
        od[3:6] = d
    return od, torch.zeros(1, n, device=x.device)


def points_kernel_phase(fm, packed, cfg, device):
    """K7 on the support grid the culled renderer builds (128^3 points of
    the cube of half-side ``far``), beside its products alone as chained
    ``torch.mm``; its sigma must equal K3's at depth 0 bit for bit."""
    from nerf_pytorch_paeng_tpu_torch.ops.occupancy import grid_points
    x = grid_points(float(cfg.far), SUPPORT_GRID, device)
    n = x.shape[1]
    p = packed["coarse"]
    kw = dict(out_dtype=torch.bfloat16)
    k_ms, k_out = cuda_ms(lambda: fm.fused_mlp_sigma(x, p, **kw), reps=5)
    p_ms, p_out = cuda_ms(lambda: fm.fused_mlp_sigma_plain(x, p, **kw),
                          reps=2)
    max_abs, rel_l2 = errors([k_out], [p_out])
    check(max_abs <= KERNEL_TOL["max_abs"] and rel_l2 <= KERNEL_TOL["rel_l2"],
          "fused_mlp_sigma disagrees with its plain version")
    check(torch.equal(k_out, fm.fused_mlp_sigma_rays(*depth0_rays(x), p,
                                                     **kw)[0]),
          "K7's sigma differs from K3's at depth 0")
    lib_ms = products_ms(p, n, full=False)
    flop = fm.sigma_flop_per_sample(cfg.L_x) * n
    b_ms, b_by = bound(flop, x.numel() * 4 + n * 2 + p["w"].numel() * 2
                       + p["b"].numel() * 4)
    log(f"kernel fused_mlp_sigma: P={n} max_abs={max_abs:.3e} "
        f"rel_l2={rel_l2:.3e} (tolerance {KERNEL_TOL}) ms={k_ms:.3f} "
        f"plain_ms={p_ms:.3f} bound_ms={b_ms:.3f} "
        f"({flop / k_ms / 1e9:.1f} TFLOP/s, {100 * b_ms / k_ms:.1f}% of the "
        f"bound; {k_ms * 1e6 / n:.3f} ns a point); its products alone as "
        f"torch.mm over the same points {lib_ms:.3f} ms; sigma equals K3's "
        f"at depth 0 bit for bit")
    return {"name": "fused_mlp_sigma", "route": "cuda",
            "source": "nerf_pytorch_paeng_tpu_torch/kernels/csrc/fused_mlp.cu",
            "replaces": "nerf_pytorch_paeng_tpu/kernels/fused_mlp.py:585",
            "launches": None, "max_abs_err": max_abs, "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms, "library": PRODUCTS_ONLY, "points": n}


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


def bwd_bytes(fm, od, z, gate=None) -> int:
    """Bytes the backward must move: rays, depths, four cotangents (and the
    gate) read once, the packed weights read once, the grads written."""
    return ((od.numel() + 5 * z.numel()) * 4
            + (0 if gate is None else gate.numel() * 4)
            + fm.W_TOTAL * 2 + fm.B_TOTAL * 4 + (fm.W_TOTAL + fm.B_TOTAL) * 4)


BWD_LAUNCHES = ("bwd_chain_kernel", "wgrad_kernel", "reduce_kernel",
                "compact_tiles_kernel")


def bwd_launch_work(fm, cfg, points: int, plan: dict) -> dict:
    """(FLOP, bytes) each launch of the backward moves for ``points``
    stashed points under ``plan`` (``fused_mlp_vjp.bwd_plan``, the
    kernel's own chunking and stash layout): the chain launch recomputes
    the forward (``eval_flop_per_point``), runs the input-gradient
    products (every 256-wide layer's, wvf's and the heads') and writes the
    stash once; the weight-gradient launch runs dW = A^T G (2 x the
    weights its jobs cover a point) and reads the stash arrays it needs
    once; the reduction reads the partials and writes dw, db.  The stash's
    write and read exist because the two launches are apart: these are
    the split design's own bounds, not the backward's (``bwd_bytes``)."""
    W, H = 256, 128
    chain = 2 * (8 * W * W + W * H + W + H * 3)
    wg_total = sum(a * b for a, b in plan["wgrad_jobs"])
    part1 = fm.B_TOTAL + W + H * 3
    parts2 = plan["chunks"] * plan["nsplit"] * wg_total
    return {
        "bwd_chain_kernel": (
            (fm.eval_flop_per_point(cfg.L_x, cfg.L_d) + chain) * points,
            points * (plan["stash_per_point"] * 2 + 6 * 4)),
        "wgrad_kernel": (2 * wg_total * points,
                         points * plan["wgrad_read_per_point"] * 2
                         + parts2 * 4),
        "reduce_kernel": (0, (parts2 + plan["chunks"] * plan["g1"] * 2 * part1
                              + fm.W_TOTAL + fm.B_TOTAL) * 4)}


def bwd_split(fn, device, plan: dict, reps: int = 3) -> dict:
    """Device ms and launches per call of each backward launch (by the
    profiler's kernel names, ``BWD_LAUNCHES``) over ``reps`` calls of
    ``fn``: the mean time of a launch times the launches a call makes
    under ``plan`` (one chain and one weight-gradient launch a chunk, one
    reduction; the profiler can miss the first launch of its window, so
    its count is not used)."""
    from torch.profiler import ProfilerActivity, profile
    per_call = {"bwd_chain_kernel": plan["chunks"],
                "wgrad_kernel": plan["chunks"], "reduce_kernel": 1,
                "compact_tiles_kernel": 1}
    fn()
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize(device)
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for name in BWD_LAUNCHES:
            if name in e.key:
                ms = getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0)) / 1e3
                t, c = out.get(name, (0.0, 0))
                out[name] = (t + ms, c + e.count)
    return {name: (t / c * per_call[name], per_call[name])
            for name, (t, c) in out.items()}


def report_split(fm, cfg, split: dict, plan: dict, points: int,
                 what: str) -> dict:
    """Log each launch's ms, TFLOP/s and share of its own bound under the
    kernel's ``plan`` (``bwd_launch_work``: the split design's traffic,
    the stash round trip included); returns them."""
    work = bwd_launch_work(fm, cfg, points, plan)
    rows = {}
    for name, (ms, count) in split.items():
        flop, nbytes = work.get(name, (0, 0))
        b_ms, b_by = bound(flop, nbytes)
        rows[name] = dict(ms=ms, launches=count, launch_bound_ms=b_ms,
                          bound_by=b_by,
                          tflops=flop / ms / 1e9 if ms > 0 else None,
                          share_of_launch_bound=b_ms / ms if ms > 0 else None)
        log(f"  {what} {name}: {ms:.3f} ms in {count:g} launches"
            + (f", {flop / ms / 1e9:.1f} TFLOP/s" if flop else "")
            + (f", its own bound (split design's traffic) {b_ms:.3f} ms "
               f"({b_by}), {100 * b_ms / ms:.1f}% of it"
               if b_ms and ms > 0 else ""))
    return rows


def wgrad_library_ms(device, jobs, points: int) -> float:
    """The weight-gradient products of ``points`` stashed points as
    PyTorch calls: one ``torch.mm(A.t(), G)`` per job of ``jobs`` (the
    kernel's (rows, columns), ``bwd_plan``) on seeded bf16 point-major
    arrays of ``points`` rows; a yardstick the port never calls."""
    g = torch.Generator(device).manual_seed(77)

    def arr(cols):
        return (torch.rand(points, cols, generator=g, device=device)
                - 0.5).to(torch.bfloat16)

    pairs = [(arr(a), arr(b)) for a, b in jobs]
    ms, _ = cuda_ms(lambda: [torch.mm(a.t(), b) for a, b in pairs], reps=5)
    del pairs
    torch.cuda.empty_cache()
    return ms


def per_tensor(fm, got, want) -> dict:
    """{packed tensor: (relative L2, cosine)} of ``got`` against ``want``
    (both (dw, db)), where ``want`` is not zero."""
    g, w = (fm._with_views(*(t.cpu() for t in x)) for x in (got, want))
    out = {}
    for name in g:
        a, b = g[name].double().flatten(), w[name].double().flatten()
        if name in ("w", "b") or float(b.norm()) == 0.0:
            continue
        out[name] = (float((a - b).norm() / b.norm()),
                     float(a @ b / (a.norm() * b.norm())))
    return out


def ragged_noise_reading(fm, fv, p, device, seeds=(0, 1, 2, 3, 4)) -> list:
    """K2 at a ragged 1000 rays x 64 under random cotangents (N(0, 1e-3),
    as ``tests/test_torch_cuda.py`` draws them), one seed each: ``b0``'s
    relative L2 and cosine against the plain version on the card, beside
    the floor (the plain version on the CPU against it), and the worst
    tensor under ``GRAD_TOL``.  A reading of the bf16 noise that random
    cotangents carry down the chain; the gates are the loss-shaped
    cotangents' (``train_kernel_phase``, the card tests)."""
    out = []
    for seed in seeds:
        od, z = seeded_rays(1000, 64, seed=9000 + seed, device=device)
        g = torch.Generator(device).manual_seed(9100 + seed)
        cots = [torch.randn(64, 1000, generator=g, device=device) * 1e-3
                for _ in range(4)]
        got = fv.fused_mlp_bwd_rays(od, z, *cots, p)
        want = fv.fused_mlp_bwd_rays_plain(od, z, *cots, p)
        other = fv.fused_mlp_bwd_rays_plain(
            od.cpu(), z.cpu(), *(c.cpu() for c in cots),
            fm._with_views(p["w"].cpu(), p["b"].cpu()))
        kernel, floor = per_tensor(fm, got, want), per_tensor(fm, other, want)
        (rel, limit, at), cos, _ = grad_errors(fm, got, want, other)
        row = dict(seed=seed, b0_rel_l2=kernel["b0"][0], b0_cos=kernel["b0"][1],
                   b0_floor_rel_l2=floor["b0"][0], b0_floor_cos=floor["b0"][1],
                   worst=at, worst_rel_l2=rel, worst_limit=limit, min_cos=cos)
        log(f"  K2 ragged (1000, 64), random cotangents, seed {seed}: b0 "
            f"cos {row['b0_cos']:.6f} (floor {row['b0_floor_cos']:.6f}) "
            f"rel_l2 {row['b0_rel_l2']:.3e} (floor "
            f"{row['b0_floor_rel_l2']:.3e}); worst {at} {rel:.3e} against "
            f"{limit:.3e}, min cos {cos:.6f}")
        out.append(row)
    return out


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
        k1_lib_ms = products_ms(p, n * s, full=True)
        again = fm.fused_mlp_eval_rays(od, z, p)
        check(all(torch.equal(a, b) for a, b in zip(outs, again)),
              f"K1 float32 at ({n}, {s}): two launches differ")
        check(torch.equal(fm.fused_mlp_sigma_rays(od, z, p), outs[3]),
              f"K3's sigma differs from K1's at ({n}, {s})")

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
        t_ops = flop / PEAK_BF16_FLOPS * 1e3
        t_bytes = bwd_bytes(fm, od, z) / PEAK_BYTES * 1e3
        log(f"kernel fused_mlp_eval_rays (float32 out): N={n} S={s} "
            f"max_abs={k1_abs:.3e} rel_l2={k1_rel:.3e} ms={k1_ms:.3f} "
            f"plain_ms={k1_plain_ms:.3f} bound_ms={k1_bound:.3f} "
            f"({k1_flop / k1_ms / 1e9:.1f} TFLOP/s); products alone as "
            f"torch.mm {k1_lib_ms:.3f} ms; two launches bit-equal, K3's "
            f"sigma equal to K1's; plan {fm.rays_plan(n, s)}")
        log(f"kernel fused_mlp_bwd_rays: N={n} S={s} worst rel_l2={rel:.3e} "
            f"against its limit {limit:.3e} ({at}) min cos={cos:.6f} "
            f"max_abs={max_abs:.3e} (tolerance {GRAD_TOL}; two launches "
            f"bit-identical) ms={k2_ms:.3f} "
            f"plain_ms={k2_plain_ms:.3f} bound_ms={max(t_ops, t_bytes):.3f} "
            f"({flop / k2_ms / 1e9:.1f} TFLOP/s of gradient products)")
        check(rel <= limit and cos >= GRAD_TOL["cos"],
              f"K2 at ({n}, {s}) disagrees with its plain version")
        plan = fv.bwd_plan(n, s)
        launches = report_split(fm, cfg, bwd_split(
            lambda: fv.fused_mlp_bwd_rays(od, z, *cots, p), device, plan),
            plan, n * s, f"K2 ({n}, {s})")
        # the weight-gradient launch's yardstick: torch.mm over this row's
        # own points
        lib_ms = wgrad_library_ms(device, plan["wgrad_jobs"], n * s)
        log(f"  K2 ({n}, {s}) weight-gradient products as "
            f"{len(plan['wgrad_jobs'])} torch.mm over {n * s} points "
            f"(bf16 out): {lib_ms:.3f} ms against wgrad_kernel "
            f"{launches.get('wgrad_kernel', {}).get('ms', float('nan')):.3f}")
        shapes.append(dict(N=n, S=s, k1_ms=k1_ms, k1_plain_ms=k1_plain_ms,
                           k1_bound_ms=k1_bound, k1_max_abs=k1_abs,
                           k1_library_ms=k1_lib_ms,
                           k2_ms=k2_ms, k2_plain_ms=k2_plain_ms,
                           k2_bound_ms=max(t_ops, t_bytes), k2_rel_l2=rel,
                           k2_rel_l2_limit=limit, k2_worst=at, k2_cos=cos,
                           k2_max_abs=max_abs, k2_launches=launches,
                           k2_wgrad_library_ms=lib_ms))
        k2_row = {
            "name": "fused_mlp_bwd_rays", "route": "cuda",
            "source": "nerf_pytorch_paeng_tpu_torch/kernels/csrc/fused_mlp_vjp.cu",
            "replaces": "nerf_pytorch_paeng_tpu/kernels/fused_mlp_vjp.py:251",
            "launches": None, "max_abs_err": max_abs, "ms": k2_ms,
            "plain_ms": k2_plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib_ms, "library": "torch.mm(A.t(), G) per "
            "weight-gradient product, the products alone, at this row's "
            "points", "launch_split": launches}
    k2_row["ragged_random_cotangents"] = ragged_noise_reading(
        fm, fv, packed["fine"], device)
    return k2_row, shapes


def k6_check(fm, fv, od, z, cots, p, gate, what: str):
    """K6 at one gate against its plain version on the card, with the
    plain version on the CPU as the floor (``grad_errors``); returns (the
    kernel's grads, (rel, limit, name), cos, max abs, plain ms)."""
    got = fv.fused_mlp_bwd_rays(od, z, *cots, p, gate=gate)
    plain_ms, want = cuda_ms(
        lambda: fv.fused_mlp_bwd_rays_plain(od, z, *cots, p, gate=gate),
        reps=1, warmup=0)
    other = fv.fused_mlp_bwd_rays_plain(
        od.cpu(), z.cpu(), *(c.cpu() for c in cots),
        fm._with_views(p["w"].cpu(), p["b"].cpu()), gate=gate.cpu())
    (rel, limit, at), cos, max_abs = grad_errors(fm, got, want, other)
    check(rel <= limit and cos >= GRAD_TOL["cos"],
          f"K6 {what} disagrees with its plain version ({at}: {rel} > "
          f"{limit} or cos {cos})")
    return got, (rel, limit, at), cos, max_abs, plain_ms, other


def gated_train_kernel_phase(fm, fv, packed, cfg, device):
    """The gated training pair at the training batch (4096 rays; the coarse
    pass's 64 and the fine pass's 192 samples), seeded random weights and
    loss-like cotangents, under three gates: all on, a seeded half on, all
    off.  K5 with float32 outputs, and K6."""
    n, p = TRAIN_RAYS, packed["fine"]
    rows, shapes = {}, []
    for s in (cfg.N_samples_c, cfg.N_samples_c + cfg.N_samples_f):
        od, z = seeded_rays(n, s, seed=4000 + s, device=device)
        size = -(-n // 128) * (s // 8)
        g = torch.Generator(device).manual_seed(5000 + s)
        gates = {
            "half": (torch.rand(size, generator=g, device=device) < 0.5)
            .to(torch.int32),
            "on": torch.ones(size, dtype=torch.int32, device=device),
            "off": torch.zeros(size, dtype=torch.int32, device=device)}
        on = fm.gate_mask(gates["half"], s, n)
        share = float(on.float().mean())

        # K5, float32 outputs
        k5_ms, k5 = cuda_ms(
            lambda: fm.fused_mlp_eval_rays(od, z, p, gate=gates["half"]),
            reps=5)
        k5_on_ms, k5_on = cuda_ms(
            lambda: fm.fused_mlp_eval_rays(od, z, p, gate=gates["on"]), reps=3)
        k1 = fm.fused_mlp_eval_rays(od, z, p)
        check(all(torch.equal(a, b) for a, b in zip(k5_on, k1)),
              f"K5 float32 at ({n}, {s}): an all-on gate does not give K1's "
              "bits")
        k5_plain_ms, k5_plain = cuda_ms(
            lambda: fm.fused_mlp_eval_rays_plain(od, z, p, gate=gates["half"]),
            reps=1)
        for got, ung in zip(k5, k1):
            check(not bool(got[~on].any()),
                  f"K5 float32 at ({n}, {s}): a gated block is not 0")
            check(torch.equal(got[on], ung[on]), f"K5 float32 at ({n}, {s}): "
                  "active blocks differ from K1")
        k5_abs, k5_rel = errors([o[on] for o in k5], [o[on] for o in k5_plain])
        check(k5_abs <= KERNEL_TOL["max_abs"] and k5_rel <= KERNEL_TOL["rel_l2"],
              f"K5 float32 at ({n}, {s}) disagrees with its plain version")
        k5_bytes = ((od.numel() + z.numel() + size) * 4 + p["w"].numel() * 2
                    + p["b"].numel() * 4 + 4 * s * n * 4)
        k5_b, k5_by = bound(gated_flop(gates["half"], n, s,
                                       fm.eval_flop_per_sample(cfg.L_x),
                                       fm.eval_flop_per_ray(cfg.L_d)), k5_bytes)
        k5_b_on, _ = bound(gated_flop(gates["on"], n, s,
                                      fm.eval_flop_per_sample(cfg.L_x),
                                      fm.eval_flop_per_ray(cfg.L_d)), k5_bytes)

        # K6
        cots = loss_like_cotangents(k1, seed=6000 + s, device=device)
        k2 = fv.fused_mlp_bwd_rays(od, z, *cots, p)
        times, grads = {}, {}
        for kind in ("half", "on", "off"):
            times[kind], grads[kind] = cuda_ms(
                lambda: fv.fused_mlp_bwd_rays(od, z, *cots, p,
                                              gate=gates[kind]), reps=3)
        again = fv.fused_mlp_bwd_rays(od, z, *cots, p, gate=gates["half"])
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(grads["on"], k2)),
              f"K6 at ({n}, {s}): an all-on gate does not give K2's bits")
        check(all(torch.equal(a, b) for a, b in zip(grads["half"], again)),
              f"K6 at ({n}, {s}): two launches differ")
        check(not any(bool(t.any()) for t in grads["off"]),
              f"K6 at ({n}, {s}): an all-off gate gives nonzero gradients")
        _, (rel, limit, at), cos, max_abs, plain_ms, other = k6_check(
            fm, fv, od, z, cots, p, gates["half"], f"at ({n}, {s}), half on")
        zeroed = fv.fused_mlp_bwd_rays(
            od, z, *(c.masked_fill(~on, 0.0) for c in cots), p)
        (zrel, zlimit, zat), zcos, _ = grad_errors(fm, grads["half"], zeroed,
                                                   other)
        check(zrel <= zlimit and zcos >= GRAD_TOL["cos"],
              f"K6 at ({n}, {s}) differs from K2 with the gated cotangents "
              f"zeroed ({zat}: {zrel} > {zlimit} or cos {zcos})")
        per = fm.bwd_flop_per_sample(cfg.L_x, cfg.L_d)
        b_half, b_by = bound(per * int(on.sum()), bwd_bytes(fm, od, z,
                                                           gates["half"]))
        k5_lib = products_ms(p, int(on.sum()), full=True)
        k6_lib = wgrad_library_ms(device, fv.bwd_plan(n, s)["wgrad_jobs"],
                                  int(on.sum()))
        b_on, _ = bound(per * s * n, bwd_bytes(fm, od, z, gates["on"]))
        log(f"kernel fused_mlp_eval_rays gated (float32 out): N={n} S={s} "
            f"gate on {share:.3f}: gated blocks 0, active blocks and an "
            f"all-on gate bit-equal to K1, vs plain max_abs={k5_abs:.3e} "
            f"rel_l2={k5_rel:.3e}; "
            f"ms={k5_ms:.3f} plain_ms={k5_plain_ms:.3f} bound_ms={k5_b:.3f}; "
            f"all on ms={k5_on_ms:.3f} bound_ms={k5_b_on:.3f}")
        log(f"kernel fused_mlp_bwd_rays gated: N={n} S={s} gate on "
            f"{share:.3f}: all on bit-equal to K2, two launches bit-equal, "
            f"all off zero; half vs plain worst rel_l2={rel:.3e} against "
            f"{limit:.3e} ({at}) min cos={cos:.6f} max_abs={max_abs:.3e}; "
            f"vs K2 with zeroed cotangents rel_l2={zrel:.3e} against "
            f"{zlimit:.3e} ({zat}) cos={zcos:.6f}; ms half {times['half']:.3f}"
            f" (bound {b_half:.3f}, plain {plain_ms:.3f}), all on "
            f"{times['on']:.3f} (bound {b_on:.3f}), all off "
            f"{times['off']:.3f}; at the {int(on.sum())} active points K5's "
            f"products alone as torch.mm {k5_lib:.3f} ms, K6's weight-"
            f"gradient products as torch.mm {k6_lib:.3f} ms")
        shapes.append(dict(N=n, S=s, gate_on_share=share, k5_ms=k5_ms,
                           k5_all_on_ms=k5_on_ms, k5_plain_ms=k5_plain_ms,
                           k5_bound_ms=k5_b, k5_all_on_bound_ms=k5_b_on,
                           k5_max_abs=k5_abs, k6_ms=times["half"],
                           k6_all_on_ms=times["on"],
                           k6_all_off_ms=times["off"], k6_plain_ms=plain_ms,
                           k6_bound_ms=b_half, k6_all_on_bound_ms=b_on,
                           k6_rel_l2=rel, k6_rel_l2_limit=limit, k6_cos=cos,
                           k6_max_abs=max_abs, k6_vs_zeroed_k2_rel_l2=zrel))
        rows["fused_mlp_eval_rays_gated_f32"] = {
            "name": "fused_mlp_eval_rays_gated_f32", "route": "cuda",
            "source": "nerf_pytorch_paeng_tpu_torch/kernels/csrc/fused_mlp.cu",
            "replaces": "nerf_pytorch_paeng_tpu/kernels/fused_mlp.py:453",
            "launches": None, "max_abs_err": k5_abs, "ms": k5_ms,
            "plain_ms": k5_plain_ms, "bound_ms": k5_b, "bound_by": k5_by,
            "library_ms": k5_lib, "library": ACTIVE_PRODUCTS_ONLY,
            "gate_on_share": share,
            "all_on_ms": k5_on_ms, "all_on_bound_ms": k5_b_on}
        rows["fused_mlp_bwd_rays_gated"] = {
            "name": "fused_mlp_bwd_rays_gated", "route": "cuda",
            "source": "nerf_pytorch_paeng_tpu_torch/kernels/csrc/fused_mlp_vjp.cu",
            "replaces": "nerf_pytorch_paeng_tpu/kernels/fused_mlp_vjp.py:277",
            "launches": None, "max_abs_err": max_abs, "ms": times["half"],
            "plain_ms": plain_ms, "bound_ms": b_half, "bound_by": b_by,
            "library_ms": k6_lib, "library": WGRAD_ONLY.replace(
                "this row's points", "the gate's active points"),
            "gate_on_share": share,
            "all_on_ms": times["on"], "all_on_bound_ms": b_on,
            "all_off_ms": times["off"]}
    return rows, shapes


def psnr(a, b) -> float:
    mse = float(torch.mean((a.float() - b.float()) ** 2))
    return math.inf if mse == 0 else -10.0 * math.log10(mse)


def profile_call(fn, what: str, device, with_counts: bool = False) -> dict:
    """``fn()`` under torch.profiler: device time by kernel and the
    device's idle share of the call's wall time (``with_counts``: and
    ``counts``, every kernel's launches in the trace, by name)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = {}     # device kernels only: CPU-op rows repeat their time
    counts = {}        # launches by kernel name, as the device trace saw them
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        counts[e.key] = counts.get(e.key, 0) + e.count
        ms = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0)) / 1e3
        if ms > 0:
            by_kernel[e.key] = (ms, e.count)
    busy = sum(ms for ms, _ in by_kernel.values())
    if busy == 0:
        log("profile: the profiler saw no device time (not measured)")
        return {"wall_ms": wall_ms, "device_busy_ms": None,
                **({"counts": counts} if with_counts else {})}
    log(f"profile: {what} wall {wall_ms:.1f} ms under the profiler, device "
        f"busy {busy:.1f} ms, idle share {1 - busy / wall_ms:.3f}")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:8]
    for key, (ms, count) in top:
        log(f"  {ms:9.2f} ms {100 * ms / busy:5.1f}%  x{count:<4d} {key[:90]}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": 1 - busy / wall_ms,
            "top": [[k[:90], ms, n] for k, (ms, n) in top],
            **({"counts": counts} if with_counts else {})}


def launch_counters() -> dict:
    """Every kernel's launch counter, by kernel name: (wrapper, attribute).
    The rays wrappers count their gated launches (K4, K5, K6) apart; K5's
    two rows (bf16 outputs on the render path, float32 on the gated
    training path) share its counter and are read on their own paths."""
    from nerf_pytorch_paeng_tpu_torch.kernels import fused_mlp as fm
    from nerf_pytorch_paeng_tpu_torch.kernels import fused_mlp_vjp as fv
    return {"fused_mlp_sigma_rays": (fm.fused_mlp_sigma_rays, "launches"),
            "fused_mlp_eval_rays": (fm.fused_mlp_eval_rays, "launches"),
            "fused_mlp_bwd_rays": (fv.fused_mlp_bwd_rays, "launches"),
            "fused_mlp_sigma_rays_gated": (fm.fused_mlp_sigma_rays,
                                           "gated_launches"),
            "fused_mlp_eval_rays_gated": (fm.fused_mlp_eval_rays,
                                          "gated_launches"),
            "fused_mlp_eval_rays_gated_f32": (fm.fused_mlp_eval_rays,
                                              "gated_launches"),
            "fused_mlp_bwd_rays_gated": (fv.fused_mlp_bwd_rays,
                                         "gated_launches"),
            "fused_mlp_sigma": (fm.fused_mlp_sigma, "launches"),
            "fused_mlp_eval": (fm.fused_mlp_eval, "launches"),
            "fused_mlp_eval_f32": (fm.fused_mlp_eval, "launches"),
            "fused_mlp_bwd": (fv.fused_mlp_bwd, "launches")}


def zero_launches() -> None:
    for fn, attr in launch_counters().values():
        setattr(fn, attr, 0)


def read_launches() -> dict:
    return {name: getattr(fn, attr)
            for name, (fn, attr) in launch_counters().items()}


def ngp_launch_counters() -> dict:
    """The NGP kernels' launch counters, by row name."""
    from nerf_pytorch_paeng_tpu_torch.kernels import hash_grid as hg
    from nerf_pytorch_paeng_tpu_torch.kernels import ngp_march as nm
    return {"hash_encode_fwd": (hg.hash_encode, "launches"),
            "hash_encode_bwd": (hg.hash_encode_bwd, "launches"),
            "ngp_march": (nm.march, "launches"),
            "ngp_composite_fwd": (nm.composite_fwd, "launches"),
            "ngp_composite_bwd": (nm.composite_bwd, "launches")}


def ngp_field(cfg, device):
    """An NGP model whose density spans many decades (tables drawn wide,
    the density head scaled), its grid after an update of every cell and
    one of half of them; 4,096 orbit rays towards the cube and their
    uniforms."""
    from nerf_pytorch_paeng_tpu_torch.models.ngp import (
        GRID_WARMUP, init_ngp, update_occupancy_grid)
    model = init_ngp(cfg, device, seed=1)
    g = torch.Generator(device).manual_seed(2)
    with torch.no_grad():
        for t in model.tables:
            t.copy_(torch.randn(t.shape, generator=g, device=device) * 2.0)
        model.sigma_w1[0].mul_(5.0)
    for step in (0, GRID_WARMUP):
        update_occupancy_grid(model, cfg, step,
                              torch.Generator(device).manual_seed(3 + step))
    c = torch.randn(TRAIN_RAYS, 3, generator=g, device=device)
    o = 4.0 * c / c.norm(dim=1, keepdim=True)
    d = -o + 0.9 * torch.randn(TRAIN_RAYS, 3, generator=g, device=device)
    u = torch.rand(TRAIN_RAYS, generator=g, device=device)
    return model, o, d, u


def ngp_kernel_rows(device) -> dict:
    """The NGP kernels against their plain twins at the training step's
    shapes, each timed beside its twin and its bound."""
    from nerf_pytorch_paeng_tpu_torch.config import NerfConfig
    from nerf_pytorch_paeng_tpu_torch.kernels import hash_grid as hg
    from nerf_pytorch_paeng_tpu_torch.kernels import ngp_march as nm

    cfg = NerfConfig(arch="ngp", compute_dtype="bfloat16").validate()
    model, o, d, u = ngp_field(cfg, device)
    p = nm.MarchParams.from_cfg(cfg)
    L = len(model.levels)
    rows = {}

    def row(name, src, ms, plain_ms, nbytes, flop, err, tol, **extra):
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flop / PEAK_FP32_FLOPS * 1e3
        rows[name] = {
            "name": name, "route": "cuda",
            "source": f"nerf_pytorch_paeng_tpu_torch/kernels/csrc/{src}",
            "replaces": None, "launches": None, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "error": err, "tolerance": tol, **extra}
        log(f"kernel {name}: ms={ms:.4f} plain_ms={plain_ms:.3f} "
            f"bound_ms={rows[name]['bound_ms']:.4f} error={err:.3e} "
            f"(tolerance {tol}) {extra}")

    # the marcher: bit-equal to its twin
    k_ms, m = cuda_ms(lambda: nm.march(o, d, u, model.grid_bits, p), 20, 3)
    p_ms, w = cuda_ms(lambda: nm.march_plain(o, d, u, model.grid_bits, p), 3)
    n = int(w.stats[1])
    same = all(torch.equal(getattr(m, f), getattr(w, f))
               for f in ("counts", "offsets", "stats")) and all(
        torch.equal(getattr(m, f)[:n], getattr(w, f)[:n])
        for f in ("ray_idx", "pos", "ts"))
    sh_err = float((m.sh[:n] - w.sh[:n]).abs().max())
    check(same and sh_err <= 1e-7 and 0 < int(w.stats[0]) < TRAIN_RAYS,
          f"ngp_march differs from march_plain (sh {sh_err})")
    occupied = float(model.grid_bits.double().mean())
    row("ngp_march", "ngp_march.cu", k_ms, p_ms,
        TRAIN_RAYS * 36 + n * 84, 0.0, sh_err, "bit-equal; sh 1e-7",
        rays_kept=int(w.stats[0]), samples=n, occupied_share=occupied)
    # the encoding at the marched samples, forward and atomic backward
    tables, n_valid = list(model.tables), m.stats[1:]
    x = m.pos
    k_ms, got = cuda_ms(lambda: hg.hash_encode(x, tables, model.levels,
                                               n_valid), 20, 3)
    p_ms, want = cuda_ms(lambda: hg.hash_encode_plain(
        x, tables, model.levels, n_valid), 3)
    err = float((got - want).abs().max())
    check(torch.allclose(got, want, atol=NGP_HASH_TOL, rtol=NGP_HASH_TOL),
          f"hash_encode differs from hash_encode_plain ({err})")
    flop = 8 * (2 + 2 * 2) * L * p.budget
    row("hash_encode_fwd", "hash_grid.cu", k_ms, p_ms,
        p.budget * (12 + 8 * L), flop, err, NGP_HASH_TOL, points=p.budget)
    gout = torch.randn(got.shape, generator=torch.Generator(
        device).manual_seed(4), device=device)
    feat = hg.hash_encode(x, tables, model.levels, n_valid)
    k_ms, gk = cuda_ms(lambda: torch.autograd.grad(
        feat, tables, gout, retain_graph=True), 20, 3)
    plain = hg.hash_encode_plain(x, tables, model.levels, n_valid)
    p_ms, gp = cuda_ms(lambda: torch.autograd.grad(
        plain, tables, gout, retain_graph=True), 3)
    err = max(float((a - b).norm() / b.norm().clamp(min=1e-30))
              for a, b in zip(gk, gp))
    check(err <= NGP_HASH_TOL, f"hash_encode's backward differs from "
          f"hash_encode_plain's ({err}; the atomics' order)")
    row("hash_encode_bwd", "hash_grid.cu", k_ms, p_ms,
        p.budget * (12 + 8 * L), flop, err, f"{NGP_HASH_TOL} rel L2 a table",
        points=p.budget)
    # the compositing of the marched samples, forward and backward
    g = torch.Generator(device).manual_seed(5)
    sigma = (torch.rand(p.budget, generator=g, device=device) * 200.0
             ).requires_grad_(True)
    rgb = torch.rand((p.budget, 3), generator=g, device=device
                     ).requires_grad_(True)
    k_ms, out = cuda_ms(lambda: nm.composite_fwd(sigma, rgb, m.counts,
                                                 m.offsets, p)[0], 20, 3)
    p_ms, ref = cuda_ms(lambda: nm.composite_plain(sigma, rgb, m.counts,
                                                   m.offsets, p)[0], 3)
    err = float((out - ref).abs().max())
    check(torch.allclose(out, ref, atol=NGP_COMPOSITE_TOL["atol"],
                         rtol=NGP_COMPOSITE_TOL["rtol"]),
          f"composite_fwd differs from composite_plain ({err})")
    row("ngp_composite_fwd", "ngp_march.cu", k_ms, p_ms,
        p.budget * 16 + TRAIN_RAYS * 20, 0.0, err,
        {k: NGP_COMPOSITE_TOL[k] for k in ("atol", "rtol")})
    g3 = torch.randn((TRAIN_RAYS, 3), generator=g, device=device)
    k_ms, gk = cuda_ms(lambda: nm.composite_bwd(
        sigma.detach(), rgb.detach(), m.counts, m.offsets, p, out, g3), 20, 3)
    p_ms, gp = cuda_ms(lambda: torch.autograd.grad(
        ref, (sigma, rgb), g3, retain_graph=True), 1)
    err = max(float((a - b).norm() / b.norm()) for a, b in zip(gk, gp))
    check(err <= NGP_COMPOSITE_TOL["bwd_rel_l2"],
          f"composite_bwd differs from composite_plain's backward ({err})")
    row("ngp_composite_bwd", "ngp_march.cu", k_ms, p_ms,
        p.budget * 32 + TRAIN_RAYS * 32, 0.0, err,
        f"{NGP_COMPOSITE_TOL['bwd_rel_l2']} rel L2")
    return rows


def ngp_phase(work: str, device) -> tuple:
    """The NGP kernel rows, then the launches of ``driver.main_worker`` on
    the NGP config: (rows with ``launches``, stats)."""
    from nerf_pytorch_paeng_tpu_torch import driver
    from nerf_pytorch_paeng_tpu_torch.config import load_config
    from nerf_pytorch_paeng_tpu_torch.models.ngp import GRID_CHUNK, GRID_EVERY
    from nerf_pytorch_paeng_tpu_torch.utils.synth import \
        save_as_blender_dataset

    rows = ngp_kernel_rows(device)
    root = os.path.join(work, "ngp_synth")
    save_as_blender_dataset(root, n_train=4, n_val=1, n_test=1,
                            H=NGP_SCENE_HW, W=NGP_SCENE_HW,
                            camera_angle_x=LEGO_CAMERA_ANGLE_X)
    steps = NGP_CHUNKS * CHUNK
    cfg = load_config([
        "--config", os.path.join(HERE, "nerf_pytorch_paeng_tpu_torch",
                                 "configs", "blender_lego_ngp.txt"),
        "--data_root", root, "--log_dir", os.path.join(work, "ngp_logs"),
        "--iter_N", str(steps), "--scan_chunk", str(CHUNK),
        "--idx_print", "0", "--idx_vis", "0", "--idx_test", "0",
        "--idx_render", "0", "--idx_save", "0"])
    counters = ngp_launch_counters()
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    t0 = time.perf_counter()
    res = driver.main_worker(cfg)
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    launches = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    updates = (steps - 1) // GRID_EVERY
    per_update = -(-int(cfg.ngp_grid_res) ** 3 // GRID_CHUNK)
    want = {k: steps for k in counters}
    want["hash_encode_fwd"] = steps + updates * per_update
    check(launches == want, f"NGP training launches {launches}, "
          f"expected {want}")
    losses = res["loss"]
    check(len(losses) == steps and all(map(math.isfinite, losses)),
          "non-finite NGP training losses")
    for name, row in rows.items():
        row["launches"] = launches[name]
    stats = {"steps": steps, "chunks": res.get("chunks"),
             "grid_updates": updates, "wall_s": wall,
             "loss_first": losses[0], "loss_last": losses[-1],
             "launches": launches}
    log(f"ngp: {steps} steps through driver.main_worker in {wall:.1f} s, "
        f"launches {launches}")
    return rows, stats


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

    # one view again through the eval entry's dense renderer, kernels and
    # plain versions on the card, same draws
    import dataclasses

    from nerf_pytorch_paeng_tpu_torch.data import load_blender
    from nerf_pytorch_paeng_tpu_torch.kernels.fused_mlp import pack_nerf
    model = driver.load_model(cfg, cfg.testing_idx, device)
    packed = pack_nerf(model, cfg, device=device)
    _, (K, ext), (H, W), i_split = load_blender(
        data_root, cfg.bkg_white, cfg.downsample, cfg.testskip)
    pose = torch.as_tensor(ext[i_split[2][0]][:3, :4])
    dense = dataclasses.replace(cfg, render_cull="none")   # as eval/test.py
    frames = {}
    for label, kw in (("kernels", {}),
                      ("plain", dict(sigma_fn=fm.fused_mlp_sigma_rays_plain,
                                     field_fn=fm.fused_mlp_eval_rays_plain))):
        render = make_frame_renderer(dense, H, W, K, device, **kw)
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
    render = make_frame_renderer(dense, H, W, K, device)
    gen = torch.Generator(device).manual_seed(cfg.seed + cfg.testing_idx)
    prof = profile_call(lambda: render(packed, pose, gen), "dense frame",
                        device)
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
    # the pre-cull policy measured the random weights' support once (one
    # refresh in 60 steps at the default cadence) and kept them ungated
    policy = policy_rows(cfg)
    check(launches["fused_mlp_sigma"] == 2 and len(policy) == 1
          and policy[0][3] == "0", f"random weights: support grids "
          f"{launches['fused_mlp_sigma']}, policy rows {policy}")
    check(all(g is None for g in res["gate_frac"]),
          "random weights trained gated")
    log(f"train: pre-cull policy rows (iter,bounds_valid,gate_frac_pred,"
        f"gated) {policy}")
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
    return launches, dict(losses=losses, step_ms=step_ms, policy=policy,
                          median_step_ms=steady,
                          steps_per_s=1e3 / steady,
                          rays_per_s=TRAIN_RAYS * 1e3 / steady,
                          wall_s=wall, peak_gb=peak_gb, profile=prof)


def policy_rows(cfg) -> list:
    """The pre-cull policy's CSV rows (iter, bounds_valid, gate_frac_pred,
    gated), as lists of strings."""
    path = os.path.join(cfg.logdir, cfg.exp_name, "precull_policy.csv")
    with open(path) as f:
        lines = f.read().splitlines()
    check(lines[0] == "iter,bounds_valid,gate_frac_pred,gated", lines[0])
    return [line.split(",") for line in lines[1:]]


def resume_phase(work: str, data_root: str, device) -> dict:
    """N steps, a checkpoint, a resume to 2N in a fresh main_worker,
    against 2N uninterrupted steps: bit-equal weights and Adam moments."""
    from nerf_pytorch_paeng_tpu_torch import driver
    from nerf_pytorch_paeng_tpu_torch.config import load_config

    n = RESUME_STEPS

    def run(exp, *extra):
        cfg = load_config(train_args(work, data_root, exp, 2 * n,
                                     "--idx_print", "0", "--train_precull",
                                     "off", *extra))
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


def compute_dtype_phase(work: str, data_root: str, device) -> dict:
    """``--compute_dtype float32`` on the card, through the entry points:
    two training steps (``main_worker``) and one 800x800 test view through
    the dense renderer (``--eval_only``'s), each against the same at
    bfloat16.  The kernels get bf16 weights at either type
    (``kernel_weight_dtype``), so the saved states and the frames must be
    equal bit for bit."""
    import dataclasses

    from nerf_pytorch_paeng_tpu_torch import driver
    from nerf_pytorch_paeng_tpu_torch.config import load_config
    from nerf_pytorch_paeng_tpu_torch.data import load_blender
    from nerf_pytorch_paeng_tpu_torch.eval.frame import make_frame_renderer
    from nerf_pytorch_paeng_tpu_torch.kernels.fused_mlp import pack_nerf
    from nerf_pytorch_paeng_tpu_torch.models.nerf import init_nerf

    states, frames = {}, {}
    for dtype in ("bfloat16", "float32"):
        cfg = load_config(train_args(
            work, data_root, f"dtype_{dtype}", 2, "--idx_print", "0",
            "--idx_save", "2", "--train_precull", "off", "--compute_dtype",
            dtype))
        driver.main_worker(cfg)
        states[dtype] = torch.load(driver.checkpoint_path(cfg, 2),
                                   map_location=device, weights_only=True)
        images, (K, ext), (H, W), i_split = load_blender(
            data_root, cfg.bkg_white, cfg.downsample, cfg.testskip)
        packed = pack_nerf(init_nerf(cfg, seed=1, device=device), cfg)
        check(packed["fine"]["w"].dtype == torch.bfloat16,
              f"compute_dtype {dtype}: the card got {packed['fine']['w'].dtype}")
        render = make_frame_renderer(
            dataclasses.replace(cfg, render_cull="none"), H, W, K, device)
        pose = torch.as_tensor(ext[i_split[2][0]][:3, :4])
        frames[dtype] = render(packed, pose,
                               torch.Generator(device).manual_seed(0))
    torch.cuda.synchronize(device)
    a, b = states["bfloat16"]["model_state_dict"], states["float32"]["model_state_dict"]
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    same_frame = all(torch.equal(x, y) for x, y in zip(frames["bfloat16"],
                                                       frames["float32"]))
    log(f"compute_dtype float32 vs bfloat16 on the card: 2 training steps, "
        f"{len(differ)} tensors differ; an {H}x{W} dense frame bit-equal: "
        f"{same_frame}")
    check(not differ and same_frame,
          f"--compute_dtype float32 differs from bfloat16: {differ[:5]}")
    return {"train_steps": 2, "frame": [H, W], "bit_equal": True}


def recording(fn, calls: list, name: str):
    """``fn`` (a rays kernel wrapper), keeping each call's (name, od, z_t,
    gate) in ``calls``."""
    def call(od, z_t, packed, gate=None, **kw):
        calls.append((name, od, z_t, gate))
        return fn(od, z_t, packed, gate=gate, **kw)
    return call


def path_kernel_phase(fm, calls, packed, cfg) -> dict:
    """K4 and K5 on the inputs one culled frame gave them (its rays,
    depths and gates: K4 over the whole frame, K5 on every cover block and
    sample class, the small blocks with fewer ray tiles than SMs),
    with the seeded random weights of the kernel phase, whose every unit
    is live: gated blocks exactly 0, active blocks bit-equal to the
    ungated kernel and within ``KERNEL_TOL`` of the gated plain version.
    Returns {kernel: (worst max abs, [(N, S, on share, blocks), ...])}."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for name, od, z, gate in calls:
        check(gate is not None, f"{name} ran ungated on the culled path")
        s, n = z.shape
        if name == "fused_mlp_sigma_rays_gated":
            kern, plain = fm.fused_mlp_sigma_rays, fm.fused_mlp_sigma_rays_plain
            p, kw = packed["coarse"], dict(L_x=cfg.L_x)
        else:
            kern, plain = fm.fused_mlp_eval_rays, fm.fused_mlp_eval_rays_plain
            p, kw = packed["fine"], dict(L_x=cfg.L_x, L_d=cfg.L_d)
        kw["out_dtype"] = torch.bfloat16
        got, ung, want = (x if isinstance(x, tuple) else (x,) for x in (
            kern(od, z, p, gate=gate, **kw), kern(od, z, p, **kw),
            plain(od, z, p, gate=gate, **kw)))
        on = fm.gate_mask(gate, s, n)
        for g, u in zip(got, ung):
            check(not bool(g[~on].any()), f"{name} at ({n}, {s}): a gated "
                  "block is not 0")
            check(torch.equal(g[on], u[on]), f"{name} at ({n}, {s}): active "
                  "blocks differ from the ungated kernel")
        max_abs, rel_l2 = errors([g[on] for g in got], [w[on] for w in want])
        blocks = fm.rays_plan(n, s, gated=True)["blocks"]
        share = float(on.float().mean())
        log(f"path kernel {name}: N={n} S={s} ({-(-n // 128)} ray tiles, "
            f"{sms} SMs) walk blocks {blocks} "
            f"gate on {share:.3f}: gated blocks 0, active blocks bit-equal "
            f"to the ungated kernel, vs plain max_abs={max_abs:.3e} "
            f"rel_l2={rel_l2:.3e} (tolerance {KERNEL_TOL})")
        check(max_abs <= KERNEL_TOL["max_abs"]
              and rel_l2 <= KERNEL_TOL["rel_l2"],
              f"{name} at ({n}, {s}) disagrees with its plain version")
        worst, shapes = out.get(name, (0.0, []))
        out[name] = (max(worst, max_abs), shapes + [(n, s, share, blocks)])
    for name in ("fused_mlp_sigma_rays_gated", "fused_mlp_eval_rays_gated"):
        check(name in out, f"{name} was not called by the culled frame")
    return out


def render_phase(fm, packed_rand, work: str, data_root: str, device):
    """The ``--render_only`` entry on the compact field through the culled
    renderer; then one pose through the culled, ungated and dense
    renderers and the plain versions, and K4 and K5 on that pose's inputs
    with the random weights ``packed_rand``."""
    import dataclasses

    from PIL import Image

    from nerf_pytorch_paeng_tpu_torch import driver
    from nerf_pytorch_paeng_tpu_torch.config import load_config
    from nerf_pytorch_paeng_tpu_torch.data import load_blender
    from nerf_pytorch_paeng_tpu_torch.data.render_pose import get_render_pose
    from nerf_pytorch_paeng_tpu_torch.eval.frame import make_frame_renderer
    from nerf_pytorch_paeng_tpu_torch.kernels.fused_mlp import pack_nerf
    from nerf_pytorch_paeng_tpu_torch.utils.synth import \
        compact_field_state_dict

    argv = ["--config", os.path.join(HERE, "configs/blender/lego.txt"),
            "--render_only", "true", "--testing_idx", "1",
            "--n_angle", str(RENDER_VIEWS), "--exp_name", "smoke_render",
            "--data_root", data_root, "--log_dir", os.path.join(work, "logs")]
    cfg = load_config(argv)
    check(cfg.render_cull == "auto" and cfg.render_type == "gif"
          and (cfg.N_samples_c, cfg.N_samples_f) == (64, 128),
          "lego.txt does not render culled gifs at 64+128 samples")
    ckpt = driver.checkpoint_path(cfg, cfg.testing_idx)
    os.makedirs(os.path.dirname(ckpt), exist_ok=True)
    torch.save({"idx": cfg.testing_idx,
                "model_state_dict": compact_field_state_dict(r=1.5, k=20.0)},
               ckpt)

    zero_launches()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    res = driver.main_worker(cfg)              # the --render_only entry
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    stats = res["stats"]
    log(f"render: launches {launches}, wall {wall:.2f} s, peak device "
        f"memory {peak_gb:.2f} GB")
    check(launches["fused_mlp_sigma"] == 2,
          f"K7 ran {launches['fused_mlp_sigma']} times, not 2 (one grid "
          "per module)")
    for name in ("fused_mlp_sigma_rays_gated", "fused_mlp_eval_rays_gated"):
        check(launches[name] >= RENDER_VIEWS, (name, launches[name]))
    for name in ("fused_mlp_sigma_rays", "fused_mlp_eval_rays",
                 "fused_mlp_bwd_rays"):
        check(launches[name] == 0, f"{name} ran on the culled path "
              "(invalid support bounds?)")
    check(len(stats) == RENDER_VIEWS, f"{len(stats)} frame records")
    frac_c = [float(st["gate_frac_coarse"]) for st in stats]
    frac_f = [float(st["gate_frac_fine"]) for st in stats]
    n_act = [st["n_act"] for st in stats]
    blocks = [st["blocks"] for st in stats]
    check(min(frac_c) > 0 and min(frac_f) > 0,
          f"a gate skipped nothing: coarse {frac_c}, fine {frac_f}")
    check(res["rgbs"].shape == (RENDER_VIEWS, 800, 800, 3)
          and bool(np.isfinite(res["rgbs"]).all())
          and bool(np.isfinite(res["disps"]).all()),
          "rendered frames: shape or finiteness")
    save_dir = res["save_dir"]
    for video in ("_rgb.gif", "_disp.gif"):
        with Image.open(os.path.join(save_dir, video)) as im:
            check(im.n_frames == RENDER_VIEWS and im.size == (800, 800),
                  (video, im.n_frames, im.size))
    missing = [f"{i}_{k}.png" for i in range(RENDER_VIEWS)
               for k in ("rgb", "disp")
               if not os.path.isfile(os.path.join(save_dir, f"{i}_{k}.png"))]
    check(not missing, f"missing {missing}")
    frame_ms = [t * 1e3 for t in res["frame_s"]]
    log(f"render: {RENDER_VIEWS} views, frame device ms "
        f"{['%.1f' % t for t in frame_ms]} (CUDA events; the first includes "
        f"the two support grids); active rays {n_act} of {800 * 800} "
        f"({['%.3f' % (a / 640000) for a in n_act]}); "
        f"phase-2 blocks {blocks}; skipped share of gate blocks, coarse "
        f"{['%.3f' % f for f in frac_c]}, fine {['%.3f' % f for f in frac_f]}")

    # one pose, deterministic sampling (no jitter of the coarse or the fine
    # depths), four ways
    cfg = dataclasses.replace(cfg, perturb=0.0)
    model = driver.load_model(cfg, cfg.testing_idx, device)
    packed = pack_nerf(model, cfg, device=device)
    _, (K, _), (H, W), _ = load_blender(data_root, cfg.bkg_white,
                                        cfg.downsample, cfg.testskip)
    pose = torch.as_tensor(get_render_pose(RENDER_VIEWS)[1][:3, :4])
    variants = (
        ("culled", cfg, {}),
        ("ungated", dataclasses.replace(cfg, render_precull="off",
                                        render_gate_fine="off"), {}),
        ("dense", dataclasses.replace(cfg, render_cull="none"), {}),
        ("plain", cfg, dict(sigma_fn=fm.fused_mlp_sigma_rays_plain,
                            field_fn=fm.fused_mlp_eval_rays_plain,
                            points_fn=fm.fused_mlp_sigma_plain)))
    frames, times = {}, {}
    for label, c, kw in variants:
        render = make_frame_renderer(c, H, W, K, device, stratified=False,
                                     **kw)
        reps = 1 if label == "plain" else 3
        times[label], frames[label] = cuda_ms(lambda: render(packed, pose),
                                              reps=reps)
    rgb = frames["culled"][0]
    p_dense = psnr(rgb, frames["dense"][0])
    p_plain = psnr(rgb, frames["plain"][0])
    d_gate = max(float((a - b).abs().max())
                 for a, b in zip(frames["culled"], frames["ungated"]))
    log(f"render: one pose, deterministic: culled vs dense PSNR "
        f"{p_dense:.2f} dB (min {CULLED_VS_DENSE_PSNR_MIN}), gated vs "
        f"ungated max abs {d_gate:.3e} (max {GATED_VS_UNGATED_MAX}), kernels "
        f"vs plain PSNR {p_plain:.2f} dB (min {FRAME_PSNR_MIN}); frame ms "
        f"(CUDA events, median of 3 after one warm-up): culled "
        f"{times['culled']:.1f}, culled without gates "
        f"{times['ungated']:.1f}, dense {times['dense']:.1f}, culled plain "
        f"{times['plain']:.1f}")
    check(p_dense >= CULLED_VS_DENSE_PSNR_MIN, f"culled vs dense {p_dense} dB")
    check(d_gate <= GATED_VS_UNGATED_MAX, f"gated vs ungated {d_gate}")
    check(p_plain >= FRAME_PSNR_MIN, f"kernels vs plain frame {p_plain} dB")
    render = make_frame_renderer(cfg, H, W, K, device, stratified=False)
    render(packed, pose)
    prof = profile_call(lambda: render(packed, pose), "culled frame", device)

    # this pose and the first orbit view (whose cover ends in small blocks
    # of fewer ray tiles than the card has SMs) once more, keeping
    # what K4 and K5 were given; then the kernels on those inputs with
    # weights that exercise every unit (the compact field's live only 6 of
    # each layer's 256)
    calls = []
    render = make_frame_renderer(
        cfg, H, W, K, device, stratified=False,
        sigma_fn=recording(fm.fused_mlp_sigma_rays, calls,
                           "fused_mlp_sigma_rays_gated"),
        field_fn=recording(fm.fused_mlp_eval_rays, calls,
                           "fused_mlp_eval_rays_gated"))
    for c2w in (pose, torch.as_tensor(get_render_pose(RENDER_VIEWS)[0][:3, :4])):
        render(packed, c2w)
    path = path_kernel_phase(fm, calls, packed_rand, cfg)
    del calls
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    check(any(-(-n // 128) < sms
              for n, *_ in path["fused_mlp_eval_rays_gated"][1]),
          "no K5 cover block of the render path had fewer ray tiles than SMs")
    return launches, dict(
        views=RENDER_VIEWS, wall_s=wall, frame_ms=frame_ms, n_act=n_act,
        active_share=[a / (H * W) for a in n_act],
        blocks=blocks, gate_frac_coarse=frac_c, gate_frac_fine=frac_f,
        peak_gb=peak_gb, pose_frame_ms=times,
        culled_vs_dense_psnr=p_dense, gated_vs_ungated_max_abs=d_gate,
        kernels_vs_plain_psnr=p_plain, profile=prof), path


def compact_checkpoint(cfg, step: int, device, r: float) -> None:
    """A reference-format checkpoint of the compact field (an L1 ball of
    radius ``r``, valid support bounds) with a fresh Adam state at
    ``step``."""
    from nerf_pytorch_paeng_tpu_torch.models.nerf import NeRF
    from nerf_pytorch_paeng_tpu_torch.train import TrainState, make_optimizer
    from nerf_pytorch_paeng_tpu_torch.train.checkpoint import save_checkpoint
    from nerf_pytorch_paeng_tpu_torch.utils.synth import \
        compact_field_state_dict
    model = NeRF()
    model.load_state_dict(compact_field_state_dict(r=r, k=20.0))
    model.to(device)
    save_checkpoint(cfg.logdir, cfg.exp_name,
                    TrainState(model, make_optimizer(model, cfg), step))


def gated_run(work, data_root, device, label: str, *extra,
              r: float = GATED_RADIUS) -> dict:
    """``main_worker`` from the compact field's checkpoint for TRAIN_STEPS
    steps with the pre-cull knobs ``extra``; its launches, per-step times,
    gate fractions and policy rows."""
    from nerf_pytorch_paeng_tpu_torch import driver
    from nerf_pytorch_paeng_tpu_torch.config import load_config
    cfg = load_config(train_args(
        work, data_root, f"smoke_{label}", GATED_START + TRAIN_STEPS,
        "--iter_start", str(GATED_START), "--idx_print", "20",
        "--idx_save", "0", "--train_precull_every", str(GATED_EVERY),
        *extra))
    compact_checkpoint(cfg, GATED_START, device, r)
    zero_launches()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    res = driver.main_worker(cfg)
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    launches = read_launches()
    losses = res["loss"]
    check(len(losses) == TRAIN_STEPS and all(map(math.isfinite, losses)),
          f"{label}: non-finite losses")
    step_ms = [t * 1e3 for t in res["step_s"]]
    gated = [g is not None for g in res["gate_frac"]]
    ms_gated = [t for t, g in zip(step_ms[5:], gated[5:]) if g]
    ms_ungated = [t for t, g in zip(step_ms[5:], gated[5:]) if not g]
    gfs = [g for g in res["gate_frac"] if g is not None]
    out = dict(cfg=cfg, launches=launches, loss_first=losses[0],
               loss_last=losses[-1], gated_steps=sum(gated),
               gate_frac_min=min(gfs, default=None),
               gate_frac_max=max(gfs, default=None),
               median_step_ms=statistics.median(step_ms[5:]),
               median_gated_step_ms=(statistics.median(ms_gated)
                                     if ms_gated else None),
               median_ungated_step_ms=(statistics.median(ms_ungated)
                                       if ms_ungated else None),
               wall_s=wall,
               peak_gb=torch.cuda.max_memory_allocated(device) / 1e9)
    if os.path.isfile(os.path.join(cfg.logdir, cfg.exp_name,
                                   "precull_policy.csv")):
        out["policy"] = policy_rows(cfg)
    log(f"gated train [{label}]: launches {launches}; gated steps "
        f"{sum(gated)} of {TRAIN_STEPS}; gate_frac "
        f"{['%.4f' % g for g in gfs[::10]]} (every 10th gated step); "
        f"policy rows {out.get('policy')}; step device ms median of 6.. "
        f"{out['median_step_ms']:.2f} (gated {out['median_gated_step_ms']}, "
        f"ungated {out['median_ungated_step_ms']}); loss first "
        f"{losses[0]:.5f} last {losses[-1]:.5f}; wall {wall:.1f} s; peak "
        f"{out['peak_gb']:.2f} GB")
    return out


def record_pair(fv, calls: list):
    """Wrap ``fused_mlp_train_rays`` (which the gated passes import at call
    time) to keep each call's rays, depths and gate in ``calls``, and, from
    hooks on its four outputs, the cotangents its backward receives;
    returns the function that undoes it."""
    pair = fv.fused_mlp_train_rays

    def rec(w, b, od, z_t, *a, gate=None, **kw):
        outs = pair(w, b, od, z_t, *a, gate=gate, **kw)
        entry = dict(od=od, z=z_t, gate=gate, cots=[None] * 4)
        calls.append(entry)
        for i, t in enumerate(outs):
            t.register_hook(lambda g, i=i, e=entry: e["cots"].__setitem__(
                i, g.detach().float().contiguous()))
        return outs

    fv.fused_mlp_train_rays = rec

    def undo():
        fv.fused_mlp_train_rays = pair
    return undo


def gated_path_kernels(fm, fv, calls, packed) -> dict:
    """K5 (float32 outputs) and K6 on the inputs one gated training step
    gave them (both passes), with the seeded random weights: K5's gated
    blocks 0, active blocks bit-equal to K1 and within ``KERNEL_TOL`` of
    the plain version; K6 within K2's tolerance of its plain version.  The
    step's cotangents are the compact field's: with the random weights
    they are data of the same shapes and gates."""
    out = {"fused_mlp_eval_rays_gated_f32": [], "fused_mlp_bwd_rays_gated": []}
    check(len(calls) == 2, f"{len(calls)} gated passes recorded, not 2")
    p = packed["fine"]
    for c in calls:
        od, z, gate, cots = c["od"], c["z"], c["gate"], c["cots"]
        check(gate is not None and all(t is not None for t in cots),
              "a pass of the gated step ran ungated or lost a cotangent")
        s, n = z.shape
        on = fm.gate_mask(gate, s, n)
        share = float(on.float().mean())
        got = fm.fused_mlp_eval_rays(od, z, p, gate=gate)
        ung = fm.fused_mlp_eval_rays(od, z, p)
        want = fm.fused_mlp_eval_rays_plain(od, z, p, gate=gate)
        for g, u in zip(got, ung):
            check(not bool(g[~on].any()) and torch.equal(g[on], u[on]),
                  f"path K5 float32 at ({n}, {s}): gated blocks or active "
                  "blocks wrong")
        max_abs, rel_l2 = errors([g[on] for g in got], [w[on] for w in want])
        check(max_abs <= KERNEL_TOL["max_abs"]
              and rel_l2 <= KERNEL_TOL["rel_l2"],
              f"path K5 float32 at ({n}, {s}) disagrees with plain")
        out["fused_mlp_eval_rays_gated_f32"].append(
            dict(N=n, S=s, gate_on_share=share, max_abs=max_abs,
                 rel_l2=rel_l2))
        log(f"path kernel fused_mlp_eval_rays gated (float32 out): N={n} "
            f"S={s} gate on {share:.3f}: gated blocks 0, active blocks "
            f"bit-equal to K1, vs plain max_abs={max_abs:.3e} "
            f"rel_l2={rel_l2:.3e}")
        _, (rel, limit, at), cos, max_abs, _, _ = k6_check(
            fm, fv, od, z, cots, p, gate, f"path at ({n}, {s})")
        out["fused_mlp_bwd_rays_gated"].append(
            dict(N=n, S=s, gate_on_share=share, rel_l2=rel, limit=limit,
                 worst=at, cos=cos, max_abs=max_abs))
        log(f"path kernel fused_mlp_bwd_rays gated: N={n} S={s} gate on "
            f"{share:.3f}: vs plain worst rel_l2={rel:.3e} against "
            f"{limit:.3e} ({at}) min cos={cos:.6f} max_abs={max_abs:.3e}")
    return out


def gated_train_phase(fm, fv, packed_rand, work: str, data_root: str,
                      device):
    """Gated training from the compact field's checkpoint: the gated run
    (the main path of K5 float32 and K6), the same steps ungated and with
    128-ray gate tiles, a profiled gated step, the one-step A/B and the
    kernels on the step's own inputs."""
    from nerf_pytorch_paeng_tpu_torch.data import load_blender
    from nerf_pytorch_paeng_tpu_torch.train import create_train_state
    from nerf_pytorch_paeng_tpu_torch.train.checkpoint import \
        restore_checkpoint
    from nerf_pytorch_paeng_tpu_torch.train.precull import \
        make_train_support_program
    from nerf_pytorch_paeng_tpu_torch.train.schedule import schedule_from_cfg
    from nerf_pytorch_paeng_tpu_torch.train.step import make_image_train_step

    runs = {"gated": gated_run(work, data_root, device, "gated",
                               "--train_precull", "auto")}
    g = runs["gated"]
    launches, policy, n_gated = g["launches"], g["policy"], g["gated_steps"]
    n_refresh = len(policy)
    check(policy[0][3] == "1", f"the first refresh did not gate: {policy}")
    check(n_gated >= GATED_EVERY, f"only {n_gated} gated steps")
    for name in ("fused_mlp_eval_rays_gated_f32", "fused_mlp_bwd_rays_gated"):
        check(launches[name] == 2 * n_gated,
              f"{name}: {launches[name]} launches in {n_gated} gated steps")
    for name in ("fused_mlp_eval_rays", "fused_mlp_bwd_rays"):
        check(launches[name] == 2 * (TRAIN_STEPS - n_gated),
              f"{name}: {launches[name]} launches in "
              f"{TRAIN_STEPS - n_gated} ungated steps")
    check(launches["fused_mlp_sigma"] == 2 * n_refresh,
          f"K7: {launches['fused_mlp_sigma']} launches in {n_refresh} "
          "refreshes")
    runs["ungated"] = gated_run(work, data_root, device, "ungated",
                                "--train_precull", "off")
    check(runs["ungated"]["gated_steps"] == 0, "--train_precull off gated")
    runs["tile128"] = gated_run(work, data_root, device, "tile128",
                                "--train_precull", "auto",
                                "--train_precull_tile", "128")
    check(runs["tile128"]["gated_steps"] >= GATED_EVERY,
          "--train_precull_tile 128 did not gate")
    # the render phase's wider ball: the policy's own decision, reported
    runs["r1.5"] = gated_run(work, data_root, device, "r15",
                             "--train_precull", "auto", r=1.5)

    # one step from the compact field's state, gated and ungated, same
    # image, pose and draws; the gated one's kernel inputs recorded
    cfg = g["cfg"]
    images, (K, ext), (H, W), i_split = load_blender(
        data_root, cfg.bkg_white, cfg.downsample, cfg.testskip)
    i_train = i_split[0]
    prog, _ = make_train_support_program(
        cfg, poses=np.asarray(ext)[i_train, :3, :4], K=K, hw=(H, W),
        device=device)
    step = make_image_train_step(cfg, schedule_from_cfg(cfg), H, W, K)
    i0 = int(i_train[0])
    img = torch.as_tensor(images[i0], device=device)
    pose = torch.as_tensor(ext[i0][:3, :4], device=device)

    def state():
        st = create_train_state(cfg, device)
        return restore_checkpoint(cfg.logdir, cfg.exp_name, GATED_START, st)

    st_u, st_g = state(), state()
    w0 = {k: v.clone() for k, v in st_g.model.state_dict().items()}
    support = prog(st_g.model)
    check(bool(support[0][3][0]) and bool(support[1][3][0]),
          "the compact field's bounds are invalid")
    m_u = step(st_u, img, pose)
    calls = []
    undo = record_pair(fv, calls)
    try:
        m_g = step(st_g, img, pose, support=support)
    finally:
        undo()
    torch.cuda.synchronize(device)
    lr = float(st_g.optimizer.param_groups[0]["lr"])
    check(torch.equal(m_u["loss"], m_g["loss"]),
          f"gated loss {float(m_g['loss'])!r} != ungated "
          f"{float(m_u['loss'])!r}")
    du = torch.cat([(v - w0[k]).flatten()
                    for k, v in st_u.model.state_dict().items()])
    dg = torch.cat([(v - w0[k]).flatten()
                    for k, v in st_g.model.state_dict().items()])
    ab_max = float((du - dg).abs().max())
    ab_rel = float((du - dg).norm() / du.norm())
    log(f"gated train A/B, one step from the same state: loss "
        f"{float(m_u['loss'])!r} both (bit-equal), gate_frac "
        f"{float(m_g['gate_frac']):.4f}; updates differ by max abs "
        f"{ab_max:.3e} (limit 2 lr = {2 * lr:.3e}), rel L2 {ab_rel:.3e}")
    check(ab_max <= 2 * lr * (1 + 1e-3), "gated vs ungated updates")
    path = gated_path_kernels(fm, fv, calls, packed_rand)
    del calls

    # one gated step under the profiler (after a warm-up)
    st = state()
    step(st, img, pose, support=support)
    prof = profile_call(lambda: step(st, img, pose, support=support),
                        "gated train step", device)
    summary = {k: {kk: vv for kk, vv in r.items() if kk != "cfg"}
               for k, r in runs.items()}
    return launches, dict(runs=summary, ab=dict(
        loss=float(m_u["loss"]), gate_frac=float(m_g["gate_frac"]),
        update_max_abs=ab_max, update_rel_l2=ab_rel, lr=lr),
        profile=prof, path=path)


def seeded_planes(n: int, s: int, seed: int, device):
    """Position and unit direction planes [3, n * s] (point ray * s +
    sample) of ``seeded_rays``' rays and depths: the plane layout's
    inputs."""
    od, z = seeded_rays(n, s, seed, device)
    o, d = od[0:3], od[3:6]
    x = (o[:, :, None] + d[:, :, None] * z.T[None]).reshape(3, -1)
    u = d / d.norm(dim=0, keepdim=True)
    return x.contiguous(), u[:, :, None].expand(3, n, s).reshape(3, -1).contiguous()


def plane_cotangents(out, seed: int, device):
    """``loss_like_cotangents`` of a [4, P] output -> [4, P]."""
    return torch.cat(loss_like_cotangents([o[None] for o in out], seed,
                                          device)).contiguous()


def k8_check(fm, x, d, p, out_dtype, what: str, reps: int = 5):
    """K8 against its plain version on the same planes: (max abs, rel L2,
    kernel ms, plain ms); the kernel timed with CUDA events (``reps`` = 0:
    one untimed launch)."""
    run = lambda: fm.fused_mlp_eval(x, d, p, out_dtype=out_dtype)  # noqa: E731
    k_ms, got = cuda_ms(run, reps=reps) if reps else (None, run())
    p_ms, want = cuda_ms(lambda: fm.fused_mlp_eval_plain(
        x, d, p, out_dtype=out_dtype), reps=1, warmup=0)
    max_abs, rel_l2 = errors([got], [want])
    check(max_abs <= KERNEL_TOL["max_abs"] and rel_l2 <= KERNEL_TOL["rel_l2"],
          f"K8 {what} disagrees with its plain version ({max_abs}, {rel_l2})")
    return max_abs, rel_l2, k_ms, p_ms


def k9_check(fm, fv, x, d, g4, p, what: str):
    """K9 against its plain version on the card, with the plain version on
    the CPU as the floor (``grad_errors``): ((rel, limit, name), cos, max
    abs, plain ms)."""
    got = fv.fused_mlp_bwd(x, d, g4, p)
    plain_ms, want = cuda_ms(lambda: fv.fused_mlp_bwd_plain(x, d, g4, p),
                             reps=1, warmup=0)
    other = fv.fused_mlp_bwd_plain(x.cpu(), d.cpu(), g4.cpu(),
                                   fm._with_views(p["w"].cpu(), p["b"].cpu()))
    (rel, limit, at), cos, max_abs = grad_errors(fm, got, want, other)
    check(rel <= limit and cos >= GRAD_TOL["cos"],
          f"K9 {what} disagrees with its plain version ({at}: {rel} > "
          f"{limit} or cos {cos})")
    return (rel, limit, at), cos, max_abs, plain_ms


def plane_kernel_phase(fm, fv, packed, cfg, device):
    """K8 (bf16 outputs) at the eval block's plane (131072 rays x 164
    samples, the merged count of ``--N_samples_f 100``), K8 (float32) and
    K9 at the training planes (4096 x 64 and 4096 x 192), seeded weights,
    points, directions and loss-like cotangents; K9 launched twice must
    give the same bits; K8's sigma row must equal K7's and, at depth 0,
    K1's bit for bit.  Bounds: FLOP of ``eval_flop_per_point`` and
    ``bwd_flop_per_point`` over the bf16 peak, bytes of the planes,
    cotangents, weights and outputs over the memory rate.  K8 beside its
    products alone as chained ``torch.mm`` at the row's own points."""
    rows, shapes = {}, []
    wbytes = packed["fine"]["w"].numel() * 2 + packed["fine"]["b"].numel() * 4
    p = packed["fine"]
    s_eval = cfg.N_samples_c + PLANE_FINE
    x, d = seeded_planes(BLOCK, s_eval, seed=7000, device=device)
    n_pts = x.shape[1]
    flop_pt = fm.eval_flop_per_point(cfg.L_x, cfg.L_d)
    max_abs, rel_l2, k_ms, p_ms = k8_check(fm, x, d, p, torch.bfloat16,
                                           f"bf16 at {n_pts} points")
    b_ms, b_by = bound(flop_pt * n_pts, n_pts * (24 + 8) + wbytes)
    lib_ms = products_ms(p, n_pts, full=True)
    log(f"kernel fused_mlp_eval (bf16 out): P={n_pts} ({BLOCK} x {s_eval}) "
        f"max_abs={max_abs:.3e} rel_l2={rel_l2:.3e} (tolerance {KERNEL_TOL})"
        f" ms={k_ms:.3f} plain_ms={p_ms:.3f} bound_ms={b_ms:.3f} "
        f"({flop_pt * n_pts / k_ms / 1e9:.1f} TFLOP/s, "
        f"{100 * b_ms / k_ms:.1f}% of the bound; {k_ms * 1e6 / n_pts:.3f} ns "
        f"a point); its products alone as torch.mm {lib_ms:.3f} ms")
    rows["fused_mlp_eval"] = {
        "name": "fused_mlp_eval", "route": "cuda",
        "source": "nerf_pytorch_paeng_tpu_torch/kernels/csrc/fused_mlp.cu",
        "replaces": "nerf_pytorch_paeng_tpu/kernels/fused_mlp.py:151",
        "launches": None, "max_abs_err": max_abs, "ms": k_ms,
        "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms, "library": PRODUCTS_ONLY, "points": n_pts}
    del x, d
    for s in (cfg.N_samples_c, cfg.N_samples_c + cfg.N_samples_f):
        x, d = seeded_planes(TRAIN_RAYS, s, seed=8000 + s, device=device)
        n_pts = x.shape[1]
        k8_abs, k8_rel, k8_ms, k8_plain_ms = k8_check(
            fm, x, d, p, torch.float32, f"float32 at {n_pts} points")
        k8_b, k8_by = bound(flop_pt * n_pts, n_pts * (24 + 16) + wbytes)
        k8_lib = products_ms(p, n_pts, full=True)
        out = fm.fused_mlp_eval(x, d, p)
        check(torch.equal(out[3], fm.fused_mlp_sigma(x, p))
              and torch.equal(out[3], fm.fused_mlp_eval_rays(
                  *depth0_rays(x, d), p)[3][0]),
              f"K8's sigma at {n_pts} points differs from K7's or from K1's "
              f"at depth 0")
        g4 = plane_cotangents(out, 9000 + s, device)
        k9_ms, got = cuda_ms(lambda: fv.fused_mlp_bwd(x, d, g4, p), reps=5)
        again = fv.fused_mlp_bwd(x, d, g4, p)
        torch.cuda.synchronize()
        check(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]),
              f"K9 at {n_pts} points: two launches differ")
        (rel, limit, at), cos, k9_abs, k9_plain_ms = k9_check(
            fm, fv, x, d, g4, p, f"at {n_pts} points")
        k9_b, k9_by = bound(fm.bwd_flop_per_point(cfg.L_x, cfg.L_d) * n_pts,
                            n_pts * (24 + 16) + wbytes
                            + (fm.W_TOTAL + fm.B_TOTAL) * 4)
        # the same weight-gradient products as K2's at this shape
        k9_lib = wgrad_library_ms(
            device, fv.bwd_plan(TRAIN_RAYS, s)["wgrad_jobs"], n_pts)
        log(f"kernel fused_mlp_eval (float32 out): P={n_pts} ({TRAIN_RAYS} x "
            f"{s}) max_abs={k8_abs:.3e} rel_l2={k8_rel:.3e} ms={k8_ms:.3f} "
            f"plain_ms={k8_plain_ms:.3f} bound_ms={k8_b:.3f} "
            f"({flop_pt * n_pts / k8_ms / 1e9:.1f} TFLOP/s, "
            f"{100 * k8_b / k8_ms:.1f}% of the bound); products alone as "
            f"torch.mm {k8_lib:.3f} ms; sigma row equals K7's and K1's at "
            f"depth 0 bit for bit")
        log(f"kernel fused_mlp_bwd: P={n_pts} ({TRAIN_RAYS} x {s}) worst "
            f"rel_l2={rel:.3e} against its limit {limit:.3e} ({at}) min "
            f"cos={cos:.6f} max_abs={k9_abs:.3e} (tolerance {GRAD_TOL}; two "
            f"launches bit-identical) ms={k9_ms:.3f} plain_ms="
            f"{k9_plain_ms:.3f} bound_ms={k9_b:.3f} "
            f"({fm.bwd_flop_per_point(cfg.L_x, cfg.L_d) * n_pts / k9_ms / 1e9:.1f}"
            f" TFLOP/s of gradient products); its weight-gradient products "
            f"as torch.mm {k9_lib:.3f} ms")
        shapes.append(dict(N=TRAIN_RAYS, S=s, P=n_pts, k8_ms=k8_ms,
                           k8_plain_ms=k8_plain_ms, k8_bound_ms=k8_b,
                           k8_library_ms=k8_lib,
                           k8_max_abs=k8_abs, k9_ms=k9_ms,
                           k9_plain_ms=k9_plain_ms, k9_bound_ms=k9_b,
                           k9_rel_l2=rel, k9_rel_l2_limit=limit, k9_worst=at,
                           k9_cos=cos, k9_max_abs=k9_abs,
                           k9_library_ms=k9_lib))
        rows["fused_mlp_eval_f32"] = {
            "name": "fused_mlp_eval_f32", "route": "cuda",
            "source": "nerf_pytorch_paeng_tpu_torch/kernels/csrc/fused_mlp.cu",
            "replaces": "nerf_pytorch_paeng_tpu/kernels/fused_mlp.py:151",
            "launches": None, "max_abs_err": k8_abs, "ms": k8_ms,
            "plain_ms": k8_plain_ms, "bound_ms": k8_b, "bound_by": k8_by,
            "library_ms": k8_lib, "library": PRODUCTS_ONLY, "points": n_pts}
        rows["fused_mlp_bwd"] = {
            "name": "fused_mlp_bwd", "route": "cuda",
            "source": "nerf_pytorch_paeng_tpu_torch/kernels/csrc/fused_mlp_vjp.cu",
            "replaces": "nerf_pytorch_paeng_tpu/kernels/fused_mlp_vjp.py:122",
            "launches": None, "max_abs_err": k9_abs, "ms": k9_ms,
            "plain_ms": k9_plain_ms, "bound_ms": k9_b, "bound_by": k9_by,
            "library_ms": k9_lib, "library": WGRAD_ONLY, "points": n_pts}
    return rows, shapes


def record_plane_pair(fv, calls: list):
    """Wrap ``fused_mlp_train`` (which ``make_train_field_fns`` imports at
    call time) to keep each call's planes in ``calls`` and, from a hook on
    its output, the cotangent its backward receives; returns the function
    that undoes it."""
    pair = fv.fused_mlp_train

    def rec(w, b, xplane, dplane, *a, **kw):
        out = pair(w, b, xplane, dplane, *a, **kw)
        entry = dict(x=xplane, d=dplane, g4=None)
        calls.append(entry)
        out.register_hook(lambda g, e=entry: e.__setitem__(
            "g4", g.detach().float().contiguous()))
        return out

    fv.fused_mlp_train = rec

    def undo():
        fv.fused_mlp_train = pair
    return undo


def plane_train_run(work, data_root, device, label: str, iters: int,
                    *extra) -> dict:
    """``main_worker`` for ``iters`` steps on a plane route; checks that
    every step launched K8 and K9 twice and nothing else."""
    from nerf_pytorch_paeng_tpu_torch import driver
    from nerf_pytorch_paeng_tpu_torch.config import load_config
    cfg = load_config(train_args(work, data_root, f"smoke_{label}", iters,
                                 "--idx_print", "10", "--idx_save", "0",
                                 *extra))
    zero_launches()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    res = driver.main_worker(cfg)
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    launches = read_launches()
    for name, want in launches.items():
        expect = 2 * iters if name in ("fused_mlp_eval_f32",
                                       "fused_mlp_bwd") else 0
        if name == "fused_mlp_eval":       # K8's counter, read as bf16 too
            continue
        check(want == expect, f"plane train [{label}]: {name} launched "
              f"{want} times in {iters} steps, not {expect}")
    losses = res["loss"]
    check(len(losses) == iters and all(map(math.isfinite, losses)),
          f"plane train [{label}]: non-finite losses")
    step_ms = [t * 1e3 for t in res["step_s"]]
    steady = step_ms[5:]
    out = dict(cfg=cfg, launches=launches, losses=losses, step_ms=step_ms,
               median_step_ms=statistics.median(steady), wall_s=wall,
               peak_gb=torch.cuda.max_memory_allocated(device) / 1e9)
    log(f"plane train [{label}]: launches {launches} in {iters} steps; loss "
        f"first {losses[0]:.5f} last {losses[-1]:.5f}; step device ms median "
        f"of 6.. {out['median_step_ms']:.2f} (min {min(steady):.2f}, max "
        f"{max(steady):.2f}); wall {wall:.1f} s; peak device memory "
        f"{out['peak_gb']:.2f} GB")
    return out


def plane_train_phase(fm, fv, packed_rand, work, data_root, device):
    """The plane training pair on the lego config at full width: 30 steps
    with ``--use_rays_train false``, 10 at ``--N_rays 4000``, a profiled
    plane step, one step ray against plane from the same state and draws,
    and K8 and K9 on that step's own inputs with the seeded weights."""
    import dataclasses

    from nerf_pytorch_paeng_tpu_torch.data import load_blender
    from nerf_pytorch_paeng_tpu_torch.train import create_train_state
    from nerf_pytorch_paeng_tpu_torch.train.schedule import schedule_from_cfg
    from nerf_pytorch_paeng_tpu_torch.train.step import (make_image_train_step,
                                                         uses_ray_pair)

    runs = {"planes": plane_train_run(work, data_root, device, "plane",
                                      PLANE_STEPS, "--use_rays_train",
                                      "false")}
    launches = runs["planes"]["launches"]
    losses = runs["planes"]["losses"]
    first, last = statistics.mean(losses[:10]), statistics.mean(losses[-10:])
    check(last < first, f"plane loss did not fall: first 10 {first}, last 10 "
          f"{last}")
    runs["n4000"] = plane_train_run(work, data_root, device, "plane4000",
                                    PLANE_SHAPE_STEPS, "--N_rays", "4000")

    cfg = runs["planes"]["cfg"]
    cfg_rays = dataclasses.replace(cfg, use_rays_train=True)
    check(not uses_ray_pair(cfg, cfg.N_rays)
          and uses_ray_pair(cfg_rays, cfg.N_rays), "route switch")
    images, (K, ext), (H, W), i_split = load_blender(
        data_root, cfg.bkg_white, cfg.downsample, cfg.testskip)
    i0 = int(i_split[0][0])
    img = torch.as_tensor(images[i0], device=device)
    pose = torch.as_tensor(ext[i0][:3, :4], device=device)
    step = make_image_train_step(cfg, schedule_from_cfg(cfg), H, W, K)
    st = create_train_state(cfg, device)
    step(st, img, pose)                          # warm-up
    prof = profile_call(lambda: step(st, img, pose), "plane train step",
                        device)

    # one step from the same fresh state and the same draws, both routes
    st_r, st_p = create_train_state(cfg, device), create_train_state(cfg,
                                                                     device)
    w0 = {k: v.clone() for k, v in st_p.model.state_dict().items()}
    m_r = make_image_train_step(cfg_rays, schedule_from_cfg(cfg), H, W, K)(
        st_r, img, pose)
    calls = []
    undo = record_plane_pair(fv, calls)
    try:
        m_p = step(st_p, img, pose)
    finally:
        undo()
    torch.cuda.synchronize(device)
    lr = float(st_p.optimizer.param_groups[0]["lr"])
    loss_rel = abs(float(m_p["loss"]) - float(m_r["loss"])) / float(m_r["loss"])
    dr = torch.cat([(v - w0[k]).flatten()
                    for k, v in st_r.model.state_dict().items()])
    dp = torch.cat([(v - w0[k]).flatten()
                    for k, v in st_p.model.state_dict().items()])
    ab_max = float((dr - dp).abs().max())
    log(f"plane train A/B, one step from the same state and draws: loss ray "
        f"{float(m_r['loss'])!r} plane {float(m_p['loss'])!r}, relative "
        f"{loss_rel:.3e} (limit {PLANE_AB_LOSS_RTOL}); updates differ by max "
        f"abs {ab_max:.3e} (limit 2 lr = {2 * lr:.3e})")
    check(loss_rel <= PLANE_AB_LOSS_RTOL, f"ray vs plane loss {loss_rel}")
    check(ab_max <= 2 * lr * (1 + 1e-3), "ray vs plane updates")

    # K8 and K9 on that step's planes and cotangents, seeded weights
    check(len(calls) == 2 and all(c["g4"] is not None for c in calls),
          f"{len(calls)} plane passes recorded, or a lost cotangent")
    path = []
    p = packed_rand["fine"]
    for c in calls:
        n_pts = c["x"].shape[1]
        k8_abs, k8_rel, _, _ = k8_check(fm, c["x"], c["d"], p, torch.float32,
                                        f"path float32 at {n_pts}", reps=0)
        (rel, limit, at), cos, k9_abs, _ = k9_check(
            fm, fv, c["x"], c["d"], c["g4"], p, f"path at {n_pts}")
        log(f"path kernel fused_mlp_eval (float32 out) and fused_mlp_bwd: "
            f"P={n_pts}: K8 max_abs={k8_abs:.3e} rel_l2={k8_rel:.3e}; K9 "
            f"worst rel_l2={rel:.3e} against {limit:.3e} ({at}) min "
            f"cos={cos:.6f} max_abs={k9_abs:.3e}")
        path.append(dict(P=n_pts, k8_max_abs=k8_abs, k8_rel_l2=k8_rel,
                         k9_rel_l2=rel, k9_limit=limit, k9_worst=at,
                         k9_cos=cos, k9_max_abs=k9_abs))
    del calls
    summary = {k: {kk: vv for kk, vv in r.items() if kk != "cfg"}
               for k, r in runs.items()}
    return launches, runs["n4000"]["launches"], dict(
        runs=summary, profile=prof, path=path,
        ab=dict(loss_rays=float(m_r["loss"]), loss_planes=float(m_p["loss"]),
                loss_rel=loss_rel, update_max_abs=ab_max, lr=lr))


def plane_frames(fm, cfg, H, W, K, packed, pose, device, what: str,
                 generator=None):
    """One frame through the kernels and through the plain versions, same
    draws, then the kernels' frame once more under the profiler: (PSNR,
    kernel ms, plain ms, profile)."""
    from nerf_pytorch_paeng_tpu_torch.eval.frame import make_frame_renderer
    frames, times = {}, {}
    for label, kw in (("kernels", {}), ("plain", dict(
            points_fn=fm.fused_mlp_sigma_plain,
            plane_fn=fm.fused_mlp_eval_plain))):
        render = make_frame_renderer(cfg, H, W, K, device,
                                     stratified=generator is not None, **kw)
        check(not render.rays_route, "a plane config took the ray kernels")
        gen = (None if generator is None else
               torch.Generator(device).manual_seed(generator))
        t0 = time.perf_counter()
        frames[label] = render(packed, pose, gen)
        torch.cuda.synchronize(device)
        times[label] = (time.perf_counter() - t0) * 1e3
        if label == "kernels":          # once more, the same draws
            if gen is not None:
                gen.manual_seed(generator)
            prof = profile_call(lambda: render(packed, pose, gen),
                                f"plane frame {what}", device)
    rgb = frames["kernels"][0]
    check(rgb.shape == (H, W, 3) and bool(torch.isfinite(rgb).all())
          and bool(torch.isfinite(frames["kernels"][1]).all()),
          "plane frame shape or finiteness")
    return psnr(rgb, frames["plain"][0]), times["kernels"], times["plain"], prof


def plane_eval_phase(fm, work: str, data_root: str, device, ray_frame_ms):
    """``--eval_only`` with ``--N_samples_f 0`` (coarse only: K8) and
    ``--N_samples_f 100`` (64 + 100 samples: K7 + K8) at 800x800 on the
    eval phase's checkpoint, and ``--render_only --N_samples_f 100`` (3
    orbit views of the compact field through the culled renderer's plane
    branches); each path's launches, and one frame of each against the
    plain versions."""
    import dataclasses

    from nerf_pytorch_paeng_tpu_torch import driver
    from nerf_pytorch_paeng_tpu_torch.config import load_config
    from nerf_pytorch_paeng_tpu_torch.data import load_blender
    from nerf_pytorch_paeng_tpu_torch.data.render_pose import get_render_pose
    from nerf_pytorch_paeng_tpu_torch.kernels.fused_mlp import pack_nerf

    base = ["--config", os.path.join(HERE, "configs/blender/lego.txt"),
            "--testing_idx", "1", "--data_root", data_root,
            "--log_dir", os.path.join(work, "logs")]
    out, paths = {}, {}
    cfg = load_config(base)
    _, (K, ext), (H, W), i_split = load_blender(
        data_root, cfg.bkg_white, cfg.downsample, cfg.testskip)
    per_frame = -(-H * W // BLOCK)
    for label, n_fine, extra in (
            ("eval_f0", 0, ["--eval_only", "true"]),
            ("eval_f100", PLANE_FINE, ["--eval_only", "true"]),
            ("render_f100", PLANE_FINE,
             ["--render_only", "true", "--exp_name", "smoke_render",
              "--n_angle", str(PLANE_RENDER_VIEWS)])):
        cfg = load_config(base + extra + ["--N_samples_f", str(n_fine)])
        zero_launches()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        res = driver.main_worker(cfg)
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        launches = read_launches()
        frame_ms = [t * 1e3 for t in res["frame_s"]]
        n = len(frame_ms)
        if label.startswith("eval"):
            check(n == 3, f"{label}: {n} test views")
            want_k8, want_k7 = n * per_frame, (n * per_frame if n_fine else 0)
        else:
            check(n == PLANE_RENDER_VIEWS
                  and res["rgbs"].shape == (n, H, W, 3)
                  and bool(np.isfinite(res["rgbs"]).all()), "plane render")
            want_k8 = sum(st["blocks"] for st in res["stats"])
            want_k7 = n            # phase 1, one per frame; no support grid
        for name, got in launches.items():
            want = {"fused_mlp_eval": want_k8, "fused_mlp_eval_f32": want_k8,
                    "fused_mlp_sigma": want_k7}.get(name, 0)
            check(got == want, f"{label}: {name} launched {got} times, not "
                  f"{want}")
        # one frame again, kernels and plain versions, the same draws
        model = driver.load_model(cfg, cfg.testing_idx, device)
        packed = pack_nerf(model, cfg, device=device)
        if label.startswith("eval"):
            pose = torch.as_tensor(ext[i_split[2][0]][:3, :4])
            p_db, k_ms, p_ms, prof = plane_frames(
                fm, cfg, H, W, K, packed, pose, device, label,
                cfg.seed + cfg.testing_idx)
        else:
            pose = torch.as_tensor(get_render_pose(PLANE_RENDER_VIEWS)[1][:3, :4])
            p_db, k_ms, p_ms, prof = plane_frames(
                fm, dataclasses.replace(cfg, perturb=0.0), H, W, K, packed,
                pose, device, label)
        check(p_db >= FRAME_PSNR_MIN, f"{label}: kernels vs plain {p_db} dB")
        stats = [dict(n_act=st["n_act"], blocks=st["blocks"])
                 for st in res.get("stats", [])]
        ray_ms = ray_frame_ms["render" if label.startswith("render")
                              else "eval"]
        log(f"plane {label}: launches {launches}; frame device ms "
            f"{['%.1f' % t for t in frame_ms]} (CUDA events; the ray route "
            f"at 64+128 in this run: {['%.1f' % t for t in ray_ms]}); "
            f"wall {wall:.2f} s; kernels vs plain PSNR {p_db:.2f} dB (min "
            f"{FRAME_PSNR_MIN}), frame {k_ms:.1f} ms kernels, {p_ms:.1f} ms "
            f"plain; culled stats {stats}")
        paths[label] = launches
        out[label] = dict(frame_ms=frame_ms, wall_s=wall, stats=stats,
                          kernels_vs_plain_psnr=p_db, frame_kernels_ms=k_ms,
                          frame_plain_ms=p_ms, profile=prof,
                          peak_gb=torch.cuda.max_memory_allocated(device) / 1e9)
    return paths, out


def llff_args(work: str, data_root: str, *extra):
    """configs/llff/fern.txt on the synthetic capture, written at fern's
    downsample-8 size, so ``--downsample 0`` is the one cut."""
    return ["--config", os.path.join(HERE, "configs/llff/fern.txt"),
            "--data_root", data_root, "--log_dir", os.path.join(work, "logs"),
            "--downsample", "0", "--iter_warmup", "0", "--idx_vis", "0",
            "--idx_test", "0", "--idx_render", "0", *extra]


def only_launched(launches: dict, want: dict, what: str) -> None:
    """Every kernel launched as often as ``want`` says, every other kernel
    never."""
    for name, got in launches.items():
        need = want.get(name, 0)
        check(got == need, f"{what}: {name} launched {got} times, not {need}")


def ndc_train_kernels(fm, fv, calls, packed) -> dict:
    """K1 (float32 outputs) and K2 on the NDC rays, depths and cotangents
    one LLFF pool step gave them (both passes), with the seeded random
    weights: K1 within ``KERNEL_TOL`` of its plain version, K2 launched
    twice with the same bits and within ``GRAD_TOL`` of its plain version
    (floor: the plain version on the CPU)."""
    check(len(calls) == 2, f"{len(calls)} LLFF passes recorded, not 2")
    p = packed["fine"]
    out = {"fused_mlp_eval_rays": [], "fused_mlp_bwd_rays": []}
    for c in calls:
        od, z, cots = c["od"], c["z"], c["cots"]
        check(c["gate"] is None and all(t is not None for t in cots),
              "the LLFF step ran gated or lost a cotangent")
        s, n = z.shape
        got = fm.fused_mlp_eval_rays(od, z, p)
        want = fm.fused_mlp_eval_rays_plain(od, z, p)
        max_abs, rel_l2 = errors(got, want)
        check(max_abs <= KERNEL_TOL["max_abs"]
              and rel_l2 <= KERNEL_TOL["rel_l2"],
              f"K1 float32 on the LLFF step's NDC inputs ({n}, {s})")
        out["fused_mlp_eval_rays"].append(dict(N=n, S=s, out="float32",
                                               max_abs=max_abs, rel_l2=rel_l2))
        g1 = fv.fused_mlp_bwd_rays(od, z, *cots, p)
        g2 = fv.fused_mlp_bwd_rays(od, z, *cots, p)
        torch.cuda.synchronize()
        check(torch.equal(g1[0], g2[0]) and torch.equal(g1[1], g2[1]),
              f"K2 on the LLFF step's inputs ({n}, {s}): two launches differ")
        plain = fv.fused_mlp_bwd_rays_plain(od, z, *cots, p)
        other = fv.fused_mlp_bwd_rays_plain(
            od.cpu(), z.cpu(), *(t.cpu() for t in cots),
            fm._with_views(p["w"].cpu(), p["b"].cpu()))
        (rel, limit, at), cos, k2_abs = grad_errors(fm, g1, plain, other)
        check(rel <= limit and cos >= GRAD_TOL["cos"],
              f"K2 on the LLFF step's NDC inputs ({n}, {s}): {at} {rel} > "
              f"{limit} or cos {cos}")
        out["fused_mlp_bwd_rays"].append(dict(
            N=n, S=s, rel_l2=rel, limit=limit, worst=at, cos=cos,
            max_abs=k2_abs))
        log(f"path kernel on NDC inputs (LLFF step, {n} x {s}): K1 float32 "
            f"max_abs={max_abs:.3e} rel_l2={rel_l2:.3e}; K2 two launches "
            f"bit-equal, worst rel_l2={rel:.3e} against {limit:.3e} ({at}), "
            f"min cos={cos:.6f} (limit {GRAD_TOL['cos']}), "
            f"max_abs={k2_abs:.3e}; NDC z range "
            f"[{float(z.min()):.3f}, {float(z.max()):.3f}]")
    return out


def ndc_frame_kernels(fm, calls, packed, cfg, tail: int) -> dict:
    """K3 and K1 (bf16 outputs) on the NDC rays and depths one dense LLFF
    frame gave them, block by block (the ragged last block of ``tail``
    rays among them), with the seeded random weights, against their plain
    versions under ``KERNEL_TOL``."""
    out = {"fused_mlp_sigma_rays": [], "fused_mlp_eval_rays": []}
    for name, od, z, gate in calls:
        check(gate is None, f"{name} ran gated on the dense LLFF frame")
        s, n = z.shape
        if name == "fused_mlp_sigma_rays":
            kern, plain = fm.fused_mlp_sigma_rays, fm.fused_mlp_sigma_rays_plain
            p, kw = packed["coarse"], dict(L_x=cfg.L_x)
        else:
            kern, plain = fm.fused_mlp_eval_rays, fm.fused_mlp_eval_rays_plain
            p, kw = packed["fine"], dict(L_x=cfg.L_x, L_d=cfg.L_d)
        kw["out_dtype"] = torch.bfloat16
        got, want = (x if isinstance(x, tuple) else (x,)
                     for x in (kern(od, z, p, **kw), plain(od, z, p, **kw)))
        max_abs, rel_l2 = errors(got, want)
        check(max_abs <= KERNEL_TOL["max_abs"]
              and rel_l2 <= KERNEL_TOL["rel_l2"],
              f"{name} on the LLFF frame's NDC inputs ({n}, {s})")
        out[name].append(dict(N=n, S=s, out="bf16", max_abs=max_abs,
                              rel_l2=rel_l2))
        log(f"path kernel {name} on NDC inputs (dense LLFF frame): N={n} "
            f"S={s} max_abs={max_abs:.3e} rel_l2={rel_l2:.3e} (tolerance "
            f"{KERNEL_TOL})")
    for name, recs in out.items():
        check(any(r["N"] == tail for r in recs),
              f"{name}: the frame's ragged {tail}-ray block was not checked")
    return out


def llff_phase(fm, fv, packed_rand, work: str, device):
    """configs/llff/fern.txt on a synthetic forward-facing capture at
    fern's downsample-8 size (378 x 504): training (global ray pool, NDC),
    ``--eval_only`` through the dense renderer, ``--render_only`` of the
    120-view spiral through the culled renderer, the kernels on the
    path's own NDC inputs, and a few steps and one orbit frame of the same
    capture as ``data_type custom``.  Returns ({path: launches}, stats)."""
    import dataclasses

    from PIL import Image

    from nerf_pytorch_paeng_tpu_torch import driver
    from nerf_pytorch_paeng_tpu_torch.config import load_config
    from nerf_pytorch_paeng_tpu_torch.data import load_custom
    from nerf_pytorch_paeng_tpu_torch.eval.frame import make_frame_renderer
    from nerf_pytorch_paeng_tpu_torch.kernels.fused_mlp import pack_nerf
    from nerf_pytorch_paeng_tpu_torch.train import (RayPool, build_ray_pool,
                                                    create_train_state)
    from nerf_pytorch_paeng_tpu_torch.train.schedule import schedule_from_cfg
    from nerf_pytorch_paeng_tpu_torch.train.step import make_train_step
    from nerf_pytorch_paeng_tpu_torch.utils.synth import save_as_llff_dataset

    H, W = LLFF_HW
    root = os.path.join(work, "fern_synth")
    t0 = time.perf_counter()
    save_as_llff_dataset(root, n_views=LLFF_VIEWS, H=H, W=W,
                         n_samples=LLFF_GT_SAMPLES)
    log(f"llff: synthetic forward-facing capture, {LLFF_VIEWS} views at "
        f"{H}x{W} (fern's downsample-8 size), written in "
        f"{time.perf_counter() - t0:.1f} s")
    paths, stats = {}, {}

    # training: the global ray pool, NDC in the step, 60 steps
    cfg = load_config(llff_args(work, root, "--iter_N", str(LLFF_STEPS),
                                "--idx_print", "20",
                                "--idx_save", str(LLFF_STEPS)))
    check(cfg.data_type == "llff" and cfg.global_batch
          and cfg.N_rays == TRAIN_RAYS
          and (cfg.N_samples_c, cfg.N_samples_f) == (64, 128)
          and (cfg.near, cfg.far) == (0.0, 1.0),
          "fern.txt is not the full-width LLFF pool config")
    zero_launches()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    res = driver.main_worker(cfg)
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    only_launched(launches, {"fused_mlp_eval_rays": 2 * LLFF_STEPS,
                             "fused_mlp_bwd_rays": 2 * LLFF_STEPS},
                  "llff train")
    losses = res["loss"]
    check(len(losses) == LLFF_STEPS and all(map(math.isfinite, losses)),
          "llff train: non-finite losses")
    first, last = statistics.mean(losses[:10]), statistics.mean(losses[-10:])
    check(last < first, f"llff train: loss did not fall ({first} -> {last})")
    step_ms = [t * 1e3 for t in res["step_s"]]
    steady = statistics.median(step_ms[5:])
    log(f"llff train: launches {launches} in {LLFF_STEPS} steps; loss first "
        f"10 {first:.5f} -> last 10 {last:.5f}; step device ms (CUDA "
        f"events): first {step_ms[0]:.1f}, median of 6.. {steady:.2f} (min "
        f"{min(step_ms[5:]):.2f}, max {max(step_ms[5:]):.2f}); "
        f"{TRAIN_RAYS * 1e3 / steady:.0f} rays/s; wall {wall:.1f} s; peak "
        f"device memory {peak_gb:.2f} GB")
    paths["llff_train"] = launches

    # one pool step more under the profiler, then one whose kernel inputs
    # are recorded (not counted above)
    images, K, ext, (h, w), i_split, _, _ = driver.load_dataset(cfg)
    check((h, w) == (H, W), f"llff capture loaded at {h}x{w}")
    focal = float(K[0][0])
    state = create_train_state(cfg, device)
    gen = torch.Generator(device=device).manual_seed(cfg.seed + 1)
    pool = RayPool(build_ray_pool(images, K, ext, i_split[0], gen, device),
                   gen)
    step = make_train_step(cfg, schedule_from_cfg(cfg), H, W, focal)
    batch = pool.next_batch(cfg.N_rays)
    step(state, *batch)                        # warm-up
    prof = profile_call(lambda: step(state, *batch), "llff train step",
                        device)
    calls = []
    undo = record_pair(fv, calls)
    try:
        step(state, *batch)
    finally:
        undo()
    torch.cuda.synchronize(device)
    path = {"train": ndc_train_kernels(fm, fv, calls, packed_rand)}
    del calls
    stats["train"] = dict(losses=losses, step_ms=step_ms,
                          median_step_ms=steady, rays_per_s=TRAIN_RAYS * 1e3
                          / steady, wall_s=wall, peak_gb=peak_gb,
                          profile=prof)

    # --eval_only: the held-out views (testskip 8) through the dense
    # renderer, K3 + K1, two blocks a frame (131072 + a ragged 59440)
    per_frame = -(-H * W // BLOCK)
    tail = H * W - (per_frame - 1) * BLOCK
    ecfg = load_config(llff_args(work, root, "--eval_only", "true",
                                 "--testing_idx", str(LLFF_STEPS)))
    zero_launches()
    t0 = time.perf_counter()
    res = driver.main_worker(ecfg)
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    launches = read_launches()
    n_views = len(res["psnr"])
    check(n_views == len(range(0, LLFF_VIEWS, ecfg.testskip)),
          f"llff eval: {n_views} held-out views")
    only_launched(launches, {"fused_mlp_sigma_rays": n_views * per_frame,
                             "fused_mlp_eval_rays": n_views * per_frame},
                  "llff eval")
    check(all(math.isfinite(v) for v in res["psnr"] + res["ssim"]),
          "llff eval: non-finite metrics")
    frame_ms = [t * 1e3 for t in res["frame_s"]]
    paths["llff_eval"] = launches

    # one held-out view again, kernels and plain versions, the same draws;
    # the kernels' own inputs recorded block by block
    model = driver.load_model(ecfg, ecfg.testing_idx, device)
    packed = pack_nerf(model, ecfg, device=device)
    pose = torch.as_tensor(ext[i_split[2][0]][:3, :4])
    dense = dataclasses.replace(ecfg, render_cull="none")   # as eval/test.py
    calls = []
    frames = {}
    for label, kw in (
            ("kernels", dict(
                sigma_fn=recording(fm.fused_mlp_sigma_rays, calls,
                                   "fused_mlp_sigma_rays"),
                field_fn=recording(fm.fused_mlp_eval_rays, calls,
                                   "fused_mlp_eval_rays"))),
            ("plain", dict(sigma_fn=fm.fused_mlp_sigma_rays_plain,
                           field_fn=fm.fused_mlp_eval_rays_plain))):
        render = make_frame_renderer(dense, H, W, K, device, **kw)
        gen = torch.Generator(device).manual_seed(ecfg.seed +
                                                  ecfg.testing_idx)
        frames[label] = render(packed, pose, gen)
    torch.cuda.synchronize(device)
    check(render.launches_per_frame == per_frame
          and frames["kernels"][0].shape == (H, W, 3)
          and bool(torch.isfinite(frames["kernels"][0]).all()),
          "llff dense frame")
    p_plain = psnr(frames["kernels"][0], frames["plain"][0])
    check(p_plain >= FRAME_PSNR_MIN, f"llff frame kernels vs plain {p_plain}")
    check(sorted(z.shape[1] for _, _, z, _ in calls) ==
          sorted([BLOCK, tail] * 2), f"llff frame blocks "
          f"{[(n, z.shape) for n, _, z, _ in calls]}")
    path["frame"] = ndc_frame_kernels(fm, calls, packed_rand, ecfg, tail)
    del calls
    render = make_frame_renderer(dense, H, W, K, device)
    gen = torch.Generator(device).manual_seed(0)
    dense_ms, _ = cuda_ms(lambda: render(packed, pose, gen), reps=5)
    eprof = profile_call(lambda: render(packed, pose, gen),
                         "llff dense frame", device)
    log(f"llff eval: launches {launches}; {n_views} views, frame device ms "
        f"{['%.1f' % t for t in frame_ms]} (CUDA events; the first includes "
        f"warm-up), dense frame median of 5 {dense_ms:.1f} ms ({per_frame} "
        f"blocks: {BLOCK} + {tail} rays); kernels vs plain PSNR "
        f"{p_plain:.2f} dB (min {FRAME_PSNR_MIN}); test PSNR {res['psnr']} "
        f"SSIM {res['ssim']}; wall {wall:.2f} s")
    stats["eval"] = dict(frame_ms=frame_ms, dense_frame_ms=dense_ms,
                         kernels_vs_plain_psnr=p_plain, psnr=res["psnr"],
                         ssim=res["ssim"], wall_s=wall, blocks=[BLOCK, tail],
                         profile=eprof)

    # --render_only: the 120-view spiral through the culled renderer, K3
    # (phase 1) and K1 (phase 2) only
    rcfg = load_config(llff_args(work, root, "--render_only", "true",
                                 "--testing_idx", str(LLFF_STEPS)))
    check(rcfg.render_cull == "auto", "fern.txt does not render culled")
    zero_launches()
    t0 = time.perf_counter()
    res = driver.main_worker(rcfg)
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    launches = read_launches()
    n = len(res["frame_s"])
    blocks = [st["blocks"] for st in res["stats"]]
    check(n == LLFF_SPIRAL and res["rgbs"].shape == (n, H, W, 3)
          and bool(np.isfinite(res["rgbs"]).all())
          and bool(np.isfinite(res["disps"]).all()), "llff spiral frames")
    only_launched(launches, {"fused_mlp_sigma_rays": n,
                             "fused_mlp_eval_rays": sum(blocks)},
                  "llff render")
    check(all(st["gate_frac_coarse"] is None and st["gate_frac_fine"] is None
              for st in res["stats"]), "an LLFF frame ran gated")
    with Image.open(os.path.join(res["save_dir"], "_rgb.gif")) as im:
        check(im.n_frames == n and im.size == (W, H), "llff spiral gif")
    rframe_ms = [t * 1e3 for t in res["frame_s"]]
    n_act = [st["n_act"] for st in res["stats"]]
    paths["llff_render"] = launches

    # one spiral pose at perturb 0: culled against dense
    spiral = driver._llff_render_poses_34(driver.load_dataset(rcfg)[5])
    pose = torch.as_tensor(spiral[LLFF_SPIRAL // 4])
    det = dataclasses.replace(rcfg, perturb=0.0)
    times, out = {}, {}
    for label, c in (("culled", det),
                     ("dense", dataclasses.replace(det, render_cull="none"))):
        render = make_frame_renderer(c, H, W, K, device, stratified=False)
        times[label], out[label] = cuda_ms(lambda: render(packed, pose),
                                           reps=5)
    p_dense = psnr(out["culled"][0], out["dense"][0])
    check(p_dense >= CULLED_VS_DENSE_PSNR_MIN,
          f"llff culled vs dense {p_dense} dB")
    rprof = profile_call(lambda: render(packed, pose), "llff dense spiral "
                         "frame", device)
    render = make_frame_renderer(det, H, W, K, device, stratified=False)
    cprof = profile_call(lambda: render(packed, pose), "llff culled spiral "
                         "frame", device)
    log(f"llff render: launches {launches}; {n} spiral views, frame device "
        f"ms median {statistics.median(rframe_ms):.1f} (min "
        f"{min(rframe_ms):.1f}, max {max(rframe_ms):.1f}, first "
        f"{rframe_ms[0]:.1f}); active rays median "
        f"{statistics.median(n_act):.0f} of {H * W}; phase-2 blocks "
        f"{sorted(set(blocks))}; wall {wall:.1f} s; one pose at perturb 0: "
        f"culled vs dense PSNR {p_dense:.2f} dB (min "
        f"{CULLED_VS_DENSE_PSNR_MIN}), culled {times['culled']:.1f} ms, dense "
        f"{times['dense']:.1f} ms (median of 5)")
    stats["render"] = dict(views=n, frame_ms=rframe_ms, n_act=n_act,
                           blocks=blocks, wall_s=wall,
                           culled_vs_dense_psnr=p_dense, pose_frame_ms=times,
                           profile=dict(dense=rprof, culled=cprof))

    # data_type custom on the same capture (poses_bounds.npy in place, no
    # COLMAP): the loader's near/far, a few steps, one orbit frame
    ccfg = load_config(llff_args(work, root, "--data_type", "custom",
                                 "--exp_name", "smoke_custom", "--iter_N",
                                 str(CUSTOM_STEPS), "--idx_print", "0",
                                 "--idx_save", str(CUSTOM_STEPS)))
    *_, nf = load_custom(root, downsample=0, testskip=ccfg.testskip)
    got = driver.load_dataset(ccfg)[-1]
    check((got.near, got.far) == tuple(nf) and tuple(nf) != (0.0, 1.0),
          f"custom near/far {got.near, got.far}, loader {nf}")
    zero_launches()
    res = driver.main_worker(ccfg)
    torch.cuda.synchronize(device)
    launches = read_launches()
    only_launched(launches, {"fused_mlp_eval_rays": 2 * CUSTOM_STEPS,
                             "fused_mlp_bwd_rays": 2 * CUSTOM_STEPS},
                  "custom train")
    check(all(map(math.isfinite, res["loss"])), "custom: non-finite losses")
    paths["custom_train"] = launches
    zero_launches()
    rres = driver.main_worker(load_config(llff_args(
        work, root, "--data_type", "custom", "--exp_name", "smoke_custom",
        "--render_only", "true", "--testing_idx", str(CUSTOM_STEPS),
        "--n_angle", "1")))
    torch.cuda.synchronize(device)
    launches = read_launches()
    check(rres["rgbs"].shape == (1, H, W, 3)
          and bool(np.isfinite(rres["rgbs"]).all()), "custom orbit frame")
    only_launched(launches, {"fused_mlp_sigma_rays": 1, "fused_mlp_eval_rays":
                             sum(st["blocks"] for st in rres["stats"])},
                  "custom render")
    paths["custom_render"] = launches
    cstep_ms = [t * 1e3 for t in res["step_s"]]
    log(f"custom: near/far {nf[0]:.4f}/{nf[1]:.4f} from the loader; "
        f"{CUSTOM_STEPS} steps, losses {['%.5f' % v for v in res['loss']]}, "
        f"step device ms {['%.1f' % t for t in cstep_ms]}; one orbit frame "
        f"{rres['frame_s'][0] * 1e3:.1f} ms; launches train "
        f"{paths['custom_train']}, render {launches}")
    stats["custom"] = dict(near=nf[0], far=nf[1], losses=res["loss"],
                           step_ms=cstep_ms,
                           frame_ms=rres["frame_s"][0] * 1e3)
    stats["path_kernels"] = path
    return paths, stats


def plain_train_run(work, data_root, device, label: str, iters: int,
                    *extra) -> dict:
    """``main_worker`` for ``iters`` per-image lego steps with
    ``--use_pallas false`` (and ``extra``): losses, step times (CUDA
    events, median of steps 6..) and peak device memory."""
    from nerf_pytorch_paeng_tpu_torch import driver
    from nerf_pytorch_paeng_tpu_torch.config import load_config
    from nerf_pytorch_paeng_tpu_torch.train.step import step_route
    cfg = load_config(train_args(work, data_root, f"smoke_{label}", iters,
                                 "--use_pallas", "false", "--idx_print",
                                 "10", *extra))
    check(step_route(cfg, cfg.N_rays) == "plain",
          f"plain [{label}]: the config does not take the plain route")
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    res = driver.main_worker(cfg)
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    losses = res["loss"]
    check(len(losses) == iters and all(map(math.isfinite, losses)),
          f"plain [{label}]: non-finite losses")
    step_ms = [t * 1e3 for t in res["step_s"]]
    out = dict(cfg=cfg, losses=losses, step_ms=step_ms,
               median_step_ms=statistics.median(step_ms[5:]), wall_s=wall,
               peak_gb=torch.cuda.max_memory_allocated(device) / 1e9)
    log(f"plain [{label}]: {iters} steps; loss first {losses[0]:.5f} last "
        f"{losses[-1]:.5f}; step device ms median of 6.. "
        f"{out['median_step_ms']:.2f} (min {min(step_ms[5:]):.2f}, max "
        f"{max(step_ms[5:]):.2f}); wall {wall:.1f} s; peak device memory "
        f"{out['peak_gb']:.2f} GB")
    return out


def plain_eval_run(base: list, device, label: str) -> dict:
    """``main_worker`` with ``--eval_only`` on ``base`` (one held-out view,
    ``--use_pallas false``): its frame times and metrics."""
    from nerf_pytorch_paeng_tpu_torch import driver
    from nerf_pytorch_paeng_tpu_torch.config import load_config
    cfg = load_config(base + ["--eval_only", "true", "--use_pallas", "false",
                              "--testskip", "3"])
    t0 = time.perf_counter()
    res = driver.main_worker(cfg)
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    check(len(res["psnr"]) == 1 and math.isfinite(res["psnr"][0])
          and math.isfinite(res["ssim"][0]), f"plain {label}: test metrics")
    frame_ms = [t * 1e3 for t in res["frame_s"]]
    log(f"plain {label}: --eval_only, 1 view at 800x800, frame device ms "
        f"{['%.1f' % t for t in frame_ms]} (CUDA events), wall {wall:.2f} s, "
        f"PSNR {res['psnr'][0]:.3f} SSIM {res['ssim'][0]:.4f}")
    return dict(frame_ms=frame_ms, wall_s=wall, psnr=res["psnr"],
                ssim=res["ssim"])


def plain_route_phase(fm, work: str, data_root: str, device, ray: dict):
    """The plain-MLP route, which runs no kernel: configs/blender/lego.txt
    at full width with ``--use_pallas false`` on the synthetic scene.
    ``PLAIN_STEPS`` per-image steps (loss falls; median step, idle share
    of one profiled step, peak memory, beside the kernel route's step of
    this call, ``ray``), ``--eval_only`` of one 800x800 view through the
    dense renderer, the same view at ``perturb 0`` through the kernels and
    the plain route from the same weights and draws (>= 35 dB) and the
    plain route with and without TF32 in its forward products (time and
    PSNR), ``--render_only`` of ``PLAIN_RENDER_VIEWS`` orbit views of the
    compact field through the culled renderer's plain branches, and the
    non-reference shape ``PLAIN_SHAPE`` (``PLAIN_SHAPE_STEPS`` steps and one
    dense frame).  The kernels' reference frame is rendered before the
    counters are zeroed; from then on no kernel may launch."""
    import dataclasses

    from nerf_pytorch_paeng_tpu_torch import driver
    from nerf_pytorch_paeng_tpu_torch.config import load_config
    from nerf_pytorch_paeng_tpu_torch.data import load_blender
    from nerf_pytorch_paeng_tpu_torch.eval.frame import make_frame_renderer
    from nerf_pytorch_paeng_tpu_torch.kernels.fused_mlp import pack_nerf
    from nerf_pytorch_paeng_tpu_torch.ops import render as ops_render
    from nerf_pytorch_paeng_tpu_torch.train import create_train_state
    from nerf_pytorch_paeng_tpu_torch.train.schedule import schedule_from_cfg
    from nerf_pytorch_paeng_tpu_torch.train.step import make_image_train_step

    base = ["--config", os.path.join(HERE, "configs/blender/lego.txt"),
            "--testing_idx", "1", "--data_root", data_root,
            "--log_dir", os.path.join(work, "logs")]
    cfg = load_config(base + ["--perturb", "0", "--render_cull", "none"])
    images, (K, ext), (H, W), i_split = load_blender(
        data_root, cfg.bkg_white, cfg.downsample, cfg.testskip)
    pose = torch.as_tensor(ext[i_split[2][0]][:3, :4])
    model = driver.load_model(cfg, cfg.testing_idx, device)
    seed = cfg.seed + cfg.testing_idx

    def frame(c, what: str):
        """One dense frame of the eval checkpoint's weights, the draws of
        ``seed``: (ms by CUDA events, rgb)."""
        render = make_frame_renderer(c, H, W, K, device)
        check(render.route == ("plain" if what.startswith("plain")
                               else "rays"), f"{what}: route {render.route}")
        fields = pack_nerf(model, c, device=device)
        gen = torch.Generator(device).manual_seed(seed)
        ms, (rgb, disp) = cuda_ms(lambda: render(fields, pose, gen), reps=1,
                                  warmup=0)
        check(rgb.shape == (H, W, 3) and bool(torch.isfinite(rgb).all())
              and bool(torch.isfinite(disp).all()), f"{what}: frame")
        return ms, rgb

    # the kernels' frame first: launches made to compare do not count
    kern_ms, kern_rgb = frame(cfg, "kernels")
    zero_launches()
    out = {}

    train = plain_train_run(work, data_root, device, "plain", PLAIN_STEPS,
                            "--idx_save", "0")
    losses = train.pop("losses")
    first, last = statistics.mean(losses[:10]), statistics.mean(losses[-10:])
    check(last < first, f"plain loss did not fall: first 10 {first}, last "
          f"10 {last}")
    tcfg = train.pop("cfg")
    i0 = int(i_split[0][0])
    img = torch.as_tensor(images[i0], device=device)
    tpose = torch.as_tensor(ext[i0][:3, :4], device=device)
    st = create_train_state(tcfg, device)
    step = make_image_train_step(tcfg, schedule_from_cfg(tcfg), H, W, K)
    step(st, img, tpose)                         # warm-up
    train["profile"] = profile_call(lambda: step(st, img, tpose),
                                    "plain train step", device)
    train.update(loss_first10=first, loss_last10=last,
                 kernel_route_median_step_ms=ray["step_ms"],
                 ratio_to_kernel_route=train["median_step_ms"] / ray["step_ms"])
    log(f"plain train: median step {train['median_step_ms']:.2f} ms against "
        f"the kernel route's {ray['step_ms']:.2f} in this call "
        f"({train['ratio_to_kernel_route']:.2f}x); loss first 10 "
        f"{first:.5f} -> last 10 {last:.5f}")
    out["train"] = train

    ev = plain_eval_run(base + ["--perturb", "0"], device, "eval")
    plain_cfg = dataclasses.replace(cfg, use_pallas=False)
    frames = {}
    for label, tf32 in (("plain_tf32", True), ("plain_fp32", False)):
        ops_render.PLAIN_TF32_AT_BF16 = tf32
        try:
            frames[label] = frame(plain_cfg, label)
        finally:
            ops_render.PLAIN_TF32_AT_BF16 = True
    p_kern = psnr(kern_rgb, frames["plain_tf32"][1])
    p_fp32 = psnr(kern_rgb, frames["plain_fp32"][1])
    p_ab = psnr(frames["plain_tf32"][1], frames["plain_fp32"][1])
    log(f"plain eval: one 800x800 view at perturb 0, the same weights and "
        f"draws: kernels {kern_ms:.1f} ms (the eval phase's frames "
        f"{['%.1f' % t for t in ray['frame_ms']]}), plain with TF32 forward "
        f"products {frames['plain_tf32'][0]:.1f} ms, plain in float32 "
        f"{frames['plain_fp32'][0]:.1f} ms; PSNR kernels vs plain "
        f"{p_kern:.2f} dB (min {FRAME_PSNR_MIN}; float32 products "
        f"{p_fp32:.2f}), TF32 vs float32 products {p_ab:.2f} dB")
    check(p_kern >= FRAME_PSNR_MIN, f"kernels vs plain frame {p_kern} dB")
    out["eval"] = dict(**ev, kernels_frame_ms=kern_ms,
                       kernel_route_frame_ms=ray["frame_ms"],
                       plain_tf32_frame_ms=frames["plain_tf32"][0],
                       plain_fp32_frame_ms=frames["plain_fp32"][0],
                       kernels_vs_plain_psnr=p_kern,
                       kernels_vs_plain_fp32_psnr=p_fp32,
                       tf32_vs_fp32_psnr=p_ab)

    rcfg = load_config(base + [
        "--render_only", "true", "--use_pallas", "false", "--exp_name",
        "smoke_render", "--n_angle", str(PLAIN_RENDER_VIEWS)])
    t0 = time.perf_counter()
    res = driver.main_worker(rcfg)
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    check(res["rgbs"].shape == (PLAIN_RENDER_VIEWS, H, W, 3)
          and bool(np.isfinite(res["rgbs"]).all())
          and bool(np.isfinite(res["disps"]).all()), "plain render frames")
    stats = [dict(n_act=st["n_act"], blocks=st["blocks"],
                  gated=st["gate_frac_coarse"] is not None
                  or st["gate_frac_fine"] is not None)
             for st in res["stats"]]
    check(not any(st["gated"] for st in stats), "a plain frame was gated")
    render_ms = [t * 1e3 for t in res["frame_s"]]
    log(f"plain render: {PLAIN_RENDER_VIEWS} orbit views of the compact "
        f"field, frame device ms {['%.1f' % t for t in render_ms]} (the "
        f"kernel route's culled frames in this call "
        f"{['%.1f' % t for t in ray['render_ms']]}); stats {stats}; wall "
        f"{wall:.2f} s")
    out["render"] = dict(frame_ms=render_ms, stats=stats, wall_s=wall,
                         kernel_route_frame_ms=ray["render_ms"])

    shape = plain_train_run(work, data_root, device, "plain_shape",
                            PLAIN_SHAPE_STEPS, "--idx_save",
                            str(PLAIN_SHAPE_STEPS), *PLAIN_SHAPE)
    shape.pop("cfg")
    shape_ev = plain_eval_run(
        base[:2] + ["--testing_idx", str(PLAIN_SHAPE_STEPS)] + base[4:]
        + ["--exp_name", "smoke_plain_shape", *PLAIN_SHAPE], device,
        "shape eval")
    out["shape"] = dict(args=list(PLAIN_SHAPE), train=shape, eval=shape_ev)

    launches = read_launches()
    check(not any(launches.values()),
          f"a kernel launched on the plain route: {launches}")
    log(f"plain route: launches {launches} (none)")
    return launches, out


# ------------------------------------------------ scan_chunk: CUDA graphs


def chunk_state_equal(a: dict, b: dict) -> bool:
    """Two checkpoints' weights and Adam states bit-equal."""
    if a["model_state_dict"].keys() != b["model_state_dict"].keys():
        return False
    if not all(torch.equal(v, b["model_state_dict"][k])
               for k, v in a["model_state_dict"].items()):
        return False
    sa, sb = (x["optimizer_state_dict"]["state"] for x in (a, b))
    return sa.keys() == sb.keys() and all(
        torch.equal(sa[i][k], sb[i][k])
        for i in sa for k in ("exp_avg", "exp_avg_sq", "step"))


def chunk_run(argv: list, device, chunk: int, start: int = 0,
              compact: bool = False) -> dict:
    """``main_worker`` at ``--scan_chunk chunk`` (from the compact field's
    checkpoint at ``start`` where ``compact``): its launches, result and
    final checkpoint."""
    from nerf_pytorch_paeng_tpu_torch import driver
    from nerf_pytorch_paeng_tpu_torch.config import load_config
    cfg = load_config(argv + ["--scan_chunk", str(chunk)])
    if compact:
        compact_checkpoint(cfg, start, device, GATED_RADIUS)
    zero_launches()
    t0 = time.perf_counter()
    res = driver.main_worker(cfg)
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    launches = read_launches()
    state = torch.load(driver.checkpoint_path(cfg, start + CHUNK_STEPS),
                       map_location="cpu", weights_only=True)
    step_ms = [t * 1e3 for t in res["step_s"]]
    return dict(cfg=cfg, res=res, launches=launches, state=state, wall=wall,
                median_ms=statistics.median(step_ms[CHUNK:]))


def chunk_kinds(work: str, data_root: str, llff_root: str) -> dict:
    """(argv without --scan_chunk and --exp_name's suffix, start, compact)
    of each step kind the phase holds: the lego ray step (K1/K2), the
    gated step from the compact field (K5/K6, a refresh every CHUNK
    steps), the plane step (K8/K9) and fern's pool step (K1/K2, NDC)."""
    def lego(exp, iters, *extra):
        return train_args(work, data_root, exp, iters, "--idx_print", "0",
                          "--idx_save", str(iters), *extra)
    end = GATED_START + CHUNK_STEPS
    return {
        "ray": (lambda s: lego(f"chunk_ray{s}", CHUNK_STEPS), 0, False),
        "gated": (lambda s: lego(
            f"chunk_gated{s}", end, "--iter_start", str(GATED_START),
            "--train_precull_every", str(CHUNK)), GATED_START, True),
        "plane": (lambda s: lego(f"chunk_plane{s}", CHUNK_STEPS,
                                 "--use_rays_train", "false"), 0, False),
        "llff_pool": (lambda s: llff_args(
            work, llff_root, "--exp_name", f"chunk_llff{s}", "--iter_N",
            str(CHUNK_STEPS), "--idx_print", "0", "--idx_save",
            str(CHUNK_STEPS)), 0, False)}


def trace_kernel_names(path: str) -> set:
    """The kernel names in a Chrome trace written by torch.profiler."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return {e.get("name", "") for e in events
            if str(e.get("cat", "")).lower() == "kernel"}


# the port's kernels in a device trace, by a part of their names, each with
# the launch counters of the wrappers that launch it once a call: one walk
# kernel a forward call (fused_mlp.cu walk_launch); one reduce_kernel a
# backward call and one compact_tiles_kernel a gated one (fused_mlp_vjp.cu
# bwd_run; PyTorch's own reduce kernels are templates, "reduce_kernel<")
TRACE_FAMILIES = {
    "eval_rays_wgmma_kernel": ("fused_mlp_eval_rays",
                               "fused_mlp_eval_rays_gated"),
    "sigma_rays_wgmma_kernel": ("fused_mlp_sigma_rays",
                                "fused_mlp_sigma_rays_gated"),
    "eval_points_wgmma_kernel": ("fused_mlp_eval",),
    "sigma_points_wgmma_kernel": ("fused_mlp_sigma",),
    "reduce_kernel(": ("fused_mlp_bwd_rays", "fused_mlp_bwd_rays_gated",
                       "fused_mlp_bwd"),
    "compact_tiles_kernel": ("fused_mlp_bwd_rays_gated",)}


def profiled_launches(fn, what: str, device) -> dict:
    """``profile_call(fn)`` and the launch counters' change over it, held
    family by family (``TRACE_FAMILIES``) against the launches the device
    trace saw: a CUDA graph's replay adds the counts its capture recorded
    without calling a wrapper, so this shows those counts true."""
    before = read_launches()
    stats = profile_call(fn, what, device, with_counts=True)
    after = read_launches()
    counts = stats.pop("counts")
    seen = {fam: sum(n for k, n in counts.items() if fam in k)
            for fam in TRACE_FAMILIES}
    counted = {fam: sum(after[c] - before[c] for c in cs)
               for fam, cs in TRACE_FAMILIES.items()}
    log(f"profile: {what}: launches in the device trace {seen}, by the "
        f"counters {counted}")
    check(seen == counted and sum(counted.values()) > 0,
          f"{what}: the trace's launches {seen} against the counters' "
          f"{counted}")
    stats.update(trace_launches=seen)
    return stats


def chunk_phase(work: str, data_root: str, llff_root: str, device) -> tuple:
    """``--scan_chunk 16`` against ``--scan_chunk 1`` for each step kind
    (``chunk_kinds``), CHUNK_STEPS steps each: losses, weights and Adam's
    state bit-equal, the launch counts equal, graphs captured and replayed;
    the ray step again under a world-1 NCCL group (its collectives inside
    the graph), bit-equal; median step times from step CHUNK + 1 on; one
    replayed chunk and the same steps eager under the profiler, their
    traces' launches against the counters (``profiled_launches``); a
    ``--profile true`` run whose trace names K1 and K2.  Returns
    ({kind: the chunked run's launches}, stats)."""
    from nerf_pytorch_paeng_tpu_torch.config import load_config
    from nerf_pytorch_paeng_tpu_torch.data import load_blender
    from nerf_pytorch_paeng_tpu_torch.train import create_train_state
    from nerf_pytorch_paeng_tpu_torch.train.chunk import StagedSteps
    from nerf_pytorch_paeng_tpu_torch.train.schedule import schedule_from_cfg

    card = card_line()
    launches, stats = {}, {"card": card}
    for kind, (argv, start, compact) in chunk_kinds(
            work, data_root, llff_root).items():
        one = chunk_run(argv(1), device, 1, start, compact)
        many = chunk_run(argv(CHUNK), device, CHUNK, start, compact)
        r1, rk = one["res"], many["res"]
        log(f"chunk [{kind}]: scan_chunk {CHUNK}: {rk['graph_captures']} "
            f"capture(s), {rk['graph_replays']} replayed step(s) of "
            f"{CHUNK_STEPS}, chunks {rk['chunks']}; median step "
            f"{many['median_ms']:.2f} ms against {one['median_ms']:.2f} ms "
            f"at scan_chunk 1 ({one['median_ms'] / many['median_ms']:.3f}x; "
            f"steps {CHUNK + 1}..{CHUNK_STEPS}, CUDA events); {card}")
        check(rk["graph_replays"] > 0 and rk["graph_captures"] >= 1
              and r1["graph_captures"] == r1["graph_replays"] == 0,
              f"{kind}: graphs {rk['graph_captures']}/{rk['graph_replays']}")
        check(rk["loss"] == r1["loss"] and all(map(math.isfinite, rk["loss"])),
              f"{kind}: the losses differ from scan_chunk 1")
        check(chunk_state_equal(one["state"], many["state"]),
              f"{kind}: the weights or Adam's state differ from scan_chunk 1")
        check(many["launches"] == one["launches"],
              f"{kind}: launches {many['launches']} against {one['launches']}")
        if kind == "gated":
            check(all(g is not None for g in rk["gate_frac"])
                  and many["launches"]["fused_mlp_bwd_rays_gated"]
                  == 2 * CHUNK_STEPS, f"gated: not every step gated")
        launches[kind] = many["launches"]
        stats[kind] = dict(
            captures=rk["graph_captures"], replays=rk["graph_replays"],
            chunks=rk["chunks"], median_step_ms=many["median_ms"],
            median_step_ms_scan1=one["median_ms"],
            loss_last=rk["loss"][-1], wall_s=many["wall"],
            wall_s_scan1=one["wall"], launches=many["launches"])
        if kind == "ray":
            # the same run under a world-1 NCCL group: the step's
            # all-reduces are captured with it
            with world_one_launch(make_group=True):
                nccl = chunk_run(argv(f"{CHUNK}_nccl"), device, CHUNK)
            check(nccl["res"]["graph_replays"] > 0
                  and nccl["res"]["loss"] == rk["loss"]
                  and chunk_state_equal(nccl["state"], many["state"]),
                  "ray: the NCCL world-1 chunked run differs")
            log(f"chunk [ray, NCCL world 1]: {nccl['res']['graph_replays']} "
                f"replayed steps, losses and state bit-equal to no group; "
                f"median step {nccl['median_ms']:.2f} ms")
            stats["ray_nccl"] = dict(replays=nccl["res"]["graph_replays"],
                                     median_step_ms=nccl["median_ms"])

    # one replayed chunk and the same 16 steps eager under the profiler
    cfg = load_config(train_args(work, data_root, "chunk_prof", 1000))
    images, (K, ext), (H, W), i_split = load_blender(
        data_root, cfg.bkg_white, cfg.downsample, cfg.testskip)
    i_train = i_split[0]
    staged = StagedSteps(
        cfg, create_train_state(cfg, device), schedule_from_cfg(cfg), device,
        H, W, K, graphs=True,
        images=torch.as_tensor(np.asarray(images[i_train], np.float32),
                               device=device),
        poses=torch.as_tensor(np.asarray(ext[i_train], np.float32)[:, :3, :4],
                              device=device))
    items = [j % len(i_train) for j in range(CHUNK)]
    staged.run(items, precrop=True, replay=True)     # warm-up and capture
    stats["profile_replayed"] = profiled_launches(
        lambda: staged.run(items, precrop=True, replay=True),
        f"one replayed chunk of {CHUNK} ray steps", device)
    stats["profile_eager"] = profiled_launches(
        lambda: staged.run(items, precrop=True, replay=False),
        f"the same {CHUNK} ray steps eager", device)
    staged.close()
    log(f"chunk: idle share {card}: replayed chunk "
        f"{stats['profile_replayed'].get('idle_share')}, eager "
        f"{stats['profile_eager'].get('idle_share')}")

    # --profile true: the window's trace names K1 and K2
    cfg = load_config(train_args(work, data_root, "chunk_trace", 16,
                                 "--idx_print", "0", "--idx_save", "0",
                                 "--profile", "true"))
    from nerf_pytorch_paeng_tpu_torch import driver
    driver.main_worker(cfg)
    path = os.path.join(cfg.logdir, cfg.exp_name, "profile",
                        "trace_10-14.json")
    names = trace_kernel_names(path)
    k1 = sorted(n for n in names if "eval_rays_wgmma_kernel" in n)
    k2 = sorted(n for n in names if "bwd_chain_kernel" in n)
    log(f"chunk: --profile true wrote {os.path.getsize(path)} bytes; K1 "
        f"{k1[:1]}, K2 {k2[:1]} among {len(names)} kernel names")
    check(k1 and k2, f"the profile trace names no K1 or K2: {sorted(names)}")
    stats["profile_trace_kernels"] = len(names)
    return launches, stats


@contextlib.contextmanager
def world_one_launch(make_group: bool = False):
    """The launch contract's variables for a world of one rank (rank 0, a
    free port on this host) inside the block, with the process group made
    (NCCL) where ``make_group``; then the environment as it was."""
    from nerf_pytorch_paeng_tpu_torch import parallel
    saved = {v: os.environ.get(v) for v in parallel.LAUNCH_ENV}
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                      MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(parallel.free_port()))
    try:
        if make_group:
            parallel.maybe_initialize_distributed("cuda")
        yield
    finally:
        if make_group:
            parallel.destroy()
        for v, old in saved.items():
            if old is None:
                os.environ.pop(v, None)
            else:
                os.environ[v] = old


def lpips_phase(work: str, data_root: str, device) -> tuple:
    """LPIPS(VGG16) on seeded random weights at the ``_LPIPS_KEYS`` shapes
    (the pretrained ones are not in the repository): the graph on the card
    against the CPU for one 800x800 pair (1e-4 relative, TF32 off), the
    TF32-on reading beside it (information, not a gate), one pair's time
    (CUDA events), then ``--eval_only`` with ``lpips_weights`` set: a
    finite LPIPS for every view.  Returns the eval path's launches and the
    phase's record."""
    from unittest import mock

    from nerf_pytorch_paeng_tpu_torch import driver
    from nerf_pytorch_paeng_tpu_torch.config import load_config
    from nerf_pytorch_paeng_tpu_torch.data import load_blender
    from nerf_pytorch_paeng_tpu_torch.eval import metrics
    from nerf_pytorch_paeng_tpu_torch.utils.synth import (
        random_lpips_params, save_lpips_params)

    path = save_lpips_params(os.path.join(work, "lpips_random.npz"),
                             random_lpips_params(0))
    on_card = metrics.load_lpips_params(path, device)
    on_cpu = metrics.load_lpips_params(path, "cpu")
    images, _, _, i_split = load_blender(data_root, True, 0, 1)
    gt = torch.from_numpy(images[i_split[2][0]])
    rng = np.random.default_rng(0)
    pred = torch.clamp(gt + torch.from_numpy(
        rng.normal(0, 0.05, gt.shape).astype(np.float32)), 0, 1)
    t0 = time.perf_counter()
    want = float(metrics.lpips_tensor(pred, gt, on_cpu))
    cpu_s = time.perf_counter() - t0
    gt_d, pred_d = gt.to(device), pred.to(device)
    ms, got = cuda_ms(lambda: metrics.lpips_tensor(pred_d, gt_d, on_card), 5)
    got = float(got)
    rel = abs(got - want) / abs(want)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        # the graph holds cuDNN's TF32 off through ``cudnn.flags``; made a
        # no-op here, the flag set above rules the convolutions
        with mock.patch.object(torch.backends.cudnn, "flags",
                               lambda **_: contextlib.nullcontext()):
            tf32_ms, tf32 = cuda_ms(
                lambda: metrics.lpips_tensor(pred_d, gt_d, on_card), 5)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    tf32 = float(tf32)
    log(f"lpips: 800x800 pair, seeded random VGG16 weights: card {got:.8f} "
        f"vs CPU {want:.8f} (rel {rel:.2e}, limit 1e-4); {ms:.3f} ms a pair "
        f"on the card (CUDA events, median of 5), {cpu_s:.2f} s on the CPU; "
        f"TF32 on (information): {tf32:.8f} (rel {abs(tf32 - want) / want:.2e}"
        f"), {tf32_ms:.3f} ms")
    check(rel <= 1e-4, f"LPIPS card vs CPU: {got} vs {want}")

    cfg = load_config(["--config", os.path.join(HERE,
                                                 "configs/blender/lego.txt"),
                       "--eval_only", "true", "--testing_idx", "1",
                       "--data_root", data_root, "--log_dir",
                       os.path.join(work, "logs"), "--lpips_weights", path])
    zero_launches()
    res = driver.main_worker(cfg)
    launches = read_launches()
    log(f"lpips: --eval_only with lpips_weights: LPIPS {res['lpips']}, "
        f"launches {launches}")
    check(len(res["lpips"]) == 3 and all(map(math.isfinite, res["lpips"])),
          f"eval LPIPS {res['lpips']}")
    return launches, dict(card=got, cpu=want, rel=rel, ms=ms, cpu_s=cpu_s,
                          tf32=tf32, tf32_ms=tf32_ms, eval_lpips=res["lpips"])


def dp_phase(work: str, data_root: str, device) -> tuple:
    """Data parallelism at world size 1 over NCCL (the card machine has one
    GPU): with the launch contract's variables set in this process,
    ``driver.main_worker`` makes the group, runs and destroys it.  Ten lego
    steps in each batch mode and one ``--eval_only`` frame must be
    bit-equal to the same runs without the variables (losses, the final
    checkpoint with its Adam moments, the view's metrics), and the frame
    through the renderer under the group bit-equal to the frame without;
    the launched runs must go through K1 and K2 (training) and K3 and K1
    (the frame).  Then ``python -m torch.distributed.run --standalone
    --nproc_per_node 1`` on the CLI with ``--n_data_shards 1`` must exit 0
    with rank 0's checkpoint written.  Returns each launched path's
    launches and the phase's record."""
    import dataclasses

    from nerf_pytorch_paeng_tpu_torch import driver, parallel
    from nerf_pytorch_paeng_tpu_torch.config import load_config
    from nerf_pytorch_paeng_tpu_torch.data import load_blender
    from nerf_pytorch_paeng_tpu_torch.eval.frame import make_frame_renderer
    from nerf_pytorch_paeng_tpu_torch.kernels.fused_mlp import pack_nerf

    launches, record = {}, {}
    steps = 10
    for mode in ("image", "global"):
        # plain, launched, launched, plain: the step time moves with the
        # host between runs, so each side runs first once
        runs = {"plain": [], "nccl": []}
        for j, label in enumerate(("plain", "nccl", "nccl", "plain")):
            cfg = load_config(train_args(
                work, data_root, f"dp_{mode}_{label}_{j}", steps,
                "--idx_print", "0", "--idx_save", str(steps),
                "--global_batch", "true" if mode == "global" else "false"))
            zero_launches()
            with (world_one_launch() if label == "nccl"
                  else contextlib.nullcontext()):
                res = driver.main_worker(cfg)
            check(not parallel.is_distributed(), "a group outlived "
                  "main_worker")
            torch.cuda.synchronize(device)
            runs[label].append((res, torch.load(
                driver.checkpoint_path(cfg, steps), map_location=device,
                weights_only=True), read_launches()))
        pres, pck, _ = runs["plain"][0]
        differ = []
        for res, ck, _ in runs["plain"][1:] + runs["nccl"]:
            differ += [k for k, v in pck["model_state_dict"].items()
                       if not torch.equal(v, ck["model_state_dict"][k])]
            sa, sb = (c["optimizer_state_dict"]["state"] for c in (pck, ck))
            differ += [f"adam {k}.{m}" for k in sa for m in sa[k]
                       if not torch.equal(sa[k][m], sb[k][m])]
            differ += ["loss"] if res["loss"] != pres["loss"] else []
        step_ms = {label: [statistics.median(t * 1e3
                                             for t in r[0]["step_s"][2:])
                           for r in rs] for label, rs in runs.items()}
        nl = runs["nccl"][0][2]
        log(f"dp {mode}: {steps} steps, plain / world 1 over NCCL / NCCL / "
            f"plain: losses and checkpoints bit-equal ({len(differ)} "
            f"differ); median step ms (CUDA events, steps 3-{steps}) plain "
            f"{['%.2f' % t for t in step_ms['plain']]}, launched "
            f"{['%.2f' % t for t in step_ms['nccl']]}; launches {nl}")
        check(not differ, f"dp {mode}: world-1 NCCL runs differ: {differ[:5]}")
        for _, _, la in runs["nccl"]:
            check(la["fused_mlp_eval_rays"] == 2 * steps
                  and la["fused_mlp_bwd_rays"] == 2 * steps,
                  f"dp {mode}: K1/K2 launches {la}")
        launches[f"dp_train_{mode}"] = nl
        record[f"train_{mode}"] = dict(
            steps=steps, bit_equal=True, step_ms_nccl=step_ms["nccl"],
            step_ms_plain=step_ms["plain"], launches=nl)

    # one --eval_only frame of the image run's checkpoint
    evals = {}
    for label in ("plain", "nccl"):
        cfg = load_config(["--config", os.path.join(
            HERE, "configs/blender/lego.txt"), "--eval_only", "true",
            "--testing_idx", str(steps), "--testskip", "3", "--exp_name",
            "dp_image_plain_0", "--data_root", data_root, "--log_dir",
            os.path.join(work, "logs")])
        zero_launches()
        with (world_one_launch() if label == "nccl"
              else contextlib.nullcontext()):
            evals[label] = (driver.main_worker(cfg), read_launches())
    (pe, _), (ne, nl) = evals["plain"], evals["nccl"]
    same = all(pe[k] == ne[k] for k in ("mse", "psnr", "ssim"))
    check(same and len(ne["psnr"]) == 1,
          f"dp eval: {ne['psnr']} vs {pe['psnr']}")
    check(nl["fused_mlp_sigma_rays"] > 0 and nl["fused_mlp_eval_rays"] > 0,
          f"dp eval launches {nl}")
    launches["dp_eval"] = nl
    # the frame itself, through the eval entry's dense renderer, with and
    # without a world-1 group
    model = driver.load_model(cfg, steps, device)
    packed = pack_nerf(model, cfg, device=device)
    _, (K, ext), (H, W), i_split = load_blender(data_root, cfg.bkg_white,
                                                cfg.downsample, cfg.testskip)
    pose = torch.as_tensor(ext[i_split[2][0]][:3, :4])
    dense = dataclasses.replace(cfg, render_cull="none")
    frames = {}
    for label in ("plain", "nccl"):
        with (world_one_launch(make_group=True) if label == "nccl"
              else contextlib.nullcontext()):
            check(parallel.is_distributed() == (label == "nccl"), label)
            render = make_frame_renderer(dense, H, W, K, device)
            frames[label] = render(packed, pose, torch.Generator(
                device).manual_seed(cfg.seed + steps))
            torch.cuda.synchronize(device)
    frame_equal = all(torch.equal(a, b) for a, b in zip(frames["plain"],
                                                        frames["nccl"]))
    log(f"dp eval: --eval_only at world 1 over NCCL: PSNR {ne['psnr']} vs "
        f"{pe['psnr']} plain, metrics equal {same}; the {H}x{W} frame "
        f"bit-equal under the group: {frame_equal}; launches {nl}")
    check(frame_equal, "dp eval: the world-1 frame differs")
    record["eval"] = dict(views=1, bit_equal=True, launches=nl)

    # through the launcher: torchrun, one process, the CLI
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "1", "-m", "nerf_pytorch_paeng_tpu_torch",
           *train_args(work, data_root, "dp_torchrun", 5, "--idx_print", "5",
                       "--idx_save", "5"), "--n_data_shards", "1"]
    env = {**os.environ, "PYTHONPATH": HERE}
    for v in parallel.LAUNCH_ENV:
        env.pop(v, None)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=HERE, env=env, capture_output=True,
                          text=True, timeout=600)
    wall = time.perf_counter() - t0
    ckpt = os.path.join(work, "logs", "dp_torchrun", "dp_torchrun_5.pth.tar")
    log(f"dp torchrun --nproc_per_node 1: exit {proc.returncode} in "
        f"{wall:.1f} s; rank 0's checkpoint {os.path.isfile(ckpt)}; "
        f"{[l for l in proc.stdout.splitlines() if 'rank(s)' in l]}")
    check(proc.returncode == 0 and os.path.isfile(ckpt),
          f"torchrun launch: {proc.returncode}\n{proc.stdout[-2000:]}\n"
          f"{proc.stderr[-2000:]}")
    record["torchrun"] = dict(exit=proc.returncode, wall_s=wall)
    return launches, record


def mesh_worker(spec_path: str) -> int:
    """One rank of the mesh phase: ``chip_smoke.py --mesh-worker <spec>``.

    The card machine has one GPU, and NCCL takes one rank a GPU, so the
    two ranks share ``cuda:0`` over a gloo group that this process makes
    itself (``parallel.maybe_initialize_distributed`` keeps a group its
    caller made).  Each job of the spec is one ``driver.main_worker`` run
    with every launch counter at 0 before it and read after.  Then, on
    the TP evaluation's weights: the dense frame of the ``--eval_only``
    entry's renderer (the rays split over both ranks), and the
    sample-sharded frame at ``perturb 0`` with K8's inputs recorded,
    timed (CUDA events) once more unrecorded, and K8 on one rank's
    coarse and fine planes of the first block against its plain version
    (these launches are not a path's).  Rank 0 writes its results, the
    frames included, to ``<out>/rank0.pt``; every rank writes its own."""
    import dataclasses
    import datetime

    import torch.distributed as dist
    sys.path.insert(0, HERE)
    with open(spec_path) as f:
        spec = json.load(f)
    r, world = spec["rank"], spec["world"]
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # a rank that fails leaves the other in a collective: 5 minutes, not
    # gloo's default 30
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{spec['port']}", rank=r, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    from nerf_pytorch_paeng_tpu_torch import driver, parallel
    from nerf_pytorch_paeng_tpu_torch.config import load_config
    from nerf_pytorch_paeng_tpu_torch.data import load_blender
    from nerf_pytorch_paeng_tpu_torch.eval.frame import make_frame_renderer
    from nerf_pytorch_paeng_tpu_torch.kernels import fused_mlp as fm

    device = torch.device("cuda", 0)
    out = {}
    try:
        for name, argv in spec["jobs"]:
            cfg = load_config(argv)
            zero_launches()
            res = driver.main_worker(cfg)
            torch.cuda.synchronize(device)
            out[name] = dict(res=res, launches=read_launches())
            log(f"mesh rank {r}: {name} done, launches "
                f"{out[name]['launches']}")

        # the frames, on the weights of the TP evaluation (its checkpoint)
        cfg = load_config(spec["jobs"][-2][1])
        parallel.init_layout(cfg)
        model = driver.load_model(cfg, cfg.testing_idx, device)
        packed = fm.pack_nerf(model, cfg, device=device)
        _, (K, ext), (H, W), i_split = load_blender(
            cfg.data_root, cfg.bkg_white, cfg.downsample, cfg.testskip)
        pose = torch.as_tensor(ext[i_split[2][0]][:3, :4])
        dense = make_frame_renderer(dataclasses.replace(
            cfg, render_cull="none"), H, W, K, device)
        out["tp_frame"] = dense(packed, pose, torch.Generator(
            device).manual_seed(cfg.seed + cfg.testing_idx))
        calls = []

        def rec(x, d, p, **kw):
            if len(calls) < 2:              # block 0: coarse, then fine
                calls.append((x, d, p, kw))
            return fm.fused_mlp_eval(x, d, p, **kw)
        sp_cfg = dataclasses.replace(load_config(spec["jobs"][-1][1]),
                                     perturb=0.0, render_cull="none")
        frames = []
        for plane_fn in (rec, fm.fused_mlp_eval):
            sp = make_frame_renderer(sp_cfg, H, W, K, device,
                                     plane_fn=plane_fn)
            zero_launches()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            frames.append(sp(packed, pose, torch.Generator(
                device).manual_seed(cfg.seed)))
            end.record()
            torch.cuda.synchronize(device)
            frames[-1] = (*frames[-1], start.elapsed_time(end),
                          read_launches()["fused_mlp_eval"])
        check(all(torch.equal(a, b) for a, b in zip(frames[0][:2],
                                                    frames[1][:2])),
              "the sample-sharded frame differs between two renders")
        out["sp_frame"] = frames[1][:2]
        out["sp_frame_ms"] = [f[2] for f in frames]
        out["sp_frame_k8"] = frames[1][3]
        k8 = []
        for turn in range(world):           # one rank at a time on the card
            if turn == r:
                k8 = sp_k8_check(fm, cfg, calls, r)
            dist.barrier()
        check(len(k8) == 2, f"K8 recorded {len(calls)} calls of block 0")
        out["k8_sp"] = k8
        out["layout"] = tuple(parallel.layout()[:2])
    finally:
        parallel.destroy()
    torch.save(out, os.path.join(spec["out"], f"rank{r}.pt"))
    return 0


def sp_k8_check(fm, cfg, calls, r: int) -> list:
    """K8 on one rank's recorded coarse and fine planes of a frame block
    (timed while the other rank waits) against its plain version."""
    k8 = []
    for (x, d, p, kw), what in zip(calls, ("coarse", "fine")):
        k_ms, got = cuda_ms(lambda: fm.fused_mlp_eval(x, d, p, **kw), 3)
        p_ms, want = cuda_ms(lambda: fm.fused_mlp_eval_plain(
            x, d, p, **kw), reps=1, warmup=0)
        max_abs, rel_l2 = errors([got], [want])
        n_pts = x.shape[1]
        wbytes = p["w"].numel() * 2 + p["b"].numel() * 4
        b_ms, b_by = bound(fm.eval_flop_per_point(cfg.L_x, cfg.L_d)
                           * n_pts, n_pts * (24 + 8) + wbytes)
        k8.append(dict(pass_=what, points=n_pts, max_abs=max_abs,
                       rel_l2=rel_l2, ms=k_ms, plain_ms=p_ms,
                       bound_ms=b_ms, bound_by=b_by))
        log(f"mesh rank {r}: K8 at the sample-sharded {what} planes of "
            f"block 0 ({n_pts} points): max_abs={max_abs:.3e} "
            f"rel_l2={rel_l2:.3e} (tolerance {KERNEL_TOL}) ms={k_ms:.3f}"
            f" plain_ms={p_ms:.3f} bound_ms={b_ms:.3f}")
        check(max_abs <= KERNEL_TOL["max_abs"]
              and rel_l2 <= KERNEL_TOL["rel_l2"],
              f"K8 at the sample-sharded {what} planes disagrees with "
              f"its plain version ({max_abs}, {rel_l2})")
    return k8


def mesh_phase(work: str, data_root: str, device) -> tuple:
    """The mesh's model axis on two ranks that share the one card over
    gloo (``mesh_worker``; NCCL takes one rank a GPU): it shows the
    semantics and the kernels on the card, not a 2-GPU speed.

    (a) ``--n_model_shards 2`` training, lego at full width and
    ``MESH_STEPS`` steps in each batch mode at ``MESH_RAYS`` rays (cut from
    4096: gloo stages every activation all-reduce through the host) and
    ``--compute_dtype float32`` (at bf16 the sharded sums' order flips
    bf16 roundings, ~1e-5 on the loss):
    step 1's loss within 1e-5 relative of the one-process plain-route
    step's (the width-sharded step takes the plain route, as the JAX
    package forces its XLA route there), no kernel launched, and the
    driver's check that the replicated weights are bit-equal over the
    model group; (b) ``--eval_only`` of one 800x800 view of the TP run's
    gathered checkpoint with ``--n_model_shards 2``: K3 and K1 launched,
    the frame within 1e-5 of the one-process frame; (c) the same with
    ``--sp_shards 2``: K8 launched and no other kernel, the frame at
    ``perturb 0`` at least ``FRAME_PSNR_MIN`` against the dense kernel
    frame of the same weights, K8 within ``KERNEL_TOL`` of its plain
    version on one rank's planes of one block.  Returns each path's
    launches (both ranks summed) and the phase's record."""
    import dataclasses

    from nerf_pytorch_paeng_tpu_torch import driver, parallel
    from nerf_pytorch_paeng_tpu_torch.config import load_config
    from nerf_pytorch_paeng_tpu_torch.data import load_blender
    from nerf_pytorch_paeng_tpu_torch.eval.frame import make_frame_renderer
    from nerf_pytorch_paeng_tpu_torch.kernels.fused_mlp import pack_nerf

    def steps_args(exp: str, mode: str, *extra):
        # float32 compute: at bf16 the sharded sums' other float32 order
        # flips some bf16 roundings of the next layer's operands (1.06e-5
        # relative on step 1's loss at 128 rays on the CPU)
        return train_args(work, data_root, exp, MESH_STEPS, "--N_rays",
                          str(MESH_RAYS), "--idx_print", "0", "--global_batch",
                          "true" if mode == "global" else "false",
                          "--compute_dtype", "float32", *extra)

    plain = {}
    for mode in ("image", "global"):
        cfg = load_config(steps_args(f"mesh_plain_{mode}", mode,
                                     "--idx_save", "0", "--use_pallas",
                                     "false"))
        plain[mode] = driver.main_worker(cfg)
    logs = os.path.join(work, "logs")
    eval_args = ["--config", os.path.join(HERE, "configs/blender/lego.txt"),
                 "--eval_only", "true", "--testing_idx", str(MESH_STEPS),
                 "--testskip", "3", "--exp_name", "mesh_tp_image",
                 "--data_root", data_root, "--log_dir", logs,
                 "--n_model_shards", "2"]
    jobs = [(f"tp_train_{mode}", steps_args(
        f"mesh_tp_{mode}", mode, "--idx_save", str(MESH_STEPS),
        "--n_model_shards", "2")) for mode in ("image", "global")]
    jobs += [("tp_eval", eval_args),
             ("sp_eval", eval_args + ["--sp_shards", "2"])]
    out_dir = os.path.join(work, "mesh")
    os.makedirs(out_dir)
    port = parallel.free_port()
    env = {**os.environ, "PYTHONPATH": HERE}
    for v in parallel.LAUNCH_ENV:
        env.pop(v, None)
    procs = []
    t0 = time.perf_counter()
    for r in range(2):
        spec = os.path.join(out_dir, f"spec{r}.json")
        with open(spec, "w") as f:
            json.dump(dict(rank=r, world=2, port=port, out=out_dir,
                           jobs=jobs), f)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(HERE, "chip_smoke.py"),
             "--mesh-worker", spec], cwd=HERE, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=MESH_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for r, (p, text) in enumerate(zip(procs, outs)):
        for line in text.splitlines():
            if line.startswith("mesh rank") or line.startswith(">> device"):
                log(line)
        check(p.returncode == 0, f"mesh rank {r} exited {p.returncode}:\n"
              f"{text[-4000:]}")
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                        map_location=device, weights_only=False)
             for r in range(2)]
    r0 = ranks[0]
    check(tuple(r0["layout"]) == (1, 2), f"layout {r0['layout']}")
    launches, record = {}, dict(ranks=2, backend="gloo", card="one, shared",
                                wall_s=wall, n_rays=MESH_RAYS,
                                steps=MESH_STEPS)

    def summed(job):
        return {k: sum(rk[job]["launches"][k] for rk in ranks)
                for k in r0[job]["launches"]}

    # (a) the width-sharded steps against the one-process plain steps
    for mode in ("image", "global"):
        res, want = r0[f"tp_train_{mode}"]["res"], plain[mode]
        rel = abs(res["loss"][0] - want["loss"][0]) / abs(want["loss"][0])
        tp_ms = [t * 1e3 for t in res["step_s"]]
        pl_ms = [t * 1e3 for t in want["step_s"]]
        la = summed(f"tp_train_{mode}")
        log(f"mesh tp {mode}: {MESH_STEPS} steps at {MESH_RAYS} rays on 2 "
            f"ranks (1 data x 2 model, gloo, one card): losses {res['loss']}"
            f" vs one process (plain route) {want['loss']}: step 1 rel "
            f"{rel:.2e} (limit 1e-5); step ms (CUDA events) "
            f"{['%.1f' % t for t in tp_ms]} vs one process "
            f"{['%.1f' % t for t in pl_ms]}; launches {la}")
        check(rel <= 1e-5, f"TP {mode} step 1 loss {res['loss'][0]} vs "
              f"{want['loss'][0]}")
        only_launched(la, {}, f"TP training ({mode})")
        launches[f"mesh_tp_train_{mode}"] = la
        record[f"tp_train_{mode}"] = dict(
            loss=res["loss"], plain_loss=want["loss"], step1_rel=rel,
            step_ms=tp_ms, plain_step_ms=pl_ms, launches=la)

    # (b) TP rendering: K3 and K1 on the gathered weights
    cfg = load_config(eval_args)
    la = summed("tp_eval")
    only_launched({k: v for k, v in la.items() if k not in (
        "fused_mlp_sigma_rays", "fused_mlp_eval_rays")}, {},
        "TP --eval_only")
    check(la["fused_mlp_sigma_rays"] > 0 and la["fused_mlp_eval_rays"] > 0,
          f"TP --eval_only launches {la}")
    model = driver.load_model(cfg, MESH_STEPS, device)
    packed = pack_nerf(model, cfg, device=device)
    _, (K, ext), (H, W), i_split = load_blender(data_root, cfg.bkg_white,
                                                cfg.downsample, cfg.testskip)
    pose = torch.as_tensor(ext[i_split[2][0]][:3, :4])
    one = make_frame_renderer(dataclasses.replace(cfg, render_cull="none"),
                              H, W, K, device)(packed, pose, torch.Generator(
                                  device).manual_seed(cfg.seed + MESH_STEPS))
    tp_err = max(float((a - b).abs().max()) for a, b in zip(r0["tp_frame"],
                                                            one))
    tp_res = r0["tp_eval"]["res"]
    log(f"mesh tp eval: --eval_only --n_model_shards 2, one {H}x{W} view: "
        f"PSNR {tp_res['psnr']}, frame ms (CUDA events, rank 0) "
        f"{['%.1f' % (t * 1e3) for t in tp_res['frame_s']]}; the frame vs "
        f"one process max abs {tp_err:.3e} (limit 1e-5); launches {la}")
    check(tp_err <= 1e-5, f"TP frame vs one process: {tp_err}")
    launches["mesh_tp_eval"] = la
    record["tp_eval"] = dict(psnr=tp_res["psnr"], frame_ms=[
        t * 1e3 for t in tp_res["frame_s"]], max_abs_vs_one=tp_err,
        launches=la)

    # (c) the sample-sharded frame: K8 alone, against the dense frame
    la = summed("sp_eval")
    only_launched({k: v for k, v in la.items() if k not in (
        "fused_mlp_eval", "fused_mlp_eval_f32")}, {}, "SP --eval_only")
    check(la["fused_mlp_eval"] > 0, f"SP --eval_only launches {la}")
    sp_cfg = dataclasses.replace(load_config(eval_args + ["--sp_shards",
                                                          "2"]),
                                 perturb=0.0, render_cull="none")
    dense = make_frame_renderer(dataclasses.replace(sp_cfg, sp_shards=0,
                                                    n_model_shards=1),
                                H, W, K, device)(packed, pose, torch.Generator(
                                    device).manual_seed(cfg.seed))
    sp_psnr = psnr(r0["sp_frame"][0], dense[0])
    sp_res = r0["sp_eval"]["res"]
    k8 = r0["k8_sp"]
    log(f"mesh sp eval: --eval_only --sp_shards 2 --n_model_shards 2, one "
        f"{H}x{W} view: PSNR {sp_res['psnr']}, frame ms (CUDA events, rank "
        f"0) {['%.1f' % (t * 1e3) for t in sp_res['frame_s']]}; launches "
        f"{la}; at perturb 0 vs the dense kernel frame {sp_psnr:.2f} dB "
        f"(min {FRAME_PSNR_MIN}), frame ms {r0['sp_frame_ms']} (rank 0, "
        f"recorded then not), K8 {r0['sp_frame_k8']} launches a rank a "
        f"frame")
    check(sp_psnr >= FRAME_PSNR_MIN, f"SP frame vs dense {sp_psnr} dB")
    launches["mesh_sp_eval"] = la
    record["sp_eval"] = dict(
        psnr=sp_res["psnr"], frame_ms=[t * 1e3 for t in sp_res["frame_s"]],
        perturb0_psnr_vs_dense=sp_psnr, perturb0_frame_ms=r0["sp_frame_ms"],
        k8_launches_a_rank_a_frame=r0["sp_frame_k8"], k8=k8, launches=la)
    return launches, record


class _PlainPoints(torch.autograd.Function):
    """The plane pair's plain versions (K8's forward, K9's backward) as one
    autograd pair, for the fit's gradients on the card without the
    kernels."""

    @staticmethod
    def forward(ctx, w, b, xplane, dplane, L_x, L_d, weight_dtype):
        from nerf_pytorch_paeng_tpu_torch.kernels import fused_mlp as fm
        packed = fm._with_views(w.to(weight_dtype), b)
        ctx.save_for_backward(packed["w"], b, xplane, dplane)
        ctx.encodings = (L_x, L_d)
        return fm.fused_mlp_eval_plain(xplane, dplane, packed, L_x, L_d,
                                       out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, gout):
        from nerf_pytorch_paeng_tpu_torch.kernels import fused_mlp as fm
        from nerf_pytorch_paeng_tpu_torch.kernels import fused_mlp_vjp as fv
        w, b, xplane, dplane = ctx.saved_tensors
        dw, db = fv.fused_mlp_bwd_plain(xplane, dplane,
                                        gout.float().contiguous(),
                                        fm._with_views(w, b), *ctx.encodings)
        return dw, db, None, None, None, None, None


def fit_grads(model, pts, dirs, blob: dict, train_fn=None) -> dict:
    """The gradients of one fit step's loss (``blob_fit_loss`` through
    ``blob_fit_fields``) at ``model``'s weights, by parameter name."""
    from nerf_pytorch_paeng_tpu_torch.utils.synth import (blob_fit_fields,
                                                          blob_fit_loss)
    model.zero_grad(set_to_none=True)
    fields = blob_fit_fields(model, train_fn=train_fn)
    blob_fit_loss(fields, pts, dirs, **blob).backward()
    return {k: p.grad.detach().clone() for k, p in model.named_parameters()}


def fit_grad_check(model, draws, blob: dict, device) -> dict:
    """The first fit step's gradients through K8/K9 against the plain pair
    on the card, same weights and draws, each parameter within
    ``GRAD_TOL`` (the floor: the plain pair on the card against the same
    on the CPU)."""
    import copy

    from nerf_pytorch_paeng_tpu_torch.utils.synth import orbit_ray_points
    pts, dirs = orbit_ray_points(draws, FIT_UNIFORM_FRAC)
    got = fit_grads(model, pts, dirs, blob)
    want = fit_grads(model, pts, dirs, blob, train_fn=_PlainPoints.apply)
    cpu = copy.deepcopy(model).cpu()
    other = fit_grads(cpu, pts.cpu(), dirs.cpu(), blob)   # plain on the CPU
    worst, worst_cos = (0.0, 1.0, None), 1.0
    for k in want:
        a, b, c = (x[k].double().cpu().flatten() for x in (got, want, other))
        rel = float((a - b).norm() / b.norm())
        limit = max(GRAD_TOL["rel_l2"],
                    GRAD_TOL["floor_factor"] * float((c - b).norm()
                                                     / b.norm()))
        cos = float(a @ b / (a.norm() * b.norm()))
        check(rel <= limit and cos >= GRAD_TOL["cos"],
              f"fit gradients: {k} through K8/K9 {rel} > {limit} or cos "
              f"{cos} against the plain pair")
        if rel / limit > worst[0] / worst[1]:
            worst = (rel, limit, k)
        worst_cos = min(worst_cos, cos)
    model.zero_grad(set_to_none=True)
    return dict(worst_rel=worst[0], worst_limit=worst[1], worst_at=worst[2],
                min_cos=worst_cos, points=int(pts.shape[0]))


def grid_stragglers(fm, packed_module, cfg, device, cutoff: float) -> dict:
    """K7 on the support grid: occupied cells, those in the cube's two
    outer layers (which make the bounds invalid) and the largest density
    logit beyond ``cutoff + 0.6`` (the far field the polish sweeps)."""
    from nerf_pytorch_paeng_tpu_torch.eval.frame import _precull_half
    from nerf_pytorch_paeng_tpu_torch.ops.occupancy import grid_points
    g, half = SUPPORT_GRID, _precull_half(cfg)
    x = grid_points(half, g, device)
    sig = fm.fused_mlp_sigma(x, packed_module, L_x=cfg.L_x,
                             out_dtype=torch.bfloat16).float()
    occ = (sig > 0).reshape(g, g, g)
    inner = torch.zeros_like(occ)
    inner[2:-2, 2:-2, 2:-2] = True
    far = torch.linalg.norm(x, dim=0) > cutoff + 0.6
    return dict(occupied=int(occ.sum()), outer=int((occ & ~inner).sum()),
                far_max_raw=float(sig[far].max()))


def distilled_phase(fm, fv, device) -> tuple:
    """Phase 16: the JAX bench's three distilled scenes at lego's width
    (``utils/synth.fit_field_to_blob`` through K8/K9, 2 K8 + 2 K9 launches
    a step, the first step's gradients against the plain pair within
    ``GRAD_TOL``), K8/K9 against their plain versions at the fit's two
    shapes, the support grids' validity and stragglers (K7), the culled
    and dense 800x800 frames of pose 0 (``perturb 0``, CUDA events, median
    of 3 after a warm-up), and on the hard and std scenes
    ``DISTILLED_STEPS`` gated and ungated train steps on 4096 pixel rays of
    that pose (median of steps 17-60).  Each returned field is gated
    (``gate``): the loss the fit returns below ``FIT_LOSS_MAX``, its
    weights' polish-phase loss on fresh draws below the same, its dense
    frame at least ``DENSE_VS_BLOB_PSNR_MIN`` against the blob, the culled
    frame ``CULLED_VS_DENSE_PSNR_MIN`` from the dense one and at most
    ``CULLED_VS_BLOB_LOSS_MAX`` further from the blob.  Returns the
    paths' launches, the phase's record, K8/K9 at the fit's shapes and
    the fitted state dicts by scene."""
    import dataclasses

    from nerf_pytorch_paeng_tpu_torch.eval.frame import (_support_for_eval,
                                                         make_frame_renderer)
    from nerf_pytorch_paeng_tpu_torch.models.nerf import NeRF, init_nerf
    from nerf_pytorch_paeng_tpu_torch.ops.rays import get_rays
    from nerf_pytorch_paeng_tpu_torch.train.precull import \
        make_train_support_program
    from nerf_pytorch_paeng_tpu_torch.utils.synth import (fit_field_to_blob,
                                                          orbit_draws,
                                                          polish_steps)

    cfg, H, W, K, pose = distilled_frame_setup(device)
    renderers = {
        label: make_frame_renderer(c, H, W, K, device, stratified=False)
        for label, c in (("culled", cfg), ("dense", dataclasses.replace(
            cfg, render_cull="none")))}
    ro, rd = get_rays(H, W, K, pose)
    g = torch.Generator(device).manual_seed(0)
    pick = torch.randperm(H * W, generator=g, device=device)[:TRAIN_RAYS]
    ro, rd = ro.reshape(-1, 3)[pick], rd.reshape(-1, 3)[pick]
    target = torch.rand((TRAIN_RAYS, 3), generator=g, device=device)
    launches, out, fields = {}, {}, {}
    for name, kw in DISTILLED_SCENES:
        blob = {k: v for k, v in kw.items() if k != "n_steps"}
        model0 = init_nerf(cfg, seed=0, device=device)
        first = orbit_draws(FIT_PTS, FIT_UNIFORM_FRAC, torch.Generator(
            device).manual_seed(1), device)
        grads = fit_grad_check(model0, first, blob, device)
        zero_launches()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        sd, loss = fit_field_to_blob(
            model0, n_pts=FIT_PTS, uniform_frac=FIT_UNIFORM_FRAC,
            generator=torch.Generator(device).manual_seed(1), **kw)
        torch.cuda.synchronize(device)
        fit_s = time.perf_counter() - t0
        launches[f"distilled_fit_{name}"] = fit_l = read_launches()
        steps = kw["n_steps"] + polish_steps(kw["n_steps"])
        check(fit_l["fused_mlp_eval"] == fit_l["fused_mlp_bwd"] == 2 * steps,
              f"distilled {name}: K8 {fit_l['fused_mlp_eval']}, K9 "
              f"{fit_l['fused_mlp_bwd']} launches for {steps} fit steps")
        check(sum(fit_l.values()) - fit_l["fused_mlp_eval_f32"]
              - fit_l["fused_mlp_eval"] - fit_l["fused_mlp_bwd"] == 0,
              f"distilled {name}: another kernel launched in the fit")
        fields[name] = sd
        model = NeRF().to(device)
        model.load_state_dict(sd)
        held = held_out_losses(model, blob, device)
        packed = fm.pack_nerf(model, cfg, device=device)
        grid = {}
        for module in ("coarse", "fine"):
            bounds, valid = _support_for_eval(packed[module], cfg, device)
            grid[module] = dict(valid=valid, lo=bounds[0].tolist(),
                                hi=bounds[1].tolist(),
                                radius=float(bounds[2][0]),
                                **grid_stragglers(fm, packed[module], cfg,
                                                  device, blob["blob_cutoff"]))
        frames, times = {}, {}
        for label, render in renderers.items():
            zero_launches()
            times[label], frames[label] = cuda_ms(
                lambda: render(packed, pose), reps=3)
            launches[f"distilled_frame_{label}_{name}"] = read_launches()
        if name == DISTILLED_SCENES[0][0]:
            launches["distilled_render_frame"], rf_ms, p_rf = \
                render_frame_check(cfg, packed, pose, K, frames["dense"][0],
                                   device)
        st = renderers["culled"].stats[-1]
        p_dense = psnr(frames["culled"][0], frames["dense"][0])
        gt = blob_frame(blob, H, W, K, pose, device)
        p_gt, p_culled_gt = (psnr(frames[k][0], gt)
                             for k in ("dense", "culled"))
        rec = dict(
            fit_s=fit_s, fit_steps=steps, fit_step_ms=1e3 * fit_s / steps,
            fit_loss=loss, held_out_main=held["main"],
            held_out_polish=held["polish"],
            dense_vs_blob_psnr=p_gt, culled_vs_blob_psnr=p_culled_gt,
            fit_launches={k: v for k, v in fit_l.items() if v},
            grads=grads, grid=grid, frame_ms=times,
            culled_vs_dense_psnr=p_dense,
            active_share=st["n_act"] / (H * W), blocks=st["blocks"],
            trunc_share=st["n_trunc"] / max(st["n_act"], 1),
            trunc_blocks=st["trunc_blocks"],
            gate_frac_coarse=(None if st["gate_frac_coarse"] is None
                              else float(st["gate_frac_coarse"])),
            gate_frac_fine=(None if st["gate_frac_fine"] is None
                            else float(st["gate_frac_fine"])))
        if name in DISTILLED_GATED:
            bc, bf = make_train_support_program(cfg)[0](model)
            valid = bool(bc[3][0]) and bool(bf[3][0])
            rec["gated_bounds_valid"] = valid
            for label, support in (("gated", (bc, bf)), ("ungated", None)):
                steps_ms, gf, lw = distilled_steps(
                    cfg, model, ro, rd, target, support, device)
                launches[f"distilled_{label}_{name}"] = lw
                rec[f"{label}_step_ms"] = statistics.median(
                    steps_ms[DISTILLED_MEDIAN_FROM - 1:])
                if gf is not None:
                    rec["gate_frac"] = gf
        log(f"distilled [{name}]: fit {fit_s:.2f} s, {steps} steps, "
            f"{rec['fit_step_ms']:.3f} ms a step, returned loss {loss:.4f} "
            f"(max {FIT_LOSS_MAX}); the returned weights on fresh draws: "
            f"main-phase loss {held['main']:.4f}, polish-phase loss "
            f"{held['polish']:.4f} (max {FIT_LOSS_MAX}); against its "
            f"blob: dense frame {p_gt:.2f} dB (min "
            f"{DENSE_VS_BLOB_PSNR_MIN}), culled {p_culled_gt:.2f} dB; "
            f"launches {rec['fit_launches']}; first-step "
            f"gradients vs plain pair: worst {grads['worst_at']} "
            f"{grads['worst_rel']:.2e} (limit {grads['worst_limit']:.2e}), "
            f"min cos {grads['min_cos']:.6f}; grids "
            f"{ {m: (v['valid'], v['occupied'], v['outer'], round(v['far_max_raw'], 4)) for m, v in grid.items()} } "
            f"(valid, occupied, outer-layer, far-field max raw); frames ms "
            f"culled {times['culled']:.1f} dense {times['dense']:.1f}, "
            f"{p_dense:.2f} dB (min {CULLED_VS_DENSE_PSNR_MIN}); active "
            f"{rec['active_share']:.3f}, blocks "
            f"{rec['blocks']}, truncated {rec['trunc_share']:.3f} of active "
            f"({rec['trunc_blocks']} blocks), skipped coarse "
            f"{rec['gate_frac_coarse']} fine {rec['gate_frac_fine']}" + (
                f"; steps gated {rec['gated_step_ms']:.2f} ms (gate_frac "
                f"{rec.get('gate_frac')}, bounds valid "
                f"{rec['gated_bounds_valid']}) ungated "
                f"{rec['ungated_step_ms']:.2f} ms"
                if name in DISTILLED_GATED else ""))
        # the returned field: the loss the fit returns, that of its
        # weights on fresh draws, the blob its dense frame renders; the
        # culled frame against the dense one and against the blob
        gate(loss < FIT_LOSS_MAX, f"distilled {name}: the fit returned "
             f"loss {loss}")
        gate(held["polish"] < FIT_LOSS_MAX, f"distilled {name}: the "
             f"returned weights' polish-phase loss {held['polish']}")
        gate(p_gt >= DENSE_VS_BLOB_PSNR_MIN, f"distilled {name}: the "
             f"dense frame {p_gt} dB against its blob")
        gate(p_culled_gt >= p_gt - CULLED_VS_BLOB_LOSS_MAX[name],
             f"distilled {name}: the culled frame {p_culled_gt} dB against "
             f"its blob, the dense one {p_gt} dB")
        gate(p_dense >= CULLED_VS_DENSE_PSNR_MIN,
             f"distilled {name}: culled vs dense {p_dense} dB")
        if name == DISTILLED_SCENES[0][0]:
            rec.update(render_frame_ms=rf_ms, render_frame_vs_dense_psnr=p_rf)
            log(f"distilled [{name}]: ops.render_frame of the frame's rays "
                f"through K7 + K8 ({-(-H * W // BLOCK)} blocks): "
                f"{rf_ms:.1f} ms, {p_rf:.2f} dB against the dense ray-kernel "
                f"frame (min {FRAME_PSNR_MIN})")
        out[name] = rec
        del model0, model, packed, frames
    # after the fits, so that the plain versions' runs (the CPU's too) do
    # not share the host with a timed fit
    fit_shapes = fit_kernel_times(
        fm, fv, init_nerf(cfg, seed=0, device=device),
        orbit_draws(FIT_PTS, FIT_UNIFORM_FRAC,
                    torch.Generator(device).manual_seed(1), device), device)
    return launches, out, fit_shapes, fields


def distilled_frame_setup(device) -> tuple:
    """The distilled scenes' frame: lego's config at ``perturb 0``, pose 0
    of ``make_synth_scene``'s orbit at ``DISTILLED_HW`` square and focal
    0.9 W -> (cfg, H, W, K, pose)."""
    from nerf_pytorch_paeng_tpu_torch.config import config_from_file
    from nerf_pytorch_paeng_tpu_torch.utils.synth import make_synth_scene
    cfg = config_from_file(os.path.join(HERE, "configs/blender/lego.txt"),
                           device="cuda", perturb=0.0)
    H = W = DISTILLED_HW
    K = np.array([[0.9 * W, 0, W / 2], [0, 0.9 * W, H / 2], [0, 0, 1]],
                 np.float32)
    pose = torch.as_tensor(make_synth_scene(n_views=1, H=8, W=8)[2][0][:3, :4],
                           device=device)
    return cfg, H, W, K, pose


def held_out_losses(model, blob: dict, device) -> dict:
    """The distillation loss of fitted weights (``model``) on
    ``HELD_OUT_DRAWS`` fresh draws of each phase (a generator seeded 2;
    the fit's is seeded 1), through the fit's own fields: the main
    phase's objective at its ray and uniform points, the polish phase's at
    its sweep -> their means."""
    from nerf_pytorch_paeng_tpu_torch.utils.synth import (
        blob_fit_fields, blob_fit_loss, orbit_draws, orbit_ray_points,
        polish_draws, polish_points)
    g = torch.Generator(device).manual_seed(2)
    fields = blob_fit_fields(model)
    out = {"main": 0.0, "polish": 0.0}
    with torch.no_grad():
        for _ in range(HELD_OUT_DRAWS):
            pts, dirs = orbit_ray_points(orbit_draws(
                FIT_PTS, FIT_UNIFORM_FRAC, g, device), FIT_UNIFORM_FRAC)
            out["main"] += float(blob_fit_loss(fields, pts, dirs, **blob))
            pts, dirs = polish_points(polish_draws(FIT_PTS, g, device),
                                      blob["blob_cutoff"])
            out["polish"] += float(blob_fit_loss(fields, pts, dirs,
                                                 polish=True, **blob))
    return {k: v / HELD_OUT_DRAWS for k, v in out.items()}


def render_frame_check(cfg, packed, pose, K, dense, device) -> tuple:
    """``ops.render_frame`` of one frame's rays in ``BLOCK``-ray blocks on
    the plane kernels (K7 for the coarse density, K8 for the field: one
    launch of each a block), timed once with CUDA events -> (its launches,
    ms, PSNR against the dense ray-kernel frame ``dense``, at least
    ``FRAME_PSNR_MIN``)."""
    from nerf_pytorch_paeng_tpu_torch.ops.rays import get_rays
    from nerf_pytorch_paeng_tpu_torch.ops.render import (make_field_fns,
                                                         make_sigma_fn,
                                                         render_frame)
    H, W = dense.shape[:2]
    ro, rd = (t.reshape(-1, 3).contiguous() for t in get_rays(H, W, K, pose))
    fields = make_field_fns(packed["coarse"], packed["fine"], cfg)
    sigma = make_sigma_fn(packed["coarse"], cfg)
    zero_launches()
    with torch.no_grad():
        ms, out = cuda_ms(lambda: render_frame(
            *fields, ro, rd, cfg, block_rays=BLOCK, stratified=False,
            coarse_sigma_fn=sigma), reps=1, warmup=0)
    got = read_launches()
    blocks = -(-H * W // BLOCK)
    others = {k: v for k, v in got.items() if v and k not in (
        "fused_mlp_sigma", "fused_mlp_eval", "fused_mlp_eval_f32")}
    check(got["fused_mlp_sigma"] == got["fused_mlp_eval"] == blocks
          and not others,
          f"render_frame launches {got}, not K7 and K8 once a block")
    p = psnr(out.rgb_f.reshape(H, W, 3), dense)
    check(p >= FRAME_PSNR_MIN, f"render_frame vs the dense frame {p} dB")
    return got, ms, p


def blob_frame(blob: dict, H: int, W: int, K, pose, device) -> torch.Tensor:
    """The frame of the blob a scene was distilled from (``blob_field``'s
    density and colour, ``GT_SAMPLES`` even depths in [2, 6] a ray,
    composited as the renderer composites) -> [H, W, 3]."""
    from nerf_pytorch_paeng_tpu_torch.ops.rays import get_rays
    from nerf_pytorch_paeng_tpu_torch.ops.volume import volume_render
    from nerf_pytorch_paeng_tpu_torch.utils.synth import blob_field
    ro, rd = (t.reshape(-1, 3) for t in get_rays(H, W, K, pose))
    z = torch.linspace(2.0, 6.0, GT_SAMPLES, device=device)
    out = []
    for i in range(0, ro.shape[0], 16384):
        o, d = ro[i:i + 16384], rd[i:i + 16384]
        zz = z.expand(o.shape[0], GT_SAMPLES)
        sig, raw_col = blob_field(o[:, None] + d[:, None] * zz[..., None],
                                  **blob)
        out.append(volume_render(torch.cat([raw_col, sig[..., None]], -1),
                                 zz, d).rgb)
    return torch.cat(out).reshape(H, W, 3)


def distilled_steps(cfg, model, ro, rd, target, support, device) -> tuple:
    """``DISTILLED_STEPS`` global-batch steps from ``model``'s weights on
    one batch (``support``: gated), each timed by CUDA events -> (ms a
    step, the last step's ``gate_frac`` or None, the launches)."""
    import copy

    from nerf_pytorch_paeng_tpu_torch.train import TrainState, make_optimizer
    from nerf_pytorch_paeng_tpu_torch.train.schedule import schedule_from_cfg
    from nerf_pytorch_paeng_tpu_torch.train.step import make_train_step
    m = copy.deepcopy(model)
    state = TrainState(m, make_optimizer(m, cfg), 0)
    step = make_train_step(cfg, schedule_from_cfg(cfg))
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(DISTILLED_STEPS + 1)]
    zero_launches()
    events[0].record()
    for i in range(DISTILLED_STEPS):
        metrics = step(state, ro, rd, target, support=support)
        events[i + 1].record()
    torch.cuda.synchronize(device)
    ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    check(math.isfinite(float(metrics["loss"])), "distilled step: loss")
    gf = metrics.get("gate_frac")
    return ms, None if gf is None else float(gf), read_launches()


def fit_kernel_times(fm, fv, model, draws, device) -> list:
    """K8 (float32 out) and K9 at the fit's two shapes (the main phase's
    ray and uniform points, the polish phase's sweep), the coarse module's
    packed weights, loss-like cotangents: each held against its plain
    version on the same inputs (K8 within ``KERNEL_TOL``, ``k8_check``; K9
    within ``GRAD_TOL``, ``k9_check``) and timed with CUDA events beside
    the plain version and the bound."""
    from nerf_pytorch_paeng_tpu_torch.utils.synth import (orbit_ray_points,
                                                          polish_draws,
                                                          polish_points)
    packed = fm.pack_nerf_mlp_params(model.model_coarse, device=device)
    rows = []
    sets = (("main", orbit_ray_points(draws, FIT_UNIFORM_FRAC)),
            ("polish", polish_points(polish_draws(
                FIT_PTS, torch.Generator(device).manual_seed(2), device))))
    for what, (pts, dirs) in sets:
        x, d = pts.T.contiguous(), dirs.T.contiguous()
        p = x.shape[1]
        k8_max_abs, k8_rel, k8_ms, k8_plain_ms = k8_check(
            fm, x, d, packed, torch.float32, f"at the fit's {what} points",
            reps=20)
        g4 = plane_cotangents(fm.fused_mlp_eval_plain(
            x, d, packed, out_dtype=torch.float32), 3, device)
        (k9_rel, k9_limit, k9_at), k9_cos, k9_max_abs, k9_plain_ms = \
            k9_check(fm, fv, x, d, g4, packed, f"at the fit's {what} points")
        k9_ms, _ = cuda_ms(lambda: fv.fused_mlp_bwd(x, d, g4, packed),
                           reps=20)
        # the planes, the output or cotangents, the weights (K9: the
        # float32 gradients written), as plane_kernel_phase counts them
        wbytes = packed["w"].numel() * 2 + packed["b"].numel() * 4
        k8_b, k8_by = bound(p * fm.eval_flop_per_point(),
                            p * (24 + 16) + wbytes)
        k9_b, k9_by = bound(p * fm.bwd_flop_per_point(),
                            p * (24 + 16) + wbytes
                            + (fm.W_TOTAL + fm.B_TOTAL) * 4)
        rows.append(dict(phase=what, points=p, k8_ms=k8_ms,
                         k8_plain_ms=k8_plain_ms, k8_bound_ms=k8_b,
                         k8_bound_by=k8_by, k8_max_abs=k8_max_abs,
                         k8_rel_l2=k8_rel, k9_ms=k9_ms,
                         k9_plain_ms=k9_plain_ms, k9_bound_ms=k9_b,
                         k9_bound_by=k9_by, k9_max_abs=k9_max_abs,
                         k9_rel_l2=k9_rel, k9_limit=k9_limit,
                         k9_worst_at=k9_at, k9_cos=k9_cos))
        log(f"distilled fit shapes [{what}, {p} points]: K8 float32 "
            f"{k8_ms:.3f} ms (plain {k8_plain_ms:.3f}, bound {k8_b:.4f}; "
            f"max abs {k8_max_abs:.2e}, rel L2 {k8_rel:.2e}), K9 "
            f"{k9_ms:.3f} ms (plain {k9_plain_ms:.3f}, bound {k9_b:.4f}; "
            f"{k9_at} rel L2 {k9_rel:.2e} limit {k9_limit:.2e}, cos "
            f"{k9_cos:.6f})")
    return rows


DRYRUN_KERNELS = {      # the dry run's names -> this script's counters
    "K3": ("fused_mlp_sigma_rays",), "K4": ("fused_mlp_sigma_rays_gated",),
    "K1": ("fused_mlp_eval_rays",),
    "K5": ("fused_mlp_eval_rays_gated", "fused_mlp_eval_rays_gated_f32"),
    "K7": ("fused_mlp_sigma",), "K8": ("fused_mlp_eval", "fused_mlp_eval_f32"),
    "K2": ("fused_mlp_bwd_rays",), "K6": ("fused_mlp_bwd_rays_gated",),
    "K9": ("fused_mlp_bwd",)}


def dryrun_phase(device) -> tuple:
    """Phase 17: ``python -m nerf_pytorch_paeng_tpu_torch.dryrun 2`` on the
    card (both ranks on cuda:0 over gloo): six ``OK`` lines, and each
    phase's launches (both ranks summed) as the phase implies: none on the
    plain route (1, 5), K1 and K2 two a rank a step (2, 3), K7 once a rank
    then K4 and K5 (4), K5 and K6 (6).  Returns each phase's launches by
    counter name and the record."""
    n = DRYRUN_RANKS
    env = {**os.environ, "PYTHONPATH": HERE}
    for v in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(v, None)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "nerf_pytorch_paeng_tpu_torch.dryrun", str(n),
         "--device", "cuda", "--timeout", str(DRYRUN_TIMEOUT_S)],
        cwd=HERE, env=env, capture_output=True, text=True,
        timeout=DRYRUN_TIMEOUT_S + 60)
    wall = time.perf_counter() - t0
    log(proc.stdout[-6000:])
    check(proc.returncode == 0, f"dryrun exited {proc.returncode}: "
          f"{proc.stderr[-3000:]}")
    ok = [line for line in proc.stdout.splitlines()
          if line.startswith("dryrun OK (")]
    check(len(ok) == 6, f"dryrun printed {len(ok)} OK lines, not 6")
    report = json.loads(proc.stdout.strip().splitlines()[-1])["dryrun"]
    want = {"tp": {}, "dp": {"K1": 2 * n, "K2": 2 * n},
            "image": {"K1": 4 * n, "K2": 4 * n}, "sp": {}}
    paths = {}
    for rec in report:
        got = rec["launches"]
        name = rec["phase"]
        if name in want:
            check(got == want[name], f"dryrun {name}: launches {got}, want "
                  f"{want[name]}")
        elif name == "culled":
            check(got.get("K7") == n and got.get("K4", 0) >= 1
                  and got.get("K5", 0) >= 1 and set(got) <= {"K7", "K4", "K5"},
                  f"dryrun culled: launches {got}")
        else:
            check(got.get("K5", 0) >= 1 and got.get("K6", 0) >= 1
                  and set(got) <= {"K5", "K6"}, f"dryrun gated: {got}")
        counts = dict.fromkeys(launch_counters(), 0)
        for k, v in got.items():
            names = DRYRUN_KERNELS[k]
            # K5's and K8's rows share a counter: the gated step's K5 is
            # the float32 row, the frame's the bf16 one
            counts[names[-1] if name == "gated" else names[0]] += v
        paths[f"dryrun_{name}"] = counts
    log(f"dryrun: {n} ranks on the card over gloo, wall {wall:.1f} s")
    return paths, dict(ranks=n, wall_s=wall, ok=ok, report=report)


def phase0_phase(fm, fields: dict, device) -> tuple:
    """Phase 18: the culled renderer's phase 0 (``render_precull on`` off
    the ray kernels) on phase 16's distilled fields, pose 0 at 800x800,
    ``perturb 0``.  The plane route (64+100 samples, off the 8-sample
    rows): the dense renderer, the culled one with ``render_precull off``
    and with ``on``, CUDA events, median of 3 after a warm-up; the missed
    share from the coarse grid's bounds (K7, built before the counters are
    zeroed) against ``renderer.stats``; launches: K7 once for the grid and
    once a phase-1 block, K8 once a cover block, nothing else.  The plain
    route (``use_pallas false``, 64+128) on ``PHASE0_PLAIN_SCENES``: the
    culled renderer off and on, one frame each (on: a first frame that
    builds the grid, then the timed one), no launch.  Gates: on against
    off within ``PHASE0_RGB_MAX``/``PHASE0_DISP_MAX`` (plane) or
    ``PHASE0_PLAIN_PSNR_MIN`` (plain), the plane route's on frame
    ``CULLED_VS_DENSE_PSNR_MIN`` from the dense one, a missed share above
    0.  Returns the paths' launches and the phase's record."""
    import dataclasses

    from nerf_pytorch_paeng_tpu_torch.eval.frame import (
        _greedy_cover, _plane_fields, _precull_half, _support_bounds,
        make_frame_renderer)
    from nerf_pytorch_paeng_tpu_torch.models.nerf import NeRF
    from nerf_pytorch_paeng_tpu_torch.ops.occupancy import (ray_hits_bounds,
                                                            segment_in_cube)
    from nerf_pytorch_paeng_tpu_torch.ops.rays import get_rays

    cfg, H, W, K, pose = distilled_frame_setup(device)
    n_total = H * W
    plane = dataclasses.replace(cfg, N_samples_f=PLANE_FINE)
    plain = dataclasses.replace(cfg, use_pallas=False)
    configs = {"planes": {"dense": dataclasses.replace(plane,
                                                       render_cull="none"),
                          "off": dataclasses.replace(plane,
                                                     render_precull="off"),
                          "on": dataclasses.replace(plane,
                                                    render_precull="on")},
               "plain": {"off": dataclasses.replace(plain,
                                                    render_precull="off"),
                         "on": dataclasses.replace(plain,
                                                   render_precull="on")}}
    ro, rd = (t.reshape(-1, 3) for t in get_rays(H, W, K, pose))
    launches, out = {}, {}
    for name, sd in fields.items():
        model = NeRF().to(device)
        model.load_state_dict(sd)
        rec = {}
        for route, cfgs in configs.items():
            if route == "plain" and name not in PHASE0_PLAIN_SCENES:
                continue
            c0 = cfgs["on"]
            packed = fm.pack_nerf(model, c0, device=device)
            renderers = {label: make_frame_renderer(c, H, W, K, device,
                                                    stratified=False)
                         for label, c in cfgs.items()}
            check(all(r.route == route for r in renderers.values()),
                  f"phase0 {route}: the renderers took "
                  f"{[r.route for r in renderers.values()]}")
            # the missed share the coarse bounds give, outside the counts
            bounds, valid = _support_bounds(
                _plane_fields(packed, c0, route, fm.fused_mlp_eval,
                              fm.fused_mlp_sigma)[2], c0, device)
            hit = (ray_hits_bounds(ro, rd, *bounds, c0.near, c0.far)
                   | ~segment_in_cube(ro, rd, _precull_half(c0), c0.near,
                                      c0.far))
            n_hit = int(hit.sum())
            frames, times, stats, first_ms = {}, {}, {}, None
            for label, render in renderers.items():
                zero_launches()
                if route == "planes":
                    times[label], frames[label] = cuda_ms(
                        lambda: render(packed, pose), reps=3)
                else:
                    if label == "on":       # the frame that builds the grid
                        first_ms, _ = cuda_ms(lambda: render(packed, pose),
                                              reps=1, warmup=0)
                    times[label], frames[label] = cuda_ms(
                        lambda: render(packed, pose), reps=1, warmup=0)
                launches[f"phase0_{route}_{label}_{name}"] = got = \
                    read_launches()
                if hasattr(render, "stats"):
                    stats[label] = [
                        {k: (None if v is None else float(v))
                         for k, v in st.items()} for st in render.stats]
                k7, k8 = got["fused_mlp_sigma"], got["fused_mlp_eval"]
                others = {k: v for k, v in got.items() if v and k not in (
                    "fused_mlp_sigma", "fused_mlp_eval",
                    "fused_mlp_eval_f32")}
                frames_run = 4 if route == "planes" else (
                    2 if label == "on" else 1)
                if route == "plain":
                    check(not any(got.values()), f"phase0 plain {label} "
                          f"{name}: launches {got}")
                elif label == "dense":
                    per = -(-n_total // render.block)
                    check(k7 == k8 == frames_run * per and not others,
                          f"phase0 dense {name}: launches {got}")
                else:
                    k8_want = sum(st["blocks"] for st in render.stats)
                    p1 = (len(_greedy_cover(n_hit, render.sizes))
                          if label == "on" and valid else 1)
                    k7_want = frames_run * p1 + (label == "on")
                    check(k7 == k7_want and k8 == k8_want and not others,
                          f"phase0 {label} {name}: K7 {k7} (want {k7_want}),"
                          f" K8 {k8} (want {k8_want}), others {others}")
            on, off = frames["on"], frames["off"]
            missed = 1.0 - n_hit / n_total
            st_on = stats["on"][-1]
            diff = [(a - b).abs().reshape(n_total, -1).amax(-1)
                    for a, b in zip(on, off)]
            r = dict(valid=valid, missed_share=missed,
                     frame_ms=dict(times),
                     stats_on=st_on, stats_off=stats["off"][-1],
                     on_vs_off_rgb_max=float(diff[0].max()),
                     on_vs_off_disp_max=float(diff[1].max()),
                     on_vs_off_psnr=psnr(on[0], off[0]),
                     bit_equal=bool(torch.equal(on[0], off[0])
                                    and torch.equal(on[1], off[1])),
                     # where the frames differ: the hit or the missed rays
                     on_vs_off_rgb_max_hit=float(diff[0][hit].max()),
                     on_vs_off_rgb_max_missed=(
                         float(diff[0][~hit].max()) if n_hit < n_total
                         else 0.0),
                     launches={label: {k: v for k, v in launches[
                         f"phase0_{route}_{label}_{name}"].items() if v}
                         for label in renderers})
            if first_ms is not None:
                r["frame_ms"]["on_first_with_grid"] = first_ms
            if route == "planes":
                r["on_vs_dense_psnr"] = psnr(on[0], frames["dense"][0])
            rec[route] = r
            log(f"phase0 [{name}, {route}]: bounds valid {valid}, missed "
                f"share {missed:.4f} (stats {st_on['gate_frac_coarse']}), "
                f"frame ms {r['frame_ms']}, on vs off rgb max "
                f"{r['on_vs_off_rgb_max']:.3e} (hit rays "
                f"{r['on_vs_off_rgb_max_hit']:.3e}, missed "
                f"{r['on_vs_off_rgb_max_missed']:.3e}) disp max "
                f"{r['on_vs_off_disp_max']:.3e}, {r['on_vs_off_psnr']:.2f} "
                f"dB, bit-equal {r['bit_equal']}" + (
                    f", on vs dense {r['on_vs_dense_psnr']:.2f} dB"
                    if route == "planes" else "") +
                f"; stats on {st_on}; launches {r['launches']}")
            check(all(bool(torch.isfinite(t).all()) for t in on)
                  and on[0].shape == (H, W, 3), f"phase0 {route} {name}: "
                  "frame shape or finiteness")
            if valid:
                check(st_on["gate_frac_coarse"] is not None and abs(
                    st_on["gate_frac_coarse"] - missed) < 1e-6,
                    f"phase0 {route} {name}: stats "
                    f"{st_on['gate_frac_coarse']} against the bounds' "
                    f"missed share {missed}")
            gate(valid and missed > 0, f"phase0 {route} {name}: bounds "
                 f"valid {valid}, missed share {missed}")
            if route == "planes":
                gate(r["on_vs_off_rgb_max"] <= PHASE0_RGB_MAX
                     and r["on_vs_off_disp_max"] <= PHASE0_DISP_MAX,
                     f"phase0 planes {name}: on vs off rgb "
                     f"{r['on_vs_off_rgb_max']} disp "
                     f"{r['on_vs_off_disp_max']}")
                gate(r["on_vs_dense_psnr"] >= CULLED_VS_DENSE_PSNR_MIN,
                     f"phase0 planes {name}: on vs dense "
                     f"{r['on_vs_dense_psnr']} dB")
            else:
                gate(r["on_vs_off_psnr"] >= PHASE0_PLAIN_PSNR_MIN,
                     f"phase0 plain {name}: on vs off "
                     f"{r['on_vs_off_psnr']} dB")
            del packed, renderers, frames
        out[name] = rec
        del model
    return launches, out


def ptxas_lines(text: str) -> list:
    """(kernel, line) for every register and spill line of a ``-Xptxas -v``
    log, each under the entry function it reports on: the ``*_kernel``
    part of the mangled name, with its instantiation (``<true>`` or
    ``<false>``) where the kernel is a template over one bool."""
    import re
    out, kernel = [], "?"
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?(\S+?)'?(?: for|$)", line.strip())
        if m:
            k = re.findall(r"\d([a-z][a-z_]*_kernel)(?:ILb([01])E)?",
                           m.group(1))
            kernel = (k[-1][0] + {"1": "<true>", "0": "<false>"}.get(
                k[-1][1], "")) if k else m.group(1)
        elif "registers" in line or "spill" in line:
            out.append((kernel, line.split(":", 1)[-1].strip()))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--mesh-worker"]:
        return mesh_worker(sys.argv[2])
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

    laps = {}
    t_lap = [time.perf_counter()]

    def lap(name: str) -> None:
        """Seconds since the previous lap, by phase."""
        now = time.perf_counter()
        laps[name] = now - t_lap[0]
        t_lap[0] = now
        log(f"phase {name}: {laps[name]:.1f} s")

    if sys.argv[1:2] == ["--ngp"]:
        return ngp_main(device, card)
    t0 = time.perf_counter()
    sources = ("fused_mlp", "fused_mlp_vjp", "hash_grid", "ngp_march")
    libs = build.build_all(sources)
    log(f"build: {', '.join(s + '.cu' for s in sources)} in "
        f"{time.perf_counter() - t0:.1f} s (one nvcc each, in parallel)")
    for src, lib in zip(sources, libs):
        for kernel, line in ptxas_lines(lib.with_suffix(".log").read_text()):
            log(f"  ptxas {src} {kernel}: {line}")

    lap("build")
    cfg = NerfConfig()
    packed = fm.pack_nerf(init_nerf(cfg, seed=1, device=device), cfg,
                          device=device)
    rows = kernel_phase(fm, packed, cfg, device)
    rows["fused_mlp_bwd_rays"], train_shapes = train_kernel_phase(
        fm, fv, packed, cfg, device)
    rows["fused_mlp_eval_rays"]["train_f32"] = [
        dict(N=t["N"], S=t["S"], ms=t["k1_ms"], plain_ms=t["k1_plain_ms"],
             bound_ms=t["k1_bound_ms"], library_ms=t["k1_library_ms"],
             max_abs_err=t["k1_max_abs"]) for t in train_shapes]
    log("kernel fused_mlp_eval_rays at the training batch (float32 out): " +
        "; ".join(f"{t['N']} x {t['S']} ms={t['k1_ms']:.3f} "
                  f"bound_ms={t['k1_bound_ms']:.3f} products-only "
                  f"torch.mm {t['k1_library_ms']:.3f}" for t in train_shapes))
    gated_rows, gated_shapes = gated_train_kernel_phase(fm, fv, packed, cfg,
                                                        device)
    rows.update(gated_rows)
    rows.update(gated_kernel_phase(fm, packed, cfg, device))
    rows["fused_mlp_sigma"] = points_kernel_phase(fm, packed, cfg, device)
    plane_rows, plane_shapes = plane_kernel_phase(fm, fv, packed, cfg, device)
    rows.update(plane_rows)
    lap("kernels")

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        data_root = os.path.join(work, "lego_synth")
        t0 = time.perf_counter()
        save_as_blender_dataset(data_root, n_train=4, n_val=1, n_test=3,
                                H=800, W=800,
                                camera_angle_x=LEGO_CAMERA_ANGLE_X)
        log(f"synthetic 800x800 blender scene at lego's field of view written "
            f"({time.perf_counter() - t0:.1f} s)")
        lap("scene")
        eval_launches, stats = slice_phase(fm, work, data_root, device)
        lap("eval")
        render_launches, render_stats, path = render_phase(
            fm, packed, work, data_root, device)
        lap("render")
        train_launches, train_stats = train_phase(work, data_root, device)
        resume = resume_phase(work, data_root, device)
        dtype_check = compute_dtype_phase(work, data_root, device)
        lap("train")
        gated_launches, gated_stats = gated_train_phase(
            fm, fv, packed, work, data_root, device)
        lap("gated_train")
        plane_launches, n4000_launches, plane_stats = plane_train_phase(
            fm, fv, packed, work, data_root, device)
        plane_frame_launches, plane_frame_stats = plane_eval_phase(
            fm, work, data_root, device,
            {"eval": stats["frame_ms"], "render": render_stats["frame_ms"]})
        lap("plane")
        llff_launches, llff_stats = llff_phase(fm, fv, packed, work, device)
        lap("llff")
        chunk_launches, chunk_stats = chunk_phase(
            work, data_root, os.path.join(work, "fern_synth"), device)
        lap("chunks")
        plain_launches, plain_stats = plain_route_phase(
            fm, work, data_root, device,
            {"step_ms": train_stats["median_step_ms"],
             "frame_ms": stats["frame_ms"],
             "render_ms": render_stats["frame_ms"]})
        lap("plain_route")
        lpips_launches, lpips_stats = lpips_phase(work, data_root, device)
        lap("lpips")
        dp_launches, dp_stats = dp_phase(work, data_root, device)
        lap("data_parallel")
        mesh_launches, mesh_stats = mesh_phase(work, data_root, device)
        lap("mesh")
        distilled_launches, distilled_stats, fit_shapes, fields = \
            distilled_phase(fm, fv, device)
        lap("distilled")
        dryrun_launches, dryrun_stats = dryrun_phase(device)
        lap("dryrun")
        log(f"phases distilled + dryrun: {laps['distilled'] + laps['dryrun']:.1f}"
            " s (budget 120 s)")
        phase0_launches, phase0_stats = phase0_phase(fm, fields, device)
        lap("phase0")
        ngp_rows, ngp_stats = ngp_phase(work, device)
        lap("ngp")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # each path's own run, counters at 0 before it: K3 and K1 on the eval
    # path, K7, K4 and K5 (bf16 outputs) on the render path, K1, K2 and K7
    # on the training path, K5 (float32 outputs), K6 and K7 on the gated
    # training path, K8 (float32 outputs) and K9 on the two plane training
    # paths, K8 (bf16) and K7 on the plane eval and render paths, K1, K2
    # and K3 on the LLFF and custom paths.  K5's and K8's two rows share a
    # counter each: each row reads its own paths.
    paths = {"eval": eval_launches, "render": render_launches,
             "train": train_launches, "gated_train": gated_launches,
             "plane_train": plane_launches, "plane_train_n4000": n4000_launches,
             **{f"plane_{k}": v for k, v in plane_frame_launches.items()},
             **llff_launches, "eval_lpips": lpips_launches, **dp_launches,
             **mesh_launches,
             **{f"chunk_{k}": v for k, v in chunk_launches.items()},
             **distilled_launches, **dryrun_launches, **phase0_launches}

    def distilled(kind: str) -> tuple:
        return tuple(k for k in distilled_launches if k.startswith(kind))
    only = {"fused_mlp_eval_rays_gated": ("render", "dryrun_culled")
            + distilled("distilled_frame_culled"),
            "fused_mlp_eval_rays_gated_f32": ("gated_train", "dryrun_gated")
            + distilled("distilled_gated"),
            "fused_mlp_eval": tuple(f"plane_{k}" for k in plane_frame_launches)
            + ("mesh_sp_eval", "distilled_render_frame")
            + tuple(k for k in phase0_launches
                    if k.startswith("phase0_planes")),
            "fused_mlp_eval_f32": ("plane_train", "plane_train_n4000")
            + distilled("distilled_fit")}
    for name, row in rows.items():
        row["launches"] = sum(paths[p][name] for p in only.get(name, paths))
        check(row["launches"] > 0, f"{name} never launched on a main path")
        row["launches_llff_custom"] = sum(paths[p][name]
                                          for p in llff_launches)
        row["launches_chunked"] = sum(v[name]
                                      for v in chunk_launches.values())
        row["launches_plain_route"] = plain_launches[name]
        row["launches_dp"] = sum(v[name] for v in dp_launches.values())
        row["launches_mesh"] = sum(mesh_launches[p][name]
                                   for p in only.get(name, mesh_launches)
                                   if p in mesh_launches)
        for what, group in (("distilled", distilled_launches),
                            ("dryrun", dryrun_launches),
                            ("phase0", phase0_launches)):
            row[f"launches_{what}"] = sum(
                group[p][name] for p in only.get(name, group) if p in group)
    # K8 (float32) and K9 at the fit's own shapes (phase 16), each held
    # against its plain version there
    for name, key in (("fused_mlp_eval_f32", "k8"), ("fused_mlp_bwd", "k9")):
        rows[name]["fit_shapes"] = [
            dict(phase=f["phase"], points=f["points"], ms=f[f"{key}_ms"],
                 plain_ms=f[f"{key}_plain_ms"],
                 bound_ms=f[f"{key}_bound_ms"],
                 bound_by=f[f"{key}_bound_by"],
                 max_abs=f[f"{key}_max_abs"], rel_l2=f[f"{key}_rel_l2"])
            for f in fit_shapes]
        rows[name]["max_abs_err"] = max(
            rows[name]["max_abs_err"],
            *(f[f"{key}_max_abs"] for f in fit_shapes))
    # K8: its runs on one rank's sample-sharded planes of one frame block
    rows["fused_mlp_eval"]["sp_path"] = mesh_stats["sp_eval"]["k8"]
    rows["fused_mlp_eval"]["max_abs_err"] = max(
        rows["fused_mlp_eval"]["max_abs_err"],
        *(k["max_abs"] for k in mesh_stats["sp_eval"]["k8"]))
    # K1, K2 and K3: the worst of the kernel phase and the LLFF path's own
    # NDC inputs
    for where, recs in llff_stats["path_kernels"].items():
        for name, rs in recs.items():
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                            *(r["max_abs"] for r in rs))
            rows[name].setdefault("llff_path_shapes", []).extend(
                (where, r["N"], r["S"]) for r in rs)
    # K4 and K5: the worst of the kernel phase and the render path's inputs
    for name, (max_abs, shapes) in path.items():
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], max_abs)
        rows[name]["path_shapes"] = shapes
    # K5 (float32) and K6: the same with the gated training step's inputs
    for name, recs in gated_stats["path"].items():
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                        *(r["max_abs"] for r in recs))
        rows[name]["path_shapes"] = [(r["N"], r["S"], r["gate_on_share"])
                                     for r in recs]

    log(json.dumps({"slice": stats}))
    log(json.dumps({"render": {**render_stats, "launches": render_launches}}))
    log(json.dumps({"train": {**train_stats, "launches": train_launches,
                              "kernel_shapes": train_shapes,
                              "resume": resume,
                              "compute_dtype_float32": dtype_check}}))
    log(json.dumps({"gated_train": {**gated_stats,
                                    "launches": gated_launches,
                                    "kernel_shapes": gated_shapes}}))
    log(json.dumps({"plane_train": {**plane_stats, "launches": plane_launches,
                                    "launches_n4000": n4000_launches,
                                    "kernel_shapes": plane_shapes}}))
    log(json.dumps({"plane_frames": {
        **plane_frame_stats, "launches": plane_frame_launches}}))
    log(json.dumps({"llff": {**llff_stats, "launches": llff_launches}}))
    log(json.dumps({"chunks": chunk_stats}))
    log(json.dumps({"plain_route": {**plain_stats,
                                    "launches": plain_launches}}))
    log(json.dumps({"lpips": {**lpips_stats, "launches": lpips_launches}}))
    log(json.dumps({"data_parallel": dp_stats}))
    log(json.dumps({"mesh": mesh_stats}))
    log(json.dumps({"distilled": distilled_stats}))
    log(json.dumps({"dryrun": dryrun_stats}))
    log(json.dumps({"phase0": phase0_stats}))
    log(json.dumps({"ngp": ngp_stats}))
    log(json.dumps({"phase_s": laps}))
    rows.update(ngp_rows)           # their launches from the NGP path
    log(json.dumps({"kernels": list(rows.values())}))
    if FAILED_GATES:
        log(json.dumps({"failed_gates": FAILED_GATES}))
        log(card)
        return 1
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def ngp_main(device, card: str) -> int:
    """``--ngp``: the NGP kernels' build and phase alone."""
    from nerf_pytorch_paeng_tpu_torch.kernels import build
    t0 = time.perf_counter()
    sources = ("hash_grid", "ngp_march")
    libs = build.build_all(sources)
    log(f"build: {', '.join(s + '.cu' for s in sources)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for src, lib in zip(sources, libs):
        for kernel, line in ptxas_lines(lib.with_suffix(".log").read_text()):
            log(f"  ptxas {src} {kernel}: {line}")
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        rows, stats = ngp_phase(work, device)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(json.dumps({"ngp": stats}))
    log(json.dumps({"kernels": list(rows.values())}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
