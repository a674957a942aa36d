"""One rank of a data-parallel job for tests/test_torch_parallel.py.

    RANK=r WORLD_SIZE=w LOCAL_RANK=r MASTER_ADDR=localhost MASTER_PORT=p \\
        python tests/torch_dist_worker.py <inputs.pt> <out_dir> <job> ...

The launch contract's variables make the process group (gloo, CPU)
through ``parallel.maybe_initialize_distributed``; each job named on the
command line runs on the inputs the test wrote (``torch.save`` of a dict
of tensors) and the rank's results go to ``<out_dir>/rank<r>.pt``.  It
imports torch and the port only, so it starts without JAX.
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch

from nerf_pytorch_paeng_tpu_torch import parallel
from nerf_pytorch_paeng_tpu_torch.config import NerfConfig
from nerf_pytorch_paeng_tpu_torch.eval.frame import make_frame_renderer
from nerf_pytorch_paeng_tpu_torch.kernels.fused_mlp import pack_nerf
from nerf_pytorch_paeng_tpu_torch.models.nerf import NeRF
from nerf_pytorch_paeng_tpu_torch.train import (RayPool, TrainState,
                                                build_ray_pool,
                                                make_optimizer)
from nerf_pytorch_paeng_tpu_torch.train.schedule import schedule_from_cfg
from nerf_pytorch_paeng_tpu_torch.train.step import (make_image_train_step,
                                                     make_train_step)
from nerf_pytorch_paeng_tpu_torch.utils.synth import (
    compact_field_state_dict, make_synth_scene)

# the steps' settings (tests/test_torch_train_parity.py's, float32)
STEP_KW = dict(compute_dtype="float32", N_samples_c=8, N_samples_f=8,
               iter_N=10, iter_warmup=2, precrop_frac=0.5)
# the frames: the compact field of tests/test_torch_culled.py, 16x16
FRAME_HW = 16
FRAME_KW = dict(N_samples_c=16, N_samples_f=24, near=2.0, far=6.0,
                perturb=0.0, compute_dtype="float32", chunk_rays=16,
                render_precull_grid=48)


def step_cfg(n_rays: int) -> NerfConfig:
    return NerfConfig(device="cpu", N_rays=n_rays, **STEP_KW)


def frame_setup(render_cull: str):
    """(renderer, packed weights, pose): one view of the compact field of
    radius 1.0 at 16x16, 16-ray blocks (16 dense blocks a frame, two
    phase-2 cover blocks), a support grid of 48^3 so the pre-cull and
    gate-fine engage on the CPU."""
    _, K, poses = make_synth_scene(n_views=2, H=FRAME_HW, W=FRAME_HW)
    cfg = NerfConfig(device="cpu", render_cull=render_cull, **FRAME_KW)
    model = NeRF()
    model.load_state_dict(compact_field_state_dict(r=1.0, k=20.0))
    renderer = make_frame_renderer(cfg, FRAME_HW, FRAME_HW, K, "cpu")
    return renderer, pack_nerf(model, cfg), torch.from_numpy(poses[0])


def _state(inputs, cfg) -> TrainState:
    model = NeRF()
    model.load_state_dict(inputs["state_dict"])
    return TrainState(model, make_optimizer(model, cfg), 0)


def _steps(state, step, n_steps: int, args) -> dict:
    """Run ``step(state, **args(i))`` ``n_steps`` times: each step's
    metrics, its (reduced) gradients and the weights after it."""
    out = dict(metrics=[], grads=[], weights=[])
    for i in range(n_steps):
        m = step(state, **args(i))
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["grads"].append({k: p.grad.clone()
                             for k, p in state.model.named_parameters()})
        out["weights"].append({k: v.clone() for k, v in
                               state.model.state_dict().items()})
    return out


def job_global(inputs, r: int) -> dict:
    """Global-batch steps on the injected batches, with this rank's
    injected draws (``u_c``/``u_f`` [steps, ranks, n_r, S])."""
    batches = inputs["batches"]                     # [steps, 3, N, 3]
    cfg = step_cfg(batches.shape[2])
    state = _state(inputs, cfg)
    step = make_train_step(cfg, schedule_from_cfg(cfg))
    return _steps(state, step, len(batches), lambda i: dict(
        rays_o=batches[i][0], rays_d=batches[i][1], target=batches[i][2],
        u_c=inputs["u_c"][i][r], u_f=inputs["u_f"][i][r]))


def job_image(inputs, r: int) -> dict:
    """Per-image steps: each step's image and pose, its injected global
    pixel set and this rank's draws (``ui_c``/``ui_f``)."""
    cfg = step_cfg(inputs["coords"].shape[1])
    state = _state(inputs, cfg)
    hw = inputs["images"].shape[1:3]
    step = make_image_train_step(cfg, schedule_from_cfg(cfg), *hw,
                                 inputs["K"].numpy())
    return _steps(state, step, len(inputs["coords"]), lambda i: dict(
        image=inputs["images"][i], pose=inputs["poses"][i],
        precrop=bool(inputs["precrop"][i]), coords=inputs["coords"][i],
        u_c=inputs["ui_c"][i][r], u_f=inputs["ui_f"][i][r]))


def job_uneven(inputs, r: int) -> dict:
    """Global-batch steps on a batch the ranks split unevenly: this
    rank's rows of the global draws (``u_c``/``u_f`` [steps, N, S])."""
    batches = inputs["uneven_batches"]
    n = batches.shape[2]
    cfg = step_cfg(n)
    state = _state(inputs, cfg)
    step = make_train_step(cfg, schedule_from_cfg(cfg))
    lo, hi = parallel.rank_bounds(n, r, parallel.world_size())
    return _steps(state, step, len(batches), lambda i: dict(
        rays_o=batches[i][0], rays_d=batches[i][1], target=batches[i][2],
        u_c=inputs["uneven_u_c"][i][lo:hi],
        u_f=inputs["uneven_u_f"][i][lo:hi]))


def job_pool(inputs, r: int) -> dict:
    """The ray pool built from a generator seeded by the rank (ranks
    that drew alone would disagree), after its build and after a replay
    through two reshuffles."""
    images, K, poses = make_synth_scene(n_views=2, H=8, W=8)
    gen = torch.Generator().manual_seed(100 + r)
    pool = RayPool(build_ray_pool(images, K, poses, np.arange(2), gen,
                                  "cpu"), gen)
    built = pool.pool.clone()
    pool.fast_forward(9, 32)                         # 128 rays: 4 a epoch
    return dict(built=built, replayed=pool.pool.clone(),
                batch=torch.stack(pool.next_batch(32)))


def job_frames(inputs, r: int) -> dict:
    out = {}
    for cull in ("none", "auto"):
        renderer, packed, pose = frame_setup(cull)
        gen = torch.Generator().manual_seed(5)
        out[cull] = renderer(packed, pose, gen)
        out[cull + "_stats"] = {k: (None if v is None else float(v))
                                for k, v in renderer.stats[-1].items()} \
            if cull == "auto" else None
    return out


JOBS = dict(global_step=job_global, image_step=job_image,
            uneven_step=job_uneven, pool=job_pool, frames=job_frames)


def main(argv) -> int:
    inputs_path, out_dir, *jobs = argv
    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "1")))
    _, made = parallel.maybe_initialize_distributed("cpu")
    try:
        inputs = torch.load(inputs_path, weights_only=True) \
            if os.path.isfile(inputs_path) else {}
        r = parallel.rank()
        res = {job: JOBS[job](inputs, r) for job in jobs}
        res["world"] = parallel.world_size()
        torch.save(res, os.path.join(out_dir, f"rank{r}.pt"))
    finally:
        if made:
            parallel.destroy()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
