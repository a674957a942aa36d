"""One rank of a multi-rank job for tests/test_torch_parallel.py (data
parallelism), tests/test_torch_tp.py (the width-sharded MLP) and
tests/test_torch_sp.py (the sample-sharded frame).

    RANK=r WORLD_SIZE=w LOCAL_RANK=r MASTER_ADDR=localhost MASTER_PORT=p \\
        python tests/torch_dist_worker.py <inputs.pt> <out_dir> <job> ...

The launch contract's variables make the process group (gloo, CPU)
through ``parallel.maybe_initialize_distributed``; each job named on the
command line runs on the inputs the test wrote (``torch.save`` of a dict
of tensors) and the rank's results go to ``<out_dir>/rank<r>.pt``.  It
imports torch and the port only, so it starts without JAX.
"""
from __future__ import annotations

import copy
import os
import sys

import numpy as np
import torch

from nerf_pytorch_paeng_tpu_torch import parallel
from nerf_pytorch_paeng_tpu_torch.config import NerfConfig
from nerf_pytorch_paeng_tpu_torch.eval.frame import make_frame_renderer
from nerf_pytorch_paeng_tpu_torch.kernels.fused_mlp import pack_nerf
from nerf_pytorch_paeng_tpu_torch.models.nerf import NeRF, init_nerf
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


# phase 0 (``render_precull on`` off the ray kernels): seeded random
# weights on the injected ball bounds of the JAX package's mesh test
# (tests/test_precull.py), 16-ray blocks, on the plane and plain routes
PHASE0_KW = dict(N_samples_c=12, N_samples_f=20, near=2.0, far=6.0,
                 perturb=0.0, compute_dtype="float32", chunk_rays=16,
                 render_precull="on", render_precull_grid=16)
PHASE0_ROUTES = {"planes": dict(),
                 "plain": dict(use_pallas=False, netDepth=4, netWidth=64,
                               L_x=6, L_d=2)}


def phase0_setup(route: str):
    """(renderer, fields, pose): one 16x16 view through the culled
    renderer's phase 0 on ``route`` with the ball as the coarse bounds."""
    _, K, poses = make_synth_scene(n_views=1, H=FRAME_HW, W=FRAME_HW)
    cfg = NerfConfig(device="cpu", **PHASE0_KW, **PHASE0_ROUTES[route])
    renderer = make_frame_renderer(cfg, FRAME_HW, FRAME_HW, K, "cpu")
    packed = pack_nerf(init_nerf(cfg, seed=0), cfg)
    renderer.set_support(packed, "coarse", (
        torch.full((3,), -1.5), torch.full((3,), 1.5), torch.tensor([2.0]),
        torch.tensor([True])))
    return renderer, packed, torch.from_numpy(poses[0])


def job_phase0_frames(inputs, r: int) -> dict:
    out = {}
    for route in PHASE0_ROUTES:
        renderer, packed, pose = phase0_setup(route)
        out[route] = renderer(packed, pose, torch.Generator().manual_seed(5))
        out[route + "_stats"] = {k: (None if v is None else float(v))
                                 for k, v in renderer.stats[-1].items()}
    return out


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


# ------------------------------------- the model axis (tests/test_torch_tp.py,
# tests/test_torch_sp.py): every job lays the ranks out as n_data x 2
TINY = dict(netDepth=4, netWidth=64, L_x=6, L_d=2, compute_dtype="float32")
TP_KW = dict(TINY, N_samples_c=16, N_samples_f=16, iter_N=10, iter_warmup=2,
             precrop_frac=0.5, n_model_shards=2)


def tp_cfg(n_rays: int = 64, **kw) -> NerfConfig:
    cfg = NerfConfig(device="cpu", N_rays=n_rays, **{**TP_KW, **kw})
    parallel.init_layout(cfg)
    return cfg


def _tp_state(sd, cfg):
    from nerf_pytorch_paeng_tpu_torch.parallel.tensor import shard_nerf
    model = NeRF(depth=cfg.netDepth, width=cfg.netWidth, L_x=cfg.L_x,
                 L_d=cfg.L_d)
    model.load_state_dict(sd)
    model = shard_nerf(model)
    return TrainState(model, make_optimizer(model, cfg), 0)


def _full_grads(model) -> dict:
    """Every parameter's gradient at full width (gathered over the model
    group by its split dim)."""
    return {k: (g if (dim := model.full_dims[k]) is None
                else parallel.all_gather_cat(g, dim, model.group))
            for k, g in ((k, p.grad) for k, p in model.named_parameters())}


def _tp_steps(state, step, n_steps: int, args) -> dict:
    from nerf_pytorch_paeng_tpu_torch.parallel.tensor import \
        check_model_replicas
    out = dict(metrics=[], grads=[], weights=[], replicated=[])
    for i in range(n_steps):
        m = step(state, **args(i))
        check_model_replicas(state.model, f"step {i}")
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["grads"].append(_full_grads(state.model))
        out["weights"].append(state.model.full_state_dict())
        out["replicated"].append([p.detach().clone() for p in
                                  state.model.replicated_parameters()])
    return out


def job_tp_forward(inputs, r: int) -> dict:
    """The width-sharded coarse module's forward and input gradient."""
    cfg = tp_cfg()
    state = _tp_state(inputs["tp_sd"], cfg)
    x = inputs["tp_x"].clone().requires_grad_(True)
    out = state.model.model_coarse(x)
    (out ** 2).sum().backward()
    return dict(out=out.detach(), dx=x.grad,
                kinds=state.model.model_coarse.kinds,
                shapes={k: tuple(v.shape) for k, v in
                        state.model.state_dict().items()})


def job_tp_steps(inputs, r: int) -> dict:
    """Both batch modes' width-sharded steps on the global batches, each
    data rank with its rows of the global draws (``tp_u_c``/``tp_u_f``
    [steps, N, S]; per image ``tp_ui_c``/``tp_ui_f``)."""
    out = {}
    batches = inputs["tp_batches"]
    n = batches.shape[2]
    cfg = tp_cfg(n)
    g = parallel.data_group()
    lo, hi = parallel.rank_bounds(n, g.index, g.size)
    state = _tp_state(inputs["tp_sd"], cfg)
    step = make_train_step(cfg, schedule_from_cfg(cfg))
    out["global"] = _tp_steps(state, step, len(batches), lambda i: dict(
        rays_o=batches[i][0], rays_d=batches[i][1], target=batches[i][2],
        u_c=inputs["tp_u_c"][i][lo:hi], u_f=inputs["tp_u_f"][i][lo:hi]))
    state = _tp_state(inputs["tp_sd"], cfg)
    hw = inputs["images"].shape[1:3]
    step = make_image_train_step(cfg, schedule_from_cfg(cfg), *hw,
                                 inputs["K"].numpy())
    out["image"] = _tp_steps(state, step, len(inputs["tp_coords"]),
                             lambda i: dict(
        image=inputs["images"][i], pose=inputs["poses"][i],
        precrop=bool(inputs["precrop"][i]), coords=inputs["tp_coords"][i],
        u_c=inputs["tp_ui_c"][i][lo:hi], u_f=inputs["tp_ui_f"][i][lo:hi]))
    return out


def job_tp_drawn(inputs, r: int) -> dict:
    """Two global-batch steps whose draws the step takes itself: at more
    than one data rank each takes its rows of the whole batch's draws."""
    batches = inputs["tp_batches"]
    cfg = tp_cfg(batches.shape[2])
    state = _tp_state(inputs["tp_sd"], cfg)
    step = make_train_step(cfg, schedule_from_cfg(cfg))
    return _tp_steps(state, step, len(batches), lambda i: dict(
        rays_o=batches[i][0], rays_d=batches[i][1], target=batches[i][2]))


RESUME_KW = dict(netDepth=8, netWidth=256, L_x=10, L_d=4, N_samples_c=8,
                 N_samples_f=8)


def job_tp_resume(inputs, r: int, out_dir: str) -> dict:
    """The reference MLP (the JAX package's checkpoint converters take
    that depth only): 2 + 2 width-sharded steps with a checkpoint after
    2, and 2 steps from that checkpoint restored into fresh shards: the
    full states at the checkpoint and after 4 steps either way, weights
    and Adam's moments, and the checkpoint's path."""
    from nerf_pytorch_paeng_tpu_torch.train import checkpoint as ckpt
    batches = inputs["rs_batches"]
    cfg = tp_cfg(batches.shape[2], **RESUME_KW)
    step = make_train_step(cfg, schedule_from_cfg(cfg))

    def run(state, steps):
        for i in steps:
            b = batches[i % len(batches)]
            step(state, rays_o=b[0], rays_d=b[1], target=b[2])
    state = _tp_state(inputs["rs_sd"], cfg)
    run(state, range(2))
    path = ckpt.save_checkpoint(out_dir, "tp", state)
    at_save = copy.deepcopy(ckpt.full_states(state))    # not the live moments
    run(state, range(2, 4))
    straight = ckpt.full_states(state)
    again = _tp_state(inputs["rs_sd"], cfg)
    ckpt.restore_checkpoint(out_dir, "tp", 2, again)
    run(again, range(2, 4))
    return dict(at_save=at_save, straight=straight,
                resumed=ckpt.full_states(again), path=path, step=again.step)


def job_tp_frames(inputs, r: int) -> dict:
    """The dense and culled frames of the compact field's gathered weights
    under the 1 x 2 layout: the rays split over every rank."""
    from nerf_pytorch_paeng_tpu_torch.parallel.tensor import (full_model,
                                                              shard_nerf)
    tp_cfg()
    out = {}
    for cull in ("none", "auto"):
        renderer, packed, pose = frame_setup(cull)
        model = NeRF()
        model.load_state_dict(compact_field_state_dict(r=1.0, k=20.0))
        cfg = NerfConfig(device="cpu", render_cull=cull, **FRAME_KW)
        packed = pack_nerf(full_model(shard_nerf(model)), cfg)
        out[cull] = renderer(packed, pose, torch.Generator().manual_seed(5))
    return out


def job_sp_composite(inputs, r: int) -> dict:
    """``composite_sample_sharded`` on this rank's columns of the inputs,
    and the two sample-sharded renders of the tiny MLP's plain fields
    (one pass on ``sp_z``; coarse and fine at the fine uniforms
    ``sp_u``)."""
    from nerf_pytorch_paeng_tpu_torch.ops.render import make_plain_field_fns
    from nerf_pytorch_paeng_tpu_torch.parallel.sp import (
        composite_sample_sharded, make_sample_sharded_render,
        make_sample_sharded_render_full)
    cfg = tp_cfg()
    g = parallel.model_group()
    raw, z, rays_d = inputs["sp_raw"], inputs["sp_z"], inputs["sp_rays_d"]
    k = z.shape[1] // g.size
    cols = slice(g.index * k, (g.index + 1) * k)
    out = composite_sample_sharded(raw[:, :, cols].contiguous(),
                                   z[:, cols].contiguous(), rays_d, g)
    model = NeRF(depth=cfg.netDepth, width=cfg.netWidth, L_x=cfg.L_x,
                 L_d=cfg.L_d)
    model.load_state_dict(inputs["sp_sd"])
    coarse, fine = make_plain_field_fns(model, cfg)
    rays_o = inputs["sp_rays_o"]
    with torch.no_grad():
        one = make_sample_sharded_render(coarse)(rays_o, rays_d, z)
        full = make_sample_sharded_render_full(
            coarse, fine, n_fine=cfg.N_samples_f, perturb=1.0)(
                rays_o, rays_d, z, u=inputs["sp_u"])
    return dict(out._asdict(), index=g.index, render=one, render_full=full)


def sp_frame_cfg(**kw) -> NerfConfig:
    """The sample-sharded frames' config: the tiny MLP off the kernels'
    domain, 16 + 16 samples, ``perturb`` 0, dense."""
    base = dict(TINY, N_samples_c=16, N_samples_f=16, near=2.0, far=6.0,
                perturb=0.0, render_cull="none", use_pallas=False,
                chunk_rays=32)
    return NerfConfig(device="cpu", **{**base, **kw})


def job_sp_frames(inputs, r: int) -> dict:
    """Frames through ``make_frame_renderer`` with ``sp_shards 2``: the tiny
    MLP with the coarse jitter drawn (16x16, 32-ray blocks) and without
    (8x8), and the reference MLP on K8's plain version (4x4, 8 + 8
    samples), all at ``perturb 0``."""
    from nerf_pytorch_paeng_tpu_torch.eval.frame import make_frame_renderer
    tp_cfg()
    out = {}
    for name, hw, kw, sd, stratified in (
            ("tiny_jitter", 16, {}, "sp_sd", True),
            ("tiny", 8, {}, "sp_sd", False),
            ("full", 4, dict(netDepth=8, netWidth=256, L_x=10, L_d=4,
                             N_samples_c=8, N_samples_f=8, use_pallas=True),
             "sp_sd_full", False)):
        cfg = sp_frame_cfg(sp_shards=2, n_model_shards=2, **kw)
        _, K, poses = make_synth_scene(n_views=1, H=hw, W=hw)
        model = NeRF(depth=cfg.netDepth, width=cfg.netWidth, L_x=cfg.L_x,
                     L_d=cfg.L_d)
        model.load_state_dict(inputs[sd])
        renderer = make_frame_renderer(cfg, hw, hw, K, "cpu",
                                       stratified=stratified)
        out[name] = renderer(pack_nerf(model, cfg),
                             torch.from_numpy(poses[0]),
                             torch.Generator().manual_seed(9))
        out[name + "_route"] = renderer.route
    return out


JOBS = dict(global_step=job_global, image_step=job_image,
            uneven_step=job_uneven, pool=job_pool, frames=job_frames,
            phase0_frames=job_phase0_frames,
            tp_forward=job_tp_forward, tp_steps=job_tp_steps,
            tp_drawn=job_tp_drawn, tp_resume=job_tp_resume,
            tp_frames=job_tp_frames, sp_composite=job_sp_composite,
            sp_frames=job_sp_frames)
WITH_OUT_DIR = ("tp_resume",)


def main(argv) -> int:
    inputs_path, out_dir, *jobs = argv
    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "1")))
    _, made = parallel.maybe_initialize_distributed("cpu")
    try:
        inputs = torch.load(inputs_path, weights_only=True) \
            if os.path.isfile(inputs_path) else {}
        r = parallel.rank()
        res = {job: JOBS[job](inputs, r, *((out_dir,) if job in WITH_OUT_DIR
                                           else ())) for job in jobs}
        res["world"] = parallel.world_size()
        torch.save(res, os.path.join(out_dir, f"rank{r}.pt"))
    finally:
        if made:
            parallel.destroy()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
