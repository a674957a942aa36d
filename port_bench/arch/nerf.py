"""NeRF (Mildenhall et al., ECCV 2020) as the program runs it: coarse and
fine 8x256 MLPs with a skip at layer 4 (``models/nerf.NeRF``), on the
fused ray kernels.

What the ``train`` and ``render`` kinds take from an architecture
(``arch/__init__.py``): the program's model, train loop and frame
renderer; the weights the cells draw (``harness/fields.py``); the
reference's steps and exact frames (``reference/nerf.py``); the counts
the metric readers take (``harness/flops.py`` and the kernels' names).
The program is imported inside the functions that call it, so that a
fault planted in it (``tests/test_pb_faults.py``) reaches the run.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..harness import fields, flops
from ..reference import nerf as ref

K1_KERNELS = ("eval_rays_wgmma_kernel",)
K2_KERNELS = ("bwd_chain_kernel", "wgrad_kernel", "reduce_kernel")
MLP_KERNELS = ("sigma_rays_wgmma_kernel", "eval_rays_wgmma_kernel")
REF_BLOCK = 8192            # rays a block in the reference frames
ROUND_CONTROL = ref.round_fp8
ROUND_OWN = ref.round_bf16


def _model(cfg, sd, device):
    from nerf_pytorch_paeng_tpu_torch.models.nerf import NeRF
    model = NeRF(depth=cfg.netDepth, width=cfg.netWidth, L_x=cfg.L_x,
                 L_d=cfg.L_d).to(device)
    model.load_state_dict(sd)
    return model


# ---------------------------------------------------------------- train


def train_weights(cfg, generator: torch.Generator, device):
    return fields.init_state_dict(generator, device, cfg.L_x, cfg.L_d)


class TrainLoop:
    """``driver.train``'s loop without its hooks and logging: chunks from
    ``ChunkSchedule``, the image choice or the pool's cursor, the
    occupancy policy ``driver._SupportPolicy`` refreshing on its cadence,
    each chunk run by one ``StagedSteps`` on one ``TrainState``."""

    def __init__(self, cfg, scene, sd, device, probe):
        from nerf_pytorch_paeng_tpu_torch.driver import _SupportPolicy
        from nerf_pytorch_paeng_tpu_torch.train.batching import (
            RayPool, build_ray_pool)
        from nerf_pytorch_paeng_tpu_torch.train.chunk import (ChunkSchedule,
                                                              StagedSteps)
        from nerf_pytorch_paeng_tpu_torch.train.precull import \
            train_precull_active
        from nerf_pytorch_paeng_tpu_torch.train.schedule import \
            schedule_from_cfg
        from nerf_pytorch_paeng_tpu_torch.train.state import (TrainState,
                                                              make_optimizer)

        self.cfg = cfg
        H, W = scene["hw"]
        K, poses, i_train = scene["K"], scene["poses"], scene["i_train"]
        model = _model(cfg, sd, device)
        self.state = TrainState(model, make_optimizer(model, cfg), 0)
        self.schedule = probe(schedule_from_cfg(cfg), self.state)
        if cfg.global_batch:
            gen = torch.Generator(device=device).manual_seed(cfg.seed + 1)
            self.pool = RayPool(build_ray_pool(scene["images"].cpu().numpy(),
                                               K, poses, i_train, gen,
                                               device), gen)
            data = dict(pool=self.pool)
        else:
            self.pool = None
            data = dict(images=scene["images"][torch.as_tensor(i_train)],
                        poses=torch.as_tensor(poses[i_train][:, :3, :4],
                                              device=device))
        self.n_images = len(i_train)
        self.policy = (_SupportPolicy(cfg, K, poses, (H, W), i_train,
                                      device, n_est=cfg.N_rays)
                       if train_precull_active(cfg, 1) else None)
        self.chunks = ChunkSchedule.from_cfg(cfg, False, False, None)
        self.steps = StagedSteps(cfg, self.state, self.schedule, device, H,
                                 W, K, graphs=self.chunks.k > 1, **data)
        self.rng = np.random.default_rng(cfg.seed + 2)
        self.loop = dict(i=1, support=None, next_refresh=1, backoff=1,
                         gated=0)
        self.loss_col = self.steps.keys.index("loss")

    @property
    def replays(self) -> int:
        return self.steps.replays

    @property
    def gated(self) -> int:
        return self.loop["gated"]

    def chunk(self):
        """One chunk of ``driver.train``'s loop; returns (steps, slab,
        items)."""
        cfg, loop, chunks, steps = self.cfg, self.loop, self.chunks, self.steps
        pool, policy = self.pool, self.policy
        i = loop["i"]
        if policy is not None and i >= loop["next_refresh"]:
            loop["support"] = policy.refresh(self.state.model, i)
            steps.set_support(loop["support"])
            on = loop["support"] is not None
            loop["backoff"] = 1 if on else min(
                loop["backoff"] * 2, max(int(cfg.train_precull_backoff_max),
                                         1))
            loop["next_refresh"] = i + max(int(cfg.train_precull_every),
                                           1) * loop["backoff"]
        refresh = loop["next_refresh"] if policy is not None else None
        if pool is not None:
            k = chunks.length(i, pool.i_batch, len(pool.pool), refresh)
            items = [pool.next_start(cfg.N_rays) for _ in range(k)]
        else:
            k = chunks.length(i, next_refresh=refresh)
            items = [int(self.rng.choice(self.n_images)) for _ in range(k)]
        gated = loop["support"] is not None
        slab = steps.run(items, precrop=i < cfg.precrop_iters, gated=gated,
                         replay=k == chunks.k and k > 1)
        loop["i"] += k
        loop["gated"] += k if gated else 0
        return k, slab, items

    def close(self) -> None:
        self.steps.close()


def first_items(cfg, scene) -> List[int]:
    """The first three steps' items as ``TrainLoop.chunk`` draws them:
    the pool's offsets in its first shuffle, or the image slots."""
    if cfg.global_batch:
        return [k * cfg.N_rays for k in range(3)]
    rng = np.random.default_rng(cfg.seed + 2)
    return [int(rng.choice(len(scene["i_train"]))) for _ in range(3)]


def reference_steps(sd, scene, cfg, items: List[int], device, rnd=None,
                    n: int = 3, keep: int = 0) -> dict:
    """The reference's first ``n`` updates from ``sd``: per image (the
    items are image slots) or from the pool (the items are the batches'
    offsets in the first shuffle) -> losses, gradients, the difference of
    the gradients of each batch's two halves, and the weights' change.
    ``rnd``: the products' operand rounding (None: float32).  ``keep`` >
    0 trains on the batch's first ``keep`` rays alone (a fault's
    reading)."""
    ref.strict_float32()
    rnd = rnd or ref.identity
    H, W = scene["hw"]
    Kt = torch.as_tensor(scene["K"], dtype=torch.float32, device=device)
    dirs = ref.pixel_dirs(H, W, Kt).reshape(-1, 3)
    poses = torch.as_tensor(scene["poses"][scene["i_train"]][:, :3, :4],
                            dtype=torch.float32, device=device)
    images = scene["images"][torch.as_tensor(scene["i_train"])].reshape(
        len(scene["i_train"]), H * W, 3)
    N, s_c, s_f = cfg.N_rays, cfg.N_samples_c, cfg.N_samples_f
    if cfg.global_batch:
        order = ref.pool_order(cfg.seed + 1, len(scene["i_train"]) * H * W,
                               device)
    params = {k: v.detach().clone().float() for k, v in sd.items()}
    adam = ref.Adam(params)
    losses, grads_k, noise_k = [], [], []
    for k in range(n):
        if cfg.global_batch:
            u_c, u_f = ref.pool_step_draws(cfg.seed + 3, k, N, s_c, s_f,
                                           device)
            idx = order[items[k]:items[k] + N]
            view, pix = idx // (H * W), idx % (H * W)
        else:
            pix, u_c, u_f = ref.image_step_draws(cfg.seed + 3, k, H, W, N,
                                                 s_c, s_f, device)
            view = torch.full_like(pix, items[k])
        o, d = ref.camera_rays(dirs[pix], poses[view])
        if cfg.data_type == "llff":
            o, d = ref.ndc(H, W, float(scene["K"][0, 0]), o, d)
        target = images[view, pix]
        if keep:
            o, d, target, u_c, u_f = (t[:keep] for t in (o, d, target, u_c,
                                                         u_f))
        # the batch's two halves apart (its loss is their mean): their
        # gradients' difference is the batch's own sampling noise
        h = o.shape[0] // 2
        (l1, g1), (l2, g2) = (ref.loss_and_grads(
            params, *(t[part] for t in (o, d, target, u_c, u_f)),
            float(cfg.near), float(cfg.far), cfg.L_x, cfg.L_d, rnd)
            for part in (slice(0, h), slice(h, None)))
        loss = 0.5 * (l1 + l2)
        grads = {k: 0.5 * (g1[k] + g2[k]) for k in g1}
        losses.append(float(loss))
        grads_k.append(grads)
        noise_k.append({k: g1[k] - g2[k] for k in g1})
        adam.step(params, grads, ref.lr_at(k, cfg.iter_N + 1, cfg.iter_warmup,
                                           cfg.lr, cfg.lr_min))
    return dict(losses=losses, grads=grads_k, noise=noise_k,
                change={k: params[k] - sd[k].float() for k in params})


def train_counts(cfg) -> dict:
    """The sample counts, a step's model operations, K1's and K2's
    launches (operations, bytes) a step and their kernels' names."""
    n, s_c, s_f = cfg.N_rays, cfg.N_samples_c, cfg.N_samples_f
    return dict(s_c=s_c, s_f=s_f,
                flop_per_step=flops.train_step_flop(n, s_c, s_f, cfg.L_x,
                                                    cfg.L_d),
                k1_launches=[flops.k1_train_launch(n, s, cfg.L_x, cfg.L_d)
                             for s in (s_c, s_c + s_f)],
                k2_launches=[flops.k2_train_launch(n, s, cfg.L_x, cfg.L_d)
                             for s in (s_c, s_c + s_f)],
                k1_kernels=K1_KERNELS, k2_kernels=K2_KERNELS)


# --------------------------------------------------------------- render


def render_field(field: dict, generator: torch.Generator, device, cfg):
    """The cell's field (``fields.ball_state_dict`` of its ``field``)."""
    return fields.ball_state_dict(field, generator, device, cfg.L_x,
                                  cfg.L_d)


def frame_renderer(cfg, hw, K, sd, device):
    """The weights packed once (``pack_nerf``) and the renderer that
    ``eval/frame.make_frame_renderer`` returns for the configuration."""
    from nerf_pytorch_paeng_tpu_torch.eval.frame import make_frame_renderer
    from nerf_pytorch_paeng_tpu_torch.kernels.fused_mlp import pack_nerf
    model = _model(cfg, sd, device)
    packed = pack_nerf(model, cfg, device=device)
    del model
    H, W = hw
    return make_frame_renderer(cfg, H, W, K, device), packed


@torch.no_grad()
def reference_frame(sd, cfg, K, hw, c2w, seeds, device, rnd=None):
    """The exact frame (every ray, every sample) of pose ``c2w``, its
    coarse and fine uniforms drawn from generators seeded ``seeds``, its
    products' operands rounded by ``rnd`` (None: float32) -> (rgb [H, W,
    3], the count of rays whose coarse occupancy is above
    ``render_cull_tau``, those that the culled renderer has to
    render)."""
    ref.strict_float32()
    rnd = rnd or ref.identity
    H, W = hw
    Kt = torch.as_tensor(K, dtype=torch.float32, device=device)
    c2w = torch.as_tensor(np.asarray(c2w)[:3, :4], dtype=torch.float32,
                          device=device)
    o, d = ref.rays(ref.pixel_dirs(H, W, Kt).reshape(-1, 3), c2w)
    if cfg.data_type == "llff":
        o, d = ref.ndc(H, W, float(np.float32(K[0, 0])), o, d)
    n = H * W
    g = torch.Generator(device=device).manual_seed(seeds[0])
    u_c = torch.rand((n, cfg.N_samples_c), generator=g, device=device)
    gf = torch.Generator(device=device).manual_seed(seeds[1])
    u_f = torch.rand((n, cfg.N_samples_f), generator=gf, device=device)
    out = torch.empty((n, 3), device=device)
    n_active = 0
    for a in range(0, n, REF_BLOCK):
        s = slice(a, a + REF_BLOCK)
        _, rgb, _, acc = ref.render(sd, o[s].contiguous(), d[s].contiguous(),
                                    u_c[s], u_f[s], float(cfg.near),
                                    float(cfg.far), cfg.L_x, cfg.L_d, rnd)
        out[s] = rgb
        n_active += int((acc > float(cfg.render_cull_tau)).sum())
    return out.reshape(H, W, 3), n_active


def render_counts(cfg) -> dict:
    """The ray kernels' names (``mlp_kernel_ms.render``)."""
    return dict(mlp_kernels=MLP_KERNELS)
