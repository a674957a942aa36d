"""The plain reference NeRF that decides a run's ``correct``.

Plain PyTorch in float32 with TF32 off (``strict_float32``): rays, NDC,
the reference positional encoding, the 8x256 MLP with its skip at layer
4, stratified and inverse-CDF sampling, alpha compositing on a white
background, the loss, Adam and the warmup-cosine learning rate, written
from the published method (Mildenhall et al., NeRF, ECCV 2020) and the
reference implementation's conventions.  It imports nothing of the
program and takes nothing the program made: weights are the state dict
the benchmark draws, draws are worked out again from the seeds.

Every matrix product goes through ``rnd``, the operand rounding: the
identity for the reference, ``round_fp8`` for the control (the step below
the configuration's bfloat16: scaled float8 e4m3 operands, float32 sums).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch

Params = Dict[str, torch.Tensor]
Rounding = Callable[[torch.Tensor], torch.Tensor]

FP8_MAX = 448.0             # largest finite float8 e4m3 value
WHITE_BKG = True            # the program composites onto white in every mode
DISP_CLAMP = 5.0


def strict_float32() -> None:
    """float32 products without TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale for the whole tensor
    (its largest magnitude maps to 448), back in float32.  The gradient
    passes through unrounded, as a scaled float8 product's does, so the
    backward's products take the rounded operands."""
    xd = x.detach()
    scale = FP8_MAX / xd.abs().amax().clamp(min=1e-30)
    q = (xd * scale).clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn)
    return x + (q.float() / scale - xd)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16, back in float32, the gradient passing
    through unrounded: the configuration's own operand precision, for a
    look at what rounding alone does (not the control)."""
    xd = x.detach()
    return x + (xd.to(torch.bfloat16).float() - xd)


# ---------------------------------------------------------------- rays


def pixel_dirs(H: int, W: int, K: torch.Tensor) -> torch.Tensor:
    """[H, W, 3] camera-frame directions of a pinhole camera."""
    dev = K.device
    j, i = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                          torch.arange(W, dtype=torch.float32, device=dev),
                          indexing="ij")
    return torch.stack([(i - K[0, 2]) / K[0, 0], -(j - K[1, 2]) / K[1, 1],
                        -torch.ones_like(i)], -1)


def rays(dirs: torch.Tensor, c2w: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Camera-frame directions [..., 3] and a [3, 4] camera-to-world ->
    world origins and directions [..., 3]."""
    d = dirs @ c2w[:3, :3].T
    return c2w[:3, 3].expand(d.shape), d


def camera_rays(dirs: torch.Tensor, c2ws: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each ray's own camera: directions [N, 3], cameras [N, 3, 4] ->
    world origins and directions [N, 3]."""
    d = torch.einsum("nj,nij->ni", dirs, c2ws[:, :3, :3])
    return c2ws[:, :3, 3], d


def ndc(H: int, W: int, focal: float, o: torch.Tensor, d: torch.Tensor,
        near: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward-facing rays into normalised device coordinates."""
    t = -(near + o[..., 2]) / d[..., 2]
    o = o + t[..., None] * d
    ax, ay = -2.0 * focal / W, -2.0 * focal / H
    o_n = torch.stack([ax * o[..., 0] / o[..., 2], ay * o[..., 1] / o[..., 2],
                       1.0 + 2.0 * near / o[..., 2]], -1)
    d_n = torch.stack([ax * (d[..., 0] / d[..., 2] - o[..., 0] / o[..., 2]),
                       ay * (d[..., 1] / d[..., 2] - o[..., 1] / o[..., 2]),
                       -2.0 * near / o[..., 2]], -1)
    return o_n, d_n


# ------------------------------------------------------------- the field


def posenc(x: torch.Tensor, L: int) -> torch.Tensor:
    """[x, sin(2^0 x), cos(2^0 x), ..., sin(2^(L-1) x), cos(2^(L-1) x)]."""
    parts = [x]
    for j in range(L):
        parts += [torch.sin(2.0 ** j * x), torch.cos(2.0 ** j * x)]
    return torch.cat(parts, -1)


def _dense(x: torch.Tensor, p: Params, name: str, rnd: Rounding
           ) -> torch.Tensor:
    return rnd(x) @ rnd(p[name + ".weight"]).T + p[name + ".bias"]


def mlp(p: Params, emb_x: torch.Tensor, emb_d: torch.Tensor,
        rnd: Rounding = identity, depth: int = 8, skip: int = 4
        ) -> torch.Tensor:
    """One radiance MLP (state-dict names ``linear_x.i``, ``linear_d``,
    ``linear_feat``, ``linear_density``, ``linear_color``): [P, in_x],
    [P, in_d] -> raw [P, 4] (rgb logits, density logit)."""
    h = emb_x
    for i in range(depth):
        h = torch.relu(_dense(h, p, f"linear_x.{i}", rnd))
        if i == skip:
            h = torch.cat([emb_x, h], -1)
    sigma = _dense(h, p, "linear_density", rnd)
    feat = _dense(h, p, "linear_feat", rnd)
    h = torch.relu(_dense(torch.cat([feat, emb_d], -1), p, "linear_d", rnd))
    return torch.cat([_dense(h, p, "linear_color", rnd), sigma], -1)


def module(state: Params, name: str) -> Params:
    """The entries of one module (``model_coarse``/``model_fine``)."""
    pre = name + "."
    return {k[len(pre):]: v for k, v in state.items() if k.startswith(pre)}


def field(p: Params, o: torch.Tensor, d: torch.Tensor, z: torch.Tensor,
          L_x: int, L_d: int, rnd: Rounding) -> torch.Tensor:
    """Raw [N, S, 4] at the points o + d z of rays [N, 3], depths [N, S];
    the view direction is d normalised."""
    n, s = z.shape
    pts = o[:, None, :] + d[:, None, :] * z[..., None]
    vd = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    emb_x = posenc(pts.reshape(-1, 3), L_x)
    emb_d = posenc(vd[:, None, :].expand(n, s, 3).reshape(-1, 3), L_d)
    return mlp(p, emb_x, emb_d, rnd).reshape(n, s, 4)


# -------------------------------------------------------------- sampling


def stratified(u: torch.Tensor, near: float, far: float) -> torch.Tensor:
    """Jittered depths: one uniform per bin of ``linspace(near, far, S)``'s
    midpoint partition.  u [N, S] -> z [N, S]."""
    s = u.shape[-1]
    t = torch.linspace(0.0, 1.0, s, device=u.device)
    z = near * (1.0 - t) + far * t
    mids = 0.5 * (z[1:] + z[:-1])
    lower = torch.cat([z[:1], mids])
    upper = torch.cat([mids, z[-1:]])
    return lower + (upper - lower) * u


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor,
               u: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF depths: bin edges [N, B], masses [N, B - 1] (plus
    1e-5 each), uniforms [N, F] -> [N, F]."""
    w = weights + 1e-5
    cdf = torch.cumsum(w / w.sum(-1, keepdim=True), -1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], -1)
    idx = torch.searchsorted(cdf, u.contiguous(), right=True)
    lo = torch.clamp(idx - 1, min=0)
    hi = torch.clamp(idx, max=cdf.shape[-1] - 1)
    c_lo, c_hi = cdf.gather(-1, lo), cdf.gather(-1, hi)
    b_lo, b_hi = bins.gather(-1, lo), bins.gather(-1, hi)
    den = c_hi - c_lo
    den = torch.where(den < 1e-5, torch.ones_like(den), den)
    return b_lo + (u - c_lo) / den * (b_hi - b_lo)


def composite(raw: torch.Tensor, z: torch.Tensor, d: torch.Tensor):
    """raw [N, S, 4], depths [N, S], ray directions [N, 3] -> (rgb [N, 3],
    disparity [N], weights [N, S])."""
    dz = torch.cat([z[:, 1:] - z[:, :-1],
                    torch.full_like(z[:, :1], 1e10)], -1)
    dist = dz * torch.linalg.norm(d, dim=-1)[:, None]
    alpha = 1.0 - torch.exp(-torch.relu(raw[..., 3]) * dist)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]),
                                     1.0 - alpha + 1e-10], -1), -1)[:, :-1]
    w = alpha * trans
    acc = w.sum(-1)
    rgb = (w[..., None] * torch.sigmoid(raw[..., :3])).sum(1)
    if WHITE_BKG:
        rgb = rgb + (1.0 - acc)[:, None]
    depth = (w * z).sum(-1)
    safe = torch.where(acc > 0, acc, torch.ones_like(acc))
    disp = torch.clamp(1.0 / torch.clamp(depth / safe, min=1e-10),
                       max=DISP_CLAMP)
    disp = torch.where(acc == 0, torch.zeros_like(disp), disp)
    return rgb, disp, w


def render(state: Params, o: torch.Tensor, d: torch.Tensor, u_c, u_f,
           near: float, far: float, L_x: int, L_d: int,
           rnd: Rounding = identity):
    """Coarse then fine (coarse and fine depths merged and sorted) over
    rays [N, 3] at the coarse jitter u_c [N, Sc] and fine uniforms
    u_f [N, Sf] -> (rgb_c, rgb_f, disp_f, the coarse occupancy [N])."""
    coarse, fine = module(state, "model_coarse"), module(state, "model_fine")
    z_c = stratified(u_c, near, far)
    rgb_c, _, w_c = composite(field(coarse, o, d, z_c, L_x, L_d, rnd),
                              z_c, d)
    z_mid = 0.5 * (z_c[:, 1:] + z_c[:, :-1])
    z_f = sample_pdf(z_mid, w_c[:, 1:-1].detach(), u_f).detach()
    z = torch.sort(torch.cat([z_c, z_f], -1), -1).values
    rgb_f, disp_f, _ = composite(field(fine, o, d, z, L_x, L_d, rnd), z, d)
    return rgb_c, rgb_f, disp_f, w_c.sum(-1)


# ------------------------------------------------------------- training


def lr_at(step: int, total: int, warmup: int, lr: float, lr_min: float
          ) -> float:
    """Linear warmup from ``lr_min`` to ``lr`` over ``warmup`` steps, then
    a half cosine down to ``lr_min`` at ``total``; update k (1-based) runs
    at ``lr_at(k - 1)``."""
    if step < warmup:
        return lr_min + (lr - lr_min) * step / max(warmup, 1)
    return lr_min + (lr - lr_min) * (1.0 + math.cos(
        math.pi * (step - warmup) / (total - warmup))) / 2.0


class Adam:
    """Adam with bias correction (beta 0.9, 0.999, eps 1e-8)."""

    def __init__(self, params: Params, b1=0.9, b2=0.999, eps=1e-8):
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.b1, self.b2, self.eps, self.t = b1, b2, eps, 0

    def step(self, params: Params, grads: Params, lr: float) -> None:
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for k, g in grads.items():
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = (self.v[k] / c2).sqrt_().add_(self.eps)
            params[k].sub_(lr * (self.m[k] / c1) / denom)


def loss_and_grads(state: Params, o, d, target, u_c, u_f, near, far, L_x,
                   L_d, rnd: Rounding = identity):
    """MSE of the coarse plus the fine colours and its gradient by every
    entry of ``state`` -> (loss, grads)."""
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in state.items()}
    rgb_c, rgb_f = render(leaves, o, d, u_c, u_f, near, far, L_x, L_d,
                          rnd)[:2]
    loss = ((rgb_c - target) ** 2).mean() + ((rgb_f - target) ** 2).mean()
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


# ------------------------------------------------------------- the draws

_U64 = (1 << 64) - 1


def splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _U64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _U64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _U64
    return x ^ (x >> 31)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of train update ``step`` (completed updates before
    it) under run seed ``seed``: splitmix64 of (seed << 32 | step)."""
    x = splitmix64(((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF))
    return torch.Generator(device=device).manual_seed(x)


def image_step_draws(seed: int, step: int, H: int, W: int, n: int, s_c: int,
                     s_f: int, device):
    """Per-image update ``step``: the pixels (a permutation's first n,
    row-major flat indices), then the coarse jitter [n, s_c] and the fine
    uniforms [n, s_f], in that order from the step's generator."""
    g = step_generator(seed, step, device)
    flat = torch.randperm(H * W, generator=g, device=device)[:n]
    u_c = torch.rand((n, s_c), generator=g, device=device)
    u_f = torch.rand((n, s_f), generator=g, device=device)
    return flat, u_c, u_f


def pool_step_draws(seed: int, step: int, n: int, s_c: int, s_f: int,
                    device):
    """Global-batch update ``step``: the coarse jitter, then the fine
    uniforms."""
    g = step_generator(seed, step, device)
    u_c = torch.rand((n, s_c), generator=g, device=device)
    u_f = torch.rand((n, s_f), generator=g, device=device)
    return u_c, u_f


def pool_order(seed: int, m: int, device) -> torch.Tensor:
    """The pool's first shuffle: a permutation of its m rays (image-major,
    then row, then column) from the pool's generator."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randperm(m, generator=g, device=device)
