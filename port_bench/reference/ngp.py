"""The plain reference Instant-NGP that decides an NGP run's ``correct``.

Plain PyTorch in float32 with TF32 off (``strict_float32``), written from
the published method (Mueller, Evans, Schied, Keller, "Instant Neural
Graphics Primitives with a Multiresolution Hash Encoding", SIGGRAPH 2022,
arXiv:2201.05989) and Instant-NGP's NeRF settings: the multiresolution
hash encoding, the spherical-harmonics direction encoding, the two
bias-free MLPs, the ray marcher over the occupancy grid with the in-order
sample budget (here a dense masked lattice of every candidate), the
compositing onto white, the MSE over the kept rays, the gradients by
autograd, Adam with L2 on the MLP weights, and the occupancy grid's
update.  It imports nothing of the program and takes nothing the program
made: parameters are the state dict the benchmark draws; draws (the rays'
uniforms, the grid's) are handed in by the caller.

Departures from the paper, the same as the program's (each *assumed* in
``configs/ngp_lego.json``): corners at floor(x N_l) (no +0.5 offset; the
floor clamped to N_l - 1 so that x = 1 takes the upper corner), dense
levels of exactly (N_l+1)^3 entries, no biases, sigma = exp(z_0) with its
argument clamped to [-15, 15], fixed lattice steps (no jump to the next
occupied cell), rays past the budget dropped in ray order, the loss the
MSE over the kept rays, the backward over every kept sample (no second
compaction), the grid updated from step 16 (not 0), no weight EMA.

Every matrix product goes through ``rnd``, the operand rounding: the
identity for the reference, scaled float8 e4m3 for the control (the step
below the configuration's bfloat16).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

Params = Dict[str, torch.Tensor]
Rounding = Callable[[torch.Tensor], torch.Tensor]
Level = Tuple[int, int, bool]

PRIMES = (1, 2654435761, 805459861)
SIGMA_CLAMP = 15.0
WHITE = 1.0
MLP = ("sigma_w0", "sigma_w1", "color_w0", "color_w1", "color_w2")
# Instant-NGP's NeRF-synthetic settings: the cube map x = SCALE p + OFFSET,
# the levels' coarsest and finest resolutions, a ray's lattice of
# MARCH_STEPS, the MLPs' width, the grid's decay and threshold, its update
# every GRID_EVERY steps (every cell before GRID_WARMUP), Adam and its decay
SCALE, OFFSET = 0.33, 0.5
N_MIN, N_MAX = 16.0, 2048.0
MARCH_STEPS = 1024
WIDTH = 64
GRID_DECAY, GRID_THRESH = 0.95, 0.01
GRID_EVERY, GRID_WARMUP = 16, 256
BETAS, EPS, L2 = (0.9, 0.99), 1e-15, 1e-6
LR_DECAY_START, LR_DECAY_EVERY, LR_DECAY = 20000, 10000, 0.33


def strict_float32() -> None:
    """float32 products without TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


# ------------------------------------------------------------ encodings


def levels(n_levels: int, log2_table: int, n_min: float, n_max: float
           ) -> List[Level]:
    """(N_l, entries, dense) of each level: N_l = floor(N_min b^l), b =
    exp((ln N_max - ln N_min) / (L - 1)); dense where (N_l+1)^3 <= T."""
    T = 2 ** log2_table
    b = math.exp((math.log(n_max) - math.log(n_min)) / max(n_levels - 1, 1))
    out = []
    for l in range(n_levels):
        n = math.floor(n_min * b ** l)
        out.append((n, (n + 1) ** 3, True) if (n + 1) ** 3 <= T
                   else (n, T, False))
    return out


def table_names(n_levels: int) -> List[str]:
    return [f"tables.{l}" for l in range(n_levels)]


def encode(p: Params, lv: List[Level], x: torch.Tensor) -> torch.Tensor:
    """Hash-grid features [n, 2 L] of points x [n, 3] in [0,1]^3."""
    x = x.clamp(0.0, 1.0)
    out = []
    for l, (res, size, dense) in enumerate(lv):
        s = x * float(res)
        lo = torch.floor(s).clamp(max=res - 1)
        f = s - lo
        lo = lo.long()
        acc = torch.zeros(x.shape[0], 2, device=x.device)
        for corner in range(8):
            bit = [(corner >> a) & 1 for a in range(3)]
            c = [lo[:, a] + bit[a] for a in range(3)]
            w = torch.ones(x.shape[0], device=x.device)
            for a in range(3):
                w = w * (f[:, a] if bit[a] else 1.0 - f[:, a])
            if dense:
                idx = c[0] + (res + 1) * c[1] + (res + 1) ** 2 * c[2]
            else:
                idx = ((c[0] * PRIMES[0]) ^ (c[1] * PRIMES[1])
                       ^ (c[2] * PRIMES[2])) % size
            acc = acc + w[:, None] * p[f"tables.{l}"][idx]
        out.append(acc)
    return torch.cat(out, 1)


def sh(d: torch.Tensor) -> torch.Tensor:
    """Real spherical harmonics of degrees 0-3 of unit directions [n, 3]
    (tiny-cuda-nn's order and constants) -> [n, 16]."""
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    return torch.stack([
        0.28209479177387814 * torch.ones_like(x),
        -0.48860251190291987 * y, 0.48860251190291987 * z,
        -0.48860251190291987 * x,
        1.0925484305920792 * x * y, -1.0925484305920792 * y * z,
        0.94617469575755997 * z * z - 0.31539156525251999,
        -1.0925484305920792 * x * z,
        0.54627421529603959 * (x * x - y * y),
        0.59004358992664352 * y * (-3.0 * x * x + y * y),
        2.8906114426405538 * x * y * z,
        0.45704579946446572 * y * (1.0 - 5.0 * z * z),
        0.3731763325901154 * z * (5.0 * z * z - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * z * z),
        1.4453057213202769 * z * (x * x - y * y),
        0.59004358992664352 * x * (-x * x + 3.0 * y * y)], 1)


def _dense(x: torch.Tensor, w: torch.Tensor, rnd: Rounding) -> torch.Tensor:
    return rnd(x) @ rnd(w).T


def density(p: Params, feat: torch.Tensor, rnd: Rounding = identity
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """sigma [n] and the density MLP's 16 outputs."""
    z = _dense(torch.relu(_dense(feat, p["sigma_w0"], rnd)), p["sigma_w1"],
               rnd)
    return torch.exp(z[:, 0].clamp(-SIGMA_CLAMP, SIGMA_CLAMP)), z


def color(p: Params, z: torch.Tensor, sh_s: torch.Tensor,
          rnd: Rounding = identity) -> torch.Tensor:
    h = torch.relu(_dense(torch.cat([z, sh_s], 1), p["color_w0"], rnd))
    h = torch.relu(_dense(h, p["color_w1"], rnd))
    return torch.sigmoid(_dense(h, p["color_w2"], rnd))


# ---------------------------------------------------------------- march


def lattice(o: torch.Tensor, d: torch.Tensor, u: torch.Tensor,
            bits: torch.Tensor, steps: int, grid: int, budget: float,
            scale: float = SCALE, offset: float = OFFSET
            ) -> Dict[str, torch.Tensor]:
    """Every ray's candidates on a dense [R, steps] lattice: their
    positions in the cube and t, the occupied ones (``occ``), each ray's
    count, and ``kept`` (the rays whose samples fit ``budget`` in ray
    order, their counts summed from the first ray)."""
    n = torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2])
    dirs = d / n[:, None]
    oc = o * scale + offset
    inv = 1.0 / dirs
    t0, t1 = (0.0 - oc) * inv, (1.0 - oc) * inv
    t_in = torch.fmin(t0, t1).amax(1).clamp(min=0.0)
    t_out = torch.fmax(t0, t1).amin(1)
    dt = math.sqrt(3.0) / steps
    k = torch.arange(steps, dtype=torch.float32, device=o.device)
    t = t_in[:, None] + (u[:, None] + k) * dt
    inside = (t < t_out[:, None]) & (t_out > t_in)[:, None]
    x = oc[:, None, :] + t[..., None] * dirs[:, None, :]
    cell = (x.clamp(0.0, 1.0) * float(grid)).floor().long().clamp(
        max=grid - 1)
    flat = cell[..., 0] + grid * cell[..., 1] + grid * grid * cell[..., 2]
    occ = inside & (bits[flat] != 0)
    count = occ.sum(1)
    end = torch.cumsum(count, 0)
    return dict(x=x, t=t, occ=occ, count=count, kept=end <= budget,
                dirs=dirs, dt=dt)


def render(p: Params, lv: List[Level], o, d, u, bits, steps: int, grid: int,
           budget: float = math.inf, rnd: Rounding = identity,
           scale: float = SCALE) -> Dict[str, torch.Tensor]:
    """Rays [R, 3] (world) -> ``rgb`` [R, 3] (0 for dropped rays), ``kept``
    [R], ``depth`` (world units) and ``acc`` [R]."""
    lat = lattice(o, d, u, bits, steps, grid, budget, scale)
    sel = lat["occ"] & lat["kept"][:, None]
    R, S = sel.shape
    ray = torch.arange(R, device=o.device)[:, None].expand(R, S)[sel]
    feat = encode(p, lv, lat["x"][sel])
    sigma, z = density(p, feat, rnd)
    rgb = color(p, z, sh(lat["dirs"])[ray], rnd)
    dt = lat["dt"]
    sig_l = torch.zeros(R, S, device=o.device).masked_scatter(sel, sigma)
    rgb_l = torch.zeros(R, S, 3, device=o.device).masked_scatter(
        sel[..., None].expand(R, S, 3), rgb)
    e = torch.exp(-(sig_l * dt))
    T_after = torch.cumprod(e, 1)
    T = torch.cat([torch.ones_like(T_after[:, :1]), T_after[:, :-1]], 1)
    w = T * (1.0 - e)
    k = lat["kept"].float()
    out = ((w[..., None] * rgb_l).sum(1) + T_after[:, -1:] * WHITE) * k[:, None]
    depth = (w * lat["t"]).sum(1) / scale * k
    return dict(rgb=out, kept=lat["kept"], depth=depth,
                acc=(1.0 - T_after[:, -1]) * k, n_samples=sel.sum())


def loss_and_grads(params: Params, lv: List[Level], o, d, u, target, bits,
                   steps: int, grid: int, rnd: Rounding = identity):
    """The MSE of the rays' colours (every sample of every ray) and its
    gradient by every parameter -> (loss, grads)."""
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    out = render(leaves, lv, o, d, u, bits, steps, grid, rnd=rnd)
    loss = ((out["rgb"] - target) ** 2).mean()
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


# ------------------------------------------------------------- training


class Adam:
    """Adam with bias correction and L2 (``l2``: name -> coefficient,
    added to that parameter's gradient)."""

    def __init__(self, params: Params, b1: float = BETAS[0],
                 b2: float = BETAS[1], eps: float = EPS,
                 l2: Optional[Dict[str, float]] = None):
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.b1, self.b2, self.eps, self.t = b1, b2, eps, 0
        self.l2 = l2 or {}

    def with_l2(self, params: Params, grads: Params) -> Params:
        return {k: g + self.l2[k] * params[k] if k in self.l2 else g
                for k, g in grads.items()}

    def step(self, params: Params, grads: Params, lr: float) -> None:
        """``grads`` already hold the L2 terms (``with_l2``)."""
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for k, g in grads.items():
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = (self.v[k] / c2).sqrt_().add_(self.eps)
            params[k].sub_(lr * (self.m[k] / c1) / denom)


def lr_at(step: int, lr: float, start: int = LR_DECAY_START,
          every: int = LR_DECAY_EVERY, decay: float = LR_DECAY) -> float:
    """Instant-NGP's schedule: x ``decay`` at ``start`` and every
    ``every`` steps after it."""
    return lr if step < start else lr * decay ** ((step - start) // every
                                                 + 1)


@torch.no_grad()
def grid_cells(bits: torch.Tensor, step: int, grid: int, warmup: int,
               generator: torch.Generator) -> torch.Tensor:
    """The cells an update after ``step`` updates samples, ``bits`` the
    occupancy before it (see ``grid_update``): the first of its draws."""
    g3, dev = grid ** 3, bits.device
    if step < warmup:
        return torch.arange(g3, device=dev)
    half = g3 // 4
    uniform = torch.randint(0, g3, (half,), generator=generator, device=dev)
    pick = torch.rand(half, generator=generator, device=dev)
    occupied = torch.nonzero(bits).reshape(-1)
    if not occupied.numel():
        return torch.cat([uniform, uniform])
    k = (pick * occupied.numel()).long().clamp(max=occupied.numel() - 1)
    return torch.cat([uniform, occupied[k]])


def grid_update(p: Params, lv: List[Level], values: torch.Tensor,
                bits: torch.Tensor, step: int, grid: int, steps: int,
                warmup: int, generator: torch.Generator,
                decay: float = GRID_DECAY, thresh: float = GRID_THRESH,
                block: int = 1 << 18, rnd: Rounding = identity
                ) -> torch.Tensor:
    """One occupancy-grid update in place of ``values`` [G^3] (x fastest)
    after ``step`` updates, ``bits`` the occupancy before it: decay, then
    the sampled cells take the larger of their value and sigma dt at a
    uniform point of the cell (before ``warmup`` every cell; after it G^3
    / 2 cells, half uniform, half among the occupied cells in index order,
    picked as floor(u n_occupied)) -> the new occupancy (uint8, above
    min(``thresh``, the mean value)).  The draws, from ``generator``: the
    uniform cells, the picks, then the jitter.  ``rnd``: the density's
    operand rounding."""
    cells = grid_cells(bits, step, grid, warmup, generator)
    jitter = torch.rand((cells.shape[0], 3), generator=generator,
                        device=values.device)
    ijk = torch.stack([cells % grid, (cells // grid) % grid,
                       cells // (grid * grid)], 1)
    x = (ijk.float() + jitter) / grid
    new = torch.cat([density(p, encode(p, lv, x[a:a + block]), rnd)[0]
                     for a in range(0, x.shape[0], block)])
    values.mul_(decay)
    values.scatter_reduce_(0, cells, new * (math.sqrt(3.0) / steps),
                           reduce="amax")
    return (values > min(thresh, float(values.mean()))).to(torch.uint8)
