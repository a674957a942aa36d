"""Instant-NGP's NeRF (Mueller, Evans, Schied, Keller, "Instant Neural
Graphics Primitives with a Multiresolution Hash Encoding", SIGGRAPH 2022,
arXiv:2201.05989) as an ``nn.Module`` with its occupancy grid as state.

The equations, as the port computes them (``port_bench/reference/ngp.py``
computes the same in plain float32; items marked *assumed* are listed in
``port_bench/configs/ngp_lego.json``):

- Scene map: a world point p maps to x = 0.33 p + 0.5 in the unit cube
  (``kernels/ngp_march.CUBE_SCALE``, ``CUBE_OFFSET``: world [-1.5,
  1.5]^3); nothing outside [0,1]^3 is sampled.
- Hash encoding (``kernels/hash_grid.py``): L = 16 levels of F = 2
  features, tables of T = 2^19 entries, N_min = 16, N_max = 2048
  (*assumed*: the paper's NeRF-synthetic value).  Level l has resolution
  N_l = floor(N_min b^l), b = exp((ln N_max - ln N_min) / (L - 1)).  A
  point's corners are floor(x N_l) + {0,1}^3 (*assumed*: x N_l without
  tiny-cuda-nn's +0.5; the floor clamped to N_l - 1 so that x = 1 takes
  the upper corner); corner c's entry is c_x + c_y (N_l+1) + c_z
  (N_l+1)^2 where (N_l+1)^3 <= T (levels 0-4, sizes not rounded up to
  multiples of 8, *assumed*), else (c_x 1 xor c_y 2654435761 xor c_z
  805459861) mod T in uint32.  Features: the trilinear interpolation of
  the 8 corners' F-vectors, the levels concatenated (32).  6,098,925
  entries, 12,197,850 parameters, one parameter a level
  (``tables.<l>``), initialised U(-1e-4, 1e-4).
- Density MLP: 32 -> 64 (ReLU) -> 16, no biases (*assumed*, as
  tiny-cuda-nn's fully fused MLP); sigma = exp(z_0), its argument clamped
  to [-15, 15] (*assumed*: Instant-NGP's clamp, which also zeroes the
  gradient outside).
- Colour MLP: [z (16), SH(d) (16)] -> 64 (ReLU) -> 64 (ReLU) -> 3, then a
  sigmoid; no biases.  SH(d): the 16 real spherical harmonics of degrees
  0-3 of the unit view direction (tiny-cuda-nn's constants), written for
  each sample by the marcher (``kernels/ngp_march.sh_encode``).
  Both MLPs: 9,408 multiply-adds a sample; weights Xavier-uniform
  (*assumed*, tiny-cuda-nn's initialisation); operands in
  ``compute_dtype``, float32 accumulation.
- Marcher (``kernels/ngp_march.py``): the ray's chord [t_in, t_out] of the
  cube, dt = sqrt(3) / 1024, candidates t_k = t_in + (u + k) dt (k < 1024,
  t_k < t_out, u the ray's uniform), kept where the 128^3 grid's cell is
  occupied (*assumed*: fixed lattice steps, no jump to the next occupied
  cell); at most B = 2^18 samples a step, the rays in order: a ray whose
  samples would pass B is dropped and enters no loss term (deterministic,
  where Instant-NGP's atomic counter is not).
- Compositing (``ops/ngp.py``): alpha_k = 1 - exp(-sigma_k dt), T_k =
  prod_{j<k} (1 - alpha_j), C = sum T_k alpha_k c_k + T_end white; the
  loss the MSE over the kept rays (*assumed*); the backward over every kept
  sample (*assumed*: no second compaction at transmittance 1e-4).
- Occupancy grid: 128^3 cells over the cube, each an estimate of sigma dt,
  occupied above min(0.01, the grid's mean).  Updated every 16 steps from
  step 16 on (*assumed*: the paper starts at step 0): every cell decays by
  0.95, then the sampled cells take max(decayed, sigma(a uniform point in
  the cell) dt); before step 256 every cell is sampled, from then on
  2^20: half uniformly, half among the occupied cells.  The bitfield
  starts full, the values at 0.  Buffers ``grid_values`` and
  ``grid_bits`` (x fastest), saved in the state dict.
- Optimizer (``train/state.py``): Adam (fused on the card), lr 1e-2,
  betas (0.9, 0.99), eps 1e-15, L2 1e-6 on the MLP weights only; the lr x0.33 every 10k steps
  from step 20k (``train/schedule.py``); no weight EMA (*assumed*).
- Precision: tables and features in float32, the MLPs in ``compute_dtype``;
  the encoding's backward scatters by float32 atomics, so a trajectory on
  the card is not bit-reproducible run to run (NeRF's fixed-order K2 is).
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
from torch import nn

from ..kernels.hash_grid import hash_encode
from ..kernels.ngp_march import MAX_STEPS
from ..utils.device import resolve_device
from ..utils.spans import span

N_MIN, N_MAX = 16, 2048     # the coarsest and finest levels' resolutions
WIDTH = 64                  # both MLPs' hidden width
GEO_FEAT = 16               # the density MLP's outputs
SH_DIM = 16                 # degrees 0-3
TABLE_INIT = 1e-4
SIGMA_CLAMP = 15.0
GRID_DECAY, GRID_THRESH = 0.95, 0.01
# an update every 16 steps, of every cell before step 256, half after
GRID_EVERY, GRID_WARMUP = 16, 256
GRID_CHUNK = 1 << 18        # points a density evaluation of the grid update
# Adam and its schedule (train/state.py, train/schedule.py)
ADAM_BETAS, ADAM_EPS, MLP_L2 = (0.9, 0.99), 1e-15, 1e-6
LR_DECAY_START, LR_DECAY_EVERY, LR_DECAY = 20000, 10000, 0.33

MLP_WEIGHTS = ("sigma_w0", "sigma_w1", "color_w0", "color_w1", "color_w2")


def hash_levels(cfg) -> List[Tuple[int, int, bool]]:
    """Each level's (resolution N_l, entries, dense)."""
    L, T = int(cfg.ngp_levels), 1 << int(cfg.ngp_log2_table)
    n_min, n_max = float(N_MIN), float(N_MAX)
    b = math.exp((math.log(n_max) - math.log(n_min)) / max(L - 1, 1))
    out = []
    for l in range(L):
        res = int(math.floor(n_min * b ** l))
        dense = (res + 1) ** 3 <= T
        out.append((res, (res + 1) ** 3 if dense else T, dense))
    return out


def march_dt() -> float:
    return math.sqrt(3.0) / MAX_STEPS


def _mm(x: torch.Tensor, w: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    return torch.nn.functional.linear(x.to(cdt), w.to(cdt))


class NGP(nn.Module):
    """The hash tables, the two bias-free MLPs and the occupancy grid."""

    def __init__(self, cfg):
        super().__init__()
        self.levels = hash_levels(cfg)
        width, n_feat = WIDTH, 2 * len(self.levels)
        self.tables = nn.ParameterList(
            nn.Parameter(torch.zeros(size, 2)) for _, size, _ in self.levels)
        self.sigma_w0 = nn.Parameter(torch.zeros(width, n_feat))
        self.sigma_w1 = nn.Parameter(torch.zeros(GEO_FEAT, width))
        self.color_w0 = nn.Parameter(torch.zeros(width, GEO_FEAT + SH_DIM))
        self.color_w1 = nn.Parameter(torch.zeros(width, width))
        self.color_w2 = nn.Parameter(torch.zeros(3, width))
        g3 = int(cfg.ngp_grid_res) ** 3
        self.register_buffer("grid_values", torch.zeros(g3))
        self.register_buffer("grid_bits", torch.ones(g3, dtype=torch.uint8))
        self.cdt = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
                    else torch.float32)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> "NGP":
        """Tables U(-1e-4, 1e-4), MLP weights Xavier-uniform, drawn in
        that order from ``generator``; a full grid."""
        for t in self.tables:
            t.copy_((torch.rand(t.shape, generator=generator,
                                device=t.device) * 2.0 - 1.0) * TABLE_INIT)
        for name in MLP_WEIGHTS:
            w = getattr(self, name)
            a = math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
            w.copy_((torch.rand(w.shape, generator=generator,
                                device=w.device) * 2.0 - 1.0) * a)
        self.grid_values.zero_()
        self.grid_bits.fill_(1)
        return self

    def mlp_parameters(self) -> List[nn.Parameter]:
        return [getattr(self, n) for n in MLP_WEIGHTS]

    def encode(self, x: torch.Tensor, n_valid: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
        with span("ngp.encode"):
            return hash_encode(x, list(self.tables), self.levels, n_valid)

    def density_mlp(self, feat: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Features [n, 32] -> (sigma [n] float32, z [n, 16])."""
        h = torch.relu(_mm(feat, self.sigma_w0, self.cdt))
        z = _mm(h, self.sigma_w1, self.cdt)
        sigma = torch.exp(z[:, 0].float().clamp(-SIGMA_CLAMP, SIGMA_CLAMP))
        return sigma, z

    def color_mlp(self, z: torch.Tensor, sh: torch.Tensor) -> torch.Tensor:
        """z [n, 16], SH [n, 16] -> rgb [n, 3] float32 in (0, 1)."""
        h = torch.relu(_mm(torch.cat([z.to(self.cdt), sh.to(self.cdt)], 1),
                           self.color_w0, self.cdt))
        h = torch.relu(_mm(h, self.color_w1, self.cdt))
        return torch.sigmoid(_mm(h, self.color_w2, self.cdt).float())

    def field(self, pos: torch.Tensor, sh: torch.Tensor,
              n_valid: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Samples in the cube [n, 3] and their rays' SH [n, 16] -> (sigma
        [n], rgb [n, 3])."""
        feat = self.encode(pos, n_valid)
        with span("ngp.mlp"):
            sigma, z = self.density_mlp(feat)
            return sigma, self.color_mlp(z, sh)

    @torch.no_grad()
    def density(self, pos: torch.Tensor) -> torch.Tensor:
        """sigma [n] at points of the cube, in blocks of ``GRID_CHUNK``."""
        out = torch.empty(pos.shape[0], device=pos.device)
        for a in range(0, pos.shape[0], GRID_CHUNK):
            out[a:a + GRID_CHUNK] = self.density_mlp(
                self.encode(pos[a:a + GRID_CHUNK]))[0]
        return out


def init_ngp(cfg, device=None, seed: Optional[int] = None) -> NGP:
    """A fresh NGP drawn from ``seed`` (``cfg.seed``) on ``device``."""
    device = resolve_device(device if device is not None else cfg.device)
    model = NGP(cfg).to(device)
    gen = torch.Generator(device=device).manual_seed(
        cfg.seed if seed is None else seed)
    return model.reset_parameters(gen)


# ------------------------------------------------------- occupancy grid


def grid_update_due(i: int) -> bool:
    """Whether the grid is updated before train iteration ``i`` (1-based;
    ``i - 1`` updates completed): every ``GRID_EVERY`` from that step
    on."""
    every, done = GRID_EVERY, i - 1
    return done >= every and done % every == 0


def next_grid_update(i: int) -> int:
    """The first iteration after ``i`` before which the grid is
    updated."""
    every = GRID_EVERY
    return ((i - 1) // every + 1) * every + 1


@torch.no_grad()
def update_occupancy_grid(model: NGP, cfg, step: int,
                          generator: torch.Generator) -> None:
    """One update of the grid after ``step`` completed updates (see the
    module docstring); its draws from ``generator``: before
    ``GRID_WARMUP`` the cells' jitter [G^3, 3]; after it the uniform
    cells [n/2], then the uniforms [n/2] that pick among the occupied
    cells (in index order), then the jitter [n, 3].  No host read."""
    vals, bits = model.grid_values, model.grid_bits
    g = int(cfg.ngp_grid_res)
    g3, dev = g ** 3, vals.device
    if step < GRID_WARMUP:
        cells = torch.arange(g3, device=dev)
    else:
        half = g3 // 4
        uniform = torch.randint(0, g3, (half,), generator=generator,
                                device=dev)
        pick = torch.rand(half, generator=generator, device=dev)
        cells = torch.cat([uniform, occupied_pick(bits, pick, uniform)])
    jitter = torch.rand((cells.shape[0], 3), generator=generator, device=dev)
    ijk = torch.stack([cells % g, (cells // g) % g, cells // (g * g)], 1)
    pos = (ijk.float() + jitter) / float(g)
    new = model.density(pos) * march_dt()
    vals.mul_(GRID_DECAY)
    vals.scatter_reduce_(0, cells, new, reduce="amax")
    thresh = torch.clamp(vals.mean(), max=GRID_THRESH)
    bits.copy_((vals > thresh).to(torch.uint8))


def occupied_pick(bits: torch.Tensor, u: torch.Tensor,
                  fallback: torch.Tensor) -> torch.Tensor:
    """Cells among the occupied ones (in index order), the i-th at
    floor(u_i n_occ); ``fallback`` where no cell is occupied."""
    g3 = bits.numel()
    occ = bits.reshape(-1) != 0
    rank = torch.cumsum(occ.long(), 0) - 1
    n_occ = rank[-1] + 1
    cells = torch.arange(g3, device=bits.device)
    # occupied cells to their rank, the others each to a slot of its own
    # past them (no two writes to one address)
    listing = torch.empty(2 * g3, dtype=torch.long, device=bits.device)
    listing.scatter_(0, torch.where(occ, rank, g3 + cells), cells)
    k = (u * n_occ.float()).long().clamp(min=0)
    k = torch.minimum(k, (n_occ - 1).clamp(min=0))
    return torch.where(n_occ > 0, listing[k], fallback)
