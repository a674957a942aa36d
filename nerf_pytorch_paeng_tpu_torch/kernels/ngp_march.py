"""Instant-NGP's ray marcher with an in-order sample budget and the
compositing of the marched samples: the CUDA kernels of
``csrc/ngp_march.cu`` and their plain PyTorch twins.

``march(rays_o, rays_d, u, bits, params)`` -> ``Marched``: each ray's
kept-sample count and offset, ``stats`` (int32 [2] on the device: the
kept rays, a prefix in ray order, and their samples) and the samples in
ray order: positions [B, 3] in the unit cube, t [B] and ray index [B]
(int32), and each sample's ray's direction in the 16 real spherical
harmonics of degrees 0-3 [B, 16] (``sh_encode``), B = ``params.budget``.
Slots past ``stats[1]`` hold zeros (the plain version) or what the
buffers held (the kernel: positions, t and SH are left unwritten, ray
indices are zero); nothing reads them as samples.  No host read on the
card.

``composite_fwd(sigma, rgb, counts, offsets, params, ts=None)`` -> (rgb
[R, 3], depth [R] or None, acc [R] or None) over each kept ray's samples
onto the white background (dropped rays: 0), and ``composite_bwd`` its
gradient in sigma and rgb (``ops/ngp.Composite`` puts them under
autograd; the plain version is differentiable as it stands).

The kernels' launch counters: ``march.launches`` (one count, scan and
compact each), ``composite_fwd.launches``, ``composite_bwd.launches``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch

WHITE = 1.0
# the scene map into the unit cube, x = CUBE_SCALE p + CUBE_OFFSET
# (Instant-NGP's NeRF-synthetic scale and offset: world [-1.5, 1.5]^3)
CUBE_SCALE, CUBE_OFFSET = 0.33, 0.5
MAX_STEPS = 1024            # a ray's lattice: dt = sqrt(3) / 1024


@dataclass(frozen=True)
class MarchParams:
    """The marcher's constants: the cube map (scale, offset), the step
    dt = sqrt(3) / max_steps, the grid's resolution and the budget."""
    scale: float
    offset: float
    max_steps: int
    grid_res: int
    budget: int

    @property
    def dt(self) -> float:
        return math.sqrt(3.0) / self.max_steps

    @classmethod
    def from_cfg(cls, cfg, budget: Optional[int] = None) -> "MarchParams":
        return cls(CUBE_SCALE, CUBE_OFFSET, MAX_STEPS, int(cfg.ngp_grid_res),
                   int(budget if budget is not None else cfg.ngp_budget))


class _CParams(ctypes.Structure):
    """``struct MarchParams`` of ``csrc/ngp_march.cu``, passed by value."""
    _fields_ = [("scale", ctypes.c_float), ("offset", ctypes.c_float),
                ("dt", ctypes.c_float), ("max_steps", ctypes.c_int),
                ("grid_res", ctypes.c_int), ("budget", ctypes.c_int)]


def _c_params(p: MarchParams) -> _CParams:
    return _CParams(p.scale, p.offset, p.dt, p.max_steps, p.grid_res,
                    p.budget)


class Marched(NamedTuple):
    counts: torch.Tensor       # [R] int32: occupied candidates of each ray
    offsets: torch.Tensor      # [R] int32: exclusive prefix sum
    stats: torch.Tensor        # [2] int32: kept rays, their samples
    pos: torch.Tensor          # [B, 3] float32, in the unit cube
    ts: torch.Tensor           # [B] float32
    ray_idx: torch.Tensor      # [B] int32
    sh: torch.Tensor           # [B, 16] float32: the sample's ray's SH


def sh_encode(d: torch.Tensor) -> torch.Tensor:
    """The 16 real spherical harmonics of degrees 0-3 of unit directions
    [R, 3] (tiny-cuda-nn's constants and order) -> [R, 16], rounded op by
    op as the compaction kernel computes them."""
    x, y, z = d.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    return torch.stack([
        torch.full_like(x, 0.28209479177387814),
        -0.48860251190291987 * y,
        0.48860251190291987 * z,
        -0.48860251190291987 * x,
        1.0925484305920792 * x * y,
        -1.0925484305920792 * y * z,
        0.94617469575755997 * zz - 0.31539156525251999,
        -1.0925484305920792 * x * z,
        0.54627421529603959 * (xx - yy),
        0.59004358992664352 * y * (-3.0 * xx + yy),
        2.8906114426405538 * x * y * z,
        0.45704579946446572 * y * (1.0 - 5.0 * zz),
        0.3731763325901154 * z * (5.0 * zz - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * zz),
        1.4453057213202769 * z * (xx - yy),
        0.59004358992664352 * x * (-xx + 3.0 * yy)], -1)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """csrc/ngp_march.cu, built at first use, with its C signatures."""
    from . import build
    lib = build.load("ngp_march")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ngp_march.argtypes = [p, p, p, i, p, _CParams, p, p, p, p, p, p, p,
                              p]
    lib.ngp_composite_fwd.argtypes = [p, p, p, p, p, i, i, f, f, p, p, p, p]
    lib.ngp_composite_bwd.argtypes = [p, p, p, p, i, i, f, p, p, p, p, p]
    for fn in (lib.ngp_march, lib.ngp_composite_fwd, lib.ngp_composite_bwd,
               lib.ngp_march_params_bytes):
        fn.restype = i
    if lib.ngp_march_params_bytes() != ctypes.sizeof(_CParams):
        raise RuntimeError("ngp_march.cu's MarchParams differs from ctypes'")
    return lib


def _raise_on(rc: int, fn: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA error {rc} at launch")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _device(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"NGP marcher on CUDA or CPU, not {t.device}")
    return t.device.type


# ---------------------------------------------------------------- march


def ray_chords(rays_o: torch.Tensor, rays_d: torch.Tensor, p: MarchParams
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """Cube origins o' [R, 3], unit directions [R, 3] and the chord
    [t_in, t_out] of [0,1]^3, rounded op by op as the kernel is."""
    d = rays_d
    norm = torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
                      + d[:, 2] * d[:, 2])
    d = d / norm[:, None]
    o = rays_o * p.scale + p.offset
    inv = 1.0 / d
    t0 = (0.0 - o) * inv
    t1 = (1.0 - o) * inv
    t_in = torch.fmin(t0, t1).amax(1).clamp(min=0.0)
    t_out = torch.fmax(t0, t1).amin(1)
    return o, d, t_in, t_out


def march_plain(rays_o: torch.Tensor, rays_d: torch.Tensor, u: torch.Tensor,
                bits: torch.Tensor, p: MarchParams) -> Marched:
    """The marcher as a dense [R, max_steps] lattice with the same
    in-order budget cut."""
    dev = rays_o.device
    R = rays_o.shape[0]
    o, d, t_in, t_out = ray_chords(rays_o, rays_d, p)
    k = torch.arange(p.max_steps, dtype=torch.float32, device=dev)
    t = t_in[:, None] + (u.reshape(R, 1) + k) * p.dt
    inside = (t < t_out[:, None]) & (t_out > t_in)[:, None]
    x = o[:, None, :] + t[..., None] * d[:, None, :]
    g = p.grid_res
    cell = (x.clamp(0.0, 1.0) * float(g)).floor().long().clamp(max=g - 1)
    flat = cell[..., 0] + g * (cell[..., 1] + g * cell[..., 2])
    occ = inside & (bits.reshape(-1)[flat] != 0)
    counts = occ.sum(1)
    offsets = torch.cumsum(counts, 0) - counts
    kept = offsets + counts <= p.budget
    sel = occ & kept[:, None]
    n = int(sel.sum())
    pos = torch.zeros((p.budget, 3), device=dev)
    ts = torch.zeros(p.budget, device=dev)
    ray_idx = torch.zeros(p.budget, dtype=torch.int32, device=dev)
    pos[:n] = x[sel]
    ts[:n] = t[sel]
    ray_idx[:n] = torch.arange(R, dtype=torch.int32, device=dev)[
        :, None].expand(R, p.max_steps)[sel]
    sh = torch.zeros((p.budget, 16), device=dev)
    sh[:n] = sh_encode(d)[ray_idx[:n].long()]
    stats = torch.stack([kept.sum(), counts[kept].sum()]).to(torch.int32)
    return Marched(counts.to(torch.int32), offsets.to(torch.int32), stats,
                   pos, ts, ray_idx, sh)


def march(rays_o: torch.Tensor, rays_d: torch.Tensor, u: torch.Tensor,
          bits: torch.Tensor, p: MarchParams) -> Marched:
    """Rays [R, 3] (world), their uniforms [R], the grid's occupancy
    [G^3] uint8 (x fastest) -> ``Marched``."""
    if _device(rays_o) == "cpu":
        return march_plain(rays_o, rays_d, u, bits, p)
    if bits.dtype != torch.uint8 or bits.numel() != p.grid_res ** 3:
        raise ValueError("bits: uint8 [grid_res^3]")
    dev, R = rays_o.device, rays_o.shape[0]
    rays_o, rays_d = rays_o.contiguous(), rays_d.contiguous()
    u = u.reshape(R).contiguous()
    counts = torch.empty(R, dtype=torch.int32, device=dev)
    offsets = torch.empty(R, dtype=torch.int32, device=dev)
    stats = torch.empty(2, dtype=torch.int32, device=dev)
    pos = torch.empty((p.budget, 3), device=dev)
    ts = torch.empty(p.budget, device=dev)
    ray_idx = torch.zeros(p.budget, dtype=torch.int32, device=dev)
    sh = torch.empty((p.budget, 16), device=dev)
    rc = _library().ngp_march(
        rays_o.data_ptr(), rays_d.data_ptr(), u.data_ptr(), R,
        bits.data_ptr(), _c_params(p), counts.data_ptr(), offsets.data_ptr(),
        stats.data_ptr(), pos.data_ptr(), ts.data_ptr(), ray_idx.data_ptr(),
        sh.data_ptr(), _stream(rays_o))
    _raise_on(rc, "ngp_march")
    march.launches += 1
    return Marched(counts, offsets, stats, pos, ts, ray_idx, sh)


march.launches = 0


# ------------------------------------------------------------ composite


def _lattice(values: torch.Tensor, counts: torch.Tensor,
             offsets: torch.Tensor, kept: torch.Tensor, fill: float
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-sample values [B, ...] laid out [R, S] by ray (S the longest
    kept ray), ``fill`` elsewhere; also the slot mask and each slot's
    sample index."""
    R = counts.shape[0]
    c = torch.where(kept, counts.long(), torch.zeros_like(counts.long()))
    S = max(int(c.max()) if R else 0, 1)
    j = torch.arange(S, device=values.device)
    mask = j[None, :] < c[:, None]
    idx = (offsets.long()[:, None] + j[None, :]).clamp(
        max=max(values.shape[0] - 1, 0))
    shape = (R, S) + tuple(values.shape[1:])
    out = torch.full(shape, fill, dtype=values.dtype, device=values.device)
    m = mask.reshape(R, S, *([1] * (values.dim() - 1)))
    out = torch.where(m, values[idx], out)
    return out, mask, idx


def composite_plain(sigma: torch.Tensor, rgb: torch.Tensor,
                    counts: torch.Tensor, offsets: torch.Tensor,
                    p: MarchParams, ts: Optional[torch.Tensor] = None):
    """The compositing in plain PyTorch (differentiable in sigma and
    rgb)."""
    kept = offsets.long() + counts.long() <= p.budget
    e_s, mask, _ = _lattice(torch.exp(-(sigma * p.dt)), counts, offsets,
                            kept, 1.0)
    c_s, _, _ = _lattice(rgb, counts, offsets, kept, 0.0)
    T_after = torch.cumprod(e_s, 1)
    T = torch.cat([torch.ones_like(T_after[:, :1]), T_after[:, :-1]], 1)
    w = torch.where(mask, T * (1.0 - e_s), torch.zeros_like(e_s))
    T_end = T_after[:, -1]
    k = kept.to(sigma.dtype)
    out = ((w[..., None] * c_s).sum(1) + T_end[:, None] * WHITE) * k[:, None]
    depth = acc = None
    if ts is not None:
        t_s, _, _ = _lattice(ts, counts, offsets, kept, 0.0)
        depth = (w * t_s).sum(1) * k
        acc = (1.0 - T_end) * k
    return out, depth, acc


def composite_fwd(sigma: torch.Tensor, rgb: torch.Tensor,
                  counts: torch.Tensor, offsets: torch.Tensor,
                  p: MarchParams, ts: Optional[torch.Tensor] = None):
    """sigma [B], rgb [B, 3] float32 -> (rgb [R, 3], depth, acc); depth
    and acc only with ``ts``."""
    if _device(sigma) == "cpu":
        return composite_plain(sigma, rgb, counts, offsets, p, ts)
    R = counts.shape[0]
    out = torch.empty((R, 3), device=sigma.device)
    depth = torch.empty(R, device=sigma.device) if ts is not None else None
    acc = torch.empty(R, device=sigma.device) if ts is not None else None
    rc = _library().ngp_composite_fwd(
        sigma.contiguous().data_ptr(), rgb.contiguous().data_ptr(),
        None if ts is None else ts.data_ptr(), counts.data_ptr(),
        offsets.data_ptr(), R, p.budget, p.dt, WHITE, out.data_ptr(),
        None if depth is None else depth.data_ptr(),
        None if acc is None else acc.data_ptr(), _stream(sigma))
    _raise_on(rc, "ngp_composite_fwd")
    composite_fwd.launches += 1
    return out, depth, acc


def composite_bwd(sigma: torch.Tensor, rgb: torch.Tensor,
                  counts: torch.Tensor, offsets: torch.Tensor,
                  p: MarchParams, out: torch.Tensor, g_out: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradient in (sigma, rgb) of the composited ``out`` [R, 3]
    given its gradient ``g_out``: the kernel (CUDA tensors only)."""
    g_sigma = torch.zeros_like(sigma)
    g_rgb = torch.zeros_like(rgb)
    rc = _library().ngp_composite_bwd(
        sigma.contiguous().data_ptr(), rgb.contiguous().data_ptr(),
        counts.data_ptr(), offsets.data_ptr(), counts.shape[0], p.budget,
        p.dt, out.data_ptr(), g_out.contiguous().data_ptr(),
        g_sigma.data_ptr(), g_rgb.data_ptr(), _stream(sigma))
    _raise_on(rc, "ngp_composite_bwd")
    composite_bwd.launches += 1
    return g_sigma, g_rgb


composite_fwd.launches = composite_bwd.launches = 0
