"""Instant-NGP's multiresolution hash encoding: the CUDA kernels of
``csrc/hash_grid.cu`` and their plain PyTorch twins.

``hash_encode(x, tables, levels, n_valid=None)`` -> features [n, L * 2]
float32, differentiable in the tables (``HashEncode``): on a CUDA tensor
the forward kernel, and in the backward the atomic scatter into one flat
gradient whose per-level views are the tables' gradients; on a CPU
tensor ``hash_encode_plain`` under autograd.  ``levels`` is
``models/ngp.hash_levels``' list of ``(res, size, dense)``.  Points at or
past ``n_valid`` (a one-element int32 device tensor: the marcher's kept
sample count) encode to zero and take no gradient.

Each wrapper counts its launches (``.launches``) and the points it
encoded (``.points``), as ``kernels.LAUNCH_COUNTERS`` lists them.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence, Tuple

import torch

MAX_LEVELS = 16
PRIMES = (1, 2654435761, 805459861)
Level = Tuple[int, int, bool]             # (res, entries, dense)


class _HashLevels(ctypes.Structure):
    """``struct HashLevels`` of ``csrc/hash_grid.cu``, passed by value."""
    _fields_ = [("table", ctypes.c_void_p * MAX_LEVELS),
                ("grad", ctypes.c_void_p),
                ("offset", ctypes.c_int * MAX_LEVELS),
                ("res", ctypes.c_int * MAX_LEVELS),
                ("size", ctypes.c_int * MAX_LEVELS),
                ("dense", ctypes.c_int * MAX_LEVELS),
                ("n_levels", ctypes.c_int)]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """csrc/hash_grid.cu, built at first use, with its C signatures."""
    from . import build
    lib = build.load("hash_grid")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ngp_hash_encode_fwd.argtypes = [p, i, p, _HashLevels, p, p]
    lib.ngp_hash_encode_bwd.argtypes = [p, i, p, _HashLevels, p, p]
    lib.ngp_hash_encode_fwd.restype = lib.ngp_hash_encode_bwd.restype = i
    lib.ngp_hash_levels_bytes.restype = i
    if lib.ngp_hash_levels_bytes() != ctypes.sizeof(_HashLevels):
        raise RuntimeError("hash_grid.cu's HashLevels differs from ctypes'")
    return lib


def _raise_on(rc: int, fn: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA error {rc} at launch")


def _levels_struct(tables: Sequence[torch.Tensor], levels: Sequence[Level],
                   grad: Optional[torch.Tensor] = None) -> _HashLevels:
    lv = _HashLevels()
    off = 0
    for l, ((res, size, dense), t) in enumerate(zip(levels, tables)):
        lv.table[l] = t.data_ptr()
        lv.offset[l], lv.res[l], lv.size[l] = off, res, size
        lv.dense[l] = int(dense)
        off += size
    lv.grad = None if grad is None else grad.data_ptr()
    lv.n_levels = len(levels)
    return lv


def _check(x: torch.Tensor, tables: Sequence[torch.Tensor],
           levels: Sequence[Level]) -> None:
    if x.dim() != 2 or x.shape[1] != 3 or x.dtype != torch.float32:
        raise ValueError(f"points [n, 3] float32, got {tuple(x.shape)} "
                         f"{x.dtype}")
    if len(tables) != len(levels) or not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"{len(tables)} tables for {len(levels)} levels")
    for t, (_, size, dense) in zip(tables, levels):
        if tuple(t.shape) != (size, 2) or t.dtype != torch.float32:
            raise ValueError(f"a table [{size}, 2] float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if not dense and size & (size - 1):
            raise ValueError(f"a hashed level's size {size} is not a power "
                             "of two")


def corner_indices(c: torch.Tensor, level: Level) -> torch.Tensor:
    """Integer corners [..., 3] (int64) -> their entries in the level's
    table: dense c_x + c_y (N+1) + c_z (N+1)^2, else the spatial hash mod
    T."""
    res, size, dense = level
    if dense:
        s = res + 1
        return c[..., 0] + c[..., 1] * s + c[..., 2] * (s * s)
    h = (c[..., 0] * PRIMES[0]) ^ (c[..., 1] * PRIMES[1]) ^ (
        c[..., 2] * PRIMES[2])
    return h & (size - 1)


def voxel(x: torch.Tensor, res: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The points' voxel at resolution ``res``: lower corner [n, 3] int64
    (floor(x res), clamped to res - 1) and the fractions [n, 3]."""
    s = x.clamp(0.0, 1.0) * float(res)
    fl = s.floor().clamp(max=res - 1)
    return fl.long(), s - fl


CORNERS = [((c & 1), (c >> 1) & 1, (c >> 2) & 1) for c in range(8)]


def hash_encode_plain(x: torch.Tensor, tables: Sequence[torch.Tensor],
                      levels: Sequence[Level],
                      n_valid: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """The encoding in plain PyTorch (differentiable in the tables): each
    level's 8 corners' features, trilinearly weighted and summed."""
    feats = []
    for level, table in zip(levels, tables):
        c0, fr = voxel(x, level[0])
        acc = x.new_zeros((x.shape[0], 2))
        for cx, cy, cz in CORNERS:
            c = c0 + torch.tensor([cx, cy, cz], device=x.device)
            wx = fr[:, 0] if cx else 1.0 - fr[:, 0]
            wy = fr[:, 1] if cy else 1.0 - fr[:, 1]
            wz = fr[:, 2] if cz else 1.0 - fr[:, 2]
            w = (wx * wy) * wz
            acc = acc + w[:, None] * table[corner_indices(c, level)]
        feats.append(acc)
    out = torch.cat(feats, 1)
    if n_valid is not None:
        keep = torch.arange(x.shape[0], device=x.device) < n_valid.reshape(
            ()).long()
        out = out * keep[:, None].to(out.dtype)
    return out


class HashEncode(torch.autograd.Function):
    """The kernels under autograd: the gradient of every table from one
    atomic scatter into a flat buffer."""

    @staticmethod
    def forward(ctx, x, n_valid, levels, *tables):
        out = torch.empty((x.shape[0], 2 * len(levels)), device=x.device)
        if x.shape[0]:
            rc = _library().ngp_hash_encode_fwd(
                x.data_ptr(), x.shape[0],
                None if n_valid is None else n_valid.data_ptr(),
                _levels_struct(tables, levels), out.data_ptr(),
                torch.cuda.current_stream(x.device).cuda_stream)
            _raise_on(rc, "ngp_hash_encode_fwd")
            hash_encode.launches += 1
            hash_encode.points += x.shape[0]
        ctx.save_for_backward(x, n_valid, *tables)
        ctx.levels = levels
        return out

    @staticmethod
    def backward(ctx, g):
        x, n_valid, *tables = ctx.saved_tensors
        levels = ctx.levels
        sizes = [size for _, size, _ in levels]
        flat = torch.zeros((sum(sizes), 2), device=x.device)
        if x.shape[0]:
            rc = _library().ngp_hash_encode_bwd(
                x.data_ptr(), x.shape[0],
                None if n_valid is None else n_valid.data_ptr(),
                _levels_struct(tables, levels, flat),
                g.contiguous().data_ptr(),
                torch.cuda.current_stream(x.device).cuda_stream)
            _raise_on(rc, "ngp_hash_encode_bwd")
            hash_encode_bwd.launches += 1
            hash_encode_bwd.points += x.shape[0]
        return (None, None, None, *torch.split(flat, sizes))


def hash_encode(x: torch.Tensor, tables: Sequence[torch.Tensor],
                levels: Sequence[Level],
                n_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Features [n, 2 L] of points x [n, 3] in [0,1]^3 (see the module
    docstring)."""
    _check(x, tables, levels)
    if x.device.type == "cpu":
        return hash_encode_plain(x, tables, levels, n_valid)
    if x.device.type != "cuda":
        raise RuntimeError(f"hash encoding on CUDA or CPU, not {x.device}")
    if n_valid is not None and n_valid.dtype != torch.int32:
        raise ValueError("n_valid is an int32 device tensor")
    return HashEncode.apply(x.contiguous(), n_valid, tuple(levels), *tables)


def hash_encode_bwd() -> None:
    """The backward kernel's counters (it runs inside ``HashEncode``)."""


hash_encode.launches = hash_encode.points = 0
hash_encode_bwd.launches = hash_encode_bwd.points = 0

__all__: List[str] = ["HashEncode", "hash_encode", "hash_encode_bwd",
                      "hash_encode_plain", "corner_indices", "voxel"]
