"""The training pairs of the fused NeRF MLP: along rays K1 forward, K2
backward, and the occupancy-gated pair K5 forward, K6 backward; at points
(the plane layout) K8 forward, K9 backward.

- ``fused_mlp_bwd_rays`` (source: ``csrc/fused_mlp_vjp.cu``) replaces the
  JAX package's ``kernels/fused_mlp_vjp.py::_bwd_rays_kernel``: it
  recomputes the forward of every sample from the rays and depths (nothing
  is kept from the forward pass) and returns float32 gradients of the
  packed weights and biases, summed over all samples of all rays.  Its
  plain PyTorch version ``fused_mlp_bwd_rays_plain`` follows
  ``_recompute_and_backprop`` step by step, with the same rounding points.
  With ``gate=`` (the layout of ``fused_mlp.py``'s gate) it is K6, which
  replaces ``_bwd_rays_kernel_gated``: the samples of every (128-ray tile,
  8-sample row) block whose entry is 0 add nothing, and are not computed.
- ``fused_mlp_train_rays`` pairs the full-field kernel
  (``fused_mlp.fused_mlp_eval_rays``, float32 outputs) with that backward
  in a ``torch.autograd.Function``: the differentiable float32 packing
  (``fused_mlp.pack_flat``) goes in, its gradients come out in the packed
  layout, and autograd carries them back to the module's parameters.  No
  input gradients: the rays are data and the depths carry no gradient.
  With ``gate=`` both directions are gated (K5 and K6); the gate is an
  int32 input without a gradient.
- ``fused_mlp_bwd`` (same source) replaces ``_bwd_kernel`` (K9): the same
  backward at the points of the position and direction planes [3, P],
  every point with its own direction, cotangents [4, P].  Its plain version
  ``fused_mlp_bwd_plain`` runs the same steps (``_backprop``) in chunks of
  points.  ``fused_mlp_train`` pairs it with ``fused_mlp.fused_mlp_eval``
  (K8, float32 outputs), as ``fused_mlp_train_rays`` does along rays.

Dispatch as in ``fused_mlp.py``: CPU tensors go to the plain version, CUDA
tensors to the kernel or the wrapper raises; ``fused_mlp_bwd_rays.launches``
counts K2's launches, ``fused_mlp_bwd_rays.gated_launches`` K6's and
``fused_mlp_bwd.launches`` K9's (one per call).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from ..ops.posenc import build_emb
from .fused_mlp import (B_TOTAL, EMBD_ROWS, EMBX_ROWS, W_TOTAL, _check,
                        _check_common, _check_planes, _cuda_lib, _ptr,
                        _raise_on, _with_views, fused_mlp_eval,
                        fused_mlp_eval_rays, gate_mask)


def _grads_check(z_t, grads):
    for name, g in zip("rgbs", grads):
        if (g.shape != z_t.shape or g.dtype != torch.float32
                or not g.is_contiguous() or g.device != z_t.device):
            raise ValueError(f"cotangent {name} must be contiguous float32 "
                             f"{tuple(z_t.shape)} on {z_t.device}")


def fused_mlp_bwd_rays_plain(od: torch.Tensor, z_t: torch.Tensor,
                             gr: torch.Tensor, gg: torch.Tensor,
                             gb: torch.Tensor, gs: torch.Tensor,
                             packed: Dict[str, torch.Tensor], L_x: int = 10,
                             L_d: int = 4, gate: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernel -> (dw [W_TOTAL],
    db [B_TOTAL]) float32, one sample row at a time.  Operands in the
    packed weights' type, float32 accumulation; cotangents, masked deltas
    and dfeat rounded to that type before their products (as
    ``fused_mlp_vjp.py:54-119`` of the JAX package).  With ``gate`` a row
    computes only the rays whose block the gate leaves on (all of them
    where every block of the row is on, none where every one is off)."""
    s, n = z_t.shape
    on = None if gate is None else gate_mask(gate, s, n)
    rnd = _rounder(packed)
    p, (dw, db), grad = _plain_state(packed, od.device)
    o, d = od[0:3].T.float(), od[3:6].T.float()
    inv = torch.rsqrt(torch.sum(d * d, -1, keepdim=True))
    embd = rnd(build_emb(d * inv, L_d, EMBD_ROWS))
    hv_dir = embd @ p["wvd"] + p["bv"]                       # [N, 128]

    for k in range(s):
        rays = slice(None)
        if on is not None and not bool(on[k].all()):
            if not bool(on[k].any()):
                continue
            rays = on[k].nonzero()[:, 0]
        gk = [t[k][rays] for t in (gr, gg, gb, gs)]
        x = o[rays] + d[rays] * z_t[k][rays][:, None].float()
        _backprop(rnd(build_emb(x, L_x, EMBX_ROWS)), embd[rays],
                  hv_dir[rays], rnd(torch.stack(gk[:3], -1).float()),
                  rnd(gk[3].float())[:, None], p, grad, rnd)
    return dw, db


def _rounder(packed: Dict[str, torch.Tensor]):
    """Rounding to the packed weights' type, kept in float32."""
    cdt = packed["w"].dtype
    return lambda t: t.to(cdt).float()


def _plain_state(packed: Dict[str, torch.Tensor], device):
    """(the packed weights' views in float32, zero (dw, db) float32, named
    views into them) for a plain backward."""
    p = {k: v.float() for k, v in packed.items() if k not in ("w", "b")}
    dw = torch.zeros(W_TOTAL, device=device)
    db = torch.zeros(B_TOTAL, device=device)
    return p, (dw, db), _with_views(dw, db)


def _backprop(embx, embd, hv_dir, g_rgb, g_sig, p, grad, rnd) -> None:
    """``_recompute_and_backprop`` of the JAX package at M points: recompute
    the forward from the rounded embeddings embx [M, 64] and embd [M, 32]
    and the direction term hv_dir [M, 128], chain the rounded cotangents
    g_rgb [M, 3] and g_sig [M, 1] back, and add every weight and bias
    gradient, summed over the points, into ``grad``."""
    def masked(h, dh):
        return rnd(torch.where(h > 0, dh, torch.zeros_like(dh)))

    hs = [rnd(torch.relu(embx @ p["w0"] + p["b0"]))]
    for i in range(1, 8):
        pre = hs[-1] @ p[f"w{i}" if i != 5 else "w5h"] + p[f"b{i}"]
        if i == 5:
            pre = embx @ p["w5e"] + pre
        hs.append(rnd(torch.relu(pre)))
    h7 = hs[7]
    feat = rnd(h7 @ p["wfeat"] + p["bfeat"])
    hv = rnd(torch.relu(feat @ p["wvf"] + hv_dir))

    grad["wcol"] += hv.T @ g_rgb
    grad["bcol"] += g_rgb.sum(0)
    dhv = masked(hv, g_rgb @ p["wcol"].T)
    grad["wvf"] += feat.T @ dhv
    grad["wvd"] += embd.T @ dhv
    grad["bv"] += dhv.sum(0)
    dfeat = rnd(dhv @ p["wvf"].T)
    grad["wfeat"] += h7.T @ dfeat
    grad["bfeat"] += dfeat.sum(0)
    dh = dfeat @ p["wfeat"].T
    grad["wdens"] += (h7.T @ g_sig)[:, 0]
    grad["bdens"] += g_sig.sum(0)
    dh = dh + g_sig @ p["wdens"][None]
    for i in range(7, 0, -1):
        gi = masked(hs[i], dh)
        w = f"w{i}" if i != 5 else "w5h"
        grad[w] += hs[i - 1].T @ gi
        grad[f"b{i}"] += gi.sum(0)
        if i == 5:
            grad["w5e"] += embx.T @ gi
        dh = gi @ p[w].T
    g0 = masked(hs[0], dh)
    grad["w0"] += embx.T @ g0
    grad["b0"] += g0.sum(0)


def fused_mlp_bwd_plain(xplane: torch.Tensor, dplane: torch.Tensor,
                        g4: torch.Tensor, packed: Dict[str, torch.Tensor],
                        L_x: int = 10, L_d: int = 4, chunk: int = 32768
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the points backward -> (dw [W_TOTAL],
    db [B_TOTAL]) float32, in chunks of points: ``_backprop`` with every
    point's own direction embedding (as given) and direction term, the
    rounding points of ``fused_mlp_bwd_rays_plain``."""
    rnd = _rounder(packed)
    p, (dw, db), grad = _plain_state(packed, xplane.device)
    x, d = xplane.T.float(), dplane.T.float()
    for i in range(0, x.shape[0], chunk):
        sl = slice(i, i + chunk)
        embd = rnd(build_emb(d[sl], L_d, EMBD_ROWS))
        _backprop(rnd(build_emb(x[sl], L_x, EMBX_ROWS)), embd,
                  embd @ p["wvd"] + p["bv"], rnd(g4[0:3, sl].T.float()),
                  rnd(g4[3, sl].float())[:, None], p, grad, rnd)
    return dw, db


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """csrc/fused_mlp_vjp.cu, built at first use, with its C signatures."""
    from . import build
    lib = build.load("fused_mlp_vjp")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.nerf_bwd_rays_workspace.argtypes = [i, i, ctypes.POINTER(
        ctypes.c_long)]
    lib.nerf_bwd_rays_workspace.restype = None
    lib.nerf_bwd_plan.argtypes = [i, i, ctypes.POINTER(ctypes.c_long), i]
    lib.nerf_bwd_plan.restype = i
    lib.nerf_bwd_rays.argtypes = [p] * 15 + [i, i, i, i, p]
    lib.nerf_bwd_points.argtypes = [p] * 10 + [i, i, i, p]
    lib.nerf_bwd_rays.restype = lib.nerf_bwd_points.restype = i
    return lib


def _workspace(lib, n: int, s: int, dev):
    """The backward's scratch at (n, s) (``nerf_bwd_rays_workspace``):
    (stash, chain partials, weight-gradient partials, the size of the
    gate's tile list).  The chain kernel reads the weights as they are
    packed: no transposed copy."""
    sizes = (ctypes.c_long * 4)()
    lib.nerf_bwd_rays_workspace(n, s, sizes)
    return (torch.empty(sizes[0], dtype=torch.bfloat16, device=dev),
            torch.empty(sizes[1], device=dev),
            torch.empty(sizes[2], device=dev), sizes[3])


def bwd_plan(n: int, s: int) -> dict:
    """The CUDA backward's plan at (n, s) as the kernel makes it on the
    current card (``nerf_bwd_plan``), for accounting each launch's work:
    ``chunks``, ``chunk_points``, ``nsplit`` (weight-gradient splits a
    chunk), ``g1`` (chain blocks a chunk), ``stash_per_point`` (bf16
    values stashed a point), ``wgrad_read_per_point`` (of them, those the
    weight-gradient launch reads) and ``wgrad_jobs``: the (rows, columns)
    of its products dW = A^T G in launch order.  Needs the card."""
    lib = _library()
    cap = lib.nerf_bwd_plan(n, s, None, 0)
    out = (ctypes.c_long * cap)()
    lib.nerf_bwd_plan(n, s, out, cap)
    keys = ("chunks", "chunk_points", "nsplit", "g1", "stash_per_point",
            "wgrad_read_per_point")
    jobs = tuple((out[7 + 2 * j], out[8 + 2 * j]) for j in range(out[6]))
    return {**dict(zip(keys, out[:6])), "wgrad_jobs": jobs}


def fused_mlp_bwd_rays(od: torch.Tensor, z_t: torch.Tensor,
                       gr: torch.Tensor, gg: torch.Tensor, gb: torch.Tensor,
                       gs: torch.Tensor, packed: Dict[str, torch.Tensor],
                       L_x: int = 10, L_d: int = 4,
                       gate: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradients of the full field along rays: od [8, N], z_t [S, N] and
    the float32 cotangents of (r, g, b, sigma), each [S, N] ->
    (dw [W_TOTAL], db [B_TOTAL]) float32 in the packed layout.  With
    ``gate`` (K6) the gated-off blocks' samples add nothing."""
    s, n = _check(od, z_t, packed, L_x, L_d, torch.float32, gate)
    grads = (gr, gg, gb, gs)
    _grads_check(z_t, grads)
    if od.device.type == "cpu":
        return fused_mlp_bwd_rays_plain(od, z_t, *grads, packed, L_x, L_d,
                                        gate)
    lib = _cuda_lib(od, packed, _library)
    dev = od.device
    dw = torch.empty(W_TOTAL, device=dev)
    db = torch.empty(B_TOTAL, device=dev)
    if s * n == 0:
        return dw.zero_(), db.zero_()
    with torch.cuda.device(dev):
        stash, part1, part2, n_list = _workspace(lib, n, s, dev)
        # K6: the list of active chain tiles and its length
        tiles = (None if gate is None else
                 torch.empty(n_list, dtype=torch.int32, device=dev))
        rc = lib.nerf_bwd_rays(
            od.data_ptr(), z_t.data_ptr(), *(g.data_ptr() for g in grads),
            packed["w"].data_ptr(), packed["b"].data_ptr(),
            stash.data_ptr(), part1.data_ptr(), part2.data_ptr(),
            dw.data_ptr(), db.data_ptr(), _ptr(gate), _ptr(tiles), n, s,
            L_x, L_d, torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "nerf_bwd_rays")
    if gate is None:
        fused_mlp_bwd_rays.launches += 1
    else:
        fused_mlp_bwd_rays.gated_launches += 1
    return dw, db


fused_mlp_bwd_rays.launches = fused_mlp_bwd_rays.gated_launches = 0


def fused_mlp_bwd(xplane: torch.Tensor, dplane: torch.Tensor,
                  g4: torch.Tensor, packed: Dict[str, torch.Tensor],
                  L_x: int = 10, L_d: int = 4
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradients of the full field at points (K9): the planes xplane and
    dplane [3, P] and the float32 cotangents g4 [4, P] of (r, g, b, sigma)
    -> (dw [W_TOTAL], db [B_TOTAL]) float32 in the packed layout."""
    p = _check_planes(packed, xplane, dplane)
    _check_common(packed, L_x, L_d, torch.float32)
    if (g4.shape != (4, p) or g4.dtype != torch.float32
            or not g4.is_contiguous() or g4.device != xplane.device):
        raise ValueError(f"the cotangents must be contiguous float32 "
                         f"[4, {p}] on {xplane.device}; got {g4.dtype} "
                         f"{tuple(g4.shape)} on {g4.device}")
    if xplane.device.type == "cpu":
        return fused_mlp_bwd_plain(xplane, dplane, g4, packed, L_x, L_d)
    lib = _cuda_lib(xplane, packed, _library)
    dev = xplane.device
    dw = torch.empty(W_TOTAL, device=dev)
    db = torch.empty(B_TOTAL, device=dev)
    if p == 0:
        return dw.zero_(), db.zero_()
    with torch.cuda.device(dev):
        stash, part1, part2, _ = _workspace(lib, p, 1, dev)
        rc = lib.nerf_bwd_points(
            xplane.data_ptr(), dplane.data_ptr(), g4.data_ptr(),
            packed["w"].data_ptr(), packed["b"].data_ptr(),
            stash.data_ptr(), part1.data_ptr(), part2.data_ptr(),
            dw.data_ptr(), db.data_ptr(), p, L_x, L_d,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "nerf_bwd_points")
    fused_mlp_bwd.launches += 1
    return dw, db


fused_mlp_bwd.launches = 0


class _TrainRays(torch.autograd.Function):
    """K1 forward (float32 logits), K2 backward (float32 packed grads); with
    a gate K5 and K6."""

    @staticmethod
    def forward(ctx, w, b, od, z_t, L_x, L_d, weight_dtype, gate):
        packed = _with_views(w.to(weight_dtype), b)
        ctx.save_for_backward(packed["w"], b, od, z_t, gate)
        ctx.encodings = (L_x, L_d)
        return fused_mlp_eval_rays(od, z_t, packed, L_x, L_d,
                                   out_dtype=torch.float32, gate=gate)

    @staticmethod
    def backward(ctx, *gout):
        w, b, od, z_t, gate = ctx.saved_tensors
        grads = [torch.zeros_like(z_t) if g is None
                 else g.float().contiguous() for g in gout]
        dw, db = fused_mlp_bwd_rays(od, z_t, *grads, _with_views(w, b),
                                    *ctx.encodings, gate=gate)
        return dw, db, None, None, None, None, None, None


def fused_mlp_train_rays(w: torch.Tensor, b: torch.Tensor, od: torch.Tensor,
                         z_t: torch.Tensor, L_x: int = 10, L_d: int = 4,
                         weight_dtype: torch.dtype = torch.bfloat16,
                         gate: Optional[torch.Tensor] = None):
    """Differentiable full field along rays: float32 packed ``w``, ``b``
    (``fused_mlp.pack_flat``), od [8, N], z_t [S, N] -> (r, g, b, sigma),
    each [S, N] float32.  The kernels see the weights in ``weight_dtype``
    (the CUDA kernels take bf16); the gradients of ``w`` and ``b`` come
    back float32.  ``gate`` (int32, ``fused_mlp.py``'s layout) gates both
    directions: gated blocks store 0 and add no gradient, which is exact
    when their samples' density logits are <= 0."""
    return _TrainRays.apply(w, b, od, z_t, L_x, L_d, weight_dtype, gate)


class _TrainPoints(torch.autograd.Function):
    """K8 forward (float32 logits), K9 backward."""

    @staticmethod
    def forward(ctx, w, b, xplane, dplane, L_x, L_d, weight_dtype):
        packed = _with_views(w.to(weight_dtype), b)
        ctx.save_for_backward(packed["w"], b, xplane, dplane)
        ctx.encodings = (L_x, L_d)
        return fused_mlp_eval(xplane, dplane, packed, L_x, L_d,
                              out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, gout):
        w, b, xplane, dplane = ctx.saved_tensors
        dw, db = fused_mlp_bwd(xplane, dplane, gout.float().contiguous(),
                               _with_views(w, b), *ctx.encodings)
        return dw, db, None, None, None, None, None


def fused_mlp_train(w: torch.Tensor, b: torch.Tensor, xplane: torch.Tensor,
                    dplane: torch.Tensor, L_x: int = 10, L_d: int = 4,
                    weight_dtype: torch.dtype = torch.bfloat16
                    ) -> torch.Tensor:
    """Differentiable full field at points: float32 packed ``w``, ``b``
    (``fused_mlp.pack_flat``), the planes xplane and dplane [3, P] ->
    [4, P] float32 logits (r, g, b, sigma).  The kernels see the weights
    in ``weight_dtype``; the gradients of ``w`` and ``b`` come back float32.
    The planes get no gradient: they are data (the JAX pair returns zeros
    for them)."""
    return _TrainPoints.apply(w, b, xplane, dplane, L_x, L_d, weight_dtype)
