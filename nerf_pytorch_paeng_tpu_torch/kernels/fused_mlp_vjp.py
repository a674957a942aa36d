"""The training pair of the fused NeRF MLP along rays: K1 forward, K2
backward.

- ``fused_mlp_bwd_rays`` (source: ``csrc/fused_mlp_vjp.cu``) replaces the
  JAX package's ``kernels/fused_mlp_vjp.py::_bwd_rays_kernel``: it
  recomputes the forward of every sample from the rays and depths (nothing
  is kept from the forward pass) and returns float32 gradients of the
  packed weights and biases, summed over all samples of all rays.  Its
  plain PyTorch version ``fused_mlp_bwd_rays_plain`` follows
  ``_recompute_and_backprop`` step by step, with the same rounding points.
- ``fused_mlp_train_rays`` pairs the full-field kernel
  (``fused_mlp.fused_mlp_eval_rays``, float32 outputs) with that backward
  in a ``torch.autograd.Function``: the differentiable float32 packing
  (``fused_mlp.pack_flat``) goes in, its gradients come out in the packed
  layout, and autograd carries them back to the module's parameters.  No
  input gradients: the rays are data and the depths carry no gradient.

Dispatch as in ``fused_mlp.py``: CPU tensors go to the plain version, CUDA
tensors to the kernel or the wrapper raises; ``fused_mlp_bwd_rays.launches``
counts the kernel's launches (one per call).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from ..ops.posenc import build_emb
from .fused_mlp import (B_TOTAL, EMBD_ROWS, EMBX_ROWS, W_TOTAL, _check,
                        _cuda_lib, _raise_on, _with_views, fused_mlp_eval_rays)


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
                             L_d: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernel -> (dw [W_TOTAL],
    db [B_TOTAL]) float32, one sample row at a time.  Operands in the
    packed weights' type, float32 accumulation; cotangents, masked deltas
    and dfeat rounded to that type before their products (as
    ``fused_mlp_vjp.py:54-119`` of the JAX package)."""
    s, n = z_t.shape
    cdt = packed["w"].dtype

    def rnd(t):
        return t.to(cdt).float()

    p = {k: v.float() for k, v in packed.items() if k not in ("w", "b")}
    dw = torch.zeros(W_TOTAL, device=od.device)
    db = torch.zeros(B_TOTAL, device=od.device)
    grad = _with_views(dw, db)
    o, d = od[0:3].T.float(), od[3:6].T.float()
    inv = torch.rsqrt(torch.sum(d * d, -1, keepdim=True))
    embd = rnd(build_emb(d * inv, L_d, EMBD_ROWS))
    hv_dir = embd @ p["wvd"] + p["bv"]                       # [N, 128]

    def masked(h, dh):
        return rnd(torch.where(h > 0, dh, torch.zeros_like(dh)))

    for k in range(s):
        embx = rnd(build_emb(o + d * z_t[k][:, None].float(), L_x,
                             EMBX_ROWS))
        hs = [rnd(torch.relu(embx @ p["w0"] + p["b0"]))]
        for i in range(1, 8):
            pre = hs[-1] @ p[f"w{i}" if i != 5 else "w5h"] + p[f"b{i}"]
            if i == 5:
                pre = embx @ p["w5e"] + pre
            hs.append(rnd(torch.relu(pre)))
        h7 = hs[7]
        feat = rnd(h7 @ p["wfeat"] + p["bfeat"])
        hv = rnd(torch.relu(feat @ p["wvf"] + hv_dir))

        g_rgb = rnd(torch.stack([gr[k], gg[k], gb[k]], -1).float())  # [N,3]
        g_sig = rnd(gs[k].float())[:, None]                          # [N,1]
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
    lib.nerf_bwd_rays.argtypes = [p] * 14 + [i, i, i, i, p]
    lib.nerf_bwd_rays.restype = i
    return lib


def fused_mlp_bwd_rays(od: torch.Tensor, z_t: torch.Tensor,
                       gr: torch.Tensor, gg: torch.Tensor, gb: torch.Tensor,
                       gs: torch.Tensor, packed: Dict[str, torch.Tensor],
                       L_x: int = 10, L_d: int = 4
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradients of the full field along rays: od [8, N], z_t [S, N] and
    the float32 cotangents of (r, g, b, sigma), each [S, N] ->
    (dw [W_TOTAL], db [B_TOTAL]) float32 in the packed layout."""
    s, n = _check(od, z_t, packed, L_x, L_d, torch.float32)
    grads = (gr, gg, gb, gs)
    _grads_check(z_t, grads)
    if od.device.type == "cpu":
        return fused_mlp_bwd_rays_plain(od, z_t, *grads, packed, L_x, L_d)
    lib = _cuda_lib(od, packed, _library)
    dev = od.device
    dw = torch.empty(W_TOTAL, device=dev)
    db = torch.empty(B_TOTAL, device=dev)
    if s * n == 0:
        return dw.zero_(), db.zero_()
    sizes = (ctypes.c_long * 4)()
    with torch.cuda.device(dev):
        lib.nerf_bwd_rays_workspace(n, s, sizes)
        wt = torch.empty(sizes[0], dtype=torch.bfloat16, device=dev)
        stash = torch.empty(sizes[1], dtype=torch.bfloat16, device=dev)
        part1 = torch.empty(sizes[2], device=dev)
        part2 = torch.empty(sizes[3], device=dev)
        rc = lib.nerf_bwd_rays(
            od.data_ptr(), z_t.data_ptr(), *(g.data_ptr() for g in grads),
            packed["w"].data_ptr(), packed["b"].data_ptr(), wt.data_ptr(),
            stash.data_ptr(), part1.data_ptr(), part2.data_ptr(),
            dw.data_ptr(), db.data_ptr(), n, s, L_x, L_d,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "nerf_bwd_rays")
    fused_mlp_bwd_rays.launches += 1
    return dw, db


fused_mlp_bwd_rays.launches = 0


class _TrainRays(torch.autograd.Function):
    """K1 forward (float32 logits), K2 backward (float32 packed grads)."""

    @staticmethod
    def forward(ctx, w, b, od, z_t, L_x, L_d, weight_dtype):
        packed = _with_views(w.to(weight_dtype), b)
        ctx.save_for_backward(packed["w"], b, od, z_t)
        ctx.encodings = (L_x, L_d)
        return fused_mlp_eval_rays(od, z_t, packed, L_x, L_d,
                                   out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, *gout):
        w, b, od, z_t = ctx.saved_tensors
        grads = [torch.zeros_like(z_t) if g is None
                 else g.float().contiguous() for g in gout]
        dw, db = fused_mlp_bwd_rays(od, z_t, *grads, _with_views(w, b),
                                    *ctx.encodings)
        return dw, db, None, None, None, None, None


def fused_mlp_train_rays(w: torch.Tensor, b: torch.Tensor, od: torch.Tensor,
                         z_t: torch.Tensor, L_x: int = 10, L_d: int = 4,
                         weight_dtype: torch.dtype = torch.bfloat16):
    """Differentiable full field along rays: float32 packed ``w``, ``b``
    (``fused_mlp.pack_flat``), od [8, N], z_t [S, N] -> (r, g, b, sigma),
    each [S, N] float32.  The kernels see the weights in ``weight_dtype``
    (the CUDA kernels take bf16); the gradients of ``w`` and ``b`` come
    back float32."""
    return _TrainRays.apply(w, b, od, z_t, L_x, L_d, weight_dtype)
