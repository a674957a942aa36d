"""Instant-NGP's two width-64 MLPs as one forward and one backward kernel
(``csrc/ngp_mlp.cu``: N6 ``ngp_mlp_fwd_kernel``, N7 ``ngp_mlp_bwd_kernel``
and its fixed-order ``ngp_mlp_reduce_kernel``), and their plain PyTorch
twin.

``ngp_mlp(feat, sh, weights, n_valid=None)`` -> (sigma [n], rgb [n, 3])
float32, differentiable in ``feat`` and the five weights (``NGPMLP``):
features [n, F] (F = 2 x the hash levels: 32 at the published 16, at most
32) and SH [n, 16] float32, ``weights`` the model's
``sigma_w0`` [64, F], ``sigma_w1`` [16, 64], ``color_w0`` [64, 32],
``color_w1`` [64, 64], ``color_w2`` [3, 64] float32 (``models/ngp.
MLP_WEIGHTS``).  On a CUDA tensor the kernels run, on a CPU tensor the
plain twin; anything else, or a tensor of another dtype, shape or device
than these, raises.  Rows at or past ``n_valid`` (a one-element int32
device tensor, as ``hash_encode`` takes) give sigma 0, rgb 0, d_feat 0
and add nothing to the weights' gradients.

The arithmetic (both versions): every product's operands rounded to bf16,
its sums float32; z_0, the outputs, d_feat and the weight gradients
float32 (``models/ngp.NGP.field`` says when it takes this route).
``ngp_mlp_plain(..., rnd=identity)`` is the float32 MLP.

Counters, as ``kernels.LAUNCH_COUNTERS`` lists them: ``ngp_mlp.launches``
(N6), ``ngp_mlp_bwd.launches`` (N7) and ``ngp_mlp_reduce.launches``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, List, Optional, Sequence, Tuple

import torch

# the weights' shapes at the published 32 features; the flat gradient the
# kernels write holds them in this order, W0 padded to 32 columns
SHAPES = ((64, 32), (16, 64), (64, 32), (64, 64), (3, 64))
N_FEAT, N_SH, N_GEO = 32, 16, 16
SIGMA_CLAMP = 15.0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """csrc/ngp_mlp.cu, built at first use, with its C signatures."""
    from . import build
    lib = build.load("ngp_mlp")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ngp_mlp_fwd.argtypes = [p, i, p, i, p, p, p, p, p, p, p, p, p]
    lib.ngp_mlp_bwd.argtypes = [p, i, p, p, p, i, p, p, p, p, p, p, p, p, i,
                                p, p]
    lib.ngp_mlp_bwd_blocks.argtypes = [i]
    for fn in (lib.ngp_mlp_fwd, lib.ngp_mlp_bwd, lib.ngp_mlp_bwd_blocks):
        fn.restype = i
    return lib


def _raise_on(rc: int, fn: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA error {rc} at launch")


def _ptrs(ts: Sequence[torch.Tensor]) -> List[int]:
    return [t.data_ptr() for t in ts]


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest bf16 value, as float32."""
    return x.to(torch.bfloat16).float()


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def _keep(n: int, n_valid: Optional[torch.Tensor], device) -> torch.Tensor:
    if n_valid is None:
        return torch.ones(n, dtype=torch.bool, device=device)
    return torch.arange(n, device=device) < n_valid.reshape(()).long()


def ngp_mlp_plain_fwd(feat, sh, weights, n_valid=None,
                      rnd: Callable = bf16_round) -> Tuple[torch.Tensor, ...]:
    """The kernels' forward in plain PyTorch -> (sigma, rgb, and what the
    backward reads: the layers' inputs x1, h1, x3, h2, h3 and z_0)."""
    keep = _keep(feat.shape[0], n_valid, feat.device)[:, None]
    w0, w1, w2, w3, w4 = (rnd(w) for w in weights)
    x1 = rnd(torch.where(keep, feat, 0.0))
    h1 = rnd(torch.relu(x1 @ w0.T))
    z = h1 @ w1.T
    x3 = torch.cat([rnd(z), rnd(torch.where(keep, sh, 0.0))], 1)
    h2 = rnd(torch.relu(x3 @ w2.T))
    h3 = rnd(torch.relu(h2 @ w3.T))
    z0 = z[:, 0]
    sigma = torch.exp(z0.clamp(-SIGMA_CLAMP, SIGMA_CLAMP))
    rgb = torch.sigmoid(h3 @ w4.T)
    sigma = torch.where(keep[:, 0], sigma, 0.0)
    rgb = torch.where(keep, rgb, 0.0)
    return sigma, rgb, (x1, h1, x3, h2, h3, z0)


def ngp_mlp_plain_bwd(feat, sh, g_sigma, g_rgb, weights, n_valid=None,
                      rnd: Callable = bf16_round
                      ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The kernels' backward in plain PyTorch: the forward again, then
    (d_feat [n, 32], the five weights' gradients)."""
    keep = _keep(feat.shape[0], n_valid, feat.device)
    sigma, rgb, (x1, h1, x3, h2, h3, z0) = ngp_mlp_plain_fwd(
        feat, sh, weights, n_valid, rnd)
    w0, w1, w2, w3, w4 = (rnd(w) for w in weights)
    g_rgb = torch.where(keep[:, None], g_rgb, 0.0)
    g_sigma = torch.where(keep, g_sigma, 0.0)
    d5 = rnd(g_rgb * (rgb * (1.0 - rgb)))
    d4 = rnd(d5 @ w4) * (h3 > 0)
    d3 = rnd(d4 @ w3) * (h2 > 0)
    dx3 = d3 @ w2
    in_clamp = (z0 >= -SIGMA_CLAMP) & (z0 <= SIGMA_CLAMP)
    dsig = torch.where(in_clamp, g_sigma * sigma, 0.0)
    d2 = rnd(dx3[:, :N_GEO] + torch.nn.functional.pad(dsig[:, None],
                                                      (0, N_GEO - 1)))
    d1 = rnd(d2 @ w1) * (h1 > 0)
    d_feat = d1 @ w0
    dw = [d1.T @ x1, d2.T @ h1, d3.T @ x3, d4.T @ h2, d5.T @ h3]
    return d_feat, dw


class _PlainMLP(torch.autograd.Function):
    """The plain twin under autograd, with the kernels' backward."""

    @staticmethod
    def forward(ctx, feat, sh, n_valid, rnd, *weights):
        sigma, rgb, _ = ngp_mlp_plain_fwd(feat, sh, weights, n_valid, rnd)
        ctx.save_for_backward(feat, sh, n_valid, *weights)
        ctx.rnd = rnd
        return sigma, rgb

    @staticmethod
    def backward(ctx, g_sigma, g_rgb):
        feat, sh, n_valid, *weights = ctx.saved_tensors
        d_feat, dw = ngp_mlp_plain_bwd(feat, sh, g_sigma, g_rgb, weights,
                                       n_valid, ctx.rnd)
        return (d_feat, None, None, None, *dw)


def ngp_mlp_plain(feat, sh, weights, n_valid=None,
                  rnd: Callable = bf16_round):
    """(sigma, rgb) of the plain twin, differentiable as ``ngp_mlp``."""
    return _PlainMLP.apply(feat, sh, n_valid, rnd, *weights)


class NGPMLP(torch.autograd.Function):
    """N6 forward, N7 and its reduce backward (CUDA tensors)."""

    @staticmethod
    def forward(ctx, feat, sh, n_valid, *weights):
        n = feat.shape[0]
        sigma = torch.empty(n, device=feat.device)
        rgb = torch.empty((n, 3), device=feat.device)
        if n:
            rc = _library().ngp_mlp_fwd(
                feat.data_ptr(), feat.shape[1], sh.data_ptr(), n,
                None if n_valid is None else n_valid.data_ptr(),
                *_ptrs(weights), sigma.data_ptr(), rgb.data_ptr(),
                torch.cuda.current_stream(feat.device).cuda_stream)
            _raise_on(rc, "ngp_mlp_fwd")
            ngp_mlp.launches += 1
        ctx.save_for_backward(feat, sh, n_valid, *weights)
        return sigma, rgb

    @staticmethod
    def backward(ctx, g_sigma, g_rgb):
        feat, sh, n_valid, *weights = ctx.saved_tensors
        n, dev = feat.shape[0], feat.device
        g_sigma = (torch.zeros(n, device=dev) if g_sigma is None
                   else g_sigma.contiguous())
        g_rgb = (torch.zeros((n, 3), device=dev) if g_rgb is None
                 else g_rgb.contiguous())
        d_feat = torch.empty_like(feat)
        # every entry written by the reduce (zeros where nothing runs)
        dw = (torch.empty if n else torch.zeros)(
            sum(a * b for a, b in SHAPES), device=dev)
        if n:
            lib = _library()
            blocks = lib.ngp_mlp_bwd_blocks(n)
            if blocks < 1:
                raise RuntimeError("ngp_mlp_bwd: the kernel cannot run on "
                                   f"{torch.cuda.get_device_name(dev)}")
            partial = torch.empty(blocks * dw.numel(), device=dev)
            rc = lib.ngp_mlp_bwd(
                feat.data_ptr(), feat.shape[1], sh.data_ptr(),
                g_sigma.data_ptr(),
                g_rgb.data_ptr(), n,
                None if n_valid is None else n_valid.data_ptr(),
                *_ptrs(weights), d_feat.data_ptr(), partial.data_ptr(),
                blocks, dw.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
            _raise_on(rc, "ngp_mlp_bwd")
            ngp_mlp_bwd.launches += 1
            ngp_mlp_reduce.launches += 1
        grads = [g.view(s) for g, s in zip(
            torch.split(dw, [a * b for a, b in SHAPES]), SHAPES)]
        if feat.shape[1] < N_FEAT:          # fewer levels: W0's own columns
            grads[0] = grads[0][:, :feat.shape[1]].contiguous()
        return (d_feat, None, None, *grads)


def _check(feat: torch.Tensor, sh: torch.Tensor,
           weights: Sequence[torch.Tensor],
           n_valid: Optional[torch.Tensor]) -> None:
    dev = feat.device
    if feat.dim() != 2 or not 2 <= feat.shape[1] <= N_FEAT \
            or feat.shape[1] % 2 or feat.dtype != torch.float32:
        raise ValueError(f"features [n, 2 x levels <= {N_FEAT}] float32, "
                         f"got {tuple(feat.shape)} {feat.dtype}")
    if tuple(sh.shape) != (feat.shape[0], N_SH) or sh.dtype != torch.float32:
        raise ValueError(f"SH [{feat.shape[0]}, {N_SH}] float32, got "
                         f"{tuple(sh.shape)} {sh.dtype}")
    if len(weights) != len(SHAPES):
        raise ValueError(f"{len(SHAPES)} weights, got {len(weights)}")
    for w, s in zip(weights, ((64, feat.shape[1]),) + SHAPES[1:]):
        if tuple(w.shape) != s or w.dtype != torch.float32:
            raise ValueError(f"a weight {s} float32, got {tuple(w.shape)} "
                             f"{w.dtype}")
    if n_valid is not None and (n_valid.dtype != torch.int32
                                or n_valid.numel() != 1):
        raise ValueError("n_valid is a one-element int32 tensor")
    others = [sh, *weights] + ([] if n_valid is None else [n_valid])
    if any(t.device != dev for t in others):
        raise ValueError("features, SH, weights and n_valid on one device")
    if dev.type not in ("cpu", "cuda"):
        raise RuntimeError(f"NGP MLPs on CUDA or CPU, not {dev}")


def ngp_mlp(feat: torch.Tensor, sh: torch.Tensor,
            weights: Sequence[torch.Tensor],
            n_valid: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sigma [n], rgb [n, 3]) of both MLPs (see the module docstring)."""
    _check(feat, sh, weights, n_valid)
    if feat.device.type == "cpu":
        return ngp_mlp_plain(feat, sh, weights, n_valid)
    feat, sh = feat.contiguous(), sh.contiguous()
    if feat.data_ptr() % 8 or sh.data_ptr() % 8:    # the kernels' float2 loads
        raise ValueError("features and SH start on an 8-byte boundary")
    return NGPMLP.apply(feat, sh, n_valid, *(w.contiguous() for w in weights))


def ngp_mlp_bwd() -> None:
    """N7's counter (it runs inside ``NGPMLP``)."""


def ngp_mlp_reduce() -> None:
    """N7's reduce's counter (it runs inside ``NGPMLP``)."""


ngp_mlp.launches = ngp_mlp_bwd.launches = ngp_mlp_reduce.launches = 0

__all__ = ["NGPMLP", "ngp_mlp", "ngp_mlp_bwd", "ngp_mlp_plain",
           "ngp_mlp_plain_bwd", "ngp_mlp_plain_fwd", "ngp_mlp_reduce",
           "bf16_round", "identity"]
