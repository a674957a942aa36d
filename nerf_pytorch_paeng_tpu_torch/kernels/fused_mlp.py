"""The fused NeRF MLP along rays: packing, CUDA wrappers, plain versions.

Two forward kernels (source: ``csrc/fused_mlp.cu``), each with a plain
PyTorch version of the same arithmetic in this module:

- ``fused_mlp_sigma_rays`` (trunk + density head; replaces the JAX
  package's ``kernels/fused_mlp.py::_sigma_rays_kernel``, the dense
  renderer's coarse pass);
- ``fused_mlp_eval_rays`` (the full field; replaces
  ``_eval_rays_kernel``, the dense renderer's fine pass and the training
  forward of both passes).

Their backward (``fused_mlp_vjp.py``) takes the weights this module packs.

Data layout, as in the JAX signatures: ``od`` [8, N] float32 (origin in
rows 0-2, unnormalised direction in rows 3-5), ``z_t`` [S, N] float32
depths; outputs are [S, N] raw logits.  Sample positions x = o + d * z and
their double-angle embedding are built inside the kernel, so no [3, P]
position plane exists in device memory.

Arithmetic: operands in the packed weights' type (bf16 on the card),
float32 accumulation, float32 biases, activations rounded to that type
after every ReLU; the skip layer is two products (embedding and hidden),
the view layer is the feature product plus a per-ray direction term
computed once per ray.

Dispatch: a tensor on the CPU goes to the plain version; a CUDA tensor
goes to the kernel, or the wrapper raises.  Each wrapper counts its kernel
launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import numpy as np
import torch

from ..ops.posenc import build_emb

EMBX_ROWS = 64   # kernel embedding rows for positions (63 used at L_x=10)
EMBD_ROWS = 32   # ... for view directions (27 used at L_d=4)
WIDTH = 256

# Packed layout: one weight buffer [in, out] row-major per layer, one bias
# buffer; every entry starts at a multiple of 8 elements (16-byte aligned
# for the kernel's asynchronous copies).  csrc/fused_mlp.cu carries the
# same offsets as constants (tests/test_torch_kernels.py checks them).
_W_LAYOUT: Tuple[Tuple[str, Tuple[int, ...]], ...] = (
    ("w0", (EMBX_ROWS, WIDTH)), ("w1", (WIDTH, WIDTH)), ("w2", (WIDTH, WIDTH)),
    ("w3", (WIDTH, WIDTH)), ("w4", (WIDTH, WIDTH)),
    ("w5e", (EMBX_ROWS, WIDTH)), ("w5h", (WIDTH, WIDTH)),
    ("w6", (WIDTH, WIDTH)), ("w7", (WIDTH, WIDTH)),
    ("wfeat", (WIDTH, WIDTH)), ("wvf", (WIDTH, WIDTH // 2)),
    ("wvd", (EMBD_ROWS, WIDTH // 2)), ("wdens", (WIDTH,)),
    ("wcol", (WIDTH // 2, 3)))
_B_LAYOUT: Tuple[Tuple[str, Tuple[int, ...]], ...] = (
    *((f"b{i}", (WIDTH,)) for i in range(8)), ("bfeat", (WIDTH,)),
    ("bv", (WIDTH // 2,)), ("bdens", (1,)), ("bcol", (3,)))


def _offsets(layout):
    offs, at = {}, 0
    for name, shape in layout:
        offs[name] = at
        at += -(-int(np.prod(shape)) // 8) * 8
    return offs, at


W_OFFSETS, W_TOTAL = _offsets(_W_LAYOUT)
B_OFFSETS, B_TOTAL = _offsets(_B_LAYOUT)

# FLOP of the function at its own widths (multiply-add = 2; the kernels'
# zero padding of the embeddings is not counted), for bounds and rates.


def sigma_flop_per_sample(L_x: int = 10) -> int:
    """Trunk (3+6*L_x inputs, six 256x256, skip (3+6*L_x+256)x256) and the
    1-wide density head."""
    in_x = 3 + 6 * L_x
    return 2 * (in_x * WIDTH + 6 * WIDTH * WIDTH + (in_x + WIDTH) * WIDTH
                + WIDTH)


def eval_flop_per_sample(L_x: int = 10) -> int:
    """The sigma kernel's work plus feature (256x256), view (256x128) and
    the 3-wide colour head."""
    return sigma_flop_per_sample(L_x) + 2 * (
        WIDTH * WIDTH + WIDTH * (WIDTH // 2) + (WIDTH // 2) * 3)


def eval_flop_per_ray(L_d: int = 4) -> int:
    """The direction term (3+6*L_d inputs x 128), once per ray."""
    return 2 * (3 + 6 * L_d) * (WIDTH // 2)


def bwd_flop_per_sample(L_x: int = 10, L_d: int = 4) -> int:
    """The backward's gradient products: every weight's gradient (the
    direction weights' too, since their delta differs per sample) and the
    input gradient of every layer but the first, the skip's embedding rows
    and the direction rows.  The recompute of the forward is the design's
    own cost and is not counted."""
    in_x, in_d = 3 + 6 * L_x, 3 + 6 * L_d
    chain = 7 * WIDTH * WIDTH + WIDTH * WIDTH + WIDTH * (WIDTH // 2) \
        + WIDTH + (WIDTH // 2) * 3      # w1-4, w5h, w6, w7, wfeat, wvf, heads
    weights = chain + 2 * in_x * WIDTH + in_d * (WIDTH // 2)  # + w0, w5e, wvd
    return 2 * (chain + weights)


def emb_perm(L: int) -> np.ndarray:
    """Kernel embedding row -> reference embedding row.

    Kernel order: [x0,x1,x2, sin f0 (3 coords), ..., sin f(L-1),
    cos f0, ..., cos f(L-1)]; reference order (``positional_encoding``):
    [x, sin f0, cos f0, sin f1, cos f1, ...]."""
    perm = np.zeros(3 + 6 * L, np.int64)
    perm[:3] = np.arange(3)
    for j in range(L):
        for c in range(3):
            perm[3 + 3 * j + c] = 3 + 6 * j + c              # sin
            perm[3 + 3 * L + 3 * j + c] = 3 + 6 * j + 3 + c  # cos
    return perm


def pack_flat(mlp, L_x: int = 10, L_d: int = 4
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ``NeRFMLP`` (reference architecture: 8x256, skip at 4) in the
    kernels' layout: ``(w [W_TOTAL], b [B_TOTAL])``, float32, on the
    module's device.  Built by differentiable ops (transpose, row
    permutation, zero padding, concatenation), so autograd maps gradients
    in the packed layout back to the module's parameters.  First-layer and
    skip rows are permuted to the kernels' embedding order and zero-padded
    to 64 (positions) / 32 (directions) rows."""
    if not (len(mlp.linear_x) == 8 and mlp.linear_x[0].out_features == WIDTH
            and mlp.skips == (4,) and 1 <= L_x <= 10 and 1 <= L_d <= 4):
        raise NotImplementedError(
            "the fused kernels take the 8x256 skip-4 MLP with 1<=L_x<=10, "
            f"1<=L_d<=4 (got L_x={L_x}, L_d={L_d})")
    in_x, in_d = 3 + 6 * L_x, 3 + 6 * L_d
    device = mlp.linear_feat.weight.device
    px = torch.as_tensor(emb_perm(L_x), device=device)
    pd = torch.as_tensor(emb_perm(L_d), device=device)

    def kern(layer):                                 # [in, out] float32
        return layer.weight.float().T

    def pad_rows(w, rows):
        return torch.cat([w, w.new_zeros(rows - w.shape[0], w.shape[1])])

    src = {"w0": pad_rows(kern(mlp.linear_x[0]).index_select(0, px),
                          EMBX_ROWS)}
    for i in (1, 2, 3, 4, 6, 7):
        src[f"w{i}"] = kern(mlp.linear_x[i])
    w5 = kern(mlp.linear_x[5])                       # rows: [emb_x | h]
    src["w5e"] = pad_rows(w5[:in_x].index_select(0, px), EMBX_ROWS)
    src["w5h"] = w5[in_x:]
    src["wfeat"] = kern(mlp.linear_feat)
    wv = kern(mlp.linear_d)                          # rows: [feat | emb_d]
    if wv.shape[0] != WIDTH + in_d:
        raise ValueError(f"view layer has {wv.shape[0]} inputs, L_d={L_d} "
                         f"needs {WIDTH + in_d}")
    src["wvf"] = wv[:WIDTH]
    src["wvd"] = pad_rows(wv[WIDTH:].index_select(0, pd), EMBD_ROWS)
    src["wdens"] = kern(mlp.linear_density)[:, 0]
    src["wcol"] = kern(mlp.linear_color)
    for i in range(8):
        src[f"b{i}"] = mlp.linear_x[i].bias.float()
    src["bfeat"] = mlp.linear_feat.bias.float()
    src["bv"] = mlp.linear_d.bias.float()
    src["bdens"] = mlp.linear_density.bias.float()
    src["bcol"] = mlp.linear_color.bias.float()

    def flat(layout):
        parts = []
        for name, shape in layout:
            t = src[name]
            if tuple(t.shape) != shape:
                raise ValueError(f"{name}: {tuple(t.shape)} != {shape}")
            parts.append(t.reshape(-1))
            pad = -t.numel() % 8
            if pad:
                parts.append(t.new_zeros(pad))
        return torch.cat(parts)

    return flat(_W_LAYOUT), flat(_B_LAYOUT)


@torch.no_grad()
def pack_nerf_mlp_params(mlp, L_x: int = 10, L_d: int = 4,
                         dtype: torch.dtype = torch.bfloat16,
                         device=None) -> Dict[str, torch.Tensor]:
    """``pack_flat`` without gradients, the weights stored in ``dtype``:
    ``{"w": flat weights, "b": flat float32 biases}`` plus a named view
    into them for every entry of the layout (the plain versions read
    those)."""
    w, b = pack_flat(mlp, L_x, L_d)
    device = device if device is not None else w.device
    return _with_views(w.to(device=device, dtype=dtype).contiguous(),
                       b.to(device).contiguous())


def _with_views(w: torch.Tensor, b: torch.Tensor) -> Dict[str, torch.Tensor]:
    """{"w", "b"} plus a named view into them for every layout entry."""
    packed = {"w": w, "b": b}
    for flat, layout, offs in ((w, _W_LAYOUT, W_OFFSETS),
                               (b, _B_LAYOUT, B_OFFSETS)):
        for name, shape in layout:
            n = int(np.prod(shape))
            packed[name] = flat[offs[name]:offs[name] + n].view(shape)
    return packed


def with_weight_dtype(packed: Dict[str, torch.Tensor],
                      dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The same packed weights stored in another type (e.g. the bf16
    weights as float32 operands, for a float32 reference)."""
    return _with_views(packed["w"].to(dtype), packed["b"])


def pack_nerf(model, cfg, device=None) -> Dict[str, Dict]:
    """Both MLPs of a ``NeRF`` packed once, for a whole evaluation run, in
    the config's compute dtype."""
    dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
             else torch.float32)
    return {
        "coarse": pack_nerf_mlp_params(model.model_coarse, cfg.L_x, cfg.L_d,
                                       dtype, device),
        "fine": pack_nerf_mlp_params(model.model_fine, cfg.L_x, cfg.L_d,
                                     dtype, device)}


# ------------------------------------------------------------ plain versions


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Operands rounded to the weights' type, product in float32."""
    return a.to(w.dtype).float() @ w.float()


def _trunk(embx: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    cdt = p["w"].dtype
    h = torch.relu(_mm(embx, p["w0"]) + p["b0"]).to(cdt).float()
    for i in (1, 2, 3, 4):
        h = torch.relu(_mm(h, p[f"w{i}"]) + p[f"b{i}"]).to(cdt).float()
    h = torch.relu(_mm(embx, p["w5e"]) + _mm(h, p["w5h"])
                   + p["b5"]).to(cdt).float()
    for i in (6, 7):
        h = torch.relu(_mm(h, p[f"w{i}"]) + p[f"b{i}"]).to(cdt).float()
    return h


def fused_mlp_sigma_rays_plain(od: torch.Tensor, z_t: torch.Tensor,
                               packed: Dict[str, torch.Tensor],
                               L_x: int = 10,
                               out_dtype: torch.dtype = torch.float32
                               ) -> torch.Tensor:
    """Plain PyTorch version of the sigma kernel (one sample row at a
    time, so memory stays at a few [N, 256] activations)."""
    s, n = z_t.shape
    o, d = od[0:3].T.float(), od[3:6].T.float()
    out = torch.empty((s, n), dtype=out_dtype, device=od.device)
    for k in range(s):
        x = o + d * z_t[k][:, None].float()
        h = _trunk(build_emb(x, L_x, EMBX_ROWS), packed)
        out[k] = (_mm(h, packed["wdens"][:, None])[:, 0]
                  + packed["bdens"]).to(out_dtype)
    return out


def fused_mlp_eval_rays_plain(od: torch.Tensor, z_t: torch.Tensor,
                              packed: Dict[str, torch.Tensor],
                              L_x: int = 10, L_d: int = 4,
                              out_dtype: torch.dtype = torch.float32):
    """Plain PyTorch version of the full-field kernel -> (r, g, b, sigma)."""
    s, n = z_t.shape
    cdt = packed["w"].dtype
    o, d = od[0:3].T.float(), od[3:6].T.float()
    inv = torch.rsqrt(torch.sum(d * d, -1, keepdim=True))
    hv_dir = _mm(build_emb(d * inv, L_d, EMBD_ROWS), packed["wvd"]) \
        + packed["bv"]                                       # [N, 128] f32
    outs = [torch.empty((s, n), dtype=out_dtype, device=od.device)
            for _ in range(4)]
    for k in range(s):
        x = o + d * z_t[k][:, None].float()
        h = _trunk(build_emb(x, L_x, EMBX_ROWS), packed)
        sigma = _mm(h, packed["wdens"][:, None])[:, 0] + packed["bdens"]
        feat = (_mm(h, packed["wfeat"]) + packed["bfeat"]).to(cdt).float()
        hv = torch.relu(_mm(feat, packed["wvf"]) + hv_dir).to(cdt).float()
        rgb = _mm(hv, packed["wcol"]) + packed["bcol"]
        for c in range(3):
            outs[c][k] = rgb[:, c].to(out_dtype)
        outs[3][k] = sigma.to(out_dtype)
    return tuple(outs)


# -------------------------------------------------------------- CUDA wrappers


def _check(od, z_t, packed, L_x, L_d, out_dtype) -> Tuple[int, int]:
    if z_t.dim() != 2 or od.dim() != 2 or od.shape != (8, z_t.shape[1]):
        raise ValueError(f"od must be [8, N] and z_t [S, N]; got "
                         f"{tuple(od.shape)}, {tuple(z_t.shape)}")
    for name, t in (("od", od), ("z_t", z_t)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
    if any(t.device != od.device for t in (z_t, packed["w"], packed["b"])):
        raise ValueError("od, z_t and the packed weights must share a device")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype {out_dtype} (float32 or bfloat16)")
    if not (1 <= L_x <= 10 and 1 <= L_d <= 4):
        raise ValueError(f"L_x={L_x}, L_d={L_d} outside 1..10 / 1..4")
    return z_t.shape


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """csrc/fused_mlp.cu, built at first use, with its C signatures."""
    from . import build
    lib = build.load("fused_mlp")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.nerf_sigma_rays.argtypes = [p, p, p, p, p, i, i, i, i, p]
    lib.nerf_eval_rays.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, p]
    lib.nerf_sigma_rays.restype = lib.nerf_eval_rays.restype = i
    return lib


def _cuda_lib(od: torch.Tensor, packed, library=_library) -> ctypes.CDLL:
    """``library()`` once the inputs are ones its kernels take."""
    if od.device.type != "cuda":
        raise RuntimeError(f"fused MLP kernels run on CUDA or CPU tensors, "
                           f"not {od.device.type}")
    if packed["w"].dtype != torch.bfloat16:
        raise ValueError("the CUDA kernels take bfloat16 packed weights")
    return library()


def _raise_on(rc: int, fn: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA error {rc} at launch")


def fused_mlp_sigma_rays(od: torch.Tensor, z_t: torch.Tensor,
                         packed: Dict[str, torch.Tensor], L_x: int = 10,
                         out_dtype: torch.dtype = torch.float32
                         ) -> torch.Tensor:
    """Density logits along rays: od [8, N], z_t [S, N] -> sigma [S, N]."""
    s, n = _check(od, z_t, packed, L_x, 1, out_dtype)
    if od.device.type == "cpu":
        return fused_mlp_sigma_rays_plain(od, z_t, packed, L_x, out_dtype)
    lib = _cuda_lib(od, packed)
    out = torch.empty((s, n), dtype=out_dtype, device=od.device)
    if s * n == 0:
        return out
    with torch.cuda.device(od.device):
        rc = lib.nerf_sigma_rays(
            od.data_ptr(), z_t.data_ptr(), packed["w"].data_ptr(),
            packed["b"].data_ptr(), out.data_ptr(), n, s, L_x,
            int(out_dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "nerf_sigma_rays")
    fused_mlp_sigma_rays.launches += 1
    return out


fused_mlp_sigma_rays.launches = 0


def fused_mlp_eval_rays(od: torch.Tensor, z_t: torch.Tensor,
                        packed: Dict[str, torch.Tensor], L_x: int = 10,
                        L_d: int = 4,
                        out_dtype: torch.dtype = torch.float32):
    """Full radiance field along rays: od [8, N], z_t [S, N] ->
    (r, g, b, sigma), each [S, N] raw logits."""
    s, n = _check(od, z_t, packed, L_x, L_d, out_dtype)
    if od.device.type == "cpu":
        return fused_mlp_eval_rays_plain(od, z_t, packed, L_x, L_d,
                                         out_dtype)
    lib = _cuda_lib(od, packed)
    outs = [torch.empty((s, n), dtype=out_dtype, device=od.device)
            for _ in range(4)]
    if s * n == 0:
        return tuple(outs)
    with torch.cuda.device(od.device):
        rc = lib.nerf_eval_rays(
            od.data_ptr(), z_t.data_ptr(), packed["w"].data_ptr(),
            packed["b"].data_ptr(), *(t.data_ptr() for t in outs), n, s,
            L_x, L_d, int(out_dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "nerf_eval_rays")
    fused_mlp_eval_rays.launches += 1
    return tuple(outs)


fused_mlp_eval_rays.launches = 0
