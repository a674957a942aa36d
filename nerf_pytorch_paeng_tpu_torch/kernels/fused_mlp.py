"""The fused NeRF MLP: packing, CUDA wrappers, plain versions.

Four forward kernels (source: ``csrc/fused_mlp.cu``), each with a plain
PyTorch version of the same arithmetic in this module:

- ``fused_mlp_sigma_rays`` (trunk + density head along rays; replaces the
  JAX package's ``kernels/fused_mlp.py::_sigma_rays_kernel``, the coarse
  pass, and with ``gate=`` ``_sigma_rays_kernel_gated``, the culled
  renderer's pre-culled coarse pass);
- ``fused_mlp_eval_rays`` (the full field along rays; replaces
  ``_eval_rays_kernel``, the fine pass and the training forward, and with
  ``gate=`` ``_eval_rays_kernel_gated``, the gated fine pass);
- ``fused_mlp_sigma`` (trunk + density head on a plane of points;
  replaces ``_mlp_sigma_kernel``, the support-bound grids and the plane
  layout's coarse pass in the frame renderers);
- ``fused_mlp_eval`` (the full field on planes of points and directions;
  replaces ``_mlp_kernel``: the plane layout, which the JAX package takes
  where the ray kernels' shapes do not apply, and its training forward).

Their backward (``fused_mlp_vjp.py``) takes the weights this module packs.

Data layout, as in the JAX signatures: ``od`` [8, N] float32 (origin in
rows 0-2, unnormalised direction in rows 3-5), ``z_t`` [S, N] float32
depths; outputs are [S, N] raw logits.  Sample positions x = o + d * z and
their double-angle embedding are built inside the kernel, so no [3, P]
position plane exists in device memory.  ``xplane`` (and ``dplane``)
[3, P] float32 for the points kernels, output sigma [P] or [4, P] (rows r,
g, b, sigma: the JAX kernels' 8-row output padding is a TPU layout and is
not carried).

The gate: int32 [ceil(N / 128) * (S / 8)], tile-major over (128-ray tile,
8-sample row), as ``ops/render.tile_row_gate`` builds it.  A block whose
entry is 0 skips the MLP and stores 0 to every output; the caller
certifies that its samples carry density logits <= 0, so the compositing
weights are the same.

Arithmetic: operands in the packed weights' type (bf16 on the card),
float32 accumulation, float32 biases, activations rounded to that type
after every ReLU; the skip layer is two products (embedding and hidden),
the view layer is the feature product plus a direction term: the plain
versions compute the direction term once per ray (once per point in
``fused_mlp_eval``); the ray kernels sum both products in one
accumulator at every sample, as the backward recomputes them.

Dispatch: a tensor on the CPU goes to the plain version; a CUDA tensor
goes to the kernel, or the wrapper raises.  Each wrapper counts its kernel
launches in ``<wrapper>.launches``; the two rays wrappers count their gated
launches (K4, K5) apart, in ``<wrapper>.gated_launches``.
"""
from __future__ import annotations

import copy
import ctypes
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.posenc import build_emb
from ..ops.render import GATE_ROWS, GATE_TILE, supports_kernels

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


def eval_flop_per_point(L_x: int = 10, L_d: int = 4) -> int:
    """The points kernel's full field: every point has its own direction
    term."""
    return eval_flop_per_sample(L_x) + eval_flop_per_ray(L_d)


def bwd_flop_per_point(L_x: int = 10, L_d: int = 4) -> int:
    """The points backward: the rays backward's count, plus the direction
    product it takes once per ray and the points backward once per
    point."""
    return bwd_flop_per_sample(L_x, L_d) + eval_flop_per_ray(L_d)


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


def kernel_weight_dtype(compute_dtype: str, device) -> torch.dtype:
    """The type the fused kernels see the packed weights in.  On a CUDA
    device bf16, whatever ``compute_dtype`` says: the CUDA kernels compute
    in bf16, as the JAX package's kernels do on the TPU (it packs float32
    and leaves ``compute_dtype`` to its XLA route).  On the CPU the
    config's type, so that the plain versions at ``float32`` reproduce the
    JAX package's float32 interpret mode."""
    if torch.device(device).type == "cuda" or compute_dtype == "bfloat16":
        return torch.bfloat16
    return torch.float32


def pack_nerf(model, cfg, device=None) -> Dict[str, Dict]:
    """Both MLPs of a ``NeRF`` prepared once, for a whole evaluation run,
    for the frame renderers: inside the kernels' domain packed in
    ``kernel_weight_dtype`` for the device they are packed onto; on the
    plain route (``ops/render.plain_route_reason``) a copy of the two
    modules on that device, tagged ``"route": "plain"``."""
    if device is None:
        device = next(model.parameters()).device
    if not supports_kernels(cfg):
        return {"route": "plain",
                "coarse": copy.deepcopy(model.model_coarse).to(device),
                "fine": copy.deepcopy(model.model_fine).to(device)}
    dtype = kernel_weight_dtype(cfg.compute_dtype, device)
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


def gate_mask(gate: torch.Tensor, s: int, n: int) -> torch.Tensor:
    """[S, N] bool: which samples a tile-major (128-ray tile, 8-sample
    row) gate leaves on."""
    g = gate.reshape(-(-n // GATE_TILE), s // GATE_ROWS) != 0     # [T, R]
    return g.T.repeat_interleave(GATE_ROWS, 0).repeat_interleave(
        GATE_TILE, 1)[:, :n]


def _gated_rows(gate: Optional[torch.Tensor], s: int, n: int):
    """(the gate's [S, N] mask or None, the sample rows to compute: those
    with any block on)."""
    if gate is None:
        return None, range(s)
    on = gate_mask(gate, s, n)
    return on, [k for k, a in enumerate(on.any(1).tolist()) if a]


def _sigma_head(x: torch.Tensor, packed: Dict[str, torch.Tensor],
                L_x: int) -> torch.Tensor:
    """Trunk and density head at points x [P, 3] -> float32 [P]."""
    h = _trunk(build_emb(x, L_x, EMBX_ROWS), packed)
    return _mm(h, packed["wdens"][:, None])[:, 0] + packed["bdens"]


def fused_mlp_sigma_rays_plain(od: torch.Tensor, z_t: torch.Tensor,
                               packed: Dict[str, torch.Tensor],
                               L_x: int = 10,
                               out_dtype: torch.dtype = torch.float32,
                               gate: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Plain PyTorch version of the sigma kernel, gated or not (one sample
    row at a time, so memory stays at a few [N, 256] activations; a row
    the gate leaves wholly off is not computed)."""
    s, n = z_t.shape
    o, d = od[0:3].T.float(), od[3:6].T.float()
    on, rows = _gated_rows(gate, s, n)
    out = torch.zeros((s, n), dtype=out_dtype, device=od.device)
    for k in rows:
        x = o + d * z_t[k][:, None].float()
        out[k] = _sigma_head(x, packed, L_x).to(out_dtype)
    return out if on is None else out.masked_fill_(~on, 0)


def fused_mlp_eval_rays_plain(od: torch.Tensor, z_t: torch.Tensor,
                              packed: Dict[str, torch.Tensor],
                              L_x: int = 10, L_d: int = 4,
                              out_dtype: torch.dtype = torch.float32,
                              gate: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the full-field kernel, gated or not ->
    (r, g, b, sigma)."""
    s, n = z_t.shape
    o, d = od[0:3].T.float(), od[3:6].T.float()
    inv = torch.rsqrt(torch.sum(d * d, -1, keepdim=True))
    hv_dir = _view_term(d * inv, packed, L_d)                # [N, 128] f32
    on, rows = _gated_rows(gate, s, n)
    outs = [torch.zeros((s, n), dtype=out_dtype, device=od.device)
            for _ in range(4)]
    for k in rows:
        x = o + d * z_t[k][:, None].float()
        rgb, sigma = _field(x, hv_dir, packed, L_x)
        for c in range(3):
            outs[c][k] = rgb[:, c].to(out_dtype)
        outs[3][k] = sigma.to(out_dtype)
    if on is not None:
        outs = [t.masked_fill_(~on, 0) for t in outs]
    return tuple(outs)


def _view_term(d: torch.Tensor, packed: Dict[str, torch.Tensor],
               L_d: int) -> torch.Tensor:
    """emb(d) @ wvd + bv for directions d [M, 3] -> float32 [M, 128]."""
    return _mm(build_emb(d, L_d, EMBD_ROWS), packed["wvd"]) + packed["bv"]


def _field(x: torch.Tensor, hv_dir: torch.Tensor,
           packed: Dict[str, torch.Tensor], L_x: int):
    """The full field at points x [M, 3] with their view terms [M, 128]
    -> (rgb [M, 3], sigma [M]) float32 logits."""
    cdt = packed["w"].dtype
    h = _trunk(build_emb(x, L_x, EMBX_ROWS), packed)
    sigma = _mm(h, packed["wdens"][:, None])[:, 0] + packed["bdens"]
    feat = (_mm(h, packed["wfeat"]) + packed["bfeat"]).to(cdt).float()
    hv = torch.relu(_mm(feat, packed["wvf"]) + hv_dir).to(cdt).float()
    return _mm(hv, packed["wcol"]) + packed["bcol"], sigma


def fused_mlp_eval_plain(xplane: torch.Tensor, dplane: torch.Tensor,
                         packed: Dict[str, torch.Tensor], L_x: int = 10,
                         L_d: int = 4, out_dtype: torch.dtype = torch.float32,
                         chunk: int = 65536) -> torch.Tensor:
    """Plain PyTorch version of the plane kernel: xplane, dplane [3, P] ->
    [4, P] (r, g, b, sigma), every point with its own direction term, the
    directions embedded as given (in chunks of points)."""
    x, d = xplane.T.float(), dplane.T.float()
    out = torch.empty((4, x.shape[0]), dtype=out_dtype, device=x.device)
    for i in range(0, x.shape[0], chunk):
        sl = slice(i, i + chunk)
        rgb, sigma = _field(x[sl], _view_term(d[sl], packed, L_d), packed,
                            L_x)
        out[0:3, sl] = rgb.T.to(out_dtype)
        out[3, sl] = sigma.to(out_dtype)
    return out


def fused_mlp_sigma_plain(xplane: torch.Tensor,
                          packed: Dict[str, torch.Tensor], L_x: int = 10,
                          out_dtype: torch.dtype = torch.float32,
                          chunk: int = 65536) -> torch.Tensor:
    """Plain PyTorch version of the points kernel: xplane [3, P] ->
    sigma [P] (in chunks of points, so a 128^3 grid stays in memory)."""
    x = xplane.T.float()
    out = torch.empty((x.shape[0],), dtype=out_dtype, device=x.device)
    for i in range(0, x.shape[0], chunk):
        out[i:i + chunk] = _sigma_head(x[i:i + chunk], packed, L_x)
    return out


# -------------------------------------------------------------- CUDA wrappers


def _check(od, z_t, packed, L_x, L_d, out_dtype, gate=None
           ) -> Tuple[int, int]:
    if z_t.dim() != 2 or od.dim() != 2 or od.shape != (8, z_t.shape[1]):
        raise ValueError(f"od must be [8, N] and z_t [S, N]; got "
                         f"{tuple(od.shape)}, {tuple(z_t.shape)}")
    for name, t in (("od", od), ("z_t", z_t)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
    if any(t.device != od.device for t in (z_t, packed["w"], packed["b"])):
        raise ValueError("od, z_t and the packed weights must share a device")
    _check_common(packed, L_x, L_d, out_dtype)
    s, n = z_t.shape
    if gate is not None:
        want = -(-n // GATE_TILE) * (s // GATE_ROWS)
        if s % GATE_ROWS:
            raise ValueError(f"a gate needs S % {GATE_ROWS} == 0; S={s}")
        if (gate.dtype != torch.int32 or gate.dim() != 1
                or gate.numel() != want or not gate.is_contiguous()
                or gate.device != od.device):
            raise ValueError(
                f"gate must be contiguous int32 [{want}] on {od.device}; "
                f"got {gate.dtype} {tuple(gate.shape)} on {gate.device}")
    return s, n


def _check_common(packed, L_x, L_d, out_dtype) -> None:
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype {out_dtype} (float32 or bfloat16)")
    if not (1 <= L_x <= 10 and 1 <= L_d <= 4):
        raise ValueError(f"L_x={L_x}, L_d={L_d} outside 1..10 / 1..4")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """csrc/fused_mlp.cu, built at first use, with its C signatures."""
    from . import build
    lib = build.load("fused_mlp")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.nerf_sigma_rays.argtypes = [p, p, p, p, p, i, i, i, i, p, p]
    lib.nerf_eval_rays.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, p,
                                   p]
    lib.nerf_sigma_points.argtypes = [p, p, p, p, i, i, i, p]
    lib.nerf_eval_points.argtypes = [p, p, p, p, p, i, i, i, i, p]
    lib.nerf_sigma_rays.restype = lib.nerf_eval_rays.restype = i
    lib.nerf_sigma_points.restype = lib.nerf_eval_points.restype = i
    lib.nerf_fwd_maps_us.argtypes = [p, i]
    lib.nerf_fwd_maps_us.restype = ctypes.c_double
    lib.nerf_rays_plan.argtypes = [i, i, i, p]
    lib.nerf_rays_plan.restype = None
    return lib


def rays_plan(n: int, s: int, gated: bool = False) -> Dict[str, int]:
    """How the ray kernels (K1/K5, K3/K4) launch at N rays x S samples
    (C ``nerf_rays_plan``; card only): blocks of the persistent walk,
    dynamic shared memory a block, the weight ring's stages, the units
    (128-ray tiles at one sample) of an ungated launch, blocks an SM
    holds."""
    out = (ctypes.c_long * 5)()
    _library().nerf_rays_plan(n, s, int(gated), out)
    return dict(zip(("blocks", "smem_bytes", "ring_stages", "units",
                     "blocks_per_sm"), out))


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


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def fused_mlp_sigma_rays(od: torch.Tensor, z_t: torch.Tensor,
                         packed: Dict[str, torch.Tensor], L_x: int = 10,
                         out_dtype: torch.dtype = torch.float32,
                         gate: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Density logits along rays: od [8, N], z_t [S, N] -> sigma [S, N];
    with ``gate`` (see the module docstring) gated blocks store 0."""
    s, n = _check(od, z_t, packed, L_x, 1, out_dtype, gate)
    if od.device.type == "cpu":
        return fused_mlp_sigma_rays_plain(od, z_t, packed, L_x, out_dtype,
                                          gate)
    lib = _cuda_lib(od, packed)
    out = torch.empty((s, n), dtype=out_dtype, device=od.device)
    if s * n == 0:
        return out
    with torch.cuda.device(od.device):
        rc = lib.nerf_sigma_rays(
            od.data_ptr(), z_t.data_ptr(), packed["w"].data_ptr(),
            packed["b"].data_ptr(), out.data_ptr(), n, s, L_x,
            int(out_dtype == torch.bfloat16), _ptr(gate),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "nerf_sigma_rays")
    if gate is None:
        fused_mlp_sigma_rays.launches += 1
    else:
        fused_mlp_sigma_rays.gated_launches += 1
    return out


fused_mlp_sigma_rays.launches = fused_mlp_sigma_rays.gated_launches = 0


def fused_mlp_eval_rays(od: torch.Tensor, z_t: torch.Tensor,
                        packed: Dict[str, torch.Tensor], L_x: int = 10,
                        L_d: int = 4,
                        out_dtype: torch.dtype = torch.float32,
                        gate: Optional[torch.Tensor] = None):
    """Full radiance field along rays: od [8, N], z_t [S, N] ->
    (r, g, b, sigma), each [S, N] raw logits; with ``gate`` gated blocks
    store 0 to all four."""
    s, n = _check(od, z_t, packed, L_x, L_d, out_dtype, gate)
    if od.device.type == "cpu":
        return fused_mlp_eval_rays_plain(od, z_t, packed, L_x, L_d,
                                         out_dtype, gate)
    lib = _cuda_lib(od, packed)
    outs = [torch.empty((s, n), dtype=out_dtype, device=od.device)
            for _ in range(4)]
    if s * n == 0:
        return tuple(outs)
    with torch.cuda.device(od.device):
        rc = lib.nerf_eval_rays(
            od.data_ptr(), z_t.data_ptr(), packed["w"].data_ptr(),
            packed["b"].data_ptr(), *(t.data_ptr() for t in outs), n, s,
            L_x, L_d, int(out_dtype == torch.bfloat16), _ptr(gate),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "nerf_eval_rays")
    if gate is None:
        fused_mlp_eval_rays.launches += 1
    else:
        fused_mlp_eval_rays.gated_launches += 1
    return tuple(outs)


fused_mlp_eval_rays.launches = fused_mlp_eval_rays.gated_launches = 0


def _check_planes(packed, *planes) -> int:
    """Every plane contiguous float32 [3, P] (one P) on the weights' device
    -> P."""
    p = planes[0].shape[-1] if planes[0].dim() == 2 else -1
    for t in planes:
        if (t.shape != (3, p) or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError(f"planes must be contiguous float32 [3, {p}]; "
                             f"got {t.dtype} {tuple(t.shape)}")
    if any(t.device != planes[0].device
           for t in (*planes, packed["w"], packed["b"])):
        raise ValueError("the planes and the packed weights must share a "
                         "device")
    return p


def fused_mlp_sigma(xplane: torch.Tensor, packed: Dict[str, torch.Tensor],
                    L_x: int = 10, out_dtype: torch.dtype = torch.float32
                    ) -> torch.Tensor:
    """Density logits at points: xplane [3, P] float32 -> sigma [P]."""
    _check_planes(packed, xplane)
    _check_common(packed, L_x, 1, out_dtype)
    if xplane.device.type == "cpu":
        return fused_mlp_sigma_plain(xplane, packed, L_x, out_dtype)
    lib = _cuda_lib(xplane, packed)
    p = xplane.shape[1]
    out = torch.empty((p,), dtype=out_dtype, device=xplane.device)
    if p == 0:
        return out
    with torch.cuda.device(xplane.device):
        rc = lib.nerf_sigma_points(
            xplane.data_ptr(), packed["w"].data_ptr(),
            packed["b"].data_ptr(), out.data_ptr(), p, L_x,
            int(out_dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "nerf_sigma_points")
    fused_mlp_sigma.launches += 1
    return out


fused_mlp_sigma.launches = 0


def fused_mlp_eval(xplane: torch.Tensor, dplane: torch.Tensor,
                   packed: Dict[str, torch.Tensor], L_x: int = 10,
                   L_d: int = 4, out_dtype: torch.dtype = torch.float32
                   ) -> torch.Tensor:
    """Full radiance field at points: positions xplane and directions
    dplane [3, P] float32 (the directions embedded as given: the callers
    pass unit vectors) -> [4, P] raw logits, rows r, g, b, sigma."""
    p = _check_planes(packed, xplane, dplane)
    _check_common(packed, L_x, L_d, out_dtype)
    if xplane.device.type == "cpu":
        return fused_mlp_eval_plain(xplane, dplane, packed, L_x, L_d,
                                    out_dtype)
    lib = _cuda_lib(xplane, packed)
    out = torch.empty((4, p), dtype=out_dtype, device=xplane.device)
    if p == 0:
        return out
    with torch.cuda.device(xplane.device):
        rc = lib.nerf_eval_points(
            xplane.data_ptr(), dplane.data_ptr(), packed["w"].data_ptr(),
            packed["b"].data_ptr(), out.data_ptr(), p, L_x, L_d,
            int(out_dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "nerf_eval_points")
    fused_mlp_eval.launches += 1
    return out


fused_mlp_eval.launches = 0
