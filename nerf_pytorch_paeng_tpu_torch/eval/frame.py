"""Exact dense frame renderer on the fused kernels.

Counterpart of the JAX package's ``eval/frame._make_dense_frame_renderer``
ray-kernel branch (``render_cull="none"``, the path held-out evaluation
always takes).  Per block of rays:

1. stratified coarse depths;
2. the sigma kernel (``fused_mlp_sigma_rays``) over the coarse samples;
3. sample-major compositing weights;
4. inverse-CDF resample and the sorted merge (coarse + fine);
5. the full-field kernel (``fused_mlp_eval_rays``) over the merged samples;
6. sample-major compositing -> rgb, disparity.

Blocks only bound memory here (a block of 131072 rays at 64+128 samples
keeps the [S, N] buffers at a few hundred MB); the last block is ragged,
since the kernels mask the edge themselves.  Each frame makes one launch
of each kernel per block (``renderer.launches_per_frame``).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..kernels.fused_mlp import fused_mlp_eval_rays, fused_mlp_sigma_rays
from ..ops.rays import get_rays
from ..ops.render import hierarchical_z_vals, pack_od
from ..ops.sampling import stratified_z_vals
from ..ops.volume import volume_render_rays_t, weights_from_sigma_t

DEFAULT_BLOCK = 131072


def _check_supported(cfg) -> None:
    """The fused kernels take the reference architecture; this slice
    renders blender scenes with a fine pass."""
    if not (cfg.netDepth == 8 and cfg.netWidth == 256
            and 1 <= cfg.L_x <= 10 and 1 <= cfg.L_d <= 4):
        raise NotImplementedError(
            "the port renders the 8x256 reference MLP (1<=L_x<=10, "
            f"1<=L_d<=4) only; got {cfg.netDepth}x{cfg.netWidth}, "
            f"L_x={cfg.L_x}, L_d={cfg.L_d}")
    if cfg.N_samples_f <= 0:
        raise NotImplementedError("the port renders with a fine pass only")
    if cfg.data_type != "blender":
        raise NotImplementedError(
            f"data_type={cfg.data_type!r}: NDC rays are not ported yet")


def make_frame_renderer(cfg, H: int, W: int, K, device,
                        block_rays: Optional[int] = None,
                        stratified: bool = True,
                        sigma_fn: Callable = fused_mlp_sigma_rays,
                        field_fn: Callable = fused_mlp_eval_rays):
    """Returns ``render(packed, c2w, generator=None) -> (rgb [H,W,3],
    disp [H,W])`` for packed weights from ``kernels.fused_mlp.pack_nerf``.

    ``sigma_fn`` / ``field_fn`` default to the kernel wrappers; passing
    the plain versions renders the same frame without the kernels.  The
    kernels emit bf16 logits, as on the JAX package's frame path."""
    _check_supported(cfg)
    device = torch.device(device)
    n_total = H * W
    block = int(block_rays or cfg.chunk_rays or min(DEFAULT_BLOCK, n_total))
    n_coarse, n_fine = cfg.N_samples_c, cfg.N_samples_f
    near, far, perturb = float(cfg.near), float(cfg.far), float(cfg.perturb)

    def render_block(packed, rays_o, rays_d, generator):
        m = rays_o.shape[0]
        z_vals = stratified_z_vals(m, near, far, n_coarse,
                                   perturb=stratified, generator=generator,
                                   device=device)
        od = pack_od(rays_o, rays_d)
        sigma_t = sigma_fn(od, z_vals.T.contiguous(), packed["coarse"],
                           L_x=cfg.L_x, out_dtype=torch.bfloat16)
        weights = weights_from_sigma_t(sigma_t, z_vals.T, rays_d).T
        z_all = hierarchical_z_vals(z_vals, weights, n_fine=n_fine,
                                    perturb=perturb, generator=generator)
        z_t = z_all.T.contiguous()
        r, g, b, sg = field_fn(od, z_t, packed["fine"], L_x=cfg.L_x,
                               L_d=cfg.L_d, out_dtype=torch.bfloat16)
        out = volume_render_rays_t(r, g, b, sg, z_t, rays_d)
        return out.rgb, out.disp

    @torch.no_grad()
    def render(packed, c2w, generator: Optional[torch.Generator] = None):
        c2w = torch.as_tensor(c2w, dtype=torch.float32, device=device)
        rays_o, rays_d = get_rays(H, W, K, c2w)
        rays_o = rays_o.reshape(-1, 3).contiguous()
        rays_d = rays_d.reshape(-1, 3).contiguous()
        parts = [render_block(packed, rays_o[i:i + block],
                              rays_d[i:i + block], generator)
                 for i in range(0, n_total, block)]
        rgb = torch.cat([p[0] for p in parts], 0).reshape(H, W, 3)
        disp = torch.cat([p[1] for p in parts], 0).reshape(H, W)
        return rgb, disp

    render.block = block
    render.launches_per_frame = -(-n_total // block)   # per kernel
    return render
