"""Hierarchical resampling and the training render (counterpart of the JAX
package's ``ops/render.py``: ``hierarchical_z_vals``,
``supports_train_rays_kernels`` and ``render_rays_train`` ungated)."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .sampling import sample_pdf, stratified_z_vals
from .volume import volume_render_rays_t


class RaysRender(NamedTuple):
    rgb_c: torch.Tensor                 # [N, 3]
    disp_c: torch.Tensor                # [N]
    rgb_f: Optional[torch.Tensor]
    disp_f: Optional[torch.Tensor]
    acc_f: Optional[torch.Tensor]
    depth_f: Optional[torch.Tensor]


def pack_od(rays_o: torch.Tensor, rays_d: torch.Tensor) -> torch.Tensor:
    """[M, 3] + [M, 3] -> the kernels' [8, M] layout (rows 6-7 zero)."""
    return torch.cat([rays_o.T, rays_d.T, rays_o.new_zeros(2, len(rays_o))],
                     0).contiguous()


def hierarchical_z_vals(z_vals: torch.Tensor, weights: torch.Tensor, *,
                        n_fine: int, perturb: float = 1.0,
                        generator: Optional[torch.Generator] = None,
                        u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Merged, sorted coarse+fine depths from the coarse sampling stats:
    z_vals [M, Sc] sorted, weights [M, Sc] -> [M, Sc + n_fine].  The fine
    depths carry no gradient, and every coarse sample stays in the merge
    (the reference semantics)."""
    z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    z_samples = sample_pdf(z_mid, weights[..., 1:-1], n_fine,
                           det=(perturb == 0.0), generator=generator, u=u)
    z_samples = z_samples.detach()
    return torch.sort(torch.cat([z_vals, z_samples], -1), -1).values


def supports_train_rays_kernels(cfg, n_rays: int) -> bool:
    """Shapes the ray-major training pair takes: a multiple of 128 rays and
    sample counts (coarse, merged) that are multiples of 8."""
    s_merged = cfg.N_samples_c + cfg.N_samples_f
    return (cfg.N_samples_c % 8 == 0
            and (cfg.N_samples_f == 0 or s_merged % 8 == 0)
            and n_rays % 128 == 0)


def render_rays_train(model, rays_o: torch.Tensor, rays_d: torch.Tensor,
                      cfg, generator: Optional[torch.Generator] = None,
                      u_c: Optional[torch.Tensor] = None,
                      u_f: Optional[torch.Tensor] = None) -> RaysRender:
    """Training render of a ``NeRF`` on the ray-major kernel pair
    (``kernels/fused_mlp_vjp.fused_mlp_train_rays``): jittered coarse
    depths, the coarse pass, compositing, the inverse-CDF fine depths (no
    gradient) merged with the coarse ones, the fine pass over all of them,
    compositing.  Each pass packs its module's float32 parameters
    differentiably, so ``loss.backward()`` reaches the module.

    rays_o, rays_d [N, 3]; the draws come from ``generator`` (coarse
    jitter first, then the fine uniforms) or are injected as ``u_c``
    [N, Sc] and ``u_f`` [N, Sf]."""
    from ..kernels.fused_mlp import pack_flat
    from ..kernels.fused_mlp_vjp import fused_mlp_train_rays

    n = rays_o.shape[0]
    if not supports_train_rays_kernels(cfg, n):
        raise NotImplementedError(
            f"N_rays={n}, N_samples_c={cfg.N_samples_c}, "
            f"N_samples_f={cfg.N_samples_f}: the ray-major training kernels "
            "take a multiple of 128 rays and sample counts that are "
            "multiples of 8; the plane-layout training path (K8/K9) that "
            "takes other shapes is not ported yet")
    wdt = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
           else torch.float32)
    near, far = float(cfg.near), float(cfg.far)
    od = pack_od(rays_o, rays_d)

    def field(mlp, z_t):
        w, b = pack_flat(mlp, cfg.L_x, cfg.L_d)
        r, g, b_, sg = fused_mlp_train_rays(w, b, od, z_t, cfg.L_x, cfg.L_d,
                                            wdt)
        return volume_render_rays_t(r, g, b_, sg, z_t, rays_d)

    z_vals = stratified_z_vals(n, near, far, cfg.N_samples_c, perturb=True,
                               generator=generator, u=u_c,
                               device=rays_o.device)
    out_c = field(model.model_coarse, z_vals.T.contiguous())
    if cfg.N_samples_f <= 0:
        return RaysRender(out_c.rgb, out_c.disp, None, None, None, None)
    z_all = hierarchical_z_vals(z_vals, out_c.weights.detach().T,
                                n_fine=cfg.N_samples_f,
                                perturb=float(cfg.perturb),
                                generator=generator, u=u_f)
    out_f = field(model.model_fine, z_all.T.contiguous())
    return RaysRender(out_c.rgb, out_c.disp, out_f.rgb, out_f.disp,
                      out_f.acc, out_f.depth)
