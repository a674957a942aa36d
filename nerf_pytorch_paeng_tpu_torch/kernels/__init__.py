from .fused_mlp import (fused_mlp_eval_rays, fused_mlp_eval_rays_plain,
                        fused_mlp_sigma_rays, fused_mlp_sigma_rays_plain,
                        pack_nerf, pack_nerf_mlp_params)

__all__ = ["fused_mlp_eval_rays", "fused_mlp_eval_rays_plain",
           "fused_mlp_sigma_rays", "fused_mlp_sigma_rays_plain", "pack_nerf",
           "pack_nerf_mlp_params"]
