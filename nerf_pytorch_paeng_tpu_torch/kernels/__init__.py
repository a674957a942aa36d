from . import fused_mlp_vjp, hash_grid, ngp_march, ngp_mlp
from .fused_mlp import (fused_mlp_eval, fused_mlp_eval_rays,
                        fused_mlp_eval_rays_plain, fused_mlp_sigma,
                        fused_mlp_sigma_rays, fused_mlp_sigma_rays_plain,
                        pack_nerf, pack_nerf_mlp_params)

# every wrapper's launch counter, (wrapper, attribute): the rays wrappers
# count their gated launches (K4, K5, K6) apart.  New counters are
# appended: readers take positions (k1_roofline.train reads 2 and 3)
LAUNCH_COUNTERS = (
    (fused_mlp_sigma_rays, "launches"), (fused_mlp_sigma_rays, "gated_launches"),
    (fused_mlp_eval_rays, "launches"), (fused_mlp_eval_rays, "gated_launches"),
    (fused_mlp_sigma, "launches"), (fused_mlp_eval, "launches"),
    (fused_mlp_vjp.fused_mlp_bwd_rays, "launches"),
    (fused_mlp_vjp.fused_mlp_bwd_rays, "gated_launches"),
    (fused_mlp_vjp.fused_mlp_bwd, "launches"),
    # Instant-NGP's kernels, appended: the hash encoding's launches and
    # points encoded, forward and backward; the marcher (count, scan and
    # compact a launch); the compositing forward and backward
    (hash_grid.hash_encode, "launches"), (hash_grid.hash_encode, "points"),
    (hash_grid.hash_encode_bwd, "launches"),
    (hash_grid.hash_encode_bwd, "points"),
    (ngp_march.march, "launches"), (ngp_march.composite_fwd, "launches"),
    (ngp_march.composite_bwd, "launches"),
    # the fused MLPs: N6, N7 and N7's reduce
    (ngp_mlp.ngp_mlp, "launches"), (ngp_mlp.ngp_mlp_bwd, "launches"),
    (ngp_mlp.ngp_mlp_reduce, "launches"))


def launch_counts() -> tuple:
    """The counters of ``LAUNCH_COUNTERS``, in its order."""
    return tuple(getattr(fn, attr) for fn, attr in LAUNCH_COUNTERS)


def add_launch_counts(delta, times: int = 1) -> None:
    """Add ``times`` x ``delta`` (``launch_counts`` order) to the counters:
    a CUDA graph replays the launches its capture recorded without calling
    the wrappers (``train/chunk.py``)."""
    for (fn, attr), d in zip(LAUNCH_COUNTERS, delta):
        setattr(fn, attr, getattr(fn, attr) + times * d)


__all__ = ["LAUNCH_COUNTERS", "add_launch_counts", "fused_mlp_eval",
           "fused_mlp_eval_rays", "fused_mlp_eval_rays_plain",
           "fused_mlp_sigma", "fused_mlp_sigma_rays",
           "fused_mlp_sigma_rays_plain", "launch_counts", "pack_nerf",
           "pack_nerf_mlp_params"]
