"""NeRF in PyTorch with hand-written CUDA kernels for Hopper.

The port of ``nerf_pytorch_paeng_tpu`` (JAX/Pallas), which stays beside it
as the reference.  This package imports torch, numpy, Pillow and the
standard library, and cv2 where it resizes images or decodes video.
Ported so far: the blender, LLFF (NDC rays, the spiral render path) and
custom loaders with the COLMAP bridge; training in both batch modes,
ungated or occupancy-gated, whose two MLP passes per step run the fused
forward and backward kernels (``kernels/csrc/fused_mlp.cu``,
``fused_mlp_vjp.cu``); held-out-view evaluation through the exact dense
renderer (``--eval_only``, with LPIPS given VGG16 weights) and novel
views through the culled one (``--render_only``); data parallelism over
the ranks of a torchrun launch (``parallel/``).
"""
from .config import NerfConfig, config_from_file, load_config

__all__ = ["NerfConfig", "config_from_file", "load_config"]
