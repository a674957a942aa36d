"""NeRF in PyTorch with hand-written CUDA kernels for Hopper.

The port of ``nerf_pytorch_paeng_tpu`` (JAX/Pallas), which stays beside it
as the reference.  This package imports torch, numpy and the standard
library only.  Ported so far: training on blender scenes (both batch
modes, ungated), whose two MLP passes per step run the fused forward and
backward kernels (``kernels/csrc/fused_mlp.cu``, ``fused_mlp_vjp.cu``),
and held-out-view evaluation of a saved checkpoint through the exact
dense renderer (``--eval_only``).
"""
from .config import NerfConfig, config_from_file, load_config

__all__ = ["NerfConfig", "config_from_file", "load_config"]
