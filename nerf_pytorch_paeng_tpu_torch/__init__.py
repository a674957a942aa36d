"""NeRF in PyTorch with hand-written CUDA kernels for Hopper.

The port of ``nerf_pytorch_paeng_tpu`` (JAX/Pallas), which stays beside it
as the reference.  This package imports torch, numpy and the standard
library only.  Ported so far: held-out-view evaluation of a saved
checkpoint through the exact dense renderer (``--eval_only``), whose two
MLP passes run in the fused kernels of ``kernels/csrc/fused_mlp.cu``.
"""
from .config import NerfConfig, config_from_file, load_config

__all__ = ["NerfConfig", "config_from_file", "load_config"]
