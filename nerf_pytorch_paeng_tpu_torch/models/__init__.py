from .nerf import NeRF, NeRFMLP, init_nerf

__all__ = ["NeRF", "NeRFMLP", "init_nerf"]
