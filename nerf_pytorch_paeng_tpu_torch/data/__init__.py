from .blender import load_blender

__all__ = ["load_blender"]
