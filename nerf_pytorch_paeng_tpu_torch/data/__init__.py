from .blender import load_blender
from .custom import load_custom
from .llff import load_llff
from .render_pose import get_render_pose, pose_spherical

__all__ = ["load_blender", "load_custom", "load_llff", "get_render_pose",
           "pose_spherical"]
