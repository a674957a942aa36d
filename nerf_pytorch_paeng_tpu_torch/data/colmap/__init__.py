from .poses import gen_poses
from .read_model import (detect_model_ext, qvec2rotmat, read_cameras_binary,
                         read_cameras_text, read_images_binary,
                         read_images_text, read_model, read_points3d_binary,
                         read_points3d_text)
from .wrapper import run_colmap

__all__ = ["gen_poses", "detect_model_ext", "qvec2rotmat",
           "read_cameras_binary", "read_cameras_text", "read_images_binary",
           "read_images_text", "read_model", "read_points3d_binary",
           "read_points3d_text", "run_colmap"]
