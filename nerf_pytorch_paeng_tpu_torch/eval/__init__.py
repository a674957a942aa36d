from .frame import make_frame_renderer
from .test import run_test

__all__ = ["make_frame_renderer", "run_test"]
