from .frame import make_frame_renderer
from .render import run_render
from .test import run_test

__all__ = ["make_frame_renderer", "run_render", "run_test"]
