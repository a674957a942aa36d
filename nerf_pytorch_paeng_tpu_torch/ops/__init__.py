from .posenc import build_emb, positional_encoding, posenc_out_dim
from .rays import get_rays, ndc_rays
from .render import hierarchical_z_vals, render_frame, render_rays
from .sampling import sample_pdf, sample_pdf_from_u, stratified_z_vals
from .so3 import so3_exp, vec2skew
from .volume import (volume_render, volume_render_planar,
                     volume_render_rays_t, weights_from_sigma,
                     weights_from_sigma_t)

__all__ = ["build_emb", "positional_encoding", "posenc_out_dim", "get_rays",
           "ndc_rays", "hierarchical_z_vals", "render_frame", "render_rays",
           "sample_pdf", "sample_pdf_from_u", "stratified_z_vals", "so3_exp",
           "vec2skew", "volume_render", "volume_render_planar",
           "volume_render_rays_t", "weights_from_sigma",
           "weights_from_sigma_t"]
