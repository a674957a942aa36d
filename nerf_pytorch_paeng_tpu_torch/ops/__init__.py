from .posenc import build_emb, positional_encoding, posenc_out_dim
from .rays import get_rays
from .render import hierarchical_z_vals
from .sampling import sample_pdf, sample_pdf_from_u, stratified_z_vals
from .volume import (volume_render_planar, volume_render_rays_t,
                     weights_from_sigma, weights_from_sigma_t)

__all__ = ["build_emb", "positional_encoding", "posenc_out_dim", "get_rays",
           "hierarchical_z_vals", "sample_pdf", "sample_pdf_from_u",
           "stratified_z_vals", "volume_render_planar", "volume_render_rays_t",
           "weights_from_sigma", "weights_from_sigma_t"]
