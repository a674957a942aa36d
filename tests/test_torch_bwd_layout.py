"""What the Hopper backward (kernels/csrc/fused_mlp_vjp.cu) rests on in the
packed weights, held on the CPU against kernels/fused_mlp.py and the JAX
package's packing.

The chain launch streams its weights by TMA from one tensor map over the
256-wide matrices w0 .. wfeat and one over wvf and wvd, so they must lie
back to back in the packed weights, at 256- and 128-element rows; the
weight-gradient launch's 12 products must cover every weight below wdens
once.  The stash layout is held by the kernel's own ``static_assert``s,
and the kernels themselves need the card (tests/test_torch_cuda.py).
"""
import numpy as np
import pytest

from nerf_pytorch_paeng_tpu.kernels import fused_mlp as jfm
from nerf_pytorch_paeng_tpu_torch.kernels import fused_mlp as fm

TRUNK = ("w0", "w1", "w2", "w3", "w4", "w5e", "w5h", "w6", "w7", "wfeat")


def _shapes():
    return dict(fm._W_LAYOUT)


@pytest.mark.parametrize("names,width", [(TRUNK, 256), (("wvf", "wvd"), 128)])
def test_chain_weight_maps_cover_contiguous_rows(names, width):
    """Each group is one row-major [rows][width] array in the packed
    weights (the chain launch's tensor maps), in the JAX package's shapes
    ([out, in] there, [in, out] here)."""
    shapes = _shapes()
    jshapes = {k: v.shape for k, v in jfm.pack_nerf_mlp_params(
        _jax_params()).items()}
    at = fm.W_OFFSETS[names[0]]
    for name in names:
        rows, cols = shapes[name]
        assert cols == width and fm.W_OFFSETS[name] == at, name
        assert fm.W_OFFSETS[name] % width == 0
        assert tuple(jshapes[name]) == (cols, rows), name
        at += rows * cols
    assert at == fm.W_OFFSETS["wvf" if width == 256 else "wdens"]


def _jax_params():
    from torch_port_util import np_nerf_params, to_jax
    return to_jax(np_nerf_params(0)["fine"])


def test_wgrad_products_cover_the_weights_once():
    """The 12 weight-gradient products (the kernel's wjob order) are the
    packed weights below wdens, each once and back to back: their FLOP is
    2 x OFF_WDENS = 2 x 593,920 a point."""
    shapes = _shapes()
    order = TRUNK + ("wvf", "wvd")
    at = 0
    for name in order:
        assert fm.W_OFFSETS[name] == at, name
        at += int(np.prod(shapes[name]))
    assert at == fm.W_OFFSETS["wdens"] == 593_920

