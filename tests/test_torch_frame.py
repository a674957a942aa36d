"""The whole slice, one frame: the port's dense frame renderer against the
JAX package's ``make_frame_renderer`` (``render_cull="none"``, ray-kernel
branch, Pallas in interpret mode), deterministic sampling, float32
compute, full 8x256 width with 8+8 samples on a 16x16 frame.

Tolerances follow tests/test_reference_parity.py: the fine outputs pass
through the inverse-CDF resample, where ulp-level differences can flip
which coarse bin a fine sample lands in, so they are pinned by outlier
fraction (< 0.2 %), max (2e-2 rgb, 8e-2 disp) and mean; the coarse-pass
quantities, which feed the resample, are held to the strict tolerance."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_pytorch_paeng_tpu.config import NerfConfig as JaxConfig
from nerf_pytorch_paeng_tpu.eval.frame import make_frame_renderer as jax_mfr
from nerf_pytorch_paeng_tpu.models.nerf import NeRF as JaxNeRF
from nerf_pytorch_paeng_tpu_torch.config import NerfConfig
from nerf_pytorch_paeng_tpu_torch.eval.frame import (make_frame_renderer,
                                                     pack_od)
from nerf_pytorch_paeng_tpu_torch.kernels.fused_mlp import (
    fused_mlp_eval_plain, fused_mlp_eval_rays_plain,
    fused_mlp_sigma_rays_plain, pack_nerf)
from nerf_pytorch_paeng_tpu_torch.models.nerf import NeRF
from nerf_pytorch_paeng_tpu_torch.utils.interop import \
    state_dict_from_jax_params
from nerf_pytorch_paeng_tpu_torch.utils.synth import make_synth_scene

from torch_port_util import np_nerf_params, to_jax

H = W = 16
KW = dict(netDepth=8, netWidth=256, L_x=10, L_d=4, N_samples_c=8,
          N_samples_f=8, near=2.0, far=6.0, perturb=0.0,
          compute_dtype="float32", render_cull="none")


def _outliers(name, ours, ref, tol, cap):
    diff = np.abs(ours - ref)
    frac_out = float((diff > tol + tol * np.abs(ref)).mean())
    assert frac_out < 2e-3, (name, frac_out)
    assert float(diff.max()) < cap, (name, float(diff.max()))
    assert float(diff.mean()) < 1e-4, (name, float(diff.mean()))


@pytest.fixture(scope="module")
def scene():
    params = np_nerf_params(11)
    _, K, poses = make_synth_scene(n_views=2, H=H, W=W)
    model = NeRF()
    model.load_state_dict(state_dict_from_jax_params(params))
    return params, model, K, poses


@pytest.mark.parametrize("view", [0, 1])
def test_dense_frame_matches_jax(scene, view):
    params, model, K, poses = scene
    jcfg = JaxConfig(use_pallas=True, **KW)
    jrender = jax_mfr(JaxNeRF(compute_dtype=jnp.float32), jcfg, H, W, K,
                      stratified=False)
    jrgb, jdisp = jrender(to_jax(params), jnp.asarray(poses[view][:3, :4]),
                          jax.random.PRNGKey(0))

    cfg = NerfConfig(device="cpu", **KW)
    render = make_frame_renderer(cfg, H, W, K, "cpu", stratified=False)
    rgb, disp = render(pack_nerf(model, cfg), torch.from_numpy(poses[view]))
    assert rgb.shape == (H, W, 3) and disp.shape == (H, W)
    assert render.launches_per_frame == 1 and render.block == H * W
    _outliers("rgb", rgb.numpy(), np.asarray(jrgb), 2e-3, 2e-2)
    _outliers("disp", disp.numpy(), np.asarray(jdisp), 5e-3, 8e-2)


def test_blocks_do_not_change_the_frame(scene):
    """Ray blocks are a memory knob: a ragged 3-block split renders the
    same frame as one block (deterministic sampling).  The CPU's matmul
    blocking depends on the row count, so the sums differ by ulps and the
    fine resample can flip a tie (u = 0 and u = 1 sit on the CDF's ends):
    held like the JAX comparison."""
    _, model, K, poses = scene
    cfg = NerfConfig(device="cpu", **KW)
    packed = pack_nerf(model, cfg)
    c2w = torch.from_numpy(poses[0])
    one = make_frame_renderer(cfg, H, W, K, "cpu", stratified=False)
    three = make_frame_renderer(cfg, H, W, K, "cpu", stratified=False,
                                block_rays=100)
    assert three.launches_per_frame == 3
    (rgb1, disp1), (rgb3, disp3) = one(packed, c2w), three(packed, c2w)
    _outliers("rgb", rgb3.numpy(), rgb1.numpy(), 2e-3, 2e-2)
    _outliers("disp", disp3.numpy(), disp1.numpy(), 5e-3, 8e-2)


def test_plain_functions_render_the_same_frame(scene):
    """The renderer takes injected field functions (chip_smoke.py renders
    with the plain versions on the card to check the kernels end to
    end); on the CPU the wrappers are those plain versions."""
    _, model, K, poses = scene
    cfg = NerfConfig(device="cpu", **KW)
    packed = pack_nerf(model, cfg)
    c2w = torch.from_numpy(poses[1])
    a = make_frame_renderer(cfg, H, W, K, "cpu", stratified=False)
    b = make_frame_renderer(cfg, H, W, K, "cpu", stratified=False,
                            sigma_fn=fused_mlp_sigma_rays_plain,
                            field_fn=fused_mlp_eval_rays_plain)
    for x, y in zip(a(packed, c2w), b(packed, c2w)):
        assert torch.equal(x, y)


def test_stratified_frame_is_seeded(scene):
    _, model, K, poses = scene
    cfg = NerfConfig(device="cpu", **dict(KW, perturb=1.0))
    packed = pack_nerf(model, cfg)
    render = make_frame_renderer(cfg, H, W, K, "cpu")
    c2w = torch.from_numpy(poses[0])
    a = render(packed, c2w, torch.Generator().manual_seed(1))
    b = render(packed, c2w, torch.Generator().manual_seed(1))
    c = render(packed, c2w, torch.Generator().manual_seed(2))
    assert torch.equal(a[0], b[0]) and not torch.equal(a[0], c[0])
    assert bool(torch.isfinite(a[0]).all() and torch.isfinite(a[1]).all())


def test_pack_od_layout():
    o = torch.arange(12.0).reshape(4, 3)
    d = -torch.arange(12.0).reshape(4, 3)
    od = pack_od(o, d)
    assert od.shape == (8, 4) and od.is_contiguous()
    assert torch.equal(od[0:3], o.T) and torch.equal(od[3:6], d.T)
    assert not od[6:].any()


@pytest.mark.parametrize("bad", [dict(netWidth=128), dict(L_d=5)])
def test_unsupported_configs_raise(bad):
    """Architectures the kernels do not take, once refused, render through
    the plain route: a finite frame from the config's own model."""
    from nerf_pytorch_paeng_tpu_torch.models.nerf import init_nerf
    cfg = NerfConfig(device="cpu", **dict(KW, **bad))
    _, K, poses = make_synth_scene(n_views=1, H=H, W=W)
    render = make_frame_renderer(cfg, H, W, K, "cpu", stratified=False)
    assert render.route == "plain" and not render.rays_route
    rgb, disp = render(pack_nerf(init_nerf(cfg), cfg),
                       torch.from_numpy(poses[0]))
    assert rgb.shape == (H, W, 3) and bool(torch.isfinite(rgb).all())
    assert bool(torch.isfinite(disp).all())


@pytest.mark.parametrize("cull", ["none", "auto"])
def test_llff_config_renders_ndc_rays(scene, cull):
    """An LLFF config, once refused, renders through both renderers: the
    frame is that of the NDC rays (``ndc_rays`` of the camera's rays, near
    1), which a blender config given those rays as its camera's would not
    see, so the two frames differ."""
    from nerf_pytorch_paeng_tpu_torch.eval.frame import _make_ray_gen
    from nerf_pytorch_paeng_tpu_torch.ops.rays import get_rays, ndc_rays
    _, model, K, poses = scene
    kw = dict(KW, near=0.0, far=1.0, render_cull=cull)
    cfg = NerfConfig(device="cpu", data_type="llff", **kw)
    c2w = torch.from_numpy(poses[0])
    o, d = get_rays(H, W, K, c2w[:3, :4])
    want = ndc_rays(H, W, float(K[0, 0]), 1.0, o.reshape(-1, 3),
                    d.reshape(-1, 3))
    got = _make_ray_gen(cfg, H, W, K, torch.device("cpu"))(c2w)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    packed = pack_nerf(model, cfg)
    rgb, disp = make_frame_renderer(cfg, H, W, K, "cpu",
                                    stratified=False)(packed, c2w)
    assert rgb.shape == (H, W, 3) and bool(torch.isfinite(rgb).all())
    assert bool(torch.isfinite(disp).all())
    world = make_frame_renderer(NerfConfig(device="cpu", **kw), H, W, K,
                                "cpu", stratified=False)(packed, c2w)
    assert not torch.equal(rgb, world[0])


def test_coarse_only_frame_renders_through_the_plane_kernel(scene):
    """Without a fine pass the dense renderer takes the plane layout (K8,
    ``fused_mlp_eval``) as the JAX package does; on the CPU the wrapper is
    its plain version, so passing that renders the same frame, and the ray
    kernels are never called."""
    _, model, K, poses = scene
    cfg = NerfConfig(device="cpu", **dict(KW, N_samples_f=0))
    packed = pack_nerf(model, cfg)
    c2w = torch.from_numpy(poses[0])

    def never(*a, **kw):
        raise AssertionError("a ray kernel ran on the coarse-only frame")

    a = make_frame_renderer(cfg, H, W, K, "cpu", stratified=False)
    b = make_frame_renderer(cfg, H, W, K, "cpu", stratified=False,
                            sigma_fn=never, field_fn=never,
                            plane_fn=fused_mlp_eval_plain)
    assert not a.rays_route and a.launches_per_frame == 1
    rgb, disp = a(packed, c2w)
    assert rgb.shape == (H, W, 3) and bool(torch.isfinite(disp).all())
    for x, y in zip((rgb, disp), b(packed, c2w)):
        assert torch.equal(x, y)


def test_config_knobs_are_the_jax_packages():
    """The port's NerfConfig has every field of the JAX package's, with its
    default, and its own (``config.PORT_ONLY``): ``device`` and the
    architecture's keys (``arch``, default NeRF, and Instant-NGP's
    ``ngp_*``); the JAX package's run knobs (``scan_chunk``, ``profile``,
    ``check_nans``, ``compile_cache``) are among them."""
    from nerf_pytorch_paeng_tpu_torch.config import PORT_ONLY
    ours = {f.name: f.default for f in dataclasses.fields(NerfConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    assert set(ours) - set(theirs) == set(PORT_ONLY)
    assert {"device", "arch"} <= set(PORT_ONLY) and ours["arch"] == "nerf"
    assert all(k in ("device", "arch") or k.startswith("ngp_")
               for k in PORT_ONLY)
    assert set(theirs) <= set(ours)
    for k, v in ours.items():
        assert k in PORT_ONLY or theirs[k] == v, k
    for name in ("scan_chunk", "profile", "check_nans", "compile_cache"):
        assert name in theirs and name in ours, name