"""The sample-sharded path of the port (``sp_shards``;
``nerf_pytorch_paeng_tpu_torch/parallel/sp.py`` and the frame renderer's
``_make_sp_frame_renderer``) on the CPU: the log-space exclusive product
against the cumprod form and against the JAX package's associative scan,
the distributed composite and renders of 2 gloo ranks against the
one-process composite, the frame of 2 ranks (1 data x 2 model) and of 4
(2 x 2) against the port's dense frame and against the JAX package's
sample-sharded frame on ``make_mesh(1, 2)`` (the tiny MLP on its XLA
route; the reference MLP with K8's plain version against its Pallas
kernel in interpret mode), the renderer's routing, and the CLI.

The ranks are processes started as ``tests/test_torch_parallel.py``
starts them (``tests/torch_dist_worker.py``, 120 s a rank).

Tolerances:
- the log-space scan against the cumprod form and against JAX: 1e-5
  relative, 1e-7 absolute (a log and an exp a factor);
- the composite, the renders and the frames against one process, and the
  tiny frame against JAX: those of the JAX package's
  ``tests/test_sample_sharding.py:188-207`` (rgb and acc rtol 1e-4, atol
  1e-5; disparity atol 1e-4); the JAX package's own fine pass there holds
  its acc to rtol 1e-3, atol 1e-4 (the distributed scan reorders the
  product), and so does the full render's acc here;
- the reference-MLP frame against JAX's Pallas path: the repo's fine-
  output convention (``tests/test_torch_plane.py``'s ``_outliers``: at
  most 0.2% of values beyond 2e-3, none beyond 2e-2).
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_pytorch_paeng_tpu.config import NerfConfig as JaxConfig
from nerf_pytorch_paeng_tpu.eval import frame as jframe
from nerf_pytorch_paeng_tpu.models.nerf import NeRF as JaxNeRF
from nerf_pytorch_paeng_tpu.ops import volume as jvolume
from nerf_pytorch_paeng_tpu.parallel import make_mesh
from nerf_pytorch_paeng_tpu_torch.config import NerfConfig
from nerf_pytorch_paeng_tpu_torch.eval.frame import make_frame_renderer
from nerf_pytorch_paeng_tpu_torch.kernels.fused_mlp import pack_nerf
from nerf_pytorch_paeng_tpu_torch.models.nerf import NeRF
from nerf_pytorch_paeng_tpu_torch.ops import volume
from nerf_pytorch_paeng_tpu_torch.ops.render import (direction_plane,
                                                     hierarchical_fine_pass,
                                                     make_plain_field_fns,
                                                     position_plane)
from nerf_pytorch_paeng_tpu_torch.utils.interop import \
    state_dict_from_jax_params
from nerf_pytorch_paeng_tpu_torch.utils.synth import (make_synth_scene,
                                                      save_as_blender_dataset)

import torch_dist_worker as tdw
from test_torch_parallel import ROOT, _launch, _results, _start_worker
from torch_port_util import np_nerf_params, to_jax

TINY = dict(depth=4, width=64, L_x=6, L_d=2)
FULL = dict(depth=8, width=256, L_x=10, L_d=4)


def _close(a, b, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


# --------------------------------------------------- the log-space scan


def _scan_inputs(seed: int):
    """1 - alpha + 1e-10 of random densities over [8, 24] samples, one
    ray fully opaque at one sample (alpha 1: the clamp's case)."""
    rng = np.random.default_rng(seed)
    alpha = 1.0 - np.exp(-rng.exponential(0.5, (8, 24)))
    alpha[3, 5] = 1.0
    return (1.0 - alpha + 1e-10).astype(np.float32)


@pytest.mark.parametrize("axis", [-1, 0])
def test_associative_scan_equals_the_cumprod_form(axis):
    x = torch.from_numpy(_scan_inputs(0))
    x = x if axis == -1 else x.T.contiguous()
    got = volume.exclusive_cumprod(x, axis, scan_impl="associative")
    want = volume.exclusive_cumprod(x, axis)
    assert torch.isfinite(got).all()
    _close(got, want, rtol=1e-5, atol=1e-7)
    first = got.narrow(axis, 0, 1)
    assert torch.equal(first, torch.ones_like(first))


@pytest.mark.parametrize("axis", [-1, 0])
def test_associative_scan_equals_the_jax_packages(axis):
    x = _scan_inputs(1)
    x = x if axis == -1 else np.ascontiguousarray(x.T)
    got = volume.exclusive_cumprod(torch.from_numpy(x), axis,
                                   scan_impl="associative")
    want = jvolume.exclusive_cumprod(jnp.asarray(x), "associative", axis)
    _close(got, want, rtol=1e-5, atol=1e-7)


# ------------------------------------------------------------ the ranks


def _frame_cfgs(**kw):
    """(JAX config, port config) of the sample-sharded frames."""
    base = dict(N_samples_c=16, N_samples_f=16, near=2.0, far=6.0,
                perturb=0.0, render_cull="none", use_pallas=False,
                compute_dtype="float32", chunk_rays=32, netDepth=4,
                netWidth=64, L_x=6, L_d=2, sp_shards=2, n_model_shards=2)
    base.update(kw)
    return JaxConfig(**base), tdw.sp_frame_cfg(**{
        k: v for k, v in base.items() if k not in ("perturb",)})


@pytest.fixture(scope="module")
def sp(tmp_path_factory):
    """The port's jobs at 2 ranks (1 x 2) and 4 ranks (2 x 2), one launch
    at a time, on seeded inputs."""
    rng = np.random.default_rng(11)
    n, s = 24, 16
    rays_o = rng.normal(0, 0.3, (n, 3)) + np.array([0.0, 0.0, 4.0])
    rays_d = -rays_o / 4.0 + rng.normal(0, 0.2, (n, 3))
    z = np.sort(rng.uniform(2.0, 6.0, (n, s)), -1)
    raw = rng.normal(0, 2.0, (4, n, s))
    inputs = dict(
        sp_raw=torch.from_numpy(raw.astype(np.float32)),
        sp_z=torch.from_numpy(z.astype(np.float32)),
        sp_rays_o=torch.from_numpy(rays_o.astype(np.float32)),
        sp_rays_d=torch.from_numpy(rays_d.astype(np.float32)),
        sp_u=torch.from_numpy(rng.uniform(size=(n, 16)).astype(np.float32)),
        sp_sd=state_dict_from_jax_params(np_nerf_params(21, **TINY)),
        sp_sd_full=state_dict_from_jax_params(np_nerf_params(22, **FULL)))
    base = tmp_path_factory.mktemp("sp")
    two = _results(_start_worker(2, inputs, base / "w2",
                                 ["sp_composite", "sp_frames"]))
    four = _results(_start_worker(4, inputs, base / "w4",
                                  ["sp_composite", "sp_frames"]))
    return dict(two=two, four=four, inputs=inputs)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_composite_equals_volume_render_planar(sp, world):
    """Each rank composites its 8 of 16 samples of every ray: rgb, disp,
    acc and depth of the whole rays, alike on the ranks; its weights are
    its columns of the one-process weights."""
    inp = sp["inputs"]
    want = volume.volume_render_planar(inp["sp_raw"], inp["sp_z"],
                                       inp["sp_rays_d"])
    ranks = [res["sp_composite"] for res in sp["two" if world == 2
                                                 else "four"]]
    for res in ranks:
        for k in ("rgb", "acc", "depth"):
            _close(res[k], getattr(want, k))
        _close(res["disp"], want.disp, atol=1e-4)
        cols = slice(res["index"] * 8, res["index"] * 8 + 8)
        _close(res["weights"], want.weights[:, cols])
        for k in ("rgb", "disp", "acc"):
            assert torch.equal(res[k], ranks[0][k])


def test_sharded_renders_equal_the_unsharded_render(sp):
    """``make_sample_sharded_render`` (one pass) and
    ``make_sample_sharded_render_full`` (coarse + fine at the same fine
    uniforms) of 2 ranks against the one-process render."""
    inp = sp["inputs"]
    cfg = NerfConfig(device="cpu", N_samples_c=16, N_samples_f=16,
                     **tdw.TINY)
    model = NeRF(**TINY)
    model.load_state_dict(inp["sp_sd"])
    coarse, fine = make_plain_field_fns(model, cfg)
    o, d, z = inp["sp_rays_o"], inp["sp_rays_d"], inp["sp_z"]
    vd = d / d.norm(dim=-1, keepdim=True)
    with torch.no_grad():
        raw = coarse(position_plane(o, d, z), direction_plane(vd, 16))
        want = volume.volume_render_planar(raw.reshape(4, 24, 16), z, d)
        out_f = hierarchical_fine_pass(fine, o, d, z, want.weights,
                                       n_fine=16, perturb=1.0, u=inp["sp_u"])
    got = sp["two"][0]["sp_composite"]["render"]
    _close(got[0], want.rgb)
    _close(got[1], want.disp, atol=1e-4)
    _close(got[2], want.acc)

    # the full render against the unsharded passes given the same coarse
    # depths and fine uniforms
    rgb_c, rgb_f, disp_f, acc_f = sp["two"][0]["sp_composite"]["render_full"]
    _close(rgb_c, want.rgb)
    _close(rgb_f, out_f.rgb)
    _close(disp_f, out_f.disp, atol=1e-4)
    _close(acc_f, out_f.acc, rtol=1e-3, atol=1e-4)


def _dense(name: str, sd):
    """The port's dense frame of the worker's frame ``name`` (same config
    without the sample split, same generator)."""
    hw, kw, stratified = {
        "tiny_jitter": (16, {}, True), "tiny": (8, {}, False),
        "full": (4, dict(netDepth=8, netWidth=256, L_x=10, L_d=4,
                         N_samples_c=8, N_samples_f=8, use_pallas=True),
                 False)}[name]
    cfg = tdw.sp_frame_cfg(**kw)
    _, K, poses = make_synth_scene(n_views=1, H=hw, W=hw)
    model = NeRF(depth=cfg.netDepth, width=cfg.netWidth, L_x=cfg.L_x,
                 L_d=cfg.L_d)
    model.load_state_dict(sd)
    r = make_frame_renderer(cfg, hw, hw, K, "cpu", stratified=stratified)
    return r(pack_nerf(model, cfg), torch.from_numpy(poses[0]),
             torch.Generator().manual_seed(9))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["tiny_jitter", "tiny", "full"])
def test_sp_frame_equals_the_dense_frame(sp, world, name):
    """The sample-sharded frame on ``world`` ranks against the port's dense
    frame of the same weights and draws (the tiny MLP with and without
    the coarse jitter, the reference MLP on K8's and K3/K1's plain
    versions); alike on every rank; the route is the plane kernel's in
    the kernels' domain, the plain MLP's outside it."""
    ranks = [res["sp_frames"] for res in sp["two" if world == 2
                                             else "four"]]
    sd = sp["inputs"]["sp_sd_full" if name == "full" else "sp_sd"]
    rgb_d, disp_d = _dense(name, sd)
    rgb, disp = ranks[0][name]
    _close(rgb, rgb_d)
    _close(disp, disp_d, atol=1e-4)
    for res in ranks[1:]:
        assert all(torch.equal(a, b) for a, b in zip(res[name],
                                                     ranks[0][name]))
    assert ranks[0][name + "_route"] == ("planes" if name == "full"
                                         else "plain")


def _outliers(name, ours, ref, tol, cap):
    diff = np.abs(ours - ref)
    frac_out = float((diff > tol + tol * np.abs(ref)).mean())
    assert frac_out < 2e-3, (name, frac_out)
    assert float(diff.max()) < cap, (name, float(diff.max()))


@pytest.mark.parametrize("name", ["tiny", "full"])
def test_sp_frame_matches_the_jax_sp_frame(sp, name):
    """The frame of 2 ranks against the JAX package's ``make_frame_renderer``
    with ``sp_shards`` 2 on ``make_mesh(1, 2)``, deterministic sampling:
    the tiny MLP on both packages' plain/XLA route (8x8, 16 + 16
    samples), and the reference MLP at 4x4 with 8 + 8 samples, where the
    port runs K8's plain version and the JAX package its Pallas kernel in
    interpret mode (float32, bf16 logits on both sides)."""
    if name == "tiny":
        hw, kw, shape, sd = 8, {}, TINY, 21
    else:
        hw, shape, sd = 4, FULL, 22
        kw = dict(netDepth=8, netWidth=256, L_x=10, L_d=4, N_samples_c=8,
                  N_samples_f=8, use_pallas=True)
    jcfg, _ = _frame_cfgs(**kw)
    _, K, poses = make_synth_scene(n_views=1, H=hw, W=hw)
    jm = JaxNeRF(depth=shape["depth"], width=shape["width"],
                 L_x=shape["L_x"], L_d=shape["L_d"],
                 compute_dtype=jnp.float32)
    jr = jframe.make_frame_renderer(jm, jcfg, hw, hw, K, mesh=make_mesh(1, 2),
                                    stratified=False)
    jrgb, jdisp = jr(to_jax(np_nerf_params(sd, **shape)),
                     jnp.asarray(poses[0][:3, :4]), jax.random.PRNGKey(0))
    rgb, disp = sp["two"][0]["sp_frames"][name]
    if name == "tiny":
        _close(rgb, jrgb)
        _close(disp, jdisp, atol=1e-4)
    else:
        _outliers("rgb", rgb.numpy(), np.asarray(jrgb), 2e-3, 2e-2)
        _outliers("disp", disp.numpy(), np.asarray(jdisp), 5e-3, 8e-2)


def test_sp_renderer_needs_its_model_group():
    """Without a launch the model group is this process alone: a
    sample-sharded renderer refuses to be made (the config passed its own
    checks)."""
    _, cfg = _frame_cfgs()
    _, K, _ = make_synth_scene(n_views=1, H=4, W=4)
    with pytest.raises(ValueError, match="model group"):
        make_frame_renderer(cfg, 4, 4, K, "cpu")


# ----------------------------------------------------------------- the CLI


def test_cli_trains_width_sharded_and_evaluates_sample_sharded(tmp_path):
    """2 ranks of the CLI: 3 steps with ``--n_model_shards 2`` (the
    checkpoint gathered to full width by rank 0), then ``--eval_only``
    of that checkpoint with ``--sp_shards 2``; both exit 0."""
    scene = str(tmp_path / "scene")
    save_as_blender_dataset(scene, n_train=2, n_val=1, n_test=1, H=16, W=16)
    logs = str(tmp_path / "logs")
    common = [sys.executable, "-m", "nerf_pytorch_paeng_tpu_torch",
              "--config", os.path.join(ROOT, "configs/blender/lego.txt"),
              "--device", "cpu", "--data_root", scene, "--log_dir", logs,
              "--exp_name", "mesh", "--N_samples_c", "8", "--N_samples_f",
              "8", "--n_model_shards", "2", "--netDepth", "4", "--netWidth",
              "64"]
    outs = _launch(2, common + ["--iter_N", "3", "--iter_warmup", "0",
                                "--N_rays", "64", "--idx_print", "1",
                                "--idx_save", "3", "--idx_test", "0",
                                "--idx_render", "0"], ROOT)
    assert "(1 data x 2 model)" in outs[0]
    assert ">> field route: plain" in outs[0]
    ck = torch.load(os.path.join(logs, "mesh", "mesh_3.pth.tar"),
                    weights_only=True)
    assert ck["model_state_dict"]["model_coarse.linear_x.0.weight"].shape \
        == (64, 63)
    outs = _launch(2, common + ["--eval_only", "true", "--testing_idx", "3",
                                "--sp_shards", "2"], ROOT)
    assert "test view 0" in outs[0]
    assert os.path.isfile(os.path.join(logs, "mesh", "mesh_3", "test_result",
                                       "_result.txt"))
