"""The port's LLFF and custom data paths against the JAX package's, on the
CPU: the NDC projection, the LLFF and custom loaders (minify, spherify,
the z-flat spiral), the COLMAP parsers and bridge, video frame
extraction, both LLFF train steps, NDC frames through both renderers and
the command line end to end.

Both sides get the same inputs: one capture on disk, copied once per
package where a loader writes into it (minify, ``gen_poses``), the same
numpy-seeded weights and the JAX package's random draws, injected into
the port.  The JAX side runs its Pallas kernels in interpret mode
(float32), as its own tests do; the port runs the plain versions with
float32 weights.

Tolerances:
- the loaders and the COLMAP bridge are the same numpy on both sides:
  images, K, extrinsics, splits, spirals and poses_bounds are equal;
- ``ndc_rays`` and a frame's NDC rays: 1e-6 relative (float32 ulps);
- the training render on NDC rays: the coarse losses to 1e-5 relative and
  each coarse layer's gradient to 1e-4 relative L2; fine rays by outlier
  fraction (at most 2% beyond 1e-4) and fine gradients to 5e-2 relative
  L2 and cosine 0.999, as tests/test_torch_train_parity.py holds the
  blender render (the inverse CDF flips bins on float32 noise, and NDC's
  divide by d_z makes more of them, tests/test_reference_parity.py:648);
- trajectories: each step's loss to 1e-4 relative, every parameter at
  the end to 2e-3 relative L2 (tests/test_torch_train_parity.py);
- frames: by outlier fraction (< 0.2% beyond 2e-3 rgb, 5e-3 disp), max
  (2e-2, 8e-2) and mean (1e-4), as tests/test_torch_frame.py holds the
  blender frames.
"""
import importlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_pytorch_paeng_tpu.config import NerfConfig as JaxConfig
from nerf_pytorch_paeng_tpu.data import custom as jcustom
from nerf_pytorch_paeng_tpu.data import llff as jllff
from nerf_pytorch_paeng_tpu.data.colmap import poses as jposes
from nerf_pytorch_paeng_tpu.eval import frame as jframe
from nerf_pytorch_paeng_tpu.models.nerf import NeRF as JaxNeRF
from nerf_pytorch_paeng_tpu.ops import rays as jrays
from nerf_pytorch_paeng_tpu.ops import render as jrender
from nerf_pytorch_paeng_tpu.train import step as jstep
from nerf_pytorch_paeng_tpu.train.state import TrainState as JaxState
from nerf_pytorch_paeng_tpu.train.state import make_optimizer as jax_adam
from nerf_pytorch_paeng_tpu_torch import driver
from nerf_pytorch_paeng_tpu_torch.config import NerfConfig, load_config
from nerf_pytorch_paeng_tpu_torch.data import custom, llff
from nerf_pytorch_paeng_tpu_torch.data.colmap import poses
from nerf_pytorch_paeng_tpu_torch.data.colmap.wrapper import (ColmapNotFound,
                                                              run_colmap)
from nerf_pytorch_paeng_tpu_torch.eval import frame
from nerf_pytorch_paeng_tpu_torch.eval.test import run_test
from nerf_pytorch_paeng_tpu_torch.kernels import fused_mlp as fm
from nerf_pytorch_paeng_tpu_torch.models.nerf import NeRF
from nerf_pytorch_paeng_tpu_torch.ops.rays import get_rays, ndc_rays
from nerf_pytorch_paeng_tpu_torch.ops.render import (maybe_ndc,
                                                     render_rays_train)
from nerf_pytorch_paeng_tpu_torch.train import TrainState, make_optimizer
from nerf_pytorch_paeng_tpu_torch.train.schedule import schedule_from_cfg
from nerf_pytorch_paeng_tpu_torch.train.step import (make_image_train_step,
                                                     make_train_step)
from nerf_pytorch_paeng_tpu_torch.utils.interop import \
    state_dict_from_jax_params
from nerf_pytorch_paeng_tpu_torch.utils.synth import (make_forward_scene,
                                                      save_as_llff_dataset)

from test_custom_video import write_video
from test_data import (write_colmap_model, write_colmap_model_text,
                       write_llff_fixture)
from torch_port_util import np_nerf_params, subprocess_env, to_jax

# the packages' ``data.colmap`` exports a function named ``read_model``
# over the module of that name
read_model = importlib.import_module(
    "nerf_pytorch_paeng_tpu_torch.data.colmap.read_model")
jread = importlib.import_module(
    "nerf_pytorch_paeng_tpu.data.colmap.read_model")

ROOT = Path(__file__).resolve().parents[1]
FERN = str(ROOT / "configs/llff/fern.txt")
H, W = 24, 32                     # the synthetic capture: 6 views


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """The port's forward-facing capture in the LLFF layout."""
    root = str(tmp_path_factory.mktemp("llff") / "capture")
    save_as_llff_dataset(root, n_views=6, H=H, W=W, n_samples=64)
    return root


def _copies(src, tmp_path):
    """One copy of a capture for each package (loaders write into it)."""
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    shutil.copytree(src, a)
    shutil.copytree(src, b)
    return a, b


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _outliers(name, ours, ref, tol, cap):
    diff = np.abs(ours - ref)
    frac_out = float((diff > tol + tol * np.abs(ref)).mean())
    assert frac_out < 2e-3, (name, frac_out)
    assert float(diff.max()) < cap, (name, float(diff.max()))
    assert float(diff.mean()) < 1e-4, (name, float(diff.mean()))


# ------------------------------------------------------------------- NDC


def _forward_rays(seed, n=257):
    """World rays of a forward-facing capture: origins near the average
    camera, directions into -z."""
    rng = np.random.default_rng(seed)
    o = rng.normal(0, 0.2, (n, 3)).astype(np.float32)
    d = (np.array([0.0, 0.0, -1.0]) + rng.normal(0, 0.3, (n, 3)))
    return o, d.astype(np.float32)


@pytest.mark.parametrize("near", [1.0, 0.5])
def test_ndc_rays_matches_jax(near):
    o, d = _forward_rays(int(near * 10))
    got = ndc_rays(H, W, 27.3, near, torch.from_numpy(o), torch.from_numpy(d))
    want = jrays.ndc_rays(H, W, 27.3, near, jnp.asarray(o), jnp.asarray(d))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (len(o), 3)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)
    # every origin lands on the near plane's NDC depth, -1
    np.testing.assert_allclose(got[0][:, 2].numpy(), -1.0, atol=1e-6)


@pytest.mark.parametrize("data_type", ["llff", "blender", "custom"])
def test_maybe_ndc_only_for_llff(data_type):
    o, d = (torch.from_numpy(a) for a in _forward_rays(3))
    got = maybe_ndc(o, d, H, W, 27.3, data_type)
    want = jrender.maybe_ndc(jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                             H, W, 27.3, data_type)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)
    if data_type != "llff":
        assert got[0] is o and got[1] is d


# --------------------------------------------------------------- loaders


def test_forward_scene_matches_jax():
    """The port's synthetic writer gives the JAX package's capture."""
    from nerf_pytorch_paeng_tpu.utils.synth import \
        make_forward_scene as jax_scene
    for a, b in zip(make_forward_scene(n_views=3, H=12, W=16, n_samples=32),
                    jax_scene(n_views=3, H=12, W=16, n_samples=32)):
        np.testing.assert_array_equal(a, b)


def _assert_llff_equal(got, want):
    (imgs, (K, ext), hw, split, spiral), (jimgs, (jK, jext), jhw, jsplit,
                                          jspiral) = got, want
    assert imgs.dtype == np.float32 and ext.dtype == jext.dtype
    np.testing.assert_array_equal(imgs, jimgs)
    np.testing.assert_array_equal(K, jK)
    np.testing.assert_array_equal(ext, jext)
    assert list(hw) == list(jhw)
    for a, b in zip(split, jsplit):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(spiral, jspiral)


@pytest.mark.parametrize("source,kw", [
    ("synth", dict(downsample=0, testskip=4)),
    ("synth", dict(downsample=2, testskip=8)),                  # minify
    ("fixture", dict(downsample=0, testskip=2)),
    ("fixture", dict(downsample=0, testskip=2, spherify=True)),
    ("fixture", dict(downsample=2, testskip=3, path_zflat=True)),
], ids=["synth", "synth_minify", "fixture", "fixture_spherify",
        "fixture_minify_zflat"])
def test_load_llff_matches_jax(capture, tmp_path, source, kw):
    if source == "synth":
        src = capture
    else:
        src = str(tmp_path / "fixture")
        write_llff_fixture(src, n=6)
    a, b = _copies(src, tmp_path)
    got = llff.load_llff(a, **kw)
    _assert_llff_equal(got, jllff.load_llff(b, **kw))
    n = 6
    assert got[0].shape[0] == n
    assert got[4].shape == ((60 if kw.get("path_zflat") else 120), 3, 5)
    if kw["downsample"]:
        assert got[2][0] == (H if source == "synth" else 12) // 2
        for d in (a, b):
            assert len(os.listdir(os.path.join(d, "images_2"))) == n


def test_minify_rewrites_a_partial_directory(capture, tmp_path):
    """An interrupted minify leaves fewer files than images/: the next load
    deletes and rewrites the directory, as the JAX package's does."""
    a, b = _copies(capture, tmp_path)
    llff.minify(a, 2)
    want = sorted(os.listdir(os.path.join(a, "images_2")))
    first = os.path.join(a, "images_2", want[0])
    os.remove(os.path.join(a, "images_2", want[-1]))
    stamp = os.stat(first).st_mtime_ns
    os.utime(first, ns=(stamp - 10 ** 9, stamp - 10 ** 9))
    llff.minify(a, 2)
    assert sorted(os.listdir(os.path.join(a, "images_2"))) == want
    assert os.stat(first).st_mtime_ns > stamp - 10 ** 9     # rewritten
    jllff.minify(b, 2)
    for name in want:
        np.testing.assert_array_equal(
            cv2.imread(os.path.join(a, "images_2", name)),
            cv2.imread(os.path.join(b, "images_2", name)))


def test_llff_pose_helpers_match_jax():
    rng = np.random.default_rng(5)
    p = rng.normal(0, 1, (7, 3, 5))
    np.testing.assert_array_equal(llff.poses_avg(p), jllff.poses_avg(p))
    np.testing.assert_array_equal(llff.recenter_poses(p),
                                  jllff.recenter_poses(p))
    bds = rng.uniform(1, 3, (7, 2))
    for x, y in zip(llff.spherify_poses(p, bds),
                    jllff.spherify_poses(p, bds)):
        np.testing.assert_array_equal(x, y)
    c2w = llff.poses_avg(p)
    np.testing.assert_array_equal(
        np.stack(llff.render_path_spiral(c2w, c2w[:3, 1], np.ones(3), 2.0,
                                         0.5, 2, 10)),
        np.stack(jllff.render_path_spiral(c2w, c2w[:3, 1], np.ones(3), 2.0,
                                          0.5, 2, 10)))


@pytest.mark.parametrize("kw", [dict(downsample=0, testskip=8),
                                dict(downsample=2, testskip=2),
                                dict(downsample=0, testskip=0)],
                         ids=["full", "downsample2", "no_test_views"])
def test_load_custom_matches_jax(capture, tmp_path, kw):
    """Spherify always on, near/far from the rescaled bounds."""
    a, b = _copies(capture, tmp_path)
    imgs, (K, ext), hw, split, nf = custom.load_custom(a, **kw)
    jimgs, (jK, jext), jhw, jsplit, jnf = jcustom.load_custom(b, **kw)
    np.testing.assert_array_equal(imgs, jimgs)
    np.testing.assert_array_equal(K, jK)
    np.testing.assert_array_equal(ext, jext)
    assert list(hw) == list(jhw) and list(nf) == list(jnf)
    assert 0 < nf[0] < nf[1]
    for x, y in zip(split, jsplit):
        np.testing.assert_array_equal(x, y)
    assert len(split[2]) == (0 if kw["testskip"] == 0 else
                             len(range(0, 6, kw["testskip"])))


def test_extract_frames_from_video_matches_jax(tmp_path):
    """Every 3rd frame of a cv2-written clip, turned by 180 degrees."""
    for d in ("port", "jax"):
        os.makedirs(tmp_path / d)
        write_video(str(tmp_path / d / "video.MOV"), n_frames=10)
    n = custom.extract_frames_from_video(str(tmp_path / "port"), batch=3)
    assert n == jcustom.extract_frames_from_video(str(tmp_path / "jax"),
                                                  batch=3) == 4
    names = sorted(os.listdir(tmp_path / "port" / "images"))
    assert names == sorted(os.listdir(tmp_path / "jax" / "images"))
    for name in names:
        np.testing.assert_array_equal(
            cv2.imread(str(tmp_path / "port" / "images" / name)),
            cv2.imread(str(tmp_path / "jax" / "images" / name)))
    with pytest.raises(FileNotFoundError):
        custom.extract_frames_from_video(str(tmp_path / "nothing"))
    with pytest.raises(FileNotFoundError):
        custom.load_custom(str(tmp_path / "nothing"))


def test_load_custom_from_video(capture, tmp_path):
    """No images/ but a video.MOV: the frames are extracted, then the
    capture's poses_bounds.npy is read."""
    root = tmp_path / "video_capture"
    os.makedirs(root)
    shutil.copy(os.path.join(capture, "poses_bounds.npy"), root)
    write_video(str(root / "video.MOV"), n_frames=12, H=H, W=W)
    imgs, (K, ext), hw, split, nf = custom.load_custom(str(root),
                                                       video_batch=2)
    assert imgs.shape == (6, H, W, 3) and list(hw) == [H, W]
    assert len(os.listdir(root / "images")) == 6


# ----------------------------------------------------------------- COLMAP


@pytest.mark.parametrize("writer", [write_colmap_model,
                                    write_colmap_model_text],
                         ids=["binary", "text"])
def test_colmap_parsers_match_jax(tmp_path, writer):
    sparse0 = str(tmp_path / "sparse" / "0")
    writer(sparse0)
    assert read_model.detect_model_ext(sparse0) == \
        jread.detect_model_ext(sparse0)
    got, want = read_model.read_model(sparse0), jread.read_model(sparse0)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in g:
            for field, value in vars(w[k]).items():
                mine = getattr(g[k], field)
                if isinstance(value, np.ndarray):
                    assert mine.dtype == value.dtype, (k, field)
                    np.testing.assert_array_equal(mine, value)
                else:
                    assert mine == value, (k, field)


def test_colmap_text_zero_point_image_and_errors(tmp_path):
    p = tmp_path / "images.txt"
    p.write_text("1 1.0 0.0 0.0 0.0 0.1 0.0 1.0 1 empty.png\n\n"
                 "2 1.0 0.0 0.0 0.0 0.2 0.0 1.0 1 a b.png\n"
                 "1.0 2.0 7 3.0 4.0 -1\n")
    got, want = read_model.read_images_text(str(p)), \
        jread.read_images_text(str(p))
    assert set(got) == set(want) == {1, 2}
    for k in got:
        assert got[k].name == want[k].name
        np.testing.assert_array_equal(got[k].xys, want[k].xys)
        np.testing.assert_array_equal(got[k].point3D_ids,
                                      want[k].point3D_ids)
    with pytest.raises(FileNotFoundError):
        read_model.detect_model_ext(str(tmp_path))
    write_colmap_model_text(str(tmp_path / "m"))
    with pytest.raises(ValueError):
        read_model.read_model(str(tmp_path / "m"), ext=".json")
    np.testing.assert_array_equal(
        read_model.qvec2rotmat(np.array([0.5, 0.5, 0.5, 0.5])),
        jread.qvec2rotmat(np.array([0.5, 0.5, 0.5, 0.5])))


@pytest.mark.parametrize("writer", [write_colmap_model,
                                    write_colmap_model_text],
                         ids=["binary", "text"])
def test_gen_poses_matches_jax(tmp_path, writer, monkeypatch):
    """A model in sparse/0 needs no COLMAP binary: poses_bounds.npy as the
    JAX package writes it, from either format."""
    monkeypatch.setenv("PATH", str(tmp_path / "no_bin"))
    for d in ("port", "jax"):
        writer(str(tmp_path / d / "sparse" / "0"))
    assert poses.gen_poses(str(tmp_path / "port"))
    jposes.gen_poses(str(tmp_path / "jax"))
    got = np.load(tmp_path / "port" / "poses_bounds.npy")
    np.testing.assert_array_equal(
        got, np.load(tmp_path / "jax" / "poses_bounds.npy"))
    assert got.shape == (2, 17)


def test_run_colmap_raises_without_the_binary(tmp_path, monkeypatch):
    """No ``colmap`` on PATH: the bridge raises ``ColmapNotFound``, and so
    does a capture with neither poses_bounds.npy nor a sparse model."""
    monkeypatch.setenv("PATH", str(tmp_path / "no_bin"))
    with pytest.raises(ColmapNotFound, match="colmap"):
        run_colmap(str(tmp_path))
    os.makedirs(tmp_path / "capture" / "images")
    with pytest.raises(ColmapNotFound):
        llff.load_llff(str(tmp_path / "capture"))
    assert issubclass(ColmapNotFound, RuntimeError)


def test_colmap_relaunch_removes_the_artifacts(tmp_path, monkeypatch):
    """``colmap_relaunch`` deletes poses_bounds.npy and the model, then
    needs the binary: without it, the load raises."""
    from nerf_pytorch_paeng_tpu_torch.data.colmap.wrapper import \
        remove_colmap_artifacts
    monkeypatch.setenv("PATH", str(tmp_path / "no_bin"))
    base = tmp_path / "cap"
    write_llff_fixture(str(base), n=2)
    write_colmap_model(str(base / "sparse" / "0"))
    (base / "database.db").write_text("")
    with pytest.raises(ColmapNotFound):
        llff.load_llff(str(base), colmap_relaunch=True)
    assert not (base / "poses_bounds.npy").exists()
    assert not (base / "sparse").exists()
    assert not (base / "database.db").exists()
    remove_colmap_artifacts(str(base))              # nothing left: a no-op


# ---------------------------------------------------------- the train steps

N, SC, SF = 128, 8, 8
KW = dict(data_type="llff", near=0.0, far=1.0, compute_dtype="float32",
          N_rays=N, N_samples_c=SC, N_samples_f=SF, iter_N=10, iter_warmup=2,
          precrop_frac=0.5)


def _cfgs(**over):
    return JaxConfig(**KW, **over), NerfConfig(device="cpu", **KW, **over)


def _model(params):
    model = NeRF()
    model.load_state_dict(state_dict_from_jax_params(params))
    return model


def _uniforms(key, n=N):
    key_c, key_f = jax.random.split(key)
    return (torch.from_numpy(np.array(jax.random.uniform(key_c, (n, SC)))),
            torch.from_numpy(np.array(jax.random.uniform(key_f, (n, SF)))))


@pytest.fixture(scope="module")
def loaded(capture):
    """The capture through the port's loader (NDC needs its K)."""
    images, (K, ext), hw, split, spiral = llff.load_llff(capture, testskip=4)
    return images, K, ext, hw, split, spiral


def _pool_batch(loaded, seed):
    """A global-pool batch: world rays and colours of seeded pixels of the
    training views."""
    images, K, ext, (h, w), (i_train, _, _), _ = loaded
    rng = np.random.default_rng(seed)
    views = rng.choice(i_train, N)
    pix = rng.integers(0, h * w, N)
    o, d = [], []
    for v, p in zip(views, pix):
        ro, rd = get_rays(h, w, K, torch.from_numpy(ext[v]))
        o.append(ro.reshape(-1, 3)[p])
        d.append(rd.reshape(-1, 3)[p])
    tgt = images[views].reshape(N, -1, 3)[np.arange(N), pix]
    return torch.stack(o).numpy(), torch.stack(d).numpy(), tgt


def test_render_rays_train_on_ndc_rays_matches_jax(loaded):
    """One training render of NDC rays: coarse strictly, fine by outlier
    fraction, the gradients as the module docstring states."""
    jcfg, cfg = _cfgs()
    _, K, _, (h, w), _, _ = loaded
    o, d, tgt = _pool_batch(loaded, 1)
    focal = float(K[0, 0])
    jo, jd = jrender.maybe_ndc(jnp.asarray(o), jnp.asarray(d), h, w, focal,
                               "llff")
    po, pd = maybe_ndc(torch.from_numpy(o), torch.from_numpy(d), h, w,
                       focal, "llff")
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-7)
    params = np_nerf_params(20)
    key = jax.random.PRNGKey(21)

    def jax_loss(p):
        out = jrender.render_rays_train(p, jo, jd, key, jcfg)
        loss_c = jnp.mean((out.rgb_c - tgt) ** 2)
        loss_f = jnp.mean((out.rgb_f - tgt) ** 2)
        return loss_c + loss_f, (loss_c, loss_f, out.rgb_f)

    (_, (jlc, jlf, jrgb_f)), jgrads = jax.jit(jax.value_and_grad(
        jax_loss, has_aux=True))(to_jax(params))
    model = _model(params)
    u_c, u_f = _uniforms(key)
    out = render_rays_train(model, po, pd, cfg, u_c=u_c, u_f=u_f)
    t = torch.from_numpy(tgt)
    loss_c = torch.mean((out.rgb_c - t) ** 2)
    loss_f = torch.mean((out.rgb_f - t) ** 2)
    (loss_c + loss_f).backward()
    assert loss_c.item() == pytest.approx(float(jlc), rel=1e-5)
    assert loss_f.item() == pytest.approx(float(jlf), rel=1e-4)
    far = np.abs(out.rgb_f.detach().numpy() - np.asarray(jrgb_f)).max(-1)
    assert (far > 1e-4).mean() <= 0.02
    want = state_dict_from_jax_params(jgrads)
    for name, p in model.named_parameters():
        got, ref = p.grad.numpy(), want[name].numpy()
        if name.startswith("model_coarse"):
            assert _rel(got, ref) <= 1e-4, name
        else:
            assert _rel(got, ref) <= 5e-2 and _cos(got, ref) >= 0.999, name


def _jax_state(jcfg, params):
    tx = jax_adam(jcfg)
    jp = to_jax(params)
    return tx, JaxState(jnp.zeros((), jnp.int32), jp, tx.init(jp))


def _compare_final(model, jparams):
    want = state_dict_from_jax_params(jax.device_get(jparams))
    for name, p in model.named_parameters():
        assert _rel(p.detach().numpy(), want[name].numpy()) <= 2e-3, name


@pytest.mark.parametrize("use_rays_train", [True, False],
                         ids=["ray_pair", "plane_pair"])
def test_llff_pool_trajectory_matches_jax(loaded, use_rays_train):
    """Three global-pool steps: both steps take world rays and project
    them into NDC themselves, on the ray pair (K1/K2) and on the plane
    pair (K8/K9, ``--use_rays_train false``)."""
    jcfg, cfg = _cfgs(use_rays_train=use_rays_train)
    _, K, _, (h, w), _, _ = loaded
    params = np_nerf_params(22)
    tx, jstate = _jax_state(jcfg, params)
    jax_step = jax.jit(jstep.make_train_step(None, tx, jcfg, h, w,
                                             float(K[0][0])))
    step_key = jax.random.PRNGKey(jcfg.seed + 3)
    model = _model(params)
    state = TrainState(model, make_optimizer(model, cfg), 0)
    port_step = make_train_step(cfg, schedule_from_cfg(cfg), h, w,
                                float(K[0][0]))
    for i in range(3):
        o, d, tgt = _pool_batch(loaded, 30 + i)
        jstate, jm = jax_step(jstate, jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(tgt), step_key)
        u_c, u_f = _uniforms(jax.random.fold_in(step_key, i))
        m = port_step(state, *(torch.from_numpy(a) for a in (o, d, tgt)),
                      u_c=u_c, u_f=u_f)
        for k in ("loss", "loss_c", "loss_f", "psnr"):
            assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-4), \
                (i, k)
    _compare_final(model, jstate.params)


def test_llff_per_image_trajectory_matches_jax(loaded):
    """Three per-image steps (the first inside the precrop window): the
    JAX step draws the pixels and the jitter, the port gets the same."""
    jcfg, cfg = _cfgs()
    images, K, ext, (h, w), (i_train, _, _), _ = loaded
    params = np_nerf_params(23)
    tx, jstate = _jax_state(jcfg, params)
    jax_step = jstep.make_image_train_step(None, tx, jcfg, h, w, K)
    step_key = jax.random.PRNGKey(jcfg.seed + 3)
    model = _model(params)
    state = TrainState(model, make_optimizer(model, cfg), 0)
    port_step = make_image_train_step(cfg, schedule_from_cfg(cfg), h, w, K)
    for i, (view, precrop) in enumerate([(i_train[0], True),
                                         (i_train[1], False),
                                         (i_train[2], False)]):
        img, pose = images[view], ext[view]
        jstate, jm = jax_step(jstate, jnp.asarray(img), jnp.asarray(pose),
                              step_key, precrop=precrop)
        key_px, key_render = jax.random.split(
            jax.random.fold_in(step_key, i))
        coords = jrays.sample_pixels(key_px, h, w, N, precrop=precrop,
                                     precrop_frac=cfg.precrop_frac)
        u_c, u_f = _uniforms(key_render)
        m = port_step(state, torch.from_numpy(img), torch.from_numpy(pose),
                      precrop=precrop,
                      coords=torch.from_numpy(np.array(coords)).long(),
                      u_c=u_c, u_f=u_f)
        for k in ("loss", "loss_c", "loss_f"):
            assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-4), \
                (i, k)
    _compare_final(model, jstate.params)


# ----------------------------------------------------------------- frames

FRAME_KW = dict(data_type="llff", near=0.0, far=1.0, perturb=0.0,
                N_samples_c=8, N_samples_f=8, compute_dtype="float32",
                chunk_rays=256)


def test_frame_rays_are_ndc_and_match_jax(loaded):
    """The frame's ray generator projects into NDC with K's float32 focal,
    as the JAX package's ``_make_ray_gen`` does."""
    _, K, ext, (h, w), _, spiral = loaded
    cfg = NerfConfig(device="cpu", **FRAME_KW)
    gen = frame._make_ray_gen(cfg, h, w, K, torch.device("cpu"))
    jgen = jframe._make_ray_gen(JaxConfig(**FRAME_KW), h, w, K, h * w)
    for pose in (ext[0], spiral[7][:3, :4]):
        got = gen(torch.from_numpy(np.ascontiguousarray(pose)))
        want = jgen(jnp.asarray(pose))
        for g, wnt in zip(got, want):
            assert g.shape == (h * w, 3) and g.is_contiguous()
            np.testing.assert_allclose(g.numpy(), np.asarray(wnt),
                                       rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got[0][:, 2].numpy(), -1.0, atol=1e-6)


@pytest.mark.parametrize("cull", ["none", "auto"])
def test_ndc_frame_matches_jax(loaded, cull):
    """A held-out view (dense) and a spiral view (culled) of the capture,
    NDC rays, deterministic sampling, both renderers against the JAX
    package's; the culled frame's pre-cull and gate-fine stay off (blender
    only), so it launches K3 and K1 alone."""
    _, K, ext, (h, w), _, spiral = loaded
    pose = ext[0] if cull == "none" else spiral[3][:3, :4]
    params = np_nerf_params(24)
    jcfg = JaxConfig(use_pallas=True, render_cull=cull, **FRAME_KW)
    jr = jframe.make_frame_renderer(JaxNeRF(compute_dtype=jnp.float32), jcfg,
                                    h, w, K, stratified=False)
    jrgb, jdisp = jr(to_jax(params), jnp.asarray(pose), jax.random.PRNGKey(0))

    cfg = NerfConfig(device="cpu", render_cull=cull, render_precull_grid=16,
                     **FRAME_KW)
    calls = []

    def counting(fn, name):
        def call(*a, **kw):
            calls.append((name, kw.get("gate")))
            return fn(*a, **kw)
        return call

    r = frame.make_frame_renderer(
        cfg, h, w, K, "cpu", stratified=False,
        sigma_fn=counting(fm.fused_mlp_sigma_rays, "K3"),
        field_fn=counting(fm.fused_mlp_eval_rays, "K1"),
        points_fn=counting(fm.fused_mlp_sigma, "K7"),
        plane_fn=counting(fm.fused_mlp_eval, "K8"))
    rgb, disp = r(fm.pack_nerf(_model(params), cfg),
                  torch.from_numpy(np.ascontiguousarray(pose)))
    assert rgb.shape == (h, w, 3) and r.rays_route
    _outliers("rgb", rgb.numpy(), np.asarray(jrgb), 2e-3, 2e-2)
    _outliers("disp", disp.numpy(), np.asarray(jdisp), 5e-3, 8e-2)
    assert {name for name, _ in calls} == {"K3", "K1"}
    assert all(gate is None for _, gate in calls)
    if cull == "auto":
        st = r.stats[-1]
        assert st["gate_frac_coarse"] is None and st["gate_frac_fine"] is None
        assert st["blocks"] >= 2
    else:
        assert r.launches_per_frame == -(-h * w // 256) == 3   # ragged tail


# --------------------------------------------------------- the entry point


def _ckpt(cfg, step, seed=25):
    path = driver.checkpoint_path(cfg, step)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({"idx": step, "model_state_dict": _model(
        np_nerf_params(seed)).state_dict()}, path)


SMALL = ["--device", "cpu", "--downsample", "0", "--N_rays", "128",
         "--N_samples_c", "8", "--N_samples_f", "8"]


def test_load_dataset_dispatch(capture):
    """``driver.load_dataset``: LLFF keeps the config and returns the
    spiral; custom installs the loader's near/far and has no spiral."""
    base = ["--config", FERN, "--data_root", capture, *SMALL]
    cfg = load_config(base)
    *_, spiral, cfg2 = driver.load_dataset(cfg)
    assert cfg2 is cfg and spiral.shape == (120, 3, 5)
    assert driver._llff_render_poses_34(spiral).shape == (120, 3, 4)
    assert driver._llff_render_poses_34(None) is None
    ccfg = load_config(base + ["--data_type", "custom"])
    *_, spiral, ccfg2 = driver.load_dataset(ccfg)
    _, _, _, _, nf = custom.load_custom(capture, downsample=0, testskip=8)
    assert spiral is None and (ccfg2.near, ccfg2.far) == tuple(nf)
    assert (ccfg.near, ccfg.far) == (0.0, 1.0)


def test_llff_cli_train_eval_and_spiral(capture, tmp_path):
    """``python -m nerf_pytorch_paeng_tpu_torch --config
    configs/llff/fern.txt`` on the CPU: 4 global-pool steps with the save,
    test and render hooks, then ``--eval_only`` and ``--render_only`` of
    the saved weights (the render is the whole 120-view spiral)."""
    logs = str(tmp_path / "logs")
    common = ["--config", FERN, "--data_root", capture, "--log_dir", logs,
              *SMALL]
    proc = subprocess.run(
        [sys.executable, "-m", "nerf_pytorch_paeng_tpu_torch", *common,
         "--iter_N", "4", "--iter_warmup", "0", "--idx_print", "2",
         "--idx_save", "4", "--idx_test", "4", "--idx_render", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=subprocess_env())
    assert proc.returncode == 0, proc.stderr
    assert ">> [global batch]" in proc.stdout
    exp = os.path.join(logs, "llff_fern")
    assert os.path.isfile(os.path.join(exp, "llff_fern_4.pth.tar"))
    assert os.path.isfile(os.path.join(exp, "llff_fern_4", "test_result",
                                       "_result.txt"))

    res = driver.main_worker(load_config(
        common + ["--eval_only", "true", "--testing_idx", "4"]))
    assert len(res["psnr"]) == 1 and np.isfinite(res["psnr"][0])
    res = driver.main_worker(load_config(
        common + ["--render_only", "true", "--testing_idx", "4",
                  "--render_cull", "none"]))
    assert res["rgbs"].shape == (120, H, W, 3)
    assert np.isfinite(res["rgbs"]).all() and np.isfinite(res["disps"]).all()
    out = os.path.join(exp, "llff_fern_4", "render_result")
    assert {"_rgb.gif", "_disp.gif", "0_rgb.png", "119_disp.png"} <= \
        set(os.listdir(out))


def test_custom_cli_train_eval_and_orbit(capture, tmp_path):
    """``--data_type custom`` on the same capture (poses_bounds.npy in
    place, no COLMAP): training with the loader's near/far, then
    ``--eval_only`` and ``--render_only`` of 2 orbit views."""
    logs = str(tmp_path / "logs")
    common = ["--config", FERN, "--data_type", "custom", "--exp_name",
              "custom", "--data_root", capture, "--log_dir", logs, *SMALL]
    res = driver.main_worker(load_config(
        common + ["--iter_N", "3", "--iter_warmup", "0", "--idx_save", "3",
                  "--idx_test", "0", "--idx_render", "0"]))
    assert res["step"] == 3 and all(np.isfinite(res["loss"]))
    assert os.path.isfile(os.path.join(logs, "custom", "custom_3.pth.tar"))
    res = driver.main_worker(load_config(
        common + ["--eval_only", "true", "--render_only", "true",
                  "--testing_idx", "3", "--n_angle", "2"]))
    assert len(res["psnr"]) == 1 and np.isfinite(res["psnr"][0])
    assert res["render"]["rgbs"].shape == (2, H, W, 3)


def test_empty_held_out_split_on_an_llff_config(capture, tmp_path):
    """``testskip 0`` leaves the custom loader no held-out view: the
    ``--eval_only`` entry writes "no test views"; ``run_test`` on an LLFF
    config with no poses does the same."""
    logs = str(tmp_path / "logs")
    cfg = load_config(["--config", FERN, "--data_type", "custom",
                       "--data_root", capture, "--log_dir", logs,
                       "--testskip", "0", "--eval_only", "true",
                       "--testing_idx", "1", *SMALL])
    _ckpt(cfg, 1)
    res = driver.main_worker(cfg)
    assert res["psnr"] == [] and np.isnan(res["mean_psnr"])
    txt = os.path.join(logs, "llff_fern", "llff_fern_1", "test_result",
                       "_result.txt")
    assert open(txt).read() == "no test views\n"
    lcfg = NerfConfig(device="cpu", **FRAME_KW)
    res = run_test(1, None, np.zeros((0, H, W, 3), np.float32),
                   np.zeros((0, 3, 4), np.float32), np.eye(3), (H, W), lcfg,
                   "cpu", save_dir=str(tmp_path / "empty"))
    assert res["frame_s"] == [] and np.isnan(res["mean_ssim"])
