"""Novel-view rendering in the port (``--render_only``, ``eval/render.py``,
``data/render_pose.py``) on the CPU: the orbit poses against the JAX
package's, the entry point end to end at 16x16 for gif and mp4 (frame
counts read back by Pillow and OpenCV), the single-angle still, and the
``idx_render`` hook of a short training run.  On the CPU the frames go
through the culled renderer without its support grids (the grid is off
there, as in the JAX package) and the kernels' plain versions."""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from nerf_pytorch_paeng_tpu.data.render_pose import \
    get_render_pose as jax_render_pose
from nerf_pytorch_paeng_tpu_torch import config as port_config
from nerf_pytorch_paeng_tpu_torch.data.render_pose import get_render_pose
from nerf_pytorch_paeng_tpu_torch.driver import (checkpoint_path, main,
                                                 main_worker)
from nerf_pytorch_paeng_tpu_torch.utils.synth import (
    compact_field_state_dict, save_as_blender_dataset)

from torch_port_util import subprocess_env

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("kw", [dict(n_angle=120),
                                dict(n_angle=3, phi=-10.0, nf=3.5),
                                dict(n_angle=1),
                                dict(n_angle=120, single_angle=30.0)])
def test_render_pose_matches_jax(kw):
    """float64 composition on both sides, cast to float32: equal to 1e-6."""
    got = get_render_pose(**kw)
    want = np.asarray(jax_render_pose(**kw))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert got.shape[0] == (kw["n_angle"] if kw.get("single_angle", -1) == -1
                            else 1)


@pytest.fixture(scope="module")
def synth16(tmp_path_factory):
    root = tmp_path_factory.mktemp("render16")
    save_as_blender_dataset(str(root), n_train=2, n_val=1, n_test=1,
                            H=16, W=16)
    return str(root)


def _args(data_root, log_dir, *extra):
    return ["--config", str(ROOT / "configs/blender/lego.txt"),
            "--device", "cpu", "--data_root", data_root,
            "--log_dir", log_dir, "--N_samples_c", "8",
            "--N_samples_f", "8", *extra]


def _write_ckpt(cfg, idx):
    path = checkpoint_path(cfg, idx)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({"idx": idx,
                "model_state_dict": compact_field_state_dict(r=1.0)}, path)


def _video_frames(path):
    if path.endswith(".gif"):
        from PIL import Image
        with Image.open(path) as im:
            return im.n_frames, im.size
    import cv2
    cap = cv2.VideoCapture(path)
    n = 0
    size = None
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        n += 1
        size = frame.shape[1::-1]
    cap.release()
    return n, size


@pytest.mark.parametrize("render_type", ["gif", "mp4"])
def test_render_only_cli(synth16, tmp_path, render_type):
    log_dir = str(tmp_path / "logs")
    args = _args(synth16, log_dir, "--render_only", "true", "--testing_idx",
                 "5", "--n_angle", "3", "--render_type", render_type)
    _write_ckpt(port_config.load_config(args), 5)
    proc = subprocess.run([sys.executable, "-m",
                           "nerf_pytorch_paeng_tpu_torch", *args],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=600, env=subprocess_env())
    assert proc.returncode == 0, proc.stderr
    out = os.path.join(log_dir, "blender_lego", "blender_lego_5",
                       "render_result")
    for i in range(3):
        for kind in ("rgb", "disp"):
            assert os.path.isfile(os.path.join(out, f"{i}_{kind}.png"))
    for name in ("_rgb", "_disp"):
        n, size = _video_frames(os.path.join(out, f"{name}.{render_type}"))
        assert n == 3 and tuple(size) == (16, 16), (name, n, size)
    assert "render view 2/3" in proc.stdout
    assert not os.path.isdir(os.path.join(out, "..", "test_result"))


def test_render_only_in_process(synth16, tmp_path):
    """main_worker returns the frames: rgb in [0, 1], disparity normalised
    to its max, one culled-renderer record and one time per frame; the
    frames are what the PNGs hold."""
    from PIL import Image
    cfg = port_config.load_config(_args(
        synth16, str(tmp_path), "--render_only", "true", "--testing_idx",
        "2", "--n_angle", "2"))
    _write_ckpt(cfg, 2)
    res = main_worker(cfg)
    assert res["rgbs"].shape == (2, 16, 16, 3)
    assert res["disps"].shape == (2, 16, 16)
    assert len(res["frame_s"]) == 2 and all(t > 0 for t in res["frame_s"])
    assert len(res["stats"]) == 2
    assert all(0 < s["n_act"] < 256 for s in res["stats"])
    assert all(s["gate_frac_coarse"] is None for s in res["stats"])
    assert float(res["rgbs"].min()) >= 0.0 and float(res["rgbs"].max()) <= 1.0
    assert float(np.nanmax(res["disps"])) == pytest.approx(1.0)
    png = np.asarray(Image.open(os.path.join(res["save_dir"], "1_rgb.png")))
    want = (255 * np.clip(res["rgbs"][1], 0, 1)).astype(np.uint8)
    assert np.abs(png.astype(int) - want).max() <= 1


def test_render_and_eval_together(synth16, tmp_path):
    cfg = port_config.load_config(_args(
        synth16, str(tmp_path), "--render_only", "true", "--eval_only",
        "true", "--testing_idx", "3", "--n_angle", "2"))
    _write_ckpt(cfg, 3)
    res = main_worker(cfg)
    assert len(res["psnr"]) == 1 and res["render"]["rgbs"].shape[0] == 2


def test_single_angle_still(synth16, tmp_path):
    """One pose, written twice (named and numbered), and no video."""
    cfg = port_config.load_config(_args(
        synth16, str(tmp_path), "--render_only", "true", "--testing_idx",
        "1", "--single_angle", "30"))
    _write_ckpt(cfg, 1)
    res = main_worker(cfg)
    out = res["save_dir"]
    assert res["rgbs"].shape == (1, 16, 16, 3)
    assert sorted(os.listdir(out)) == ["0_disp.png", "0_rgb.png",
                                       "30.0_-30.0_4.0_rgb.png"]


def test_idx_render_hook_in_training(synth16, tmp_path):
    """4 training steps with ``idx_render 2``: the orbit is rendered with
    the weights of steps 2 and 4."""
    log_dir = str(tmp_path / "logs")
    rc = main(_args(synth16, log_dir, "--exp_name", "hook", "--iter_N", "4",
                    "--iter_warmup", "0", "--N_rays", "128", "--idx_print",
                    "0", "--idx_vis", "0", "--idx_test", "0", "--idx_save",
                    "0", "--idx_render", "2", "--n_angle", "2",
                    "--global_batch", "true"))
    assert rc == 0
    for step in (2, 4):
        out = os.path.join(log_dir, "hook", f"hook_{step}", "render_result")
        assert _video_frames(os.path.join(out, "_rgb.gif"))[0] == 2
    assert not os.path.isdir(os.path.join(log_dir, "hook", "hook_1"))


def test_mode_render_false_skips_the_hook(synth16, tmp_path):
    log_dir = str(tmp_path / "logs")
    assert main(_args(synth16, log_dir, "--exp_name", "off", "--iter_N", "2",
                      "--iter_warmup", "0", "--N_rays", "128", "--idx_print",
                      "0", "--idx_vis", "0", "--idx_test", "0", "--idx_save",
                      "0", "--idx_render", "1", "--global_batch", "true",
                      "--mode_render", "false")) == 0
    assert not os.path.isdir(os.path.join(log_dir, "off", "off_1"))
