"""Training through the port's entry point on the CPU, end to end:
``python -m nerf_pytorch_paeng_tpu_torch --config configs/blender/lego.txt
--device cpu ...`` on a tiny synthetic blender scene (the lego config's
8x256 MLPs, 128 rays, 8+8 samples), in both batch modes: the metrics
CSV, the reference-format checkpoint, the ``idx_test`` hook, the
``--eval_only`` entry reading the trained checkpoint, and a bit-exact
resume (the pattern of ``tests/test_cli.py::test_resume_matches_uninterrupted``).
"""
import csv
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from nerf_pytorch_paeng_tpu_torch import config as port_config
from nerf_pytorch_paeng_tpu_torch.driver import main, main_worker
from nerf_pytorch_paeng_tpu_torch.train import checkpoint as ckpt
from nerf_pytorch_paeng_tpu_torch.utils.synth import save_as_blender_dataset

from torch_port_util import subprocess_env

ROOT = pathlib.Path(__file__).resolve().parents[1]
MODES = {"per_image": [], "global": ["--global_batch", "true"]}


@pytest.fixture(scope="module")
def scene32(tmp_path_factory):
    """32x32: the per-image precrop window (16x16) holds 128 rays."""
    root = tmp_path_factory.mktemp("synth32")
    save_as_blender_dataset(str(root), n_train=2, n_val=1, n_test=1,
                            H=32, W=32)
    return str(root)


@pytest.fixture(scope="module")
def scene16(tmp_path_factory):
    """16x16, 2 train views: a 512-ray pool, 4 batches of 128 per epoch."""
    root = tmp_path_factory.mktemp("synth16")
    save_as_blender_dataset(str(root), n_train=2, n_val=1, n_test=1,
                            H=16, W=16)
    return str(root)


def _args(data_root, log_dir, exp, iters, *extra):
    return ["--config", str(ROOT / "configs/blender/lego.txt"),
            "--device", "cpu", "--data_root", data_root,
            "--log_dir", log_dir, "--exp_name", exp,
            "--iter_N", str(iters), "--iter_warmup", "0",
            "--N_rays", "128", "--N_samples_c", "8", "--N_samples_f", "8",
            "--idx_print", "0", "--idx_vis", "0", "--idx_test", "0", *extra]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_train_cli_end_to_end(scene32, tmp_path, mode):
    log_dir = str(tmp_path / "logs")
    args = _args(scene32, log_dir, "cli", 6, "--idx_vis", "3",
                 "--idx_print", "3", "--idx_save", "6", "--idx_test", "6",
                 "--precrop_iters", "2", *MODES[mode])
    proc = subprocess.run([sys.executable, "-m",
                           "nerf_pytorch_paeng_tpu_torch", *args],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=600, env=subprocess_env())
    assert proc.returncode == 0, proc.stderr
    assert "i : 6 , " in proc.stdout and ">> training done" in proc.stdout

    rows = list(csv.DictReader(open(os.path.join(log_dir, "cli",
                                                 "metrics.csv"))))
    assert [r["step"] for r in rows] == ["3", "6"]
    for r in rows:
        assert all(np.isfinite(float(r[k])) for k in
                   ("loss", "loss_c", "loss_f", "psnr", "lr",
                    "steps_per_sec", "rays_per_sec"))
    saved = torch.load(ckpt.checkpoint_path(log_dir, "cli", 6),
                       weights_only=True)
    assert saved["idx"] == 6
    assert set(saved) == {"idx", "model_state_dict", "optimizer_state_dict"}
    # the idx_test hook scored the held-out view with the trained weights
    assert os.path.isfile(os.path.join(log_dir, "cli", "cli_6",
                                       "test_result", "_result.txt"))

    # the eval entry reads the checkpoint training wrote
    shutil.rmtree(os.path.join(log_dir, "cli", "cli_6"))
    assert main(_args(scene32, log_dir, "cli", 6, "--eval_only", "true",
                      "--testing_idx", "6")) == 0
    lines = open(os.path.join(log_dir, "cli", "cli_6", "test_result",
                              "_result.txt")).read().splitlines()
    assert lines[0].startswith("idx:0\tloss:")


@pytest.mark.parametrize("mode", sorted(MODES))
def test_train_resume_is_bit_exact(scene16, scene32, tmp_path, mode):
    """6 steps, save, resume (``iter_start -1`` finds step 6) to 8,
    against 8 uninterrupted steps: weights and Adam moments bit-equal.
    The global arm's pool reshuffles at step 5, before the resume point,
    so the resumed run must replay it; the per-image arm replays its
    image choices and leaves the precrop window at step 3."""
    log_dir = str(tmp_path / "logs")
    scene = scene16 if mode == "global" else scene32
    extra = ["--precrop_iters", "3", *MODES[mode]]

    def run(exp, *more):
        cfg = port_config.load_config(_args(scene, log_dir, exp, 8,
                                            *extra, *more))
        res = main_worker(cfg)
        assert res["step"] == 8 and all(np.isfinite(res["loss"]))
        return res

    a = run("a", "--idx_save", "2")          # saves 2, 4, 6, 8
    os.makedirs(os.path.join(log_dir, "b"))
    shutil.copy(ckpt.checkpoint_path(log_dir, "a", 6),
                ckpt.checkpoint_path(log_dir, "b", 6))
    b = run("b", "--idx_save", "8", "--iter_start", "-1")
    assert len(a["loss"]) == 8 and len(b["loss"]) == 2
    assert a["loss"][6:] == b["loss"]

    sa, sb = (torch.load(ckpt.checkpoint_path(log_dir, e, 8),
                         weights_only=True) for e in ("a", "b"))
    for k, v in sa["model_state_dict"].items():
        assert torch.equal(v, sb["model_state_dict"][k]), k
    oa, ob = (s["optimizer_state_dict"]["state"] for s in (sa, sb))
    for k in oa:
        for m in oa[k]:
            assert torch.equal(oa[k][m], ob[k][m]), (k, m)
