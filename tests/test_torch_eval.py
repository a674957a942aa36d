"""Port vs JAX package for the eval surface: SSIM, the config parser on
every shipped config, the blender loader, and the ``--eval_only`` entry
point end to end on the CPU."""
import glob
import json
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_pytorch_paeng_tpu.config import config_from_file as jax_config
from nerf_pytorch_paeng_tpu.data.blender import load_blender as jax_load
from nerf_pytorch_paeng_tpu.eval.metrics import compute_ssim as jax_ssim
from nerf_pytorch_paeng_tpu_torch import config as port_config
from nerf_pytorch_paeng_tpu_torch.data.blender import load_blender
from nerf_pytorch_paeng_tpu_torch.driver import checkpoint_path, main
from nerf_pytorch_paeng_tpu_torch.eval.metrics import (compute_lpips,
                                                       compute_ssim,
                                                       load_lpips_params)
from nerf_pytorch_paeng_tpu_torch.models.nerf import init_nerf
from nerf_pytorch_paeng_tpu_torch.utils.device import resolve_device
from nerf_pytorch_paeng_tpu_torch.utils.synth import save_as_blender_dataset

from torch_port_util import subprocess_env

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = sorted(glob.glob(str(ROOT / "configs" / "*" / "*.txt")))


@pytest.mark.parametrize("kind", ["noise", "shift", "anticorrelated"])
def test_ssim_matches_jax(kind):
    """float64 here against float32 there: 1e-5."""
    rng = np.random.default_rng(0)
    gt = rng.uniform(0, 1, (40, 48, 3)).astype(np.float32)
    if kind == "noise":
        pred = np.clip(gt + rng.normal(0, 0.1, gt.shape), 0, 1)
    elif kind == "shift":
        pred = np.clip(gt + 0.05, 0, 1)
    else:
        pred = 1.0 - gt
    pred = pred.astype(np.float32)
    want = float(jax_ssim(jnp.asarray(pred), jnp.asarray(gt)))
    got = compute_ssim(torch.from_numpy(pred), torch.from_numpy(gt))
    assert got == pytest.approx(want, abs=1e-5)
    assert compute_ssim(torch.from_numpy(gt), torch.from_numpy(gt)) == \
        pytest.approx(1.0, abs=1e-9)


def test_lpips_is_gated_not_faked():
    assert load_lpips_params("") is None
    assert np.isnan(compute_lpips(np.zeros((4, 4, 3)), np.zeros((4, 4, 3)),
                                  None))
    with pytest.raises(NotImplementedError):
        load_lpips_params("/nonexistent/vgg.npz")


@pytest.mark.parametrize("path", CONFIGS,
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_config_parity(path):
    ours = port_config.config_from_file(path)
    theirs = jax_config(path)
    got = {k: v for k, v in vars(ours).items() if k != "device"}
    want = {k: getattr(theirs, k) for k in got}
    assert got == want
    assert ours.device == "cuda"


def test_cli_overrides_and_device_knob():
    cfg = port_config.load_config(
        ["--config", str(ROOT / "configs/blender/lego.txt"), "--device",
         "cpu", "--N_samples_c", "8", "--eval_only", "true"])
    assert (cfg.device, cfg.N_samples_c, cfg.eval_only) == ("cpu", 8, True)
    assert cfg.bkg_white and cfg.testskip == 1
    with pytest.raises(ValueError):
        port_config.load_config(["--device", "tpu"])
    with pytest.raises(ValueError):
        port_config.load_config(["--data_type", "nope"])


@pytest.mark.parametrize("knob", [("use_pallas", "false"),
                                  ("scan_chunk", "4")])
def test_unported_tpu_knobs_are_refused(knob, tmp_path):
    """A TPU knob of the JAX package fails loudly instead of being
    ignored, on the command line and in a config file."""
    name, value = knob
    with pytest.raises(SystemExit):
        port_config.load_config([f"--{name}", value])
    path = tmp_path / "knob.txt"
    path.write_text(f"{name} = {value}\n")
    with pytest.raises(KeyError, match=name):
        port_config.config_from_file(str(path))


def test_resolve_device_never_falls_back():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            resolve_device("cuda")


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth_blender")
    save_as_blender_dataset(str(root), n_train=2, n_val=1, n_test=2,
                            H=16, W=16)
    return str(root)


@pytest.mark.parametrize("downsample,testskip,white", [(0, 1, True),
                                                       (2, 2, False)])
def test_load_blender_matches_jax(synth_root, downsample, testskip, white):
    a = load_blender(synth_root, white, downsample, testskip)
    b = jax_load(synth_root, white, downsample, testskip)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1][0], b[1][0])
    np.testing.assert_array_equal(a[1][1], b[1][1])
    assert a[2] == b[2]
    for x, y in zip(a[3], b[3]):
        np.testing.assert_array_equal(x, y)


def test_synth_scene_matches_jax():
    """The port's own copy of the synthetic scene renders the same views
    (row chunking does not change a pixel)."""
    from nerf_pytorch_paeng_tpu.utils.synth import make_synth_scene as jax_ms
    from nerf_pytorch_paeng_tpu_torch.utils.synth import make_synth_scene
    a, b = make_synth_scene(3, 20, 24), jax_ms(3, 20, 24)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-6)


def test_synth_scene_camera_angle(tmp_path):
    """A scene written at lego's field of view loads with lego's focal
    length (the loader's own formula, within float32 rounding)."""
    angle = 0.6911112070083618
    save_as_blender_dataset(str(tmp_path), n_train=1, n_val=1, n_test=1,
                            H=8, W=10, camera_angle_x=angle)
    _, (K, _), (H, W), _ = load_blender(str(tmp_path), True, 0, 1)
    assert (H, W) == (8, 10)
    np.testing.assert_allclose(K[0, 0], 0.5 * 10 / np.tan(0.5 * angle),
                               rtol=1e-6)


def test_png_round_trip_matches_imageio(tmp_path):
    import imageio.v2 as imageio
    from nerf_pytorch_paeng_tpu_torch.utils.image import imread, imwrite
    arr = np.random.default_rng(0).integers(0, 256, (9, 7, 4), np.uint8)
    imwrite(str(tmp_path / "a.png"), arr)
    np.testing.assert_array_equal(imread(str(tmp_path / "a.png")), arr)
    np.testing.assert_array_equal(imageio.imread(str(tmp_path / "a.png")),
                                  arr)


def _write_ckpt(cfg, step):
    path = checkpoint_path(cfg, step)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    model = init_nerf(cfg, seed=3)
    torch.save({"idx": step, "model_state_dict": model.state_dict()}, path)
    return path


def test_eval_only_cli_end_to_end(synth_root, tmp_path):
    """python -m nerf_pytorch_paeng_tpu_torch --eval_only on the lego
    config (8x256) at 16x16 with 8+8 samples, on the CPU: PNGs and a
    reference-format _result.txt, finite metrics, LPIPS nan."""
    log_dir = str(tmp_path / "logs")
    args = ["--config", str(ROOT / "configs/blender/lego.txt"),
            "--eval_only", "true", "--testing_idx", "5", "--device", "cpu",
            "--data_root", synth_root, "--log_dir", log_dir,
            "--N_samples_c", "8", "--N_samples_f", "8"]
    cfg = port_config.load_config(args)
    _write_ckpt(cfg, 5)
    proc = subprocess.run([sys.executable, "-m",
                           "nerf_pytorch_paeng_tpu_torch", *args],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300, env=subprocess_env())
    assert proc.returncode == 0, proc.stderr
    out_dir = os.path.join(log_dir, "blender_lego", "blender_lego_5",
                           "test_result")
    for i in range(2):
        for suffix in ("", "_disp"):
            assert os.path.isfile(os.path.join(out_dir, f"{i:03d}{suffix}.png"))
    lines = open(os.path.join(out_dir, "_result.txt")).read().splitlines()
    assert lines[0].startswith("idx:0\tloss:") and "\tlpips:nan" in lines[0]
    assert lines[3].startswith("Best Value ) PSNR : ")
    assert lines[4].startswith("Mean Value ) PSNR : ")
    psnr = float(lines[0].split("psnr:")[1].split("\t")[0])
    assert np.isfinite(psnr) and psnr > 0
    assert "test view 1:" in proc.stdout


@pytest.mark.parametrize("flags", [["--data_type", "custom"],
                                   ["--data_type", "llff"]])
def test_unported_modes_exit_nonzero(flags, capsys):
    rc = main(["--config", str(ROOT / "configs/blender/lego.txt"),
               "--device", "cpu", *flags])
    assert rc != 0
    assert "not ported yet" in capsys.readouterr().err


def test_run_test_metrics_in_process(synth_root, tmp_path):
    from nerf_pytorch_paeng_tpu_torch.driver import main_worker
    cfg = port_config.load_config(
        ["--config", str(ROOT / "configs/blender/lego.txt"),
         "--eval_only", "true", "--testing_idx", "1", "--device", "cpu",
         "--data_root", synth_root, "--log_dir", str(tmp_path),
         "--N_samples_c", "8", "--N_samples_f", "8"])
    _write_ckpt(cfg, 1)
    res = main_worker(cfg)
    assert len(res["psnr"]) == 2 and len(res["frame_s"]) == 2
    assert all(np.isfinite(res["psnr"])) and all(np.isfinite(res["ssim"]))
    assert all(np.isnan(res["lpips"]))
    assert res["mean_psnr"] == pytest.approx(np.mean(res["psnr"]))
    json.dumps(res)                      # plain floats, serialisable
