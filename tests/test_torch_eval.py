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
                                                       load_lpips_params,
                                                       ssim_tensor)
from nerf_pytorch_paeng_tpu_torch.models.nerf import init_nerf
from nerf_pytorch_paeng_tpu_torch.utils.device import resolve_device
from nerf_pytorch_paeng_tpu_torch.utils.synth import (save_as_blender_dataset,
                                                      save_as_llff_dataset)

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


@pytest.mark.parametrize("hwc", [(3, 4, 3), (10, 24, 3)])
def test_ssim_is_nan_below_the_window(hwc):
    """A frame lower or narrower than the 11-pixel window: JAX's VALID
    filter leaves an empty map whose mean is nan; the port returns nan
    (float64, on the images' device) where it used to raise."""
    rng = np.random.default_rng(1)
    gt = rng.uniform(0, 1, hwc).astype(np.float32)
    pred = np.clip(gt + rng.normal(0, 0.1, hwc), 0, 1).astype(np.float32)
    assert np.isnan(float(jax_ssim(jnp.asarray(pred), jnp.asarray(gt))))
    t = ssim_tensor(torch.from_numpy(pred), torch.from_numpy(gt))
    assert t.dtype == torch.float64 and t.shape == () and bool(t.isnan())
    assert np.isnan(compute_ssim(torch.from_numpy(pred),
                                 torch.from_numpy(gt)))


def test_eval_only_below_the_ssim_window_logs_nan(tmp_path):
    """``--eval_only`` of a custom capture at ``--downsample 8``: 24x32
    views become 3x4 frames, below SSIM's window; the run exits 0 and
    logs nan SSIM beside finite PSNR."""
    root = str(tmp_path / "capture")
    save_as_llff_dataset(root, n_views=6, H=24, W=32, n_samples=64)
    args = ["--config", str(ROOT / "configs/llff/fern.txt"), "--data_type",
            "custom", "--exp_name", "tiny", "--data_root", root,
            "--log_dir", str(tmp_path / "logs"), "--device", "cpu",
            "--downsample", "8", "--N_samples_c", "8", "--N_samples_f", "8",
            "--eval_only", "true", "--testing_idx", "1"]
    cfg = port_config.load_config(args)
    ckpt = checkpoint_path(cfg, 1)
    os.makedirs(os.path.dirname(ckpt), exist_ok=True)
    torch.save({"idx": 1, "model_state_dict":
                init_nerf(cfg, device="cpu").state_dict()}, ckpt)
    assert main(args) == 0
    result = os.path.join(str(tmp_path / "logs"), "tiny", "tiny_1",
                          "test_result", "_result.txt")
    line = open(result).read().splitlines()[0]
    fields = dict(f.split(":", 1) for f in line.split("\t"))
    assert np.isnan(float(fields["ssim"]))
    assert np.isfinite(float(fields["psnr"]))


def test_lpips_is_gated_not_faked():
    assert load_lpips_params("") is None
    assert np.isnan(compute_lpips(np.zeros((4, 4, 3)), np.zeros((4, 4, 3)),
                                  None))
    with pytest.raises(FileNotFoundError):
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


@pytest.mark.parametrize("knob", [
    (("compile_cache", "off", "auto"), ("profile", "true", False)),
    (("scan_chunk", "4", 16), ("check_nans", "true", False))])
def test_unported_tpu_knobs_are_refused(knob, tmp_path):
    """The JAX package's four run knobs (once refused here, now ported:
    ``train/chunk.py``, ``driver.py``, ``kernels/build.py``) parse on the
    command line and in a config file as the JAX package parses them, and
    default to the JAX package's values."""
    from nerf_pytorch_paeng_tpu.config import NerfConfig as JaxConfig
    for name, value, default in knob:
        want = {"true": True, "4": 4}.get(value, value)
        assert getattr(port_config.NerfConfig(), name) == default
        assert getattr(JaxConfig(), name) == default
        assert getattr(port_config.load_config([f"--{name}", value]),
                       name) == want
        path = tmp_path / "knob.txt"
        path.write_text(f"{name} = {value}  # the JAX package's knob\n")
        assert getattr(port_config.config_from_file(str(path)), name) == want


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
def test_llff_and_custom_modes_run(flags, tmp_path, capsys):
    """The LLFF and custom data types, once refused, train through
    ``main`` on a synthetic forward-facing capture (LLFF layout, with
    poses_bounds.npy: no COLMAP) and save a checkpoint."""
    root = str(tmp_path / "capture")
    save_as_llff_dataset(root, n_views=4, H=16, W=24, n_samples=32)
    rc = main(["--config", str(ROOT / "configs/llff/fern.txt"),
               "--device", "cpu", *flags, "--data_root", root,
               "--log_dir", str(tmp_path / "logs"), "--downsample", "0",
               "--iter_N", "2", "--iter_warmup", "0", "--N_rays", "128",
               "--N_samples_c", "8", "--N_samples_f", "8", "--idx_save", "2",
               "--idx_test", "0", "--idx_render", "0"])
    assert rc == 0
    assert f"loading dataset [{flags[1]}]" in capsys.readouterr().out
    assert (tmp_path / "logs" / "llff_fern" / "llff_fern_2.pth.tar").is_file()


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
