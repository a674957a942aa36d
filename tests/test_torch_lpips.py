"""LPIPS(VGG16) of the port (``eval/metrics.py``) against the JAX
package's ``_lpips_graph``, its weight loader's errors, and LPIPS in the
``--eval_only`` entry.

The pretrained weights are not in the repository: both sides get seeded
random weights at the ``_LPIPS_KEYS`` shapes
(``utils/synth.random_lpips_params``), written as the export tool writes
them (.npz in HWIO plus a ``.sha256`` sidecar).  Tolerance: 1e-5 relative
(float32 convolutions summed in another order; measured 9e-8).
"""
import dataclasses
import os
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_pytorch_paeng_tpu.eval.metrics import _LPIPS_KEYS as JAX_KEYS
from nerf_pytorch_paeng_tpu.eval.metrics import _lpips_graph
from nerf_pytorch_paeng_tpu_torch.config import load_config
from nerf_pytorch_paeng_tpu_torch.data.blender import load_blender
from nerf_pytorch_paeng_tpu_torch.driver import (checkpoint_path, load_model,
                                                 main_worker)
from nerf_pytorch_paeng_tpu_torch.eval.frame import make_frame_renderer
from nerf_pytorch_paeng_tpu_torch.eval.metrics import (_LPIPS_KEYS,
                                                       compute_lpips,
                                                       load_lpips_params,
                                                       lpips_tensor)
from nerf_pytorch_paeng_tpu_torch.kernels.fused_mlp import pack_nerf
from nerf_pytorch_paeng_tpu_torch.models.nerf import init_nerf
from nerf_pytorch_paeng_tpu_torch.utils.synth import (random_lpips_params,
                                                      save_as_blender_dataset,
                                                      save_lpips_params)

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    params = random_lpips_params(0)
    path = str(tmp_path_factory.mktemp("lpips") / "vgg.npz")
    return params, save_lpips_params(path, params)


def _pair(shape, kind):
    rng = np.random.default_rng(sum(shape))
    gt = rng.uniform(0, 1, shape).astype(np.float32)
    if kind == "same":
        return gt, gt
    return np.clip(gt + rng.normal(0, 0.1, shape), 0, 1).astype(np.float32), gt


@pytest.mark.parametrize("shape,kind", [((32, 48, 3), "noise"),
                                        ((37, 50, 3), "noise"),
                                        ((32, 48, 3), "same")],
                         ids=["32x48", "37x50-odd", "identical"])
def test_lpips_graph_matches_jax(weights, shape, kind):
    """Odd sizes test the pool's floor (JAX's VALID reduce_window)."""
    params, path = weights
    assert _LPIPS_KEYS == JAX_KEYS
    pred, gt = _pair(shape, kind)
    want = float(_lpips_graph(jnp.asarray(pred), jnp.asarray(gt),
                              {k: jnp.asarray(v) for k, v in params.items()}))
    got = lpips_tensor(torch.from_numpy(pred), torch.from_numpy(gt),
                       load_lpips_params(path))
    assert got.dtype == torch.float32 and got.shape == ()
    if kind == "same":
        assert float(got) == want == 0.0
    else:
        assert float(got) == pytest.approx(want, rel=1e-5)
        assert want > 0


def test_loader_turns_hwio_to_oihw_once(weights):
    params, path = weights
    loaded = load_lpips_params(path)
    assert set(loaded) == _LPIPS_KEYS
    for i in (0, 5, 12):
        np.testing.assert_array_equal(
            loaded[f"conv{i}_w"].numpy(),
            params[f"conv{i}_w"].transpose(3, 2, 0, 1))
    assert loaded["conv0_w"].shape == (64, 3, 3, 3)
    assert load_lpips_params("") is None
    assert np.isnan(compute_lpips(np.zeros((4, 4, 3)), np.zeros((4, 4, 3)),
                                  None))


def test_loader_errors(weights, tmp_path):
    """A set path never degrades to nan: missing file, wrong sidecar,
    missing key."""
    params, _ = weights
    with pytest.raises(FileNotFoundError, match="export_lpips_weights"):
        load_lpips_params(str(tmp_path / "absent.npz"))
    stale = save_lpips_params(str(tmp_path / "stale.npz"), params)
    with open(stale + ".sha256", "w") as f:
        f.write("0" * 64 + "  stale.npz\n")
    with pytest.raises(ValueError, match="sha256 mismatch"):
        load_lpips_params(stale)
    short = {k: v for k, v in params.items() if k != "lin4_w"}
    with pytest.raises(ValueError, match="lin4_w"):
        load_lpips_params(save_lpips_params(str(tmp_path / "short.npz"),
                                            short))


def test_eval_only_logs_the_lpips_of_its_frames(weights, tmp_path):
    """``--eval_only`` with ``lpips_weights``: every view's LPIPS, queued
    as a tensor behind its render, is ``compute_lpips`` of that very frame
    (rendered again with the same draws) against its ground truth, and
    ``_result.txt`` holds it."""
    _, path = weights
    data = str(tmp_path / "scene")
    save_as_blender_dataset(data, n_train=1, n_val=1, n_test=2, H=16, W=16)
    cfg = load_config([
        "--config", str(ROOT / "configs/blender/lego.txt"), "--device",
        "cpu", "--data_root", data, "--log_dir", str(tmp_path / "logs"),
        "--exp_name", "lp", "--N_samples_c", "8", "--N_samples_f", "8",
        "--eval_only", "true", "--testing_idx", "1", "--lpips_weights",
        path])
    ckpt = checkpoint_path(cfg, 1)
    os.makedirs(os.path.dirname(ckpt))
    torch.save({"idx": 1, "model_state_dict":
                init_nerf(cfg, device="cpu").state_dict()}, ckpt)
    res = main_worker(cfg)
    assert len(res["lpips"]) == 2 and np.isfinite(res["lpips"]).all()

    images, (K, ext), (H, W), (_, _, i_test) = load_blender(
        data, cfg.bkg_white, cfg.downsample, cfg.testskip)
    render = make_frame_renderer(dataclasses.replace(cfg, render_cull="none"),
                                 H, W, K, "cpu")
    packed = pack_nerf(load_model(cfg, 1, "cpu"), cfg, device="cpu")
    gen = torch.Generator().manual_seed(cfg.seed + 1)
    params = load_lpips_params(path)
    lines = open(os.path.join(cfg.logdir, "lp", "lp_1", "test_result",
                              "_result.txt")).read().splitlines()
    for i, v in enumerate(i_test):
        rgb, _ = render(packed, torch.as_tensor(ext[v][:3, :4]), gen)
        want = compute_lpips(rgb, images[v], params)
        assert res["lpips"][i] == want
        fields = dict(f.split(":", 1) for f in lines[i].split("\t"))
        assert float(fields["lpips"]) == want
