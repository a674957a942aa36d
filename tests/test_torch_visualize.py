"""The port's extrinsics plots (``utils/visualize.py``, Pillow) against
the JAX package's (matplotlib): ``center_ray_points`` bit for bit (the
same numpy arithmetic), the file at the same path for the same arguments,
the drawn content (camera centres, axes, the origin star, the ray
points), and the training driver writing ``_ext_vis/train_cameras.png``
(and ``train_cameras_rays.png`` with ``idx_vis_cam_param > 0``) on a run
from step 0, as the JAX driver does."""
import os

import numpy as np
import pytest
from PIL import Image

from nerf_pytorch_paeng_tpu.utils import visualize as jax_visualize
from nerf_pytorch_paeng_tpu_torch.config import load_config
from nerf_pytorch_paeng_tpu_torch.driver import main_worker
from nerf_pytorch_paeng_tpu_torch.utils import visualize
from nerf_pytorch_paeng_tpu_torch.utils.synth import (make_synth_scene,
                                                      save_as_blender_dataset)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("hw", [(32, 32), (24, 33)])
def test_center_ray_points_bit_equal(hw):
    _, K, poses = make_synth_scene(n_views=3, H=hw[0], W=hw[1])
    a_rng, b_rng = np.random.default_rng(5), np.random.default_rng(5)
    for p in poses:
        got = visualize.center_ray_points(p, K, hw, 2.0, 6.0, 50, a_rng)
        want = jax_visualize.center_ray_points(p, K, hw, 2.0, 6.0, 50, b_rng)
        assert got.shape == (50, 3)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        visualize.center_ray_points(poses[0], K, hw, 2.0, 6.0),
        jax_visualize.center_ray_points(poses[0], K, hw, 2.0, 6.0))


def test_extrinsics_plot_lands_where_jax_puts_it(tmp_path):
    _, K, poses = make_synth_scene(n_views=4, H=16, W=16)
    for kw in (dict(name="cams"), dict(name="cams_rays", K=K, hw=(16, 16))):
        want = jax_visualize.visualize_extrinsics(
            poses, str(tmp_path / "jax"), idx_list=[0, 2], **kw)
        got = visualize.visualize_extrinsics(
            poses, str(tmp_path / "port"), idx_list=[0, 2], **kw)
        assert os.path.relpath(got, tmp_path / "port") == os.path.relpath(
            want, tmp_path / "jax") == kw["name"] + ".png"
        with Image.open(got) as im:
            assert im.format == "PNG" and im.size == (visualize.SIZE,) * 2
    dirs = np.eye(3)[[0, 1, 2, 0, 1]]
    rays = visualize.visualize_rays(np.zeros((5, 3)), dirs,
                                    str(tmp_path / "r" / "rays.png"))
    assert os.path.isfile(rays)


def _pixel(img, view, pt):
    x, y = np.round(view(np.asarray(pt, np.float64)[None])[0]).astype(int)
    return img.getpixel((int(x), int(y)))


def test_extrinsics_plot_draws_the_content(tmp_path):
    """Every camera centre is a black dot, the origin the orange star, the
    x axes are drawn red, and with K and hw the ray points in their
    colour."""
    _, K, poses = make_synth_scene(n_views=5, H=16, W=16)
    path = visualize.visualize_extrinsics(poses, str(tmp_path), name="a",
                                          K=K, hw=(16, 16), n_z=40)
    img = Image.open(path).convert("RGB")
    # the plot's view: fitted to the centres, the origin, the axis tips and
    # the ray points, as visualize_extrinsics fits it
    rng = np.random.default_rng(0)
    tips = [p[:3, 3] + p[:3, a] * 0.5 for p in poses for a in range(3)]
    rays = [visualize.center_ray_points(p, K, (16, 16), 2.0, 6.0, 40, rng)
            for p in poses]
    view = visualize._View(np.concatenate([poses[:, :3, 3], np.zeros((1, 3)),
                                           np.reshape(tips, (-1, 3)),
                                           *rays]))
    for p in poses:
        assert _pixel(img, view, p[:3, 3]) == (0, 0, 0)
    assert _pixel(img, view, np.zeros(3)) == visualize.ORIGIN_COLOR
    colors = np.asarray(img).reshape(-1, 3)
    assert (colors == visualize.RAY_POINT_COLOR).all(-1).sum() > 40
    assert (colors == visualize.AXIS_COLORS[0]).all(-1).sum() > 10


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth_vis")
    save_as_blender_dataset(str(root), n_train=3, n_val=1, n_test=1,
                            H=32, W=32)
    return str(root)


@pytest.mark.parametrize("cam_param,files", [
    ("1000", {"train_cameras.png", "train_cameras_rays.png"}),
    ("0", {"train_cameras.png"})])
def test_training_writes_the_extrinsics_plots(scene, tmp_path, cam_param,
                                              files):
    log_dir = str(tmp_path / "logs")
    cfg = load_config([
        "--config", os.path.join(ROOT, "configs/blender/lego.txt"),
        "--device", "cpu", "--data_root", scene, "--log_dir", log_dir,
        "--exp_name", "vis", "--iter_N", "2", "--iter_warmup", "0",
        "--N_rays", "128", "--N_samples_c", "8", "--N_samples_f", "8",
        "--idx_print", "0", "--idx_vis", "0", "--idx_test", "0",
        "--idx_save", "0", "--idx_vis_cam_param", cam_param])
    assert main_worker(cfg)["step"] == 2
    vis = os.path.join(log_dir, "vis", "_ext_vis")
    assert set(os.listdir(vis)) == files
