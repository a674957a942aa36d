"""The training pieces of the port around the render: schedule, ray pool,
pixel sampling, batched rays, metrics log, checkpoints and the shape gate
between the ray and the plane training kernels.  Against the JAX package
where it computes the same thing (float32, a few ulps), otherwise against
their contracts."""
import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_pytorch_paeng_tpu.ops import rays as jrays
from nerf_pytorch_paeng_tpu.train.schedule import \
    cosine_annealing_warmup_restarts as jax_lr
from nerf_pytorch_paeng_tpu_torch.config import NerfConfig
from nerf_pytorch_paeng_tpu_torch.ops import rays
from nerf_pytorch_paeng_tpu_torch.ops.render import (
    render_rays_train, supports_train_rays_kernels)
from nerf_pytorch_paeng_tpu_torch.train import (RayPool, build_ray_pool,
                                                create_train_state)
from nerf_pytorch_paeng_tpu_torch.train import checkpoint as ckpt
from nerf_pytorch_paeng_tpu_torch.train.schedule import (
    cosine_annealing_warmup_restarts, schedule_from_cfg)
from nerf_pytorch_paeng_tpu_torch.train.step import (make_train_step,
                                                     mse2psnr, step_generator)
from nerf_pytorch_paeng_tpu_torch.utils.logging import MetricLogger
from nerf_pytorch_paeng_tpu_torch.utils.synth import make_synth_scene

from test_schedule import oracle_lr


@pytest.mark.parametrize("fcs,warm", [(2001, 100), (11, 0), (101, 100)])
def test_schedule_matches_oracle(fcs, warm):
    for step in sorted({0, 1, max(warm - 1, 0), warm, warm + 1, fcs // 2,
                        fcs - 1, fcs, fcs + 5}):
        got = cosine_annealing_warmup_restarts(step, fcs, warm, 5e-4, 5e-5)
        want = oracle_lr(step, fcs, warm, 5e-4, 5e-5)
        assert got == pytest.approx(want, rel=1e-12), step


def test_schedule_restarts_match_jax():
    for step in (0, 50, 99, 100, 150, 299, 300, 700):
        got = cosine_annealing_warmup_restarts(step, 100, 10, 1e-3, 1e-5,
                                               cycle_mult=2.0, gamma=0.5)
        want = float(jax_lr(step, 100, 10, 1e-3, 1e-5, cycle_mult=2.0,
                            gamma=0.5))
        assert got == pytest.approx(want, rel=1e-5), step


def test_schedule_from_cfg_is_zero_based():
    cfg = NerfConfig(iter_N=100, iter_warmup=10, lr=5e-4, lr_min=5e-5)
    s = schedule_from_cfg(cfg)
    assert s(0) == pytest.approx(5e-5)       # update 1 runs at the floor
    assert s(10) == pytest.approx(5e-4)      # the peak right after warmup
    assert s(100) < s(50) < s(10)


def _pool_inputs(n_views=2, H=8, W=8):
    images, K, poses = make_synth_scene(n_views=n_views, H=H, W=W)
    return images, K, poses, np.arange(n_views)


def test_ray_pool_holds_every_train_pixel():
    images, K, poses, i_train = _pool_inputs()
    pool = build_ray_pool(images, K, poses, i_train,
                          torch.Generator().manual_seed(0), "cpu")
    assert pool.shape == (2 * 64, 3, 3)
    o, d = jrays.get_rays_batched(8, 8, jnp.asarray(K, jnp.float32),
                                  jnp.asarray(poses[:, :3, :4]))
    want = np.stack([np.asarray(o), np.asarray(d), images], 3).reshape(-1, 3, 3)
    # the JAX package's unshuffled pool in the generator's order
    perm = torch.randperm(128, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(pool.numpy(), want[perm.numpy()], rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("steps", [1, 3, 4, 5, 9, 13])
def test_ray_pool_fast_forward_matches_stepping(steps):
    """per epoch = 128 // 32 = 4 batches: reshuffles at calls 5, 9, 13."""
    images, K, poses, i_train = _pool_inputs()

    def fresh():
        gen = torch.Generator().manual_seed(1)
        return RayPool(build_ray_pool(images, K, poses, i_train, gen, "cpu"),
                       gen)

    a, b = fresh(), fresh()
    for _ in range(steps):
        a.next_start(32)
    b.fast_forward(steps, 32)
    assert (a.i_batch, a.epoch) == (b.i_batch, b.epoch)
    assert torch.equal(a.pool, b.pool)
    for x, y in zip(a.next_batch(32), b.next_batch(32)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("precrop", [False, True])
def test_sample_pixels_bounds_and_no_repeats(precrop):
    H, W, n = 20, 24, 100
    g = torch.Generator().manual_seed(0)
    c = rays.sample_pixels(H, W, n, precrop=precrop, precrop_frac=0.5,
                           generator=g)
    assert c.shape == (n, 2) and c.dtype == torch.int64
    lo_r, hi_r, lo_c, hi_c = (5, 15, 6, 18) if precrop else (0, H, 0, W)
    assert int(c[:, 0].min()) >= lo_r and int(c[:, 0].max()) < hi_r
    assert int(c[:, 1].min()) >= lo_c and int(c[:, 1].max()) < hi_c
    assert len({tuple(x) for x in c.tolist()}) == n
    with pytest.raises(ValueError):
        rays.sample_pixels(H, W, 10 * 12 + 1, precrop=True, generator=g)


@pytest.mark.parametrize("precrop", [False, True])
def test_sample_pixels_with_jax_draws(precrop):
    """Injected flat indices give the JAX package's coordinates."""
    key = jax.random.PRNGKey(7)
    want = np.asarray(jrays.sample_pixels(key, 20, 24, 50, precrop=precrop))
    n_px = 10 * 12 if precrop else 20 * 24
    flat = np.array(jax.random.choice(key, n_px, shape=(50,),
                                        replace=False))
    got = rays.sample_pixels(20, 24, 50, precrop=precrop,
                             flat=torch.from_numpy(flat).long())
    np.testing.assert_array_equal(got.numpy(), want)


def test_get_rays_batched_and_gather_match_jax():
    images, K, poses, _ = _pool_inputs(n_views=3, H=6, W=10)
    jo, jd = jrays.get_rays_batched(6, 10, jnp.asarray(K, jnp.float32),
                                    jnp.asarray(poses[:, :3, :4]))
    o, d = rays.get_rays_batched(6, 10, K, torch.from_numpy(poses))
    assert o.shape == d.shape == (3, 6, 10, 3)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-6)
    coords = np.array([[0, 0], [5, 9], [2, 3]])
    want = jrays.gather_rays(jo[1], jd[1], jnp.asarray(images[1]),
                             jnp.asarray(coords))
    got = rays.gather_rays(o[1], d[1], torch.from_numpy(images[1]),
                           torch.from_numpy(coords))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


def test_step_generator_replays_by_step():
    a = torch.rand(4, generator=step_generator(3, 7, "cpu"))
    b = torch.rand(4, generator=step_generator(3, 7, "cpu"))
    c = torch.rand(4, generator=step_generator(3, 8, "cpu"))
    d = torch.rand(4, generator=step_generator(4, 7, "cpu"))
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, d)


def test_mse2psnr():
    assert float(mse2psnr(torch.tensor(0.01))) == pytest.approx(20.0)


def test_train_shape_gate_names_the_plane_kernels(monkeypatch):
    """Shapes the ray pair does not take train on the plane pair (K8/K9,
    ``fused_mlp_train``); ``render_rays_train`` keeps its shape check for
    direct callers."""
    from nerf_pytorch_paeng_tpu_torch.kernels import fused_mlp_vjp
    cfg = NerfConfig(device="cpu", N_samples_c=8, N_samples_f=8,
                     compute_dtype="float32", iter_N=10, iter_warmup=0)
    assert supports_train_rays_kernels(cfg, 256)
    assert not supports_train_rays_kernels(cfg, 100)
    assert not supports_train_rays_kernels(
        NerfConfig(N_samples_c=12, N_samples_f=8), 256)
    assert not supports_train_rays_kernels(
        NerfConfig(N_samples_c=8, N_samples_f=4), 256)
    state = create_train_state(cfg, "cpu")
    with pytest.raises(AssertionError, match="plane layout"):
        render_rays_train(state.model, torch.zeros(100, 3),
                          torch.ones(100, 3), cfg)
    calls = []
    pair = fused_mlp_vjp.fused_mlp_train
    monkeypatch.setattr(fused_mlp_vjp, "fused_mlp_train",
                        lambda *a, **kw: calls.append(1) or pair(*a, **kw))
    g = torch.Generator().manual_seed(0)
    o = torch.tensor([0.0, 0.0, 4.0]) + 0.1 * torch.randn(100, 3, generator=g)
    d = -o / 4.0 + 0.1 * torch.randn(100, 3, generator=g)
    m = make_train_step(cfg, schedule_from_cfg(cfg))(
        state, o, d, torch.rand(100, 3, generator=g))
    assert state.step == 1 and bool(torch.isfinite(m["loss"]))
    assert len(calls) == 2                 # the coarse and the fine pass


def test_metric_logger_merges_a_foreign_header(tmp_path):
    """A resumed run over a file of another schema keeps its rows under
    the union header."""
    path = tmp_path / "exp" / "metrics.csv"
    path.parent.mkdir()
    path.write_text("step,loss,gate_frac\r\n5,0.5,0.25\r\n")
    log = MetricLogger(str(tmp_path), "exp")
    log.log(6, {"loss": 0.4})
    log.close()
    rows = list(csv.DictReader(open(path)))
    assert [(r["step"], r["loss"], r["gate_frac"]) for r in rows] == [
        ("5", "0.5", "0.25"), ("6", "0.4", "")]


def test_metric_logger_schema_and_resume(tmp_path):
    log = MetricLogger(str(tmp_path), "exp", fresh=True)
    log.log(10, {"loss": 0.5, "psnr": 3.0, "lr": 1e-4}, n_rays=128)
    log.log(20, {"loss": 0.25, "psnr": 6.0, "lr": 2e-4}, n_rays=128)
    log.close()
    path = tmp_path / "exp" / "metrics.csv"
    rows = list(csv.DictReader(open(path)))
    assert [r["step"] for r in rows] == ["10", "20"]
    assert set(rows[0]) == {"step", "loss", "loss_c", "loss_f", "psnr",
                            "psnr_c", "psnr_f", "lr", "gate_frac",
                            "steps_per_sec", "rays_per_sec"}
    assert float(rows[1]["rays_per_sec"]) == pytest.approx(
        128 * float(rows[1]["steps_per_sec"]))
    resumed = MetricLogger(str(tmp_path), "exp")           # appends
    resumed.log(30, {"loss": 0.125, "gate_frac": 0.5})
    with pytest.raises(ValueError):                      # not in the schema
        resumed.log(40, {"grad_norm": 0.5})
    resumed.close()
    assert len(list(csv.DictReader(open(path)))) == 3
    MetricLogger(str(tmp_path), "exp", fresh=True).close()  # truncates
    assert list(csv.DictReader(open(path))) == []


def test_checkpoint_round_trip(tmp_path):
    cfg = NerfConfig(device="cpu", log_dir=str(tmp_path), exp_name="e")
    state = create_train_state(cfg, "cpu")
    loss = sum(p.sum() for p in state.model.parameters())
    loss.backward()
    state.optimizer.step()
    state.step = 7
    assert ckpt.latest_checkpoint_step(cfg.logdir, "e") is None
    path = ckpt.save_checkpoint(cfg.logdir, "e", state)
    assert path.endswith("e/e_7.pth.tar")
    state.step = 12
    ckpt.save_checkpoint(cfg.logdir, "e", state)
    assert ckpt.latest_checkpoint_step(cfg.logdir, "e") == 12
    raw = torch.load(path, weights_only=True)
    assert set(raw) == {"idx", "model_state_dict", "optimizer_state_dict"}
    assert raw["idx"] == 7

    other = create_train_state(NerfConfig(device="cpu", seed=9), "cpu")
    ckpt.restore_checkpoint(cfg.logdir, "e", 7, other)
    assert other.step == 7
    for (k, a), b in zip(state.model.state_dict().items(),
                         other.model.state_dict().values()):
        assert torch.equal(a, b), k
    sa, sb = (s.optimizer.state_dict()["state"] for s in (state, other))
    for k in sa:
        for m in sa[k]:
            assert torch.equal(sa[k][m], sb[k][m]), (k, m)
