"""The port's run knobs ``scan_chunk``, ``check_nans``, ``profile`` and
``compile_cache`` on the CPU (``train/chunk.py``, ``driver.train``,
``kernels/build.py``).

``scan_chunk`` runs the same staged step eagerly here (CUDA graphs are the
card's: ``tests/test_torch_cuda.py``), so these tests hold what the card
shares with the CPU: the chunk schedule against the JAX package's
``_chunk_len``, and chunked runs against single steps, bit for bit, in
the JAX package's own scenario (``tests/test_cli.py:73-110``: 3 views of
16x16, 64 rays, 48 iterations, a pool reshuffle every 12 steps) and in a
gated run that crosses a precrop flip, ``idx_save``, ``idx_test`` and
pre-cull refreshes.
"""
import ast
import csv
import dataclasses
import json
import math
import os
import pathlib
import types

import numpy as np
import pytest
import torch

from nerf_pytorch_paeng_tpu_torch.config import NerfConfig, load_config
from nerf_pytorch_paeng_tpu_torch.driver import main_worker
from nerf_pytorch_paeng_tpu_torch.kernels import build
from nerf_pytorch_paeng_tpu_torch.models.nerf import NeRF
from nerf_pytorch_paeng_tpu_torch.train import TrainState, make_optimizer
from nerf_pytorch_paeng_tpu_torch.train.checkpoint import (checkpoint_path,
                                                           save_checkpoint)
from nerf_pytorch_paeng_tpu_torch.train.chunk import (ChunkSchedule,
                                                      StagedSteps,
                                                      chunk_off_reason)
from nerf_pytorch_paeng_tpu_torch.utils.synth import (
    compact_field_state_dict, save_as_blender_dataset)

import torch_port_util  # noqa: F401  (this worker's share of the cores)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMING = {"steps_per_sec", "rays_per_sec"}     # wall-clock columns


@pytest.fixture(scope="module")
def scene16(tmp_path_factory):
    """The JAX package's CLI scene (tests/test_cli.py:35-39)."""
    root = tmp_path_factory.mktemp("synth16")
    save_as_blender_dataset(str(root), n_train=3, n_val=1, n_test=2, H=16,
                            W=16)
    return str(root)


@pytest.fixture(scope="module")
def scene32(tmp_path_factory):
    """32x32: the precrop window (16x16) holds 128 rays."""
    root = tmp_path_factory.mktemp("synth32")
    save_as_blender_dataset(str(root), n_train=2, n_val=1, n_test=1, H=32,
                            W=32)
    return str(root)


def _jax_scenario(root, log_dir, exp, **over):
    """tests/test_cli.py's write_cfg at iter_N 48 with idx_save 48 and no
    test or render hook, as its _run_and_restore runs it."""
    kw = dict(data_type="blender", data_root=root, near=2.0, far=6.0,
              exp_name=exp, iter_N=48, iter_warmup=2, N_rays=64,
              N_samples_c=8, N_samples_f=8, netDepth=2, netWidth=32, L_x=4,
              L_d=2, testskip=1, idx_save=48, idx_test=0, idx_render=0,
              idx_print=6, idx_vis=6, chunk_rays=64,
              compute_dtype="float32", bkg_white=True, global_batch=False,
              log_dir=log_dir, device="cpu")
    kw.update(over)
    return NerfConfig(**kw).validate()


def _csv_rows(cfg):
    with open(os.path.join(cfg.logdir, cfg.exp_name, "metrics.csv")) as f:
        return [{k: v for k, v in row.items() if k not in TIMING}
                for row in csv.DictReader(f)]


def _saved(cfg, step):
    return torch.load(checkpoint_path(cfg.logdir, cfg.exp_name, step),
                      weights_only=True)


def _assert_same_state(a, b):
    """Weights and Adam's moments and counts bit-equal."""
    for k, v in a["model_state_dict"].items():
        assert torch.equal(v, b["model_state_dict"][k]), k
    sa, sb = (x["optimizer_state_dict"]["state"] for x in (a, b))
    assert sa.keys() == sb.keys()
    for i in sa:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)


@pytest.mark.parametrize("global_batch", [False, True],
                         ids=["per_image", "global_batch"])
def test_scan_chunk_trajectory_is_bit_equal(tmp_path, scene16, global_batch):
    """scan_chunk 4 against 1 in the JAX package's scenario: final weights,
    Adam's state, every loss and every logged metrics.csv row bit-equal,
    with chunks of 4 run (the global-batch pool reshuffles every 12
    steps, which ends a chunk)."""
    runs = {}
    for k in (1, 4):
        cfg = _jax_scenario(scene16, str(tmp_path / "logs"),
                            f"scan{k}", scan_chunk=k,
                            global_batch=global_batch)
        runs[k] = (cfg, main_worker(cfg))
    (c1, r1), (c4, r4) = runs[1], runs[4]
    assert r1["loss"] == r4["loss"] and len(r4["loss"]) == 48
    assert all(map(math.isfinite, r4["loss"]))
    _assert_same_state(_saved(c1, 48), _saved(c4, 48))
    rows1, rows4 = _csv_rows(c1), _csv_rows(c4)
    assert rows1 == rows4
    assert [int(r["step"]) for r in rows4] == list(range(6, 49, 6))
    assert r1["chunks"] == [1] * 48
    assert r4["chunks"].count(4) >= 8 and sum(r4["chunks"]) == 48


def _gated_run(root, log_dir, exp, chunk):
    """Per-image lego-width steps 11..34 from a compact-field checkpoint,
    gated (min_gate 0, a refresh every 8 steps), across the precrop flip
    at 20, saves at 16 and 32 and a test at 24."""
    cfg = load_config([
        "--config", str(ROOT / "configs/blender/lego.txt"), "--device", "cpu",
        "--data_root", root, "--log_dir", log_dir, "--exp_name", exp,
        "--iter_start", "10", "--iter_N", "34", "--iter_warmup", "0",
        "--N_rays", "128", "--N_samples_c", "8", "--N_samples_f", "8",
        "--precrop_iters", "20", "--idx_save", "16", "--idx_test", "24",
        "--idx_render", "0", "--idx_print", "0", "--idx_vis", "3",
        "--testskip", "1", "--render_precull_grid", "16",
        "--train_precull_every", "8", "--train_precull_min_gate", "0",
        "--scan_chunk", str(chunk)])
    model = NeRF()
    model.load_state_dict(compact_field_state_dict(r=1.5))
    save_checkpoint(cfg.logdir, cfg.exp_name,
                    TrainState(model, make_optimizer(model, cfg), 10))
    return cfg, main_worker(cfg)


def test_scan_chunk_across_precrop_save_test_and_gated_refresh(tmp_path,
                                                               scene32):
    """A gated per-image run through the ray-major pair: scan_chunk 4
    against 1 bit-equal (losses, gate shares, the saves at 16 and 32,
    the logged rows, the policy's refreshes at 11, 19 and 27), with
    chunks of 4 between the hooks, the precrop flip and the refreshes."""
    (c1, r1), (c4, r4) = (_gated_run(scene32, str(tmp_path / "logs"),
                                     f"gated{k}", k) for k in (1, 4))
    assert r1["loss"] == r4["loss"] and r1["gate_frac"] == r4["gate_frac"]
    assert all(g is not None for g in r4["gate_frac"])
    for step in (16, 32):
        _assert_same_state(_saved(c1, step), _saved(c4, step))
    assert _csv_rows(c1) == _csv_rows(c4)
    for c in (c1, c4):
        with open(os.path.join(c.logdir, c.exp_name,
                               "precull_policy.csv")) as f:
            rows = f.read().splitlines()[1:]
        assert [r.split(",")[0] for r in rows] == ["11", "19", "27"]
        assert os.path.isfile(os.path.join(c.logdir, c.exp_name,
                                           f"{c.exp_name}_24", "test_result",
                                           "_result.txt"))
    # 11-14, then single steps around the save at 16, the precrop flip at
    # 20 and the refresh at 19; 20-23; single steps around the test at 24
    # and the refresh at 27; 27-30; single steps before the save at 32
    assert r4["chunks"] == [4, 1, 1, 1, 1, 1, 4, 1, 1, 1, 4, 1, 1, 1, 1]


def _jax_chunk_len():
    """The JAX package's ``_chunk_len`` (its driver.py:332-355), taken from
    its source and made a function of (i, K_scan, use_scan, cfg, ray_pool,
    test_on, render_on)."""
    src = (ROOT / "nerf_pytorch_paeng_tpu" / "driver.py").read_text()
    fn = next(n for n in ast.walk(ast.parse(src))
              if isinstance(n, ast.FunctionDef) and n.name == "_chunk_len")
    code = compile(ast.Module(body=[fn], type_ignores=[]), "jax_driver",
                   "exec")

    def chunk_len(i, **scope):
        ns = dict(scope)
        exec(code, ns)
        return ns["_chunk_len"](i)
    return chunk_len


@pytest.mark.parametrize("over", [
    dict(), dict(global_batch=False, precrop_iters=37),
    dict(profile=True), dict(idx_save=50, idx_test=30, idx_render=45),
    dict(scan_chunk=1), dict(scan_chunk=8, iter_N=15),
    dict(iter_start=7, idx_save=20, global_batch=False)])
def test_chunk_schedule_is_the_jax_packages(over):
    """``ChunkSchedule.length`` against the JAX package's own
    ``_chunk_len`` (driver.py:325-355: use_scan, the run's end, the
    profiler window, the precrop flip, the pool's reshuffle, save/test/
    render on the chunk's last iteration only) at every iteration and
    pool cursor; the port's one extra rule, a chunk ending before a
    pre-cull refresh, checked apart."""
    base = dict(scan_chunk=4, iter_start=0, iter_N=100, profile=False,
                global_batch=True, precrop_iters=0, N_rays=64, idx_save=0,
                idx_test=0, idx_render=0)
    cfg = types.SimpleNamespace(**{**base, **over})
    k = max(int(cfg.scan_chunk), 1)
    use_scan = k > 1 and cfg.iter_N - cfg.iter_start >= 2 * k
    test_on, render_on = bool(cfg.idx_test), bool(cfg.idx_render)
    ours = ChunkSchedule.from_cfg(cfg, test_on, render_on)
    theirs = _jax_chunk_len()
    pool_size = 12 * cfg.N_rays
    for i in range(cfg.iter_start + 1, cfg.iter_N + 1):
        for cursor in range(0, pool_size + 1, cfg.N_rays):
            pool = types.SimpleNamespace(i_batch=cursor,
                                         pool=np.empty((pool_size, 3, 3)))
            want = theirs(i, K_scan=k, use_scan=use_scan, cfg=cfg,
                          ray_pool=pool, test_on=test_on,
                          render_on=render_on)
            assert ours.length(i, cursor, pool_size) == want, (i, cursor)
    if ours.k > 1:
        i = cfg.iter_start + 21
        free = ours.length(i, 0, pool_size)
        assert ours.length(i, 0, pool_size, next_refresh=i) == free
        assert ours.length(i, 0, pool_size, next_refresh=i + k) == free
        for r in range(i + 1, i + k):
            assert ours.length(i, 0, pool_size, next_refresh=r) == 1


def test_chunks_are_single_steps_under_gloo_and_tp():
    """Chunk length 1 under a gloo group, an NCCL group of more than one
    rank or a width-sharded model, decided from the configuration, the
    backend and the world size (no capture is attempted); a world-1 NCCL
    group captures."""
    cfg = NerfConfig(device="cpu", iter_N=100)
    assert chunk_off_reason(cfg, None) is None
    assert chunk_off_reason(cfg, "nccl") is None
    assert chunk_off_reason(cfg, "nccl", 1) is None
    assert "NCCL group of 2 ranks" in chunk_off_reason(cfg, "nccl", 2)
    assert "gloo" in chunk_off_reason(cfg, "gloo")
    tp = dataclasses.replace(cfg, n_model_shards=2)
    assert "n_model_shards 2" in chunk_off_reason(tp, "nccl")
    for reason in (chunk_off_reason(cfg, "gloo"), chunk_off_reason(tp, None),
                   chunk_off_reason(cfg, "nccl", 4)):
        assert ChunkSchedule.from_cfg(cfg, False, False, reason).k == 1
    assert ChunkSchedule.from_cfg(cfg, False, False).k == 16


def test_staged_steps_are_the_single_steps(scene16):
    """``StagedSteps`` on the CPU, three eager steps from the pool, against
    ``make_train_step`` on the same batches: weights and metrics
    bit-equal; the slab's columns are the metrics, ``gate_frac`` nan
    ungated, ``finite`` 1."""
    from nerf_pytorch_paeng_tpu_torch.data import load_blender
    from nerf_pytorch_paeng_tpu_torch.train import (RayPool, build_ray_pool,
                                                    create_train_state)
    from nerf_pytorch_paeng_tpu_torch.train.schedule import schedule_from_cfg
    from nerf_pytorch_paeng_tpu_torch.train.step import make_train_step

    cfg = _jax_scenario(scene16, "", "staged", check_nans=True)
    images, (K, ext), (H, W), i_split = load_blender(scene16, True, 0, 1)

    def pool():
        gen = torch.Generator().manual_seed(cfg.seed + 1)
        return RayPool(build_ray_pool(images, K, ext, i_split[0], gen,
                                      "cpu"), gen)

    sched = schedule_from_cfg(cfg)
    a, b = create_train_state(cfg, "cpu"), create_train_state(cfg, "cpu")
    step, pa = make_train_step(cfg, sched, H, W, float(K[0][0])), pool()
    want = [step(a, *pa.next_batch(cfg.N_rays)) for _ in range(3)]
    staged = StagedSteps(cfg, b, sched, torch.device("cpu"), H, W, K,
                         pool=pool())
    slab = staged.run([staged.pool.next_start(cfg.N_rays) for _ in range(3)])
    assert b.step == 3 and staged.captures == 0
    for pa_, pb_ in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(pa_, pb_)
    for j, m in enumerate(want):
        for c, key in enumerate(staged.keys):
            if key in m:
                assert float(slab[j, c]) == float(m[key]), (j, key)
        assert math.isnan(float(slab[j, staged.keys.index("gate_frac")]))
        assert float(slab[j, staged.keys.index("finite")]) == 1.0


def _diverging(root, log_dir, exp, check_nans):
    """An overflowing learning rate (1e30): the second update's loss is
    nan.  Per-image with precrop_iters 2, so that the JAX package's
    jitted step meets the second step's precrop flag for the first time
    (its nan check runs on a dispatch-cache miss)."""
    return dict(data_type="blender", data_root=root, log_dir=log_dir,
                exp_name=exp, iter_N=3, iter_warmup=0, N_rays=64,
                N_samples_c=8, N_samples_f=8, netDepth=2, netWidth=32,
                L_x=4, L_d=2, testskip=1, idx_save=0, idx_test=0,
                idx_render=0, idx_print=0, idx_vis=0,
                compute_dtype="float32", bkg_white=True, global_batch=False,
                precrop_iters=2, lr=1e30, lr_min=1e30, scan_chunk=1,
                check_nans=check_nans)


@pytest.fixture
def jax_debug_nans_reset():
    """The JAX package's check_nans sets a process-wide flag: clear it."""
    import jax
    yield
    jax.config.update("jax_debug_nans", False)


@pytest.mark.parametrize("check_nans", [True, False], ids=["on", "off"])
def test_check_nans_on_a_diverging_run(tmp_path, scene16, check_nans,
                                       jax_debug_nans_reset):
    """With check_nans a diverging run raises FloatingPointError in the
    port (naming update 2) and under the JAX package; without it both run
    to their end, the port's losses nan from update 2 on."""
    from nerf_pytorch_paeng_tpu.config import NerfConfig as JaxConfig
    from nerf_pytorch_paeng_tpu.driver import main_worker as jax_main

    kw = _diverging(scene16, str(tmp_path / "logs"), "nan", check_nans)
    port_cfg = NerfConfig(device="cpu", **kw).validate()
    jax_cfg = JaxConfig(**{**kw, "exp_name": "nan_jax",
                           "compile_cache": "off"}).validate()
    if check_nans:
        with pytest.raises(FloatingPointError, match="update 2"):
            main_worker(port_cfg)
        with pytest.raises(FloatingPointError):
            jax_main(jax_cfg)
    else:
        res = main_worker(port_cfg)
        assert math.isfinite(res["loss"][0])
        assert all(math.isnan(x) for x in res["loss"][1:])
        jax_main(jax_cfg)


def test_profile_writes_a_chrome_trace(tmp_path, scene16, capsys):
    """``profile`` traces steps 10-14 (single steps: the window ends
    chunks) on the CPU into logs/<exp>/profile/ and prints the path."""
    cfg = _jax_scenario(scene16, str(tmp_path / "logs"), "prof", iter_N=24,
                        idx_save=0, profile=True, scan_chunk=4)
    res = main_worker(cfg)
    out = capsys.readouterr().out
    path = os.path.join(cfg.logdir, "prof", "profile", "trace_10-14.json")
    assert f">> profiler trace written to {path}" in out
    with open(path) as f:
        trace = json.load(f)
    assert any(e.get("name", "").startswith("aten::")
               for e in trace["traceEvents"])
    assert res["chunks"][:15] == [1] * 15 and 4 in res["chunks"]


def test_compile_cache_resolves_its_three_forms(tmp_path, capsys):
    """"auto" is the repository's build/kernels, "off" one fresh temporary
    directory a process, anything else that directory; the driver
    resolves it before anything builds and prints it."""
    assert build.resolve_build_dir("auto") == ROOT / "build" / "kernels"
    off = build.resolve_build_dir("off")
    assert off.is_dir() and off != build.resolve_build_dir("auto")
    assert build.resolve_build_dir("off") == off
    assert build.resolve_build_dir(str(tmp_path / "k")) == tmp_path / "k"
    try:
        assert build.use_build_dir(str(tmp_path / "k")) == tmp_path / "k"
        assert build.library_path("fused_mlp").parent == tmp_path / "k"
        with pytest.raises(FileNotFoundError):
            main_worker(NerfConfig(device="cpu", compile_cache="off",
                                   data_root=str(tmp_path / "none"),
                                   eval_only=True))
        assert f">> kernel build cache: {off}" in capsys.readouterr().out
        assert build.BUILD_DIR == off
    finally:
        build.use_build_dir("auto")
