"""Data parallelism of the port (``nerf_pytorch_paeng_tpu_torch/parallel``)
on the CPU: the launch contract, the two train steps of two gloo ranks
against the JAX package's shard_map steps on 2 virtual CPU devices and
against one rank, the ray pool, the frame renderers, and the CLI.

The ranks are processes that the tests start with the launch contract's
variables set (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``, as torchrun sets them), each with a timeout of 120 s:
``tests/torch_dist_worker.py`` for the steps, the pool and the frames,
``python -m nerf_pytorch_paeng_tpu_torch`` for the CLI.

The JAX side runs ``make_train_step_for_mesh`` and
``make_image_train_step_for_mesh`` on a 2-device mesh: the shard_map path
with its Pallas ray pair in interpret mode, at float32, as
``tests/test_parallel_pallas.py`` runs it.  Each rank of the port gets the
draws of its shard, taken from the keys the JAX steps fold
(``fold_in(key, axis_index)``, ``train/step.py:128-131, 234-244``).

Tolerances:
- port (2 ranks) against JAX (2 shards), one step: the losses to 1e-4
  relative and the updated weights to 2e-3 relative L2, those of
  ``tests/test_torch_train_parity.py`` (float32 sums in another order; a
  fine point's ReLU can fall the other way);
- 2 ranks against 1 rank over the same global batch and draws: every
  step's losses and the first step's gradients to 1e-6 relative (the
  gradient is summed in another order), the weights after two Adam steps
  to 1e-4 relative L2 (Adam moves a weight whose gradient is at float32
  noise by a full step either way; measured up to 4.5e-5);
- a launch of 1 rank against no launch, the ranks' weights against each
  other, the ray pools: bit for bit;
- frames of 2 ranks against 1 rank at ``perturb 0``: 1e-5 absolute.
"""
import os
import shutil
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_pytorch_paeng_tpu.config import NerfConfig as JaxConfig
from nerf_pytorch_paeng_tpu.ops.rays import sample_pixels as jax_pixels
from nerf_pytorch_paeng_tpu.parallel import (batch_sharding, make_mesh,
                                             make_image_train_step_for_mesh,
                                             make_train_step_for_mesh)
from nerf_pytorch_paeng_tpu.train.state import TrainState as JaxState
from nerf_pytorch_paeng_tpu.train.state import make_optimizer as jax_adam
from nerf_pytorch_paeng_tpu_torch import parallel
from nerf_pytorch_paeng_tpu_torch.config import NerfConfig, load_config
from nerf_pytorch_paeng_tpu_torch.driver import main_worker
from nerf_pytorch_paeng_tpu_torch.utils.interop import \
    state_dict_from_jax_params
from nerf_pytorch_paeng_tpu_torch.utils.synth import (make_synth_scene,
                                                      save_as_blender_dataset,
                                                      save_as_llff_dataset)

import torch_dist_worker as tdw
from torch_port_util import np_nerf_params, subprocess_env, to_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_dist_worker.py")
TIMEOUT = 120
N, SC, SF, STEPS = 256, 8, 8, 2
N_UNEVEN = 253                       # 127 + 126 rays: the plane pair


def _start(world: int, argv, cwd, per_rank=None) -> list:
    """Start ``world`` ranks of ``argv`` (``per_rank(r)`` appends to it)
    with the launch contract's variables."""
    env = subprocess_env()
    env.update(PYTHONPATH=ROOT, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(parallel.free_port()), WORLD_SIZE=str(world),
               OMP_NUM_THREADS=str(max(1, torch.get_num_threads() // world)))
    return [subprocess.Popen(
        [*argv, *(per_rank(r) if per_rank else [])], cwd=cwd,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**env, "RANK": str(r), "LOCAL_RANK": str(r)})
        for r in range(world)]


def _wait(procs, ok: bool = True) -> list:
    """Every rank's output, after 120 s at most each; fails unless every
    rank exits 0 (where ``ok``)."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 or not ok, \
            f"rank {r} of {len(procs)}:\n{out[-3000:]}"
    return outs


def _launch(world: int, argv, cwd, per_rank=None) -> list:
    return _wait(_start(world, argv, cwd, per_rank))


def _start_worker(world: int, inputs: dict, out_dir, jobs):
    """Start the worker's ranks on ``inputs``; ``_results`` waits."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "inputs.pt")
    torch.save(inputs, path)
    return (world, out_dir,
            _start(world, [sys.executable, WORKER, path, str(out_dir), *jobs],
                   ROOT))


def _results(started) -> list:
    world, out_dir, procs = started
    _wait(procs)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=True) for r in range(world)]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ------------------------------------------------------ the launch contract


@pytest.fixture
def no_launch(monkeypatch):
    for v in parallel.LAUNCH_ENV:
        monkeypatch.delenv(v, raising=False)
    yield monkeypatch
    assert not parallel.is_distributed()


def test_no_launch_is_one_process(no_launch):
    device, made = parallel.maybe_initialize_distributed("cpu")
    assert (device, made) == (torch.device("cpu"), False)
    assert (parallel.rank(), parallel.world_size()) == (0, 1)


def test_half_set_launch_raises(no_launch):
    no_launch.setenv("RANK", "0")
    no_launch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="LOCAL_RANK.*MASTER_ADDR"):
        parallel.maybe_initialize_distributed("cpu")


def test_failed_init_raises(no_launch):
    """The rendezvous port is taken: init_process_group fails, and the
    launch refuses to run as one process."""
    with socket.socket() as taken:
        taken.bind(("127.0.0.1", 0))
        taken.listen(1)
        for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                         MASTER_ADDR="127.0.0.1",
                         MASTER_PORT=str(taken.getsockname()[1])).items():
            no_launch.setenv(k, v)
        with pytest.raises(RuntimeError, match="refusing to run as one"):
            parallel.maybe_initialize_distributed("cpu")


def test_world_mismatch_raises(no_launch, tmp_path):
    """n_data_shards set to another count than the launch's ranks: the
    run stops before it loads anything, and the group it made is gone."""
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                     MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(parallel.free_port())).items():
        no_launch.setenv(k, v)
    cfg = NerfConfig(device="cpu", n_data_shards=2,
                     data_root=str(tmp_path / "absent"))
    with pytest.raises(ValueError, match="n_data_shards=2"):
        main_worker(cfg)


@pytest.mark.parametrize("argv,world,match", [
    (["--sp_shards", "2"], 2, "needs n_model_shards == sp_shards"),
    (["--sp_shards", "3", "--n_model_shards", "3"], 3,
     "must divide N_samples_c=64"),
    (["--sp_shards", "2", "--n_model_shards", "2", "--N_samples_f", "127"],
     2, r"N_samples_c \+ N_samples_f = 191"),
    (["--n_model_shards", "2"], 3, "does not divide the launch's 3"),
    (["--n_model_shards", "2", "--n_data_shards", "3"], 4,
     "n_data_shards=3 x n_model_shards=2 = 6"),
    (["--n_model_shards", "0"], 1, "invalid n_model_shards=0")],
    ids=["sp_without_model", "coarse_not_divisible", "merged_not_divisible",
         "world_not_divisible", "data_x_model_not_world", "model_below_1"])
def test_mesh_axis_checks_raise(argv, world, match):
    """The JAX package's rules for the mesh knobs (its ``config.py:278``
    and ``eval/frame.py:698-703``), before any rank starts: ``validate``
    for the sample counts, ``check_data_shards`` for the launch's world."""
    with pytest.raises(ValueError, match=match):
        parallel.check_data_shards(load_config(argv), world)


def test_mesh_axes_are_accepted():
    cfg = load_config(["--n_model_shards", "2"])
    assert parallel.check_data_shards(cfg, 4) == (2, 2)
    cfg = load_config(["--sp_shards", "2", "--n_model_shards", "2"])
    assert (cfg.sp_shards, cfg.n_model_shards) == (2, 2)
    assert parallel.check_data_shards(cfg, 2) == (1, 2)
    for ok in ("0", "1"):
        assert load_config(["--sp_shards", ok]).sp_shards == int(ok)
    assert parallel.layout() == parallel.Layout(
        1, 1, parallel.world_group(), parallel.world_group())


# ------------------------------------------------------------ the steps


def test_rank_slices_route_at_the_per_rank_count():
    """3 ranks at 4096 rays hold 1366, 1365 and 1365: counts off the ray
    pair's 128-ray multiple, so each trains on the plane pair, as each
    JAX shard's kernels would; 2 ranks hold 2048 each and keep the ray
    pair."""
    from nerf_pytorch_paeng_tpu_torch.train.step import step_route
    cfg = NerfConfig(device="cpu")
    parts = [parallel.rank_bounds(4096, r, 3) for r in range(3)]
    assert parts == [(0, 1366), (1366, 2731), (2731, 4096)]
    assert [step_route(cfg, hi - lo) for lo, hi in parts] == ["planes"] * 3
    assert step_route(cfg, 2048) == "rays"


def test_render_jitter_is_drawn_per_rank():
    """At world size > 1 each rank's render generator mixes its rank into
    (seed, step); without a rank it is the plain run's."""
    from nerf_pytorch_paeng_tpu_torch.train.step import step_generator

    def draw(rank):
        return torch.rand(8, generator=step_generator(3, 5, "cpu", rank))
    assert torch.equal(draw(None), draw(None))
    assert torch.equal(draw(1), draw(1))
    draws = [draw(r) for r in (None, 0, 1, 2)]
    assert all(not torch.equal(a, b) for i, a in enumerate(draws)
               for b in draws[i + 1:])



def _jax_uniforms(key, n: int):
    """The render's draws from ``key`` (render_rays_train's split)."""
    key_c, key_f = jax.random.split(key)
    return (torch.from_numpy(np.array(jax.random.uniform(key_c, (n, SC)))),
            torch.from_numpy(np.array(jax.random.uniform(key_f, (n, SF)))))


def _batch(seed: int, n: int):
    rng = np.random.default_rng(seed)
    o = np.array([0.0, 0.0, 4.0]) + rng.normal(0, 0.1, (n, 3))
    d = -o / 4.0 + rng.normal(0, 0.2, (n, 3))
    return np.stack([o, d, rng.uniform(0, 1, (n, 3))]).astype(np.float32)


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """The port's jobs at 2 ranks and at 1 rank (both shards' draws,
    concatenated), then the JAX shard_map step of each mode (its first
    step: interpret mode takes ~10 s a step) and the plain run of each job
    in this process.  The draws of every step
    are the JAX shards' (``fold_in(key, step)``, then the shard index)."""
    jcfg = JaxConfig(compute_dtype="float32", N_rays=N, N_samples_c=SC,
                     N_samples_f=SF, iter_N=10, iter_warmup=2,
                     precrop_frac=0.5)
    params = np_nerf_params(3)
    step_key = jax.random.PRNGKey(jcfg.seed + 3)

    def shard_draws(key):
        draws = [_jax_uniforms(jax.random.fold_in(key, r), N // 2)
                 for r in range(2)]
        return [d[0] for d in draws], [d[1] for d in draws]

    # global batch: fold_in(key, step), then the shard index
    batches = np.stack([_batch(10 + i, N) for i in range(STEPS)])
    u_c, u_f = zip(*(shard_draws(jax.random.fold_in(step_key, i))
                     for i in range(STEPS)))
    # per image: the global pixel set from the first half of the split
    # key, the shard index folded into the second
    images, K, poses = make_synth_scene(n_views=2, H=32, W=32)
    views, precrop = [0, 1], [True, False]
    coords, ui_c, ui_f = [], [], []
    for i in range(STEPS):
        key_px, key_render = jax.random.split(jax.random.fold_in(step_key, i))
        coords.append(torch.from_numpy(np.array(jax_pixels(
            key_px, 32, 32, N, precrop=precrop[i],
            precrop_frac=jcfg.precrop_frac))).long())
        c, f = shard_draws(key_render)
        ui_c.append(c)
        ui_f.append(f)
    rng = np.random.default_rng(7)
    inputs = dict(
        state_dict=state_dict_from_jax_params(params),
        batches=torch.from_numpy(batches), u_c=list(u_c), u_f=list(u_f),
        images=torch.from_numpy(np.stack([images[v] for v in views])),
        poses=torch.from_numpy(np.stack(
            [poses[v][:3, :4] for v in views]).astype(np.float32)),
        K=torch.from_numpy(np.asarray(K, np.float32)),
        precrop=torch.tensor(precrop), coords=torch.stack(coords),
        ui_c=ui_c, ui_f=ui_f,
        uneven_batches=torch.from_numpy(
            np.stack([_batch(20 + i, N_UNEVEN) for i in range(STEPS)])),
        uneven_u_c=torch.from_numpy(
            rng.uniform(size=(STEPS, N_UNEVEN, SC)).astype(np.float32)),
        uneven_u_f=torch.from_numpy(
            rng.uniform(size=(STEPS, N_UNEVEN, SF)).astype(np.float32)))
    one = {**inputs,
           **{k: [[torch.cat(v[i])] for i in range(STEPS)]
              for k, v in (("u_c", u_c), ("u_f", u_f), ("ui_c", ui_c),
                           ("ui_f", ui_f))}}
    base = tmp_path_factory.mktemp("dp")
    jobs = ["global_step", "image_step", "uneven_step", "pool", "frames"]
    # one launch at a time: ranks that share the cores with another
    # launch's threads wait on each other's spinning
    two = _results(_start_worker(2, inputs, base / "w2", jobs))
    ones = _results(_start_worker(1, one, base / "w1", jobs[:3]))

    mesh = make_mesh(2, 1)
    bs = batch_sharding(mesh)
    jax_runs = {}
    for job, make in (("global_step", make_train_step_for_mesh),
                      ("image_step", make_image_train_step_for_mesh)):
        tx = jax_adam(jcfg)
        jp = to_jax(params)
        js = JaxState(jnp.zeros((), jnp.int32), jp, tx.init(jp))
        if job == "global_step":
            js, m = make(None, tx, jcfg, mesh)(
                js, *(jax.device_put(jnp.asarray(a), bs) for a in batches[0]),
                step_key)
        else:
            js, m = make(None, tx, jcfg, mesh, 32, 32, K)(
                js, jnp.asarray(images[views[0]]),
                jnp.asarray(poses[views[0]][:3, :4].astype(np.float32)),
                step_key, precrop=precrop[0])
        jax_runs[job] = ({k: float(v) for k, v in m.items()},
                         jax.device_get(js.params))
    # the plain run: this process, no group, the 1-rank inputs
    plain = {job: tdw.JOBS[job](one, 0) for job in jobs[:3]}
    return dict(jax=jax_runs, two=two, one=ones[0], plain=plain)


@pytest.mark.parametrize("job", ["global_step", "image_step"])
def test_two_ranks_match_the_jax_shard_map_step(dp, job):
    """The first step of each mode: 2 ranks of the port, each with its
    shard's draws, against the JAX package's shard_map step on 2
    devices."""
    want, jw = dp["jax"][job]
    got = dp["two"][0][job]
    for k in ("loss", "loss_c", "loss_f", "psnr", "psnr_c", "psnr_f"):
        assert got["metrics"][0][k] == pytest.approx(want[k], rel=1e-4), k
    ref = state_dict_from_jax_params(jw)
    for name, w in got["weights"][0].items():
        assert _rel(w.numpy(), ref[name].numpy()) <= 2e-3, name


@pytest.mark.parametrize("job", ["global_step", "image_step", "uneven_step"])
def test_two_ranks_equal_one_rank(dp, job):
    """The same global batch and draws: 2 ranks (each its part, the
    gradients summed by share) against one rank over all of it, in the
    uneven split too; the ranks hold the same weights bit for bit."""
    r0, r1 = (res[job] for res in dp["two"])
    ref = dp["plain"][job]
    for m, want in zip(r0["metrics"], ref["metrics"]):
        for k, v in want.items():
            assert m[k] == pytest.approx(v, rel=1e-6), k
    for name, w in r0["weights"][-1].items():
        assert torch.equal(w, r1["weights"][-1][name]), name
        g, want = r0["grads"][0][name], ref["grads"][0][name]
        assert _rel(g.numpy(), want.numpy()) <= 1e-6, name
        # Adam's first step moves a weight by about lr times the sign of
        # its gradient: a gradient at float32 noise moves it a full step
        # either way (measured up to 4.5e-5)
        assert _rel(w.numpy(), ref["weights"][-1][name].numpy()) <= 1e-4, \
            name


@pytest.mark.parametrize("job", ["global_step", "image_step", "uneven_step"])
def test_a_launch_of_one_rank_is_the_plain_run(dp, job):
    """A gloo group of one rank runs every collective of the step (which
    then copies): its metrics, gradients and weights are the plain run's
    bit for bit."""
    got, ref = dp["one"][job], dp["plain"][job]
    assert got["metrics"] == ref["metrics"]
    for a, b in zip(got["grads"] + got["weights"],
                    ref["grads"] + ref["weights"]):
        for name, t in a.items():
            assert torch.equal(t, b[name]), name


def test_ray_pool_is_rank_zeros_on_every_rank(dp):
    """Each rank seeded its pool's generator differently: the pool, its
    order after two reshuffles and the next batch are rank 0's."""
    r0, r1 = (res["pool"] for res in dp["two"])
    for k in ("built", "replayed", "batch"):
        assert torch.equal(r0[k], r1[k]), k
    gen = torch.Generator().manual_seed(101)         # rank 1's own
    images, K, poses = make_synth_scene(n_views=2, H=8, W=8)
    from nerf_pytorch_paeng_tpu_torch.train import build_ray_pool
    own = build_ray_pool(images, K, poses, np.arange(2), gen, "cpu")
    assert not torch.equal(own, r1["built"])


@pytest.mark.parametrize("cull", ["none", "auto"])
def test_two_rank_frames_equal_one_rank(dp, cull):
    """Dense and culled frames at perturb 0 with the coarse jitter on:
    each rank renders its part of every block, the parts are gathered."""
    r0, r1 = (res["frames"] for res in dp["two"])
    renderer, packed, pose = tdw.frame_setup(cull)
    want = renderer(packed, pose, torch.Generator().manual_seed(5))
    for a, b, ref in zip(r0[cull], r1[cull], want):
        assert torch.equal(a, b)
        assert a.shape == ref.shape
        assert float((a - ref).abs().max()) <= 1e-5
    if cull == "auto":
        st = r0["auto_stats"]
        assert st["n_act"] == renderer.stats[-1]["n_act"]
        assert st["blocks"] == renderer.stats[-1]["blocks"] >= 2
        assert st["gate_frac_coarse"] is not None


# ----------------------------------------------------------------- the CLI


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_scene")
    save_as_blender_dataset(str(root), n_train=2, n_val=1, n_test=1, H=32,
                            W=32)
    return str(root)


def _cli(scene, log_dir, *extra):
    return [sys.executable, "-m", "nerf_pytorch_paeng_tpu_torch", "--config",
            os.path.join(ROOT, "configs/blender/lego.txt"), "--device", "cpu",
            "--data_root", scene, "--exp_name", "dp", "--iter_N", "10",
            "--iter_warmup", "0", "--N_rays", "128", "--N_samples_c", "8",
            "--N_samples_f", "8", "--idx_print", "5", "--idx_save", "5",
            "--idx_vis", "5", "--idx_test", "0", "--idx_render", "0",
            *extra, *(["--log_dir", log_dir] if log_dir else [])]


@pytest.mark.parametrize("mode", ["per_image", "global"])
def test_two_rank_cli_trains_resumes_and_only_rank_zero_writes(
        scene, tmp_path, mode):
    """Ten steps on 2 ranks, each rank given its own log dir: rank 0's
    holds the checkpoints, metrics.csv and the extrinsics plots, rank 1's
    stays empty, and the run checked that both ranks ended with the same
    weights.  Then 5
    steps resumed from rank 0's step-5 checkpoint by 2 ranks sharing one
    log dir: the step-10 state equals the uninterrupted run's bit for
    bit."""
    mode_args = ["--global_batch", "true" if mode == "global" else "false"]
    logs = [str(tmp_path / f"rank{r}") for r in range(2)]
    outs = _launch(2, _cli(scene, None, *mode_args), ROOT,
                   per_rank=lambda r: ["--log_dir", logs[r]])
    assert ">> final weights bit-equal on all 2 ranks" in outs[0]
    assert "2 rank(s) over gloo" in outs[0] and outs[1].count(">>") == 0
    exp = os.path.join(logs[0], "dp")
    assert sorted(os.listdir(exp)) == ["_ext_vis", "dp_10.pth.tar",
                                       "dp_5.pth.tar", "metrics.csv"]
    assert not os.path.exists(logs[1])
    with open(os.path.join(exp, "metrics.csv")) as f:
        assert [row.split(",")[0] for row in f.read().split()[1:]] == \
            ["5", "10"]

    resumed = str(tmp_path / "resumed")
    os.makedirs(os.path.join(resumed, "dp"))
    shutil.copy(os.path.join(exp, "dp_5.pth.tar"),
                os.path.join(resumed, "dp", "dp_5.pth.tar"))
    _launch(2, _cli(scene, resumed, *mode_args, "--iter_start", "-1"), ROOT)
    a, b = (torch.load(os.path.join(d, "dp", "dp_10.pth.tar"),
                       weights_only=True) for d in (logs[0], resumed))
    assert a["idx"] == b["idx"] == 10
    for k, v in a["model_state_dict"].items():
        assert torch.equal(v, b["model_state_dict"][k]), k
    sa, sb = (c["optimizer_state_dict"]["state"] for c in (a, b))
    for k in sa:
        for m in sa[k]:
            assert torch.equal(sa[k][m], sb[k][m]), (k, m)


def test_two_rank_gated_training_decides_alike(scene, tmp_path):
    """Occupancy-gated training on 2 ranks from a checkpoint of the compact
    field: the policy's bounds and prediction are rank 0's, so both ranks
    gate their 128 rays alike (a rank that gated alone would bring a
    ``gate_frac`` the other lacks to the metric reduction); rank 0 alone
    writes ``precull_policy.csv``."""
    from nerf_pytorch_paeng_tpu_torch.models.nerf import NeRF
    from nerf_pytorch_paeng_tpu_torch.train import TrainState, make_optimizer
    from nerf_pytorch_paeng_tpu_torch.train.checkpoint import save_checkpoint
    from nerf_pytorch_paeng_tpu_torch.utils.synth import \
        compact_field_state_dict

    model = NeRF()
    model.load_state_dict(compact_field_state_dict(r=1.5))
    logs = [str(tmp_path / f"rank{r}") for r in range(2)]
    save_checkpoint(logs[0], "dp", TrainState(
        model, make_optimizer(model, NerfConfig()), 10))
    os.makedirs(os.path.join(logs[1], "dp"))
    shutil.copy(os.path.join(logs[0], "dp", "dp_10.pth.tar"),
                os.path.join(logs[1], "dp", "dp_10.pth.tar"))
    outs = _launch(2, _cli(scene, None, "--N_rays", "256", "--iter_start",
                           "10", "--iter_N", "20", "--idx_save", "0",
                           "--render_precull_grid", "16",
                           "--train_precull_every", "5",
                           "--train_precull_min_gate", "0"), ROOT,
                   per_rank=lambda r: ["--log_dir", logs[r]])
    assert ">> train_precull -> GATED" in outs[0]
    assert ">> final weights bit-equal on all 2 ranks" in outs[0]
    with open(os.path.join(logs[0], "dp", "precull_policy.csv")) as f:
        rows = [r.split(",") for r in f.read().split()[1:]]
    assert [r[0] for r in rows] == ["11", "16"] and rows[0][3] == "1"
    with open(os.path.join(logs[0], "dp", "metrics.csv")) as f:
        header, *lines = f.read().split()
    gate = header.split(",").index("gate_frac")
    assert all(0 <= float(line.split(",")[gate]) <= 1 for line in lines)
    assert sorted(os.listdir(os.path.join(logs[1], "dp"))) == ["dp_10.pth.tar"]


def test_two_rank_llff_cli_prepares_the_data_on_rank_zero(tmp_path):
    """A fresh LLFF capture at ``downsample 2`` on 2 ranks: rank 0 writes
    ``images_2/`` (``minify``) before the other rank loads, so both load
    the same 6 images, train 2 steps and end with the same weights."""
    root = str(tmp_path / "capture")
    save_as_llff_dataset(root, n_views=6, H=24, W=32, n_samples=16)
    logs = str(tmp_path / "logs")
    outs = _launch(2, [
        sys.executable, "-m", "nerf_pytorch_paeng_tpu_torch", "--config",
        os.path.join(ROOT, "configs/llff/fern.txt"), "--device", "cpu",
        "--data_root", root, "--downsample", "2", "--log_dir", logs,
        "--iter_N", "2", "--iter_warmup", "0", "--N_rays", "64",
        "--N_samples_c", "8", "--N_samples_f", "8", "--idx_print", "1",
        "--idx_save", "2", "--idx_test", "0", "--idx_render", "0"], ROOT)
    assert ">> final weights bit-equal on all 2 ranks" in outs[0]
    assert "images (6, 12, 16, 3)" in outs[0]
    assert len(os.listdir(os.path.join(root, "images_2"))) == 6
    assert os.path.isfile(os.path.join(logs, "llff_fern",
                                       "llff_fern_2.pth.tar"))


def test_a_failed_data_preparation_stops_every_rank(tmp_path):
    """Rank 0 cannot load the data root (no images, no poses): it raises
    its own error, and the rank waiting for it raises too in place of
    waiting."""
    procs = _start(2, [
        sys.executable, "-m", "nerf_pytorch_paeng_tpu_torch", "--config",
        os.path.join(ROOT, "configs/blender/lego.txt"), "--device", "cpu",
        "--data_root", str(tmp_path / "absent")], ROOT)
    outs = _wait(procs, ok=False)
    assert [p.returncode != 0 for p in procs] == [True, True], outs
    assert "rank 0 failed" not in outs[0]
    assert "RuntimeError: rank 0 failed" in outs[1], outs[1][-3000:]
