"""The width-sharded (tensor-parallel) MLP of the port
(``nerf_pytorch_paeng_tpu_torch/parallel/tensor.py``, ``n_model_shards``)
on the CPU: its partition rule against the JAX package's
``param_partition_specs``, the forward, one step of 2 gloo ranks (1 data
x 2 model) and of 4 (2 x 2) in both batch modes against the JAX
package's GSPMD steps on ``make_mesh(1, 2)`` and ``make_mesh(2, 2)`` and
against the port's one-process step, a resume, the checkpoint through a
one-process model and the JAX package's converter, and the frames of the
gathered weights.

The ranks are processes started as ``tests/test_torch_parallel.py``
starts them (``tests/torch_dist_worker.py``, 120 s a rank).  The JAX
package's TP step is GSPMD, single-device semantics: the draws are the
whole batch's (``fold_in(key, step)``), and each data rank of the port
takes its rows of them.

Tolerances:
- the forward of 2 ranks against the full module: 1e-6 relative (float32
  sums split in two);
- against JAX (its ``tests/test_parallel.py:69-89``'s own): the loss to
  1e-5 relative, the weights after one Adam step to rtol 1e-2, atol
  2e-4 (a gradient at float32 noise flips its Adam step);
- against the port's one-process step on the same draws: the losses to
  1e-6 relative, the gradients to 1e-5 relative L2 (a fine pass whose
  depths a tie flip moves: 1e-5 and 5e-3, as named there); replicated
  weights bit-equal over the model group, every weight over the data
  group;
- resume, checkpoint round trip and the shard/gather of weights: bit for
  bit; frames of the gathered weights against one process: 1e-5.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from nerf_pytorch_paeng_tpu.config import NerfConfig as JaxConfig
from nerf_pytorch_paeng_tpu.models.nerf import NeRF as JaxNeRF
from nerf_pytorch_paeng_tpu.ops.rays import sample_pixels as jax_pixels
from nerf_pytorch_paeng_tpu.parallel import (batch_sharding, make_mesh,
                                             make_image_train_step_for_mesh,
                                             make_train_step_for_mesh,
                                             param_partition_specs,
                                             shard_params)
from nerf_pytorch_paeng_tpu.train.state import TrainState as JaxState
from nerf_pytorch_paeng_tpu.train.state import make_optimizer as jax_adam
from nerf_pytorch_paeng_tpu.utils.interop import \
    train_state_from_reference_checkpoint
from nerf_pytorch_paeng_tpu_torch import parallel
from nerf_pytorch_paeng_tpu_torch.config import NerfConfig
from nerf_pytorch_paeng_tpu_torch.models.nerf import NeRF
from nerf_pytorch_paeng_tpu_torch.parallel.tensor import (
    ShardedNeRF, gather_state_dict, layer_kind, mlp_kinds, partition_dims,
    shard_state_dict)
from nerf_pytorch_paeng_tpu_torch.train import (TrainState,
                                                create_train_state,
                                                make_optimizer)
from nerf_pytorch_paeng_tpu_torch.train import checkpoint as ckpt
from nerf_pytorch_paeng_tpu_torch.train.precull import train_precull_active
from nerf_pytorch_paeng_tpu_torch.train.schedule import schedule_from_cfg
from nerf_pytorch_paeng_tpu_torch.train.step import (make_image_train_step,
                                                     make_train_step,
                                                     step_route)
from nerf_pytorch_paeng_tpu_torch.utils.interop import (
    MODULE_PAIRS, layer_pairs, state_dict_from_jax_params)
from nerf_pytorch_paeng_tpu_torch.utils.synth import make_synth_scene

import torch_dist_worker as tdw
from test_torch_parallel import _rel, _results, _start_worker
from torch_port_util import np_nerf_params, to_jax

N, SC, SF, STEPS, HW = 64, 16, 16, 2, 16
SHAPES = {"tiny": dict(depth=4, width=64, L_x=6, L_d=2),
          "full": dict(depth=8, width=256, L_x=10, L_d=4)}


def _params(seed: int, shape: str) -> dict:
    return np_nerf_params(seed, **SHAPES[shape])


def _nerf(shape: str, params=None) -> NeRF:
    model = NeRF(**SHAPES[shape])
    if params is not None:
        model.load_state_dict(state_dict_from_jax_params(params))
    return model


# ------------------------------------------------------ the partition rule


def _jax_spec(kind: str, leaf: str):
    """The JAX package's spec of a port kind: kernels are [in, out]."""
    if kind == "col":
        return P(None, "model") if leaf == "kernel" else P("model")
    if kind == "row" and leaf == "kernel":
        return P("model", None)
    return P()


@pytest.mark.parametrize("shape,n", [("tiny", 2), ("full", 2), ("full", 3)])
def test_partition_rule_is_the_jax_packages(shape, n):
    """Every layer's kernel and bias spec equals JAX
    ``param_partition_specs``; at 3 ranks on 8x256 the layers that 3 does
    not divide fall back (to replicated, the colour head to column)."""
    params = _params(0, shape)
    specs = param_partition_specs(params, n)
    model = _nerf(shape)
    depth = SHAPES[shape]["depth"]
    for jax_mod, ref_mod in MODULE_PAIRS:
        kinds = mlp_kinds(model.get_submodule(ref_mod), n)
        for jax_layer, ref_layer in layer_pairs(depth):
            for leaf in ("kernel", "bias"):
                assert specs[jax_mod][jax_layer][leaf] == _jax_spec(
                    kinds[ref_layer], leaf), (jax_mod, jax_layer, leaf)
    kinds = mlp_kinds(model.model_coarse, n)
    if (shape, n) == ("full", 2):
        assert kinds["linear_x.5"] == "col"          # 319 inputs: falls back
        assert [kinds[f"linear_x.{i}"] for i in (0, 1, 6, 7)] == [
            "col", "row", "col", "row"]
    if n == 3:
        assert kinds["linear_color"] == "col"         # 3 outputs divide
        assert {k for k, v in kinds.items() if v != "rep"} == {"linear_color"}


def test_layer_kind_names_its_fallbacks():
    assert layer_kind("trunk_1", 256, 256, 2) == "row"
    assert layer_kind("trunk_5", 319, 256, 2) == "col"
    assert layer_kind("trunk_0", 63, 256, 3) == "rep"
    assert layer_kind("density", 256, 1, 3) == "rep"
    assert layer_kind("view", 283, 128, 2) == "col"
    assert layer_kind("trunk_1", 256, 256, 1) == "rep"


@pytest.mark.parametrize("shape,n", [("tiny", 2), ("full", 2), ("full", 3)])
def test_shard_and_gather_round_trip_bit_exact(shape, n):
    """The parts of every model index gather back to the full state dict
    bit for bit, and each ``ShardedNeRF`` holds exactly its index's parts
    as parameters (so Adam's moments are split too)."""
    model = _nerf(shape, _params(1, shape))
    full = model.state_dict()
    dims = partition_dims(model, n)
    parts = [shard_state_dict(full, dims, n, m) for m in range(n)]
    back = gather_state_dict(parts, dims)
    assert list(back) == list(full)
    for k, v in full.items():
        assert torch.equal(back[k], v), k
    for m in range(n):
        sharded = ShardedNeRF(model, parallel.Group(None, tuple(range(n)), m))
        got = sharded.state_dict()
        assert list(got) == list(full)
        for k, v in parts[m].items():
            assert torch.equal(got[k], v), k
        opt = make_optimizer(sharded, NerfConfig())
        assert [p.shape for g in opt.param_groups for p in g["params"]] == [
            v.shape for v in parts[m].values()]
        split = sum(p.numel() for p in sharded.parameters())
        assert split < sum(v.numel() for v in full.values()) or n == 3


def test_width_sharded_training_has_no_kernel_and_no_gate():
    """``n_model_shards > 1``: the step's route is plain inside the
    kernels' domain (the JAX package's ``force_xla``), and gated training
    is off (JAX ``train/precull.py:77-83``)."""
    cfg = NerfConfig(device="cpu", n_model_shards=2, train_precull="on",
                     render_precull_grid=16)
    assert step_route(cfg, 4096) == "plain"
    assert step_route(NerfConfig(device="cpu"), 4096) == "rays"
    assert not train_precull_active(cfg, 2)


# ------------------------------------------------------------ the ranks


def _draws(key, n):
    key_c, key_f = jax.random.split(key)
    return (torch.from_numpy(np.array(jax.random.uniform(key_c, (n, SC)))),
            torch.from_numpy(np.array(jax.random.uniform(key_f, (n, SF)))))


def _batch(seed: int, n: int):
    rng = np.random.default_rng(seed)
    o = np.array([0.0, 0.0, 4.0]) + rng.normal(0, 0.1, (n, 3))
    d = -o / 4.0 + rng.normal(0, 0.2, (n, 3))
    return np.stack([o, d, rng.uniform(0, 1, (n, 3))]).astype(np.float32)


def _jcfg():
    return JaxConfig(netDepth=4, netWidth=64, L_x=6, L_d=2,
                     compute_dtype="float32", N_rays=N, N_samples_c=SC,
                     N_samples_f=SF, iter_N=10, iter_warmup=2,
                     precrop_frac=0.5)


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    """The port's jobs at 2 ranks (1 x 2) and 4 ranks (2 x 2), one launch
    at a time; the JAX package's TP steps on both meshes; the port's
    one-process steps on the same draws, in this process."""
    jcfg = _jcfg()
    params = _params(3, "tiny")
    step_key = jax.random.PRNGKey(jcfg.seed + 3)
    batches = np.stack([_batch(40 + i, N) for i in range(STEPS)])
    u_c, u_f = zip(*(_draws(jax.random.fold_in(step_key, i), N)
                     for i in range(STEPS)))
    images, K, poses = make_synth_scene(n_views=2, H=HW, W=HW)
    views, precrop = [0, 1], [True, False]
    coords, ui_c, ui_f = [], [], []
    for i in range(STEPS):
        key_px, key_render = jax.random.split(jax.random.fold_in(step_key, i))
        coords.append(torch.from_numpy(np.array(jax_pixels(
            key_px, HW, HW, N, precrop=precrop[i],
            precrop_frac=jcfg.precrop_frac))).long())
        c, f = _draws(key_render, N)
        ui_c.append(c)
        ui_f.append(f)
    rng = np.random.default_rng(5)
    inputs = dict(
        tp_sd=state_dict_from_jax_params(params),
        tp_x=torch.from_numpy(rng.normal(size=(300, 39 + 15)).astype(
            np.float32)),
        tp_batches=torch.from_numpy(batches), tp_u_c=torch.stack(u_c),
        tp_u_f=torch.stack(u_f),
        images=torch.from_numpy(np.stack([images[v] for v in views])),
        poses=torch.from_numpy(np.stack(
            [poses[v][:3, :4] for v in views]).astype(np.float32)),
        K=torch.from_numpy(np.asarray(K, np.float32)),
        precrop=torch.tensor(precrop), tp_coords=torch.stack(coords),
        tp_ui_c=torch.stack(ui_c), tp_ui_f=torch.stack(ui_f),
        rs_sd=state_dict_from_jax_params(_params(4, "full")),
        rs_batches=torch.from_numpy(np.stack([_batch(50 + i, 32)
                                              for i in range(2)])))
    base = tmp_path_factory.mktemp("tp")
    two = _results(_start_worker(2, inputs, base / "w2", [
        "tp_forward", "tp_steps", "tp_drawn", "tp_resume", "tp_frames"]))
    four = _results(_start_worker(4, inputs, base / "w4",
                                  ["tp_steps", "tp_drawn"]))

    jax_runs = {}
    model = JaxNeRF(depth=4, width=64, L_x=6, L_d=2,
                    compute_dtype=jnp.float32)
    for n_data in (1, 2):
        mesh = make_mesh(n_data, 2)
        bs = batch_sharding(mesh)
        for mode, make in (("global", make_train_step_for_mesh),
                           ("image", make_image_train_step_for_mesh)):
            tx = jax_adam(jcfg)
            jp = shard_params(to_jax(params), mesh, 2)
            js = JaxState(jnp.zeros((), jnp.int32), jp, jax.jit(tx.init)(jp))
            if mode == "global":
                js, m = make(model, tx, jcfg, mesh)(
                    js, *(jax.device_put(jnp.asarray(a), bs)
                          for a in batches[0]), step_key)
            else:
                js, m = make(model, tx, jcfg, mesh, HW, HW, K)(
                    js, jnp.asarray(images[views[0]]),
                    jnp.asarray(poses[views[0]][:3, :4].astype(np.float32)),
                    step_key, precrop=precrop[0])
            jax_runs[(n_data, mode)] = ({k: float(v) for k, v in m.items()},
                                        jax.device_get(js.params))

    cfg = NerfConfig(device="cpu", N_rays=N, **tdw.TINY,
                     **{k: v for k, v in tdw.TP_KW.items()
                        if k not in tdw.TINY and k != "n_model_shards"})
    one = {}
    for mode in ("global", "image"):
        model1 = _nerf("tiny", params)
        state = TrainState(model1, make_optimizer(model1, cfg), 0)
        if mode == "global":
            step = make_train_step(cfg, schedule_from_cfg(cfg))
            args = lambda i: dict(  # noqa: E731
                rays_o=inputs["tp_batches"][i][0],
                rays_d=inputs["tp_batches"][i][1],
                target=inputs["tp_batches"][i][2], u_c=u_c[i], u_f=u_f[i])
        else:
            step = make_image_train_step(cfg, schedule_from_cfg(cfg), HW, HW,
                                         inputs["K"].numpy())
            args = lambda i: dict(  # noqa: E731
                image=inputs["images"][i], pose=inputs["poses"][i],
                precrop=precrop[i], coords=coords[i], u_c=ui_c[i],
                u_f=ui_f[i])
        one[mode] = tdw._steps(state, step, STEPS, args)
    model1 = _nerf("tiny", params)
    state = TrainState(model1, make_optimizer(model1, cfg), 0)
    one["drawn"] = tdw._steps(state, make_train_step(
        cfg, schedule_from_cfg(cfg)), STEPS, lambda i: dict(
            rays_o=inputs["tp_batches"][i][0],
            rays_d=inputs["tp_batches"][i][1],
            target=inputs["tp_batches"][i][2]))
    return dict(two=two, four=four, jax=jax_runs, one=one, inputs=inputs,
                params=params)


def test_width_sharded_forward_equals_the_full_module(tp):
    """The sharded coarse module on 2 ranks: its output and the gradient
    of its input against the full module's, alike on both ranks."""
    model = _nerf("tiny", tp["params"])
    x = tp["inputs"]["tp_x"].clone().requires_grad_(True)
    want = model.model_coarse(x)
    (want ** 2).sum().backward()
    r0, r1 = (res["tp_forward"] for res in tp["two"])
    assert torch.equal(r0["out"], r1["out"])
    assert _rel(r0["out"].numpy(), want.detach().numpy()) <= 1e-6
    assert _rel(r0["dx"].numpy(), x.grad.numpy()) <= 1e-6
    assert r0["shapes"]["model_coarse.linear_x.0.weight"] == (32, 39)
    assert r0["shapes"]["model_coarse.linear_x.1.weight"] == (64, 32)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("mode", ["global", "image"])
def test_width_sharded_step_matches_the_jax_tp_step(tp, world, mode):
    """The first step on ``world`` ranks (n_data x 2) against the JAX
    package's GSPMD step on ``make_mesh(n_data, 2)`` with the same whole
    batch's draws."""
    want, jw = tp["jax"][(world // 2, mode)]
    got = tp["two" if world == 2 else "four"][0]["tp_steps"][mode]
    for k in ("loss", "loss_c", "loss_f", "psnr"):
        assert got["metrics"][0][k] == pytest.approx(want[k], rel=1e-5), k
    ref = state_dict_from_jax_params(jw)
    for name, w in got["weights"][0].items():
        np.testing.assert_allclose(w.numpy(), ref[name].numpy(), rtol=1e-2,
                                   atol=2e-4, err_msg=name)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("mode", ["global", "image"])
def test_width_sharded_step_equals_one_process(tp, world, mode):
    """The first step on ``world`` ranks against the port's one-process
    step on the same draws: losses to 1e-6 relative, full gradients to
    1e-5, and the weights after it to 1e-4 relative L2 (Adam's first step
    moves a weight whose gradient is at float32 noise by a full step
    either way); after both steps the replicated weights alike over each
    model group, every weight over the data group.

    The global batch's fine pass is held as the repo holds fine outputs
    (ROADMAP §3, inverse-CDF tie flips): the sharded coarse weights differ
    from one process's by 1.2e-7, which moves one of its 2048 fine depths
    by 1.8e-3 (checked apart on these inputs), so its fine loss is held to
    1e-5 (the JAX package's own TP tolerance) and the fine module's
    gradients to 5e-3 (measured 1.75e-6 and 1.3e-3).  The coarse pass,
    and the image batch's both passes, stay strict."""
    ranks = [res["tp_steps"][mode] for res in
             tp["two" if world == 2 else "four"]]
    ref = tp["one"][mode]
    flips = mode == "global"
    for k, v in ref["metrics"][0].items():
        rel = 1e-5 if flips and not k.endswith("_c") else 1e-6
        assert ranks[0]["metrics"][0][k] == pytest.approx(v, rel=rel), k
    for name, g in ranks[0]["grads"][0].items():
        tol = 5e-3 if flips and name.startswith("model_fine") else 1e-5
        assert _rel(g.numpy(), ref["grads"][0][name].numpy()) <= tol, name
        w, want = ranks[0]["weights"][0][name], ref["weights"][0][name]
        assert _rel(w.numpy(), want.numpy()) <= 1e-4, name
    for a, b in zip(ranks[0]["replicated"][-1], ranks[1]["replicated"][-1]):
        assert torch.equal(a, b)
    for other in ranks[1:]:
        for name, w in ranks[0]["weights"][-1].items():
            assert torch.equal(w, other["weights"][-1][name]), name


def test_two_data_ranks_take_rows_of_the_whole_batchs_draws(tp):
    """A step that draws for itself: at 2 data ranks x 2 the draws are
    the one-process step's for the whole batch, each data rank its rows
    (GSPMD semantics), so the first step's losses are the one process's
    (the fine losses as in ``test_width_sharded_step_equals_one_process``).
    """
    ref = tp["one"]["drawn"]["metrics"][0]
    for world in ("two", "four"):
        got = tp[world][0]["tp_drawn"]["metrics"][0]
        for k, v in ref.items():
            rel = 1e-6 if k.endswith("_c") else 1e-5
            assert got[k] == pytest.approx(v, rel=rel), (world, k)


def test_width_sharded_resume_is_bit_exact(tp):
    """2 + 2 steps through a checkpoint equal 4 straight steps, weights
    and Adam's moments, bit for bit (the reference MLP at 2 ranks)."""
    r0 = tp["two"][0]["tp_resume"]
    assert r0["step"] == 4
    (sa, oa), (sb, ob) = r0["straight"], r0["resumed"]
    for k, v in sa.items():
        assert torch.equal(v, sb[k]), k
    for i, entry in oa["state"].items():
        for m in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(entry[m], ob["state"][i][m]), (i, m)


def test_width_sharded_checkpoint_is_the_reference_format(tp):
    """The file rank 0 wrote is the full-width one: a one-process model
    and optimizer restore it equal to the gathered state, and the JAX
    package's ``train_state_from_reference_checkpoint`` reads it."""
    res = tp["two"][0]["tp_resume"]
    want_sd, want_opt = res["at_save"]
    cfg = NerfConfig(device="cpu", N_rays=32, compute_dtype="float32",
                     **{k: v for k, v in tdw.RESUME_KW.items()})
    state = create_train_state(cfg, "cpu")
    path = res["path"]
    ckpt.restore_checkpoint(os.path.dirname(os.path.dirname(path)), "tp", 2,
                            state)
    assert state.step == 2
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, want_sd[k]), k
    got_opt = state.optimizer.state_dict()["state"]
    for i, entry in want_opt["state"].items():
        for m in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(got_opt[i][m], entry[m]), (i, m)
    raw = torch.load(path, weights_only=True)

    def numpy(tree):
        if isinstance(tree, dict):
            return {k: numpy(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [numpy(v) for v in tree]
        return tree.numpy() if isinstance(tree, torch.Tensor) else tree
    jstate = train_state_from_reference_checkpoint(numpy(raw), JaxConfig(
        compute_dtype="float32", N_rays=32, N_samples_c=8, N_samples_f=8))
    assert int(jstate.step) == 2
    back = state_dict_from_jax_params(jax.device_get(jstate.params))
    for k, v in want_sd.items():
        assert torch.equal(back[k], v), k


@pytest.mark.parametrize("cull", ["none", "auto"])
def test_width_sharded_frames_equal_one_process(tp, cull):
    """The dense and culled frames of the gathered weights, the rays split
    over both ranks, at ``perturb 0``: within 1e-5 of one process."""
    renderer, packed, pose = tdw.frame_setup(cull)
    want = renderer(packed, pose, torch.Generator().manual_seed(5))
    r0, r1 = (res["tp_frames"][cull] for res in tp["two"])
    for a, b, ref in zip(r0, r1, want):
        assert torch.equal(a, b)
        assert float((a - ref).abs().max()) <= 1e-5
