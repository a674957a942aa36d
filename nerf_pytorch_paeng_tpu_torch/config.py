"""Config system: dataclass + loader for the reference ``key = value`` files.

Own copy of the JAX package's parser (``nerf_pytorch_paeng_tpu/config.py``):
the same dialect (inline ``#`` comments, bare action flags such as
``bkg_white_true``, bracketed lists) and every option of the JAX package's
``NerfConfig`` under the same name, with the same default and parsing, so
one config file or command line drives both packages.  It adds the knob
``device`` and the architecture's keys (``arch`` and the ``ngp_*`` keys of
Instant-NGP; ``PORT_ONLY`` names them all).  ``use_pallas`` means "run
the hand-written CUDA kernels where the architecture allows" (off: the
plain-MLP route, ``ops/render.py``).
The mesh knobs lay the launch's ranks out as ``n_data`` x ``n_model``
(``parallel.check_data_shards``: the product must be the world size);
``sp_shards > 1`` needs ``n_model_shards == sp_shards`` and sample counts
it divides, checked here before any rank starts.

The JAX package's four run knobs, as the port reads them:

- ``scan_chunk`` (16): up to this many consecutive train steps run as one
  chunk (``train/chunk.py``): on the card each step of a full-length chunk
  replays a CUDA graph of the staged step, with the step's draws, batch
  and learning rate copied into the graph's static buffers between
  replays; hooks fall on a chunk's last step, and the trajectory is the
  single steps' bit for bit.  ``--scan_chunk 1`` turns graphs off.  Under
  a gloo process group or ``n_model_shards > 1`` chunks have length 1.
- ``profile`` (false): ``torch.profiler`` traces steps ``iter_start + 10``
  to ``iter_start + 14`` into a Chrome trace under ``logs/<exp>/profile/``.
  The trace carries the program's spans (``utils/spans.py``), annotated
  only while a profiler runs: ``nerf/chunk``, ``nerf/step.stage``,
  ``nerf/step.launch``, ``nerf/policy.refresh``, ``nerf/pool.reshuffle``,
  the frame renderers' ``nerf/frame``, ``nerf/frame.phase0``,
  ``nerf/frame.read_hits``, ``nerf/frame.phase1``, ``nerf/frame.read``,
  ``nerf/frame.phase2``, the render loop's ``nerf/pipeline.issue`` and
  ``nerf/pipeline.drain``, Instant-NGP's ``nerf/ngp.march``,
  ``nerf/ngp.encode``, ``nerf/ngp.mlp``, ``nerf/ngp.composite`` and
  ``nerf/ngp.grid_update``, and the set-up spans (``nerf/`` and
  ``setup.kernels``, ``setup.pack``, ``setup.support_grid``,
  ``setup.pool``, ``setup.state``, ``chunk.capture``, ``data.load``,
  ``checkpoint.save``).
- ``check_nans`` (false): a step whose loss, gradients or updated weights
  are not finite raises ``FloatingPointError`` naming it (read once a
  chunk); off, no check runs.
- ``compile_cache`` ("auto"): the directory of the ``nvcc`` builds of the
  kernels (``kernels/build.py``): "auto" ``<repo>/build/kernels``, "off" a
  fresh temporary directory for the process, anything else that
  directory.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import re
from dataclasses import dataclass, field
from typing import List, Optional

from .arch import NAMES as ARCHITECTURES

LOG_DIR = os.path.normpath(os.path.join(
    os.path.abspath(os.path.dirname(os.path.realpath(__file__))), os.pardir,
    "logs"))

# Bare flag -> (dest, value); the reference's store_true/store_false args.
_FLAG_ACTIONS = {
    "bkg_white_true": ("bkg_white", True),
    "colmap_relaunch_true": ("colmap_relaunch", True),
    "global_batch_false": ("global_batch", False),
    "mode_test_false": ("mode_test", False),
    "mode_render_false": ("mode_render", False),
}

@dataclass
class NerfConfig:
    # == Visualization / devices (kept for config-file compatibility)
    visdom: bool = False
    visdom_port: int = 8900
    gpu_ids: List[int] = field(default_factory=lambda: [0])

    # ====== Dataset
    data_type: str = "blender"    # [blender, llff, custom]
    data_name: str = ""
    data_root: str = ""
    downsample: int = 0           # 0 disables downsampling
    near: float = 2.0
    far: float = 6.0
    bkg_white: bool = False
    colmap_relaunch: bool = False
    precrop_iters: int = 0
    precrop_frac: float = 0.5
    video_batch: int = 30

    # ====== Model
    L_x: int = 10
    L_d: int = 4
    netDepth: int = 8
    netWidth: int = 256

    # ====== Training
    exp_name: str = "exp"
    lr: float = 5e-4
    lr_min: float = 5e-5
    iter_warmup: int = 10000
    iter_N: int = 200000
    iter_start: int = 0

    # ====== Batch
    global_batch: bool = True
    N_rays: int = 4096
    N_samples_c: int = 64
    N_samples_f: int = 128
    # frame-renderer ray block (0 = the renderer's default block)
    chunk_rays: int = 0
    chunk_pts: int = 262144
    perturb: float = 1.0

    # ====== Testing
    mode_test: bool = True
    testskip: int = 8

    # ====== Rendering
    mode_render: bool = True
    render_type: str = "gif"      # mp4 | gif
    n_angle: int = 120
    single_angle: float = -1.0
    phi: float = -30.0
    nf: float = 4.0
    testing_idx: int = 0

    # ====== Periodic indices
    idx_vis: int = 100
    idx_print: int = 1000
    idx_save: int = 100000
    idx_test: int = 200000
    idx_render: int = 200000
    idx_vis_cam_param: int = 1000

    # ====== Additions of the JAX package
    seed: int = 0
    eval_only: bool = False       # load ckpt at testing_idx, run test, exit
    render_only: bool = False
    compute_dtype: str = "bfloat16"
    log_dir: str = ""             # defaults to <repo>/logs
    # where the kernels' nvcc builds go: "auto" <repo>/build/kernels, "off"
    # a fresh temporary directory for the process, else that directory
    compile_cache: str = "auto"
    # consecutive train steps run as one chunk: on the card a CUDA graph of
    # the staged step replayed once a step (train/chunk.py); 1 turns it off
    scan_chunk: int = 16
    profile: bool = False         # torch.profiler trace of a few steps
    check_nans: bool = False      # raise at the first non-finite step
    lpips_weights: str = ""       # VGG16 weights .npz for LPIPS ("" = nan)
    # the fused CUDA kernels for the reference architecture (8x256,
    # 1<=L_x<=10, 1<=L_d<=4); off, or for other architectures, the plain
    # MLP (NeRFMLP.forward under autograd) renders and trains
    use_pallas: bool = True
    # train on the ray-major kernel pair (K1/K2, positions built in the
    # kernel) where its shapes apply; off, or for other shapes, on the
    # plane pair (K8/K9)
    use_rays_train: bool = True

    # ====== The culled frame renderer (eval/frame.py; the JAX package's
    # config.py documents each).  "auto" renders through the
    # occupancy-culled two-phase renderer, "none" densely.
    render_cull: str = "auto"
    render_cull_tau: float = 1e-3
    render_trunc_eps: float = 1e-3
    # support-bound pre-cull of the coarse pass (K4, grids by K7): "auto"
    # = where the gated kernels apply; grid 0 = auto (128 on CUDA, off on
    # the CPU); half-side 0 = far
    render_precull: str = "auto"
    render_precull_grid: int = 0
    render_precull_halfside: float = 0.0
    # fine-pass row gating by the fine module's own support bounds (K5)
    render_gate_fine: str = "auto"

    # ====== Occupancy-gated training (train/precull.py; the JAX package's
    # config.py documents each).  "auto" gates where the policy says it
    # pays; the support bounds are refreshed every train_precull_every
    # steps; tile 0 = auto (512 at 4096 rays); below min_gate predicted
    # skipped share the step runs ungated; declined refreshes back off up
    # to every * backoff_max.
    train_precull: str = "auto"
    train_precull_every: int = 256
    train_precull_tile: int = 0
    train_precull_min_gate: float = 0.15
    train_precull_backoff_max: int = 8

    # ====== The device mesh (the JAX package's names and defaults) over the
    # ranks of a torchrun launch (parallel/): n_data_shards x n_model_shards
    # ranks (n_data_shards 0 = world // n_model_shards).  n_model_shards > 1
    # shards the MLP's width over the model group in training (the plain
    # route, as the JAX package forces its XLA route there); sp_shards > 1
    # shards each ray's samples over the model group in the frame renderer
    # (K8 on each rank's slice) and needs n_model_shards == sp_shards.
    n_data_shards: int = 0
    n_model_shards: int = 1
    sp_shards: int = 0

    # ====== Port only: where tensors live ("cuda", "cuda:N" or "cpu")
    device: str = "cuda"

    # ====== Port only: the architecture.  "nerf" the coarse and fine MLPs
    # above; "ngp" Instant-NGP's NeRF (models/ngp.py, whose constants hold
    # the rest of its published settings): a multiresolution hash encoding
    # of ngp_levels levels (tables of 2^ngp_log2_table entries), points
    # kept where the ngp_grid_res^3 occupancy grid says, at most ngp_budget
    # samples a step.  The sizes the tests shrink; NGP trains on the
    # global ray pool, in one process.
    arch: str = "nerf"
    ngp_levels: int = 16
    ngp_log2_table: int = 19
    ngp_budget: int = 262144
    ngp_grid_res: int = 128

    @property
    def logdir(self) -> str:
        return self.log_dir or LOG_DIR

    def validate(self) -> "NerfConfig":
        """The JAX package's checks on the fields kept here, plus ``device``;
        raises ValueError."""
        tri_state = ("auto", "on", "off", "true", "false", "t", "f", "yes",
                     "no", "y", "n", "0", "1")
        checks = (
            ("data_type", self.data_type in ("blender", "llff", "custom")),
            ("render_type", self.render_type in ("gif", "mp4")),
            ("compute_dtype", self.compute_dtype in ("bfloat16", "float32")),
            ("N_samples_c", self.N_samples_c > 0),
            ("iter_warmup", self.iter_warmup < self.iter_N + 1),
            ("device", self.device == "cpu" or self.device.startswith("cuda")),
            ("n_data_shards", self.n_data_shards >= 0),
            ("n_model_shards", self.n_model_shards >= 1),
            ("render_cull", self.render_cull in ("auto", "none")),
            ("render_precull", str(self.render_precull).lower() in tri_state),
            ("render_gate_fine",
             str(self.render_gate_fine).lower() in tri_state),
            ("train_precull", str(self.train_precull).lower() in tri_state),
            ("train_precull_tile", self.train_precull_tile >= 0
             and self.train_precull_tile % 128 == 0),
        )
        for name, ok in checks:
            if not ok:
                raise ValueError(f"invalid {name}={getattr(self, name)!r}")
        if self.arch not in ARCHITECTURES:
            raise ValueError(f"invalid arch={self.arch!r}")
        if self.arch == "ngp":
            self._validate_ngp()
        n_sp = int(self.sp_shards)
        if n_sp > 1:
            # the JAX package's sample-sharded frame renderer's asserts
            # (eval/frame.py:698-703), here before any rank starts
            if self.n_model_shards != n_sp:
                raise ValueError(
                    f"sp_shards={n_sp} needs n_model_shards == sp_shards "
                    f"(got n_model_shards={self.n_model_shards}): the "
                    "samples split over the model group")
            if self.N_samples_c % n_sp:
                raise ValueError(
                    f"sp_shards={n_sp} must divide N_samples_c="
                    f"{self.N_samples_c}")
            if (self.N_samples_c + self.N_samples_f) % n_sp:
                raise ValueError(
                    f"sp_shards={n_sp} must divide N_samples_c + N_samples_f"
                    f" = {self.N_samples_c + self.N_samples_f}")
        return self

    def _validate_ngp(self) -> None:
        """The NGP keys: what the hash and marching kernels take."""
        checks = (
            ("ngp_levels", 1 <= self.ngp_levels <= 16),
            ("ngp_log2_table", 4 <= self.ngp_log2_table <= 24),
            ("ngp_budget", 1 <= self.ngp_budget < 2 ** 31),
            ("ngp_grid_res", 1 <= self.ngp_grid_res <= 1024),
            ("global_batch", self.global_batch),
            ("n_model_shards", self.n_model_shards == 1),
            ("sp_shards", self.sp_shards <= 1),
            ("data_type", self.data_type == "blender"),
        )
        for name, ok in checks:
            if not ok:
                raise ValueError(f"invalid {name}={getattr(self, name)!r} "
                                 "for arch ngp")


# the port's own fields: the JAX package's NerfConfig has none of them
PORT_ONLY = tuple(f.name for f in dataclasses.fields(NerfConfig)
                  if f.name in ("device", "arch") or f.name.startswith("ngp_"))

_FIELDS = {f.name: f for f in dataclasses.fields(NerfConfig)}


def _coerce_bool(raw: str) -> bool:
    return raw.strip().lower() in ("yes", "true", "t", "y", "1")


def _coerce(name: str, raw: str):
    """Coerce a raw config-file string to the dataclass field's type."""
    f = _FIELDS[name]
    raw = raw.strip()
    if f.type in ("int", int):
        return int(float(raw))
    if f.type in ("float", float):
        return float(raw)
    if f.type in ("bool", bool):
        return _coerce_bool(raw)
    if name == "gpu_ids":
        return [int(x) for x in re.findall(r"-?\d+", raw)]
    return raw


def parse_config_file(path: str) -> dict:
    """Parse a reference-style ``key = value`` config text file."""
    out = {}
    with open(path) as fp:
        for line in fp:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            if "=" in line:
                key, val = line.split("=", 1)
                key = key.strip()
                if key in _FLAG_ACTIONS:  # e.g. `bkg_white_true = true`
                    dest, value = _FLAG_ACTIONS[key]
                    out[dest] = value if _coerce_bool(val) else not value
                elif key in _FIELDS:
                    out[key] = _coerce(key, val)
                else:
                    raise KeyError(f"unknown config key {key!r} in {path}")
            elif line in _FLAG_ACTIONS:
                dest, value = _FLAG_ACTIONS[line]
                out[dest] = value
            else:
                raise KeyError(f"unknown bare flag {line!r} in {path}")
    return out


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="NeRF in PyTorch/CUDA (nerf_pytorch_paeng_tpu_torch)")
    p.add_argument("--config", type=str, default=None, help="config file path")
    for f in dataclasses.fields(NerfConfig):
        if f.type in ("bool", bool):
            p.add_argument(f"--{f.name}", type=str, default=None,
                           help=f"bool (default {f.default})")
        elif f.name == "gpu_ids":
            p.add_argument("--gpu_ids", nargs="+", default=None)
        else:
            typ = int if f.type in ("int", int) else (
                float if f.type in ("float", float) else str)
            p.add_argument(f"--{f.name}", type=typ, default=None)
    for flag in _FLAG_ACTIONS:
        p.add_argument(f"--{flag}", dest=f"__flag_{flag}", action="store_true")
    return p


def load_config(argv: Optional[List[str]] = None) -> NerfConfig:
    """CLI entry: precedence CLI > config file > dataclass defaults."""
    ns = build_arg_parser().parse_args(argv)
    values: dict = {}
    if ns.config:
        values.update(parse_config_file(ns.config))
    for f in dataclasses.fields(NerfConfig):
        raw = getattr(ns, f.name, None)
        if raw is None:
            continue
        if f.type in ("bool", bool):
            values[f.name] = _coerce_bool(raw)
        elif f.name == "gpu_ids":
            values[f.name] = [int(x) for x in raw]
        else:
            values[f.name] = raw
    for flag, (dest, value) in _FLAG_ACTIONS.items():
        if getattr(ns, f"__flag_{flag}", False):
            values[dest] = value
    return NerfConfig(**values).validate()


def config_from_file(path: str, **overrides) -> NerfConfig:
    values = parse_config_file(path)
    values.update(overrides)
    return NerfConfig(**values).validate()
