"""Config system: dataclass + loader for the reference ``key = value`` files.

Own copy of the JAX package's parser (``nerf_pytorch_paeng_tpu/config.py``):
the same dialect (inline ``#`` comments, bare action flags such as
``bkg_white_true``, bracketed lists) and every option under the same name,
so one config file drives both packages.  Of the JAX package's additions it
keeps those the ported slices read (``seed``, ``eval_only``, ``render_only``,
``compute_dtype``, ``log_dir``, ``lpips_weights``, ``use_pallas``,
``use_rays_train``, the seven knobs of the culled frame renderer,
``render_cull`` ... ``render_gate_fine``, the five of occupancy-gated
training, ``train_precull`` ... ``train_precull_backoff_max``, and the
three of the device mesh, ``n_data_shards``, ``n_model_shards`` and
``sp_shards``) and adds one knob, ``device``.  ``use_pallas`` keeps the
JAX package's name, default and parsing; here it means "run the
hand-written CUDA kernels where the architecture allows" (off: the
plain-MLP route, ``ops/render.py``).  Of the mesh knobs only data
parallelism is ported (``parallel/``): ``n_model_shards > 1`` and
``sp_shards > 1`` raise, and a set ``n_data_shards`` must equal the
launch's world size (``parallel.check_data_shards``).  The JAX package's
other TPU knobs (``scan_chunk``, ``profile``, ``check_nans``,
``compile_cache``) are not fields here: a config file or command line
that sets one fails instead of being ignored.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import re
from dataclasses import dataclass, field
from typing import List, Optional

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

    # ====== Additions of the JAX package that this slice reads
    seed: int = 0
    eval_only: bool = False       # load ckpt at testing_idx, run test, exit
    render_only: bool = False
    compute_dtype: str = "bfloat16"
    log_dir: str = ""             # defaults to <repo>/logs
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

    # ====== The device mesh (the JAX package's names and defaults): data
    # parallelism over the ranks of a torchrun launch (parallel/); 0 = every
    # rank of the launch, else it must equal the launch's world size.  The
    # width-sharded and sample-sharded paths are not ported (ROADMAP §1):
    # n_model_shards > 1 and sp_shards > 1 raise.
    n_data_shards: int = 0
    n_model_shards: int = 1
    sp_shards: int = 0

    # ====== Port only: where tensors live ("cuda", "cuda:N" or "cpu")
    device: str = "cuda"

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
        for name in ("n_model_shards", "sp_shards"):
            if getattr(self, name) > 1:
                raise ValueError(
                    f"{name}={getattr(self, name)}: the width-sharded and "
                    "sample-sharded paths are not ported to PyTorch yet "
                    "(ROADMAP §1, item 4); data parallelism runs over the "
                    "ranks of a torchrun launch (n_data_shards)")
        return self


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
