"""Architectures: the one place in the package that reads ``cfg.arch``.

``architecture(cfg)`` returns the module ``arch/<cfg.arch>.py``; the
names it accepts are ``NAMES`` (``config.validate`` checks the field
against them).  Each module names its architecture's pieces, whose code
keeps its home under ``models/``, ``ops/``, ``kernels/``, ``train/`` and
``eval/``; every module gives every name in ``MEMBERS``:

- ``fresh_model(cfg, device)``: the weights drawn from ``cfg.seed`` (for
  ``train/state.create_train_state``); ``empty_model(cfg)``: a model to
  load a checkpoint into (``driver.load_model``);
- ``make_optimizer(model, cfg)`` and ``schedule(cfg)`` -> ``lr(step)``
  (``train/state.make_optimizer``, ``train/schedule.schedule_from_cfg``);
- ``route_line(cfg)``: what the driver prints after ">> field route: ";
- ``frame_weights(model, cfg, device)``: what the frame renderers take
  from a model; ``make_frame_renderer(cfg, H, W, K, device, block_rays,
  **plain)`` (``eval/frame.make_frame_renderer``);
- ``step_kind(cfg, H, W, K, device, pool)``: the staged train step of
  either batch mode (``pool``: the global ray pool), a
  ``train/chunk.StepKind`` (``train/chunk.StagedSteps``);
- ``check_run(cfg, world)``: raises ``ValueError`` where the run cannot
  train on ``world`` processes;
- ``chunk_hook(cfg, K, extrinsics, hw, i_train, device, world)``: the
  train loop's work between chunks (``train/chunk.py``'s hook:
  ``before(i, model)``, ``next_boundary(i)``).

A module is imported at its first use, never with the package, so that
it may import what it names at its top.
"""
import importlib

NAMES = ("nerf", "ngp")
MEMBERS = ("fresh_model", "empty_model", "make_optimizer", "schedule",
           "route_line", "frame_weights", "make_frame_renderer", "step_kind",
           "check_run", "chunk_hook")


def architecture(cfg):
    """The module of ``cfg.arch``; ``ValueError`` for a name not in
    ``NAMES``."""
    name = cfg.arch
    if name not in NAMES:
        raise ValueError(f"invalid arch={name!r}")
    return importlib.import_module(f"{__name__}.{name}")
