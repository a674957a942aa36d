"""Architectures: what a cell runs, apart from how it is measured.

A configuration (``configs/<name>.json``) names its architecture by the
key ``"arch"``; without it the architecture is ``nerf``.  The name
resolves by import to ``arch/<name>.py``, so an architecture's cells come
in as new files: its module, its configuration, its reference
(``reference/<name>.py``), its workload files and its metric readers.

A kind (``harness/<kind>.py``) lists in ``ARCH_NEEDS`` the names it takes
from the module:

- ``train``: ``train_weights(cfg, generator, device)`` -> the fresh
  weights; ``TrainLoop(cfg, scene, sd, device, probe)``, the program's
  train loop (``chunk()`` -> (steps, slab, items), ``loss_col``,
  ``replays``, ``gated``, ``close()``), whose learning-rate schedule it
  hands to ``probe(schedule, state)`` and keeps as ``schedule``;
  ``first_items(cfg, scene)`` -> the images or pool offsets of the first
  three steps; ``reference_steps(sd, scene, cfg, items, device, rnd,
  keep=0)``; ``train_counts(cfg)`` -> the record's counts;
- ``render``: ``render_field(field, generator, device, cfg)``;
  ``frame_renderer(cfg, hw, K, sd, device)`` -> (renderer, field), the
  renderer called as ``renderer(field, pose, generator)`` -> (rgb, disp);
  ``reference_frame(sd, cfg, K, hw, c2w, seeds, device, rnd)`` -> (rgb,
  the count of rays the renderer has to render); ``render_counts(cfg)``;
- both: ``ROUND_CONTROL``, the reference's operand rounding one step below
  the configuration's precision (the control), and ``ROUND_OWN``, at the
  configuration's own (a witness of what rounding alone does).

The reference functions set the reference's own precision themselves
(float32 with TF32 off); their ``rnd`` rounds the products' operands
(None: none).
"""
import importlib

DEFAULT = "nerf"


def load(name: str):
    """``arch/<name>.py``, or a module already registered under its
    import name."""
    if not name.isidentifier():
        raise ValueError(f"architecture {name!r} is not a module name")
    return importlib.import_module(f"{__name__}.{name}")


def of(config: dict):
    """The architecture module of a configuration file's contents."""
    return load(config.get("arch", DEFAULT))
