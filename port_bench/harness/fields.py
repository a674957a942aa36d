"""The weights the cells run, made on the card from the seed.

Both are state dicts in the reference ``model_state_dict`` naming
(``model_coarse.linear_x.0.weight``, ...), which the program loads with
``NeRF.load_state_dict`` and the reference reads as they are.

- ``init_state_dict``: a fresh initialisation, Xavier-uniform weights and
  U(+-1/sqrt(fan_in)) biases (the distribution of the program's
  ``NeRFMLP.reset_parameters``), from one draw of a generator on the card.
- ``ball_state_dict``: the render cells' stand-in for a trained field:
  the program's ``utils/synth.compact_field_params`` construction (a
  density logit k (r - |x|_1), positive inside an L1 ball of radius r)
  on units 0-5, and seeded weights on every other unit, encoding column
  and direction column, so that the check sees every tile of every
  product.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

MODULES = ("model_coarse", "model_fine")


def layer_shapes(L_x: int = 10, L_d: int = 4, depth: int = 8,
                 width: int = 256, skip: int = 4
                 ) -> List[Tuple[str, Tuple[int, int]]]:
    """(layer name, (out, in)) of one module, in registration order."""
    in_x, in_d = 3 + 6 * L_x, 3 + 6 * L_d
    shapes = []
    for i in range(depth):
        fan_in = in_x if i == 0 else width + (in_x if i == skip + 1 else 0)
        shapes.append((f"linear_x.{i}", (width, fan_in)))
    return shapes + [("linear_d", (width // 2, width + in_d)),
                     ("linear_feat", (width, width)),
                     ("linear_density", (1, width)),
                     ("linear_color", (3, width // 2))]


def init_state_dict(generator: torch.Generator, device, L_x: int = 10,
                    L_d: int = 4) -> Dict[str, torch.Tensor]:
    shapes = layer_shapes(L_x, L_d)
    sizes = [o * i + o for _, (o, i) in shapes] * len(MODULES)
    u = torch.rand(sum(sizes), generator=generator, device=device)
    out, at = {}, 0
    for mod in MODULES:
        for name, (o, i) in shapes:
            a = math.sqrt(6.0 / (i + o))
            bnd = 1.0 / math.sqrt(i)
            out[f"{mod}.{name}.weight"] = (u[at:at + o * i].view(o, i)
                                           * (2 * a) - a)
            at += o * i
            out[f"{mod}.{name}.bias"] = u[at:at + o] * (2 * bnd) - bnd
            at += o
    return out


def ball_state_dict(field: Dict[str, float], generator: torch.Generator,
                    device, L_x: int = 10, L_d: int = 4
                    ) -> Dict[str, torch.Tensor]:
    """A field with an opaque L1 ball whose every weight counts.
    ``field``: ``r``, the ball's radius; ``k``, the density's slope;
    ``mix``, the seeded units' share of the density; ``gain``, of the
    colour logits; ``octave``, the scale of each octave's encoding
    columns against the one below, which keeps the field smooth along a
    ray; and ``geometry_seed``, which draws the trunk and the density:
    the occupancy, and so the renderer's work, is the same for every
    run's seed (``generator``), which draws the colour branches.

    - trunk (shared by both modules, so their supports agree and the
      culled renderer's coarse cull keeps what the fine pass would show):
      layer 0 maps x_i to units 2i (+x_i) and 2i + 1 (-x_i), every later
      layer carries units 0-5 on unchanged (the ``compact_field_params``
      construction of ``utils/synth.py``); units 6-255 of every layer are
      seeded He-normal over all the layer's inputs, every encoding column
      included, with small seeded biases;
    - density: k r - k (units 0-5 summed), plus ``mix`` times a seeded
      readout of units 6-255: positive inside the ball, its boundary
      moved by about mix / k;
    - colour (each module its own draws): ``linear_feat`` over every
      unit, ``linear_d`` over every feature and direction column,
      ``linear_color`` over every unit of it, scaled by ``gain``.

    Every weight comes from two normal draws on ``device``."""
    r, k = float(field["r"]), float(field["k"])
    mix, gain = float(field["mix"]), float(field["gain"])
    octave = float(field["octave"])
    shapes = layer_shapes(L_x, L_d)
    in_x = 3 + 6 * L_x
    width = shapes[0][1][0]
    per_module = sum(o * i + o for _, (o, i) in shapes)
    z = torch.randn(len(MODULES) * per_module, generator=generator,
                    device=device)
    z_geo = torch.randn(per_module, generator=torch.Generator(
        device=device).manual_seed(int(field["geometry_seed"])),
        device=device)
    enc = torch.cat([torch.ones(3, device=device)]
                    + [torch.full((6,), octave ** j, device=device)
                       for j in range(L_x)])
    units = torch.arange(6, device=device)
    sign = torch.where(units % 2 == 0, 1.0, -1.0)
    out, at = {}, 0
    for m, mod in enumerate(MODULES):
        for name, (o, i) in shapes:
            shared = name.startswith("linear_x.") or name == "linear_density"
            src, a0 = (z_geo, at - m * per_module) if shared else (z, at)
            w = src[a0:a0 + o * i].view(o, i).clone()
            b = 0.1 * src[a0 + o * i:a0 + o * i + o]
            at += o * i + o
            if name.startswith("linear_x."):
                if name == "linear_x.0":
                    col, ident = enc, None
                elif i > width:                      # the skip layer
                    col = torch.cat([enc, torch.ones(width, device=device)])
                    ident = in_x + units
                else:
                    col, ident = torch.ones(i, device=device), units
                w = w * col * math.sqrt(2.0 / float(col.square().sum()))
                w[:6] = 0.0
                b[:6] = 0.0
                if ident is None:
                    w[units, units // 2] = sign
                else:
                    w[units, ident] = 1.0
            elif name == "linear_density":
                w = w * mix / math.sqrt(i - 6)
                w[0, :6] = -k
                b = torch.full_like(b, k * r)
            elif name == "linear_color":
                w = w * gain * math.sqrt(1.0 / i)
                b = torch.zeros_like(b)
            else:                                # linear_feat, linear_d
                w = w * math.sqrt(1.0 / i)
            if m > 0 and shared:
                w = out[f"{MODULES[0]}.{name}.weight"].clone()
                b = out[f"{MODULES[0]}.{name}.bias"].clone()
            out[f"{mod}.{name}.weight"] = w
            out[f"{mod}.{name}.bias"] = b
    return out
