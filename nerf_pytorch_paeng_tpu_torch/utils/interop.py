"""Weight carrier between the JAX package's params tree and the port.

The JAX package keeps each MLP as a flax tree
``{coarse|fine: {trunk_i|density|feature|view|color: {kernel, bias}}}``
with kernels [in, out]; the port's ``NeRF.state_dict()`` is the reference
``model_state_dict`` with torch's [out, in] weights.  Both directions here
are numpy in, tensors (or numpy) out, so nothing of JAX is needed:

  trunk_0..7 <-> linear_x.0..7      (kernel = weight.T)
  view       <-> linear_d
  feature    <-> linear_feat
  density    <-> linear_density
  color      <-> linear_color

prefixed ``model_coarse.`` / ``model_fine.``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

# (JAX package, reference) layer-name pairs in the reference's registration
# order, which is the port's state_dict order.
LAYER_PAIRS: List[Tuple[str, str]] = (
    [(f"trunk_{i}", f"linear_x.{i}") for i in range(8)]
    + [("view", "linear_d"), ("feature", "linear_feat"),
       ("density", "linear_density"), ("color", "linear_color")])

MODULE_PAIRS = [("coarse", "model_coarse"), ("fine", "model_fine")]


def state_dict_from_jax_params(params: Any) -> Dict[str, torch.Tensor]:
    """Flax params tree (numpy leaves) -> the port's ``NeRF`` state dict."""
    sd: Dict[str, torch.Tensor] = {}
    for jax_mod, ref_mod in MODULE_PAIRS:
        mlp = params[jax_mod]
        for jax_layer, ref_layer in LAYER_PAIRS:
            w = np.asarray(mlp[jax_layer]["kernel"], np.float32).T
            b = np.asarray(mlp[jax_layer]["bias"], np.float32)
            sd[f"{ref_mod}.{ref_layer}.weight"] = torch.from_numpy(w.copy())
            sd[f"{ref_mod}.{ref_layer}.bias"] = torch.from_numpy(b.copy())
    return sd


def jax_params_from_state_dict(sd: Dict[str, Any]) -> Dict[str, Dict]:
    """The port's (or the reference's) state dict -> flax params tree with
    numpy leaves."""
    def np32(t):
        if isinstance(t, torch.Tensor):
            t = t.detach().cpu().numpy()
        return np.asarray(t, np.float32)

    params: Dict[str, Dict] = {}
    for jax_mod, ref_mod in MODULE_PAIRS:
        params[jax_mod] = {
            jax_layer: {
                "kernel": np32(sd[f"{ref_mod}.{ref_layer}.weight"]).T.copy(),
                "bias": np32(sd[f"{ref_mod}.{ref_layer}.bias"]),
            }
            for jax_layer, ref_layer in LAYER_PAIRS}
    return params
