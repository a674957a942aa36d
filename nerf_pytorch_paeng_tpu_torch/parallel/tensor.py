"""The width-sharded (tensor-parallel) MLP over the model group
(``n_model_shards > 1``; counterpart of the JAX package's
``parallel/sharding.py`` ``param_partition_specs`` and ``shard_params``).

The partition rule is the JAX package's, per layer, by its layer names
(``utils/interop.layer_pairs``):

- trunk layer ``i`` is column-parallel (its outputs split) when ``i`` is
  even and row-parallel (its inputs split) when ``i`` is odd;
- a row layer whose input count ``n_model`` does not divide falls back to
  column (the post-skip layer, 256 + 63 = 319 inputs at 8x256), and a
  column layer whose output count it does not divide to replicated;
- ``feature``, ``density`` and ``color`` are row-parallel, ``view`` is
  column-parallel;
- a bias is split exactly where its kernel is column-parallel.

JAX keeps kernels as [in, out], so its ``P(None, "model")`` (column)
splits a torch ``nn.Linear.weight`` [out, in] along dim 0, and its
``P("model", None)`` (row) along dim 1.  Every split is contiguous and
even: model index ``m`` holds part ``m`` of ``n_model``.

``ShardedNeRFMLP`` holds only its rank's parts as parameters, so Adam's
moments are split too.  Its forward is Megatron's, in the model group:
an identity whose backward all-reduces in front of a column layer
(``_Copy``), an all-reduce behind a row layer (``_Reduce``, its backward
the identity), and an all-gather where a split activation must be whole
(``_Gather``: the skip concat, a column layer after a column layer, a
replicated layer, the outputs; its backward keeps the rank's part).  A
row layer given a whole activation takes its part (``_Split``, whose
backward all-gathers).  ``models/nerf._linear``'s rounding holds per
part: operands rounded to ``compute_dtype``, float32 products and sums.
Every value outside a split is the same on every rank of the group, and
so is the gradient of every replicated parameter.
"""
from __future__ import annotations

import copy
import re
from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from ..models.nerf import NeRF, NeRFMLP
from ..utils.interop import MODULE_PAIRS, layer_pairs
from .mesh import Group, data_group, model_group
from .sharding import all_gather_cat, all_reduce_sum, check_replicas

COL, ROW, REP = "col", "row", "rep"


def layer_kind(jax_name: str, d_in: int, d_out: int, n_model: int) -> str:
    """The JAX package's rule for one layer: "col", "row" or "rep"."""
    if n_model <= 1:
        return REP
    col = COL if d_out % n_model == 0 else REP
    row = ROW if d_in % n_model == 0 else col
    m = re.fullmatch(r"trunk_(\d+)", jax_name)
    if m:
        return col if int(m.group(1)) % 2 == 0 else row
    if jax_name in ("feature", "density", "color"):
        return row
    if jax_name == "view":
        return col
    return REP


def _split_dim(kind: str, leaf: str) -> Optional[int]:
    """The split dim of a torch ``weight`` [out, in] or ``bias`` [out]."""
    if kind == COL:
        return 0
    if kind == ROW and leaf == "weight":
        return 1
    return None


def mlp_kinds(mlp: NeRFMLP, n_model: int) -> Dict[str, str]:
    """{reference layer name: kind} of one full-width ``NeRFMLP``."""
    out = {}
    for jax_name, ref_name in layer_pairs(len(mlp.linear_x)):
        w = mlp.get_submodule(ref_name).weight
        out[ref_name] = layer_kind(jax_name, w.shape[1], w.shape[0], n_model)
    return out


def partition_dims(model: NeRF, n_model: int) -> Dict[str, Optional[int]]:
    """{state-dict key of a full-width ``NeRF``: its split dim, or None
    where every rank holds it whole}."""
    dims = {}
    for _, ref_mod in MODULE_PAIRS:
        kinds = mlp_kinds(model.get_submodule(ref_mod), n_model)
        for ref_layer, kind in kinds.items():
            for leaf in ("weight", "bias"):
                dims[f"{ref_mod}.{ref_layer}.{leaf}"] = _split_dim(kind, leaf)
    return dims


def shard_tensor(t: torch.Tensor, dim: Optional[int], n: int, m: int
                 ) -> torch.Tensor:
    """Part ``m`` of ``n`` of ``t`` along ``dim`` (a copy; the whole of
    ``t`` where ``dim`` is None)."""
    if dim is None:
        return t.clone()
    size = t.shape[dim] // n
    return t.narrow(dim, m * size, size).clone()


def shard_state_dict(full: Dict[str, torch.Tensor],
                     dims: Dict[str, Optional[int]], n_model: int, m: int
                     ) -> Dict[str, torch.Tensor]:
    """Model index ``m``'s parts of a full state dict (``dims`` from
    ``partition_dims``)."""
    return {k: shard_tensor(t, dims[k], n_model, m) for k, t in full.items()}


def gather_state_dict(shards: Sequence[Dict[str, torch.Tensor]],
                      dims: Dict[str, Optional[int]]
                      ) -> Dict[str, torch.Tensor]:
    """The full state dict from every model index's parts, in order; the
    inverse of ``shard_state_dict``, bit for bit."""
    return {k: (shards[0][k].clone() if dims[k] is None
                else torch.cat([s[k] for s in shards], dims[k]))
            for k in shards[0]}


# ---------------------------------------------------- the model group's ops


class _Copy(torch.autograd.Function):
    """Identity; the backward sums the ranks' partial gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous().clone(), ctx.group), None


class _Reduce(torch.autograd.Function):
    """The sum of the ranks' partial products; the backward passes the
    (whole, alike) gradient to every rank's part."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """The ranks' last-dim parts concatenated; the backward keeps this
    rank's part of the (alike) gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.width = group, x.shape[-1]
        return all_gather_cat(x, -1, group)

    @staticmethod
    def backward(ctx, g):
        w = ctx.width
        return g.narrow(-1, ctx.group.index * w, w).contiguous(), None


class _Split(torch.autograd.Function):
    """This rank's last-dim part; the backward gathers every rank's part
    of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        w = x.shape[-1] // group.size
        return x.narrow(-1, group.index * w, w).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g, -1, ctx.group), None


def _mm(x: torch.Tensor, w: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    return x.to(cdt).float() @ w.to(cdt).float().T


class ShardedNeRFMLP(NeRFMLP):
    """One ``NeRFMLP`` split over a model group (``group``, this rank at
    ``group.index``): the reference layer names, each layer holding this
    rank's part (``kinds``: {layer name: "col" | "row" | "rep"})."""

    def __init__(self, full: NeRFMLP, group: Group):
        nn.Module.__init__(self)
        n, m = group.size, group.index
        self.in_ch_x, self.skips = full.in_ch_x, full.skips
        self.group = group
        self.kinds = mlp_kinds(full, n)

        def part(name: str) -> nn.Linear:
            src = full.get_submodule(name)
            kind = self.kinds[name]
            w = shard_tensor(src.weight.detach(),
                             _split_dim(kind, "weight"), n, m)
            b = shard_tensor(src.bias.detach(), _split_dim(kind, "bias"),
                             n, m)
            # made without storage, then filled: no initialisation draws
            layer = nn.Linear(w.shape[1], w.shape[0], device="meta").to_empty(
                device=w.device)
            with torch.no_grad():
                layer.weight.copy_(w)
                layer.bias.copy_(b)
            return layer
        self.linear_x = nn.ModuleList(
            part(f"linear_x.{i}") for i in range(len(full.linear_x)))
        self.linear_d = part("linear_d")
        self.linear_feat = part("linear_feat")
        self.linear_density = part("linear_density")
        self.linear_color = part("linear_color")

    def _whole(self, h: torch.Tensor, split: bool) -> torch.Tensor:
        return _Gather.apply(h, self.group) if split else h

    def _layer(self, name: str, h: torch.Tensor, split: bool,
               cdt: torch.dtype):
        """(output, whether it is split) of layer ``name`` given ``h``
        (split over the group or whole)."""
        layer, kind = self.get_submodule(name), self.kinds[name]
        if kind == ROW:
            x = h if split else _Split.apply(h, self.group)
            y = _Reduce.apply(_mm(x, layer.weight, cdt), self.group)
            return y + layer.bias.float(), False
        x = self._whole(h, split)
        if kind == COL:
            x = _Copy.apply(x, self.group)
        return _mm(x, layer.weight, cdt) + layer.bias.float(), kind == COL

    def forward(self, x: torch.Tensor,
                compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """[..., in_ch_x + in_ch_d] (alike on every rank of the group) ->
        [..., 4] float32 (rgb logits, sigma), alike on every rank."""
        cdt = compute_dtype
        x = x.float()
        pts, dirs = x[..., :self.in_ch_x], x[..., self.in_ch_x:]
        h, split = pts, False
        for i in range(len(self.linear_x)):
            h, split = self._layer(f"linear_x.{i}", h, split, cdt)
            h = torch.relu(h)
            if i in self.skips:
                h, split = torch.cat([pts, self._whole(h, split)], -1), False
        sigma, s_split = self._layer("linear_density", h, split, cdt)
        feat, f_split = self._layer("linear_feat", h, split, cdt)
        hv, v_split = self._layer(
            "linear_d", torch.cat([self._whole(feat, f_split), dirs], -1),
            False, cdt)
        rgb, c_split = self._layer("linear_color", torch.relu(hv), v_split,
                                   cdt)
        return torch.cat([self._whole(rgb, c_split),
                          self._whole(sigma, s_split)], -1)

    def replicated_parameters(self) -> List[torch.Tensor]:
        """The parameters every rank of the group holds whole."""
        return [p for name, p in self.named_parameters()
                if _split_dim(self.kinds[name.rsplit(".", 1)[0]],
                              name.rsplit(".", 1)[1]) is None]


# ------------------------------------------------------ the sharded NeRF


class ShardedNeRF(NeRF):
    """A ``NeRF`` whose two modules are ``ShardedNeRFMLP``s of one model
    group; ``full_dims`` is the full state dict's split dims."""

    def __init__(self, full: NeRF, group: Group):
        nn.Module.__init__(self)
        self.model_coarse = ShardedNeRFMLP(full.model_coarse, group)
        self.model_fine = ShardedNeRFMLP(full.model_fine, group)
        self.group = group
        self.full_dims = partition_dims(full, group.size)
        # the full module's shapes, without storage (a list: no submodule)
        self._template = [copy.deepcopy(full).to("meta")]

    def full_state_dict(self) -> Dict[str, torch.Tensor]:
        """The full state dict, gathered over the model group on every
        rank of it (a collective: every rank of the group calls it)."""
        return {k: t.detach().clone() if self.full_dims[k] is None
                else all_gather_cat(t.detach(), self.full_dims[k], self.group)
                for k, t in self.state_dict().items()}

    def full_model(self) -> NeRF:
        """A plain ``NeRF`` holding the gathered weights, on this rank's
        device (a collective)."""
        sd = self.full_state_dict()
        full = copy.deepcopy(self._template[0]).to_empty(
            device=next(iter(sd.values())).device)
        full.load_state_dict(sd)
        return full

    def replicated_parameters(self) -> List[torch.Tensor]:
        return (self.model_coarse.replicated_parameters()
                + self.model_fine.replicated_parameters())


def shard_nerf(full: NeRF, group: Optional[Group] = None) -> NeRF:
    """This rank's ``ShardedNeRF`` of ``full`` (the same weights on every
    rank of ``group``, default: the model group); ``full`` itself where
    the group is this rank alone."""
    group = group or model_group()
    return full if group.size <= 1 else ShardedNeRF(full, group)


def full_model(model: NeRF) -> NeRF:
    """The plain ``NeRF`` of a sharded one (gathered: a collective of its
    model group), else ``model`` itself."""
    return model.full_model() if isinstance(model, ShardedNeRF) else model


def check_model_replicas(model: NeRF, what: str) -> None:
    """Raise unless the ranks that must hold the same bits do: every
    parameter over the data group, and a sharded model's replicated
    parameters over its model group."""
    check_replicas(model.parameters(), what, data_group())
    if isinstance(model, ShardedNeRF):
        check_replicas(model.replicated_parameters(),
                       what + " (replicated over the model group)",
                       model.group)
