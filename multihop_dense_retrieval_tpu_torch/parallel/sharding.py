"""Tensor-parallel sharding of the transformer encoder (the JAX package's
``parallel/sharding.py``): Megatron-style column / row splits of the
attention heads and the FFN over the mesh's ``index`` axis.

The rules, in torch's ``nn.Linear`` layout (weight (out, in); hidden H,
heads A of width d, FFN width F):

  attention q/k/v weight (A·d, H)      → dim 0   [column]
  attention q/k/v bias   (A·d,)        → dim 0
  attention output.dense weight (H, A·d) → dim 1 [row], its bias replicated
  intermediate.dense weight (F, H)     → dim 0   [column]
  intermediate.dense bias   (F,)       → dim 0
  output.dense weight       (H, F)     → dim 1   [row], its bias replicated
  everything else                      → replicated

These are the parameters the JAX rule shards, no more and no fewer.

Where JAX only annotates and XLA inserts the all-reduces, the eager port
moves the parameters: ``shard_params`` replaces each split ``nn.Linear``
by a ``ShardedLinear`` whose blocks are parameters of their own, block s on
index shard s's device, so that an optimizer's state for a block lives
beside it (JAX's "grads and Adam moments follow").  The replicated
parameters stay where they are: on the mesh's home device.  The encoder's
layers see the blocks and compute each shard's heads and FFN columns on
its device (``models/encoder.py``).

Over an index axis that spans processes (``Mesh.check_tensor_parallel``
says which layouts run), a process keeps only its own blocks, with their
global shard ids, and the ``ShardedLinear`` holds the index group (the
processes of its data row, ``Mesh.axis_groups``): the encoder gathers the
shards' partial sums over it, and ``gather_state_dict`` gathers the
blocks.  Every process of the world calls ``shard_params`` (it may make
the mesh's groups) and ``constrain_params``; every process of an index
group calls ``gather_state_dict`` together.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from ..core.mesh import INDEX_AXIS, AxisGroup, Mesh, all_gather

# (suffix of a parameter name, the dim its weight splits on, whether its
# bias splits too)
_RULES = (("attention.self.query", 0, True), ("attention.self.key", 0, True),
          ("attention.self.value", 0, True), ("intermediate.dense", 0, True),
          ("output.dense", 1, False))


def _rule(linear_name: str):
    for suffix, dim, split_bias in _RULES:
        if linear_name == suffix or linear_name.endswith("." + suffix):
            return dim, split_bias
    return None


class ShardedLinear(nn.Module):
    """An ``nn.Linear`` cut into ``n_shards`` equal blocks along ``dim`` of
    its (out, in) weight; this process keeps the blocks of ``shards``
    ((global shard id, device), in shard order), each a parameter of its
    own on its device.  dim 0 (column-parallel) cuts the bias with the
    weight; dim 1 (row-parallel) keeps the bias whole, a replicated
    parameter on the linear's own device.  ``weight[s]`` and
    (column-parallel) ``bias[s]`` are the blocks of ``shard_ids[s]``;
    ``group``, where other processes hold the other blocks, is the index
    group (None where this process holds every block); ``gathered()`` is
    the linear's (weight, bias) in one piece."""

    def __init__(self, lin: nn.Linear, dim: int, shards, n_shards: int,
                 group: Optional[AxisGroup] = None):
        super().__init__()
        self.dim, self.n_shards, self.group = dim, n_shards, group
        self.shard_ids = tuple(s for s, _ in shards)
        with torch.no_grad():
            ws = lin.weight.chunk(n_shards, dim)
            self.weight = nn.ParameterList(
                nn.Parameter(ws[s].to(d, copy=True), lin.weight.requires_grad)
                for s, d in shards)
            if dim == 0:
                bs = lin.bias.chunk(n_shards, 0)
                self.bias = nn.ParameterList(
                    nn.Parameter(bs[s].to(d, copy=True), lin.bias.requires_grad)
                    for s, d in shards)
            else:
                self.bias = lin.bias

    @property
    def devices(self) -> tuple:
        return tuple(w.device for w in self.weight)

    def blocks(self) -> list:
        """This process's block parameters: the weight's, then the
        bias's (column-parallel)."""
        return list(self.weight) + (list(self.bias) if self.dim == 0 else [])

    def block(self, s: int):
        """(weight, bias) of block s; a row-parallel block has no bias."""
        return self.weight[s], (self.bias[s] if self.dim == 0 else None)

    def gathered(self):
        """The unsplit (weight, bias) on block 0's device (the bias on
        its own device when it is replicated), bit for bit.  Collective
        over ``group``, where there is one."""
        home = self.weight[0].device

        def join(blocks, dim):
            x = torch.cat([b.detach().to(home) for b in blocks], dim)
            return x if self.group is None else all_gather(x, dim,
                                                           self.group)

        if self.dim == 0:
            return join(self.weight, 0), join(self.bias, 0)
        return join(self.weight, 1), self.bias.detach()


def _axis_shards(mesh: Mesh, axis: str):
    """((shard id, device) of this process's index shards of its first data
    row, the index group: None where the row is this process's alone)."""
    if axis != INDEX_AXIS:
        raise ValueError(f"tensor parallelism runs over the {INDEX_AXIS!r} "
                         f"axis, not {axis!r}")
    shards = list(mesh.data_entries(tensor_parallel=True)[0][1])
    group = mesh.axis_groups()[0]
    return shards, (group if group.size > 1 else None)


def _check_divides(model: nn.Module, n: int):
    c = getattr(model, "config", None)
    if c is None:
        return
    for what, size in (("num_heads", c.num_heads),
                       ("intermediate_size", c.intermediate_size)):
        if size % n:
            raise ValueError(f"{what}={size} does not split over {n} index "
                             f"shards")


def encoder_param_specs(model: nn.Module, mesh: Mesh,
                        axis: str = INDEX_AXIS) -> Dict[str, Optional[int]]:
    """Each parameter name of ``model`` (its unsharded names) → the dim it
    splits on over the mesh's ``axis``, or None (replicated).  Raises
    where the heads or the FFN width do not divide the axis."""
    _check_divides(model, mesh.shape[axis])
    specs = {}
    for mod_name, mod in model.named_modules():
        rule = _rule(mod_name) if isinstance(mod, (nn.Linear,
                                                   ShardedLinear)) else None
        for name in ("weight", "bias"):
            if rule is not None:
                dim, split_bias = rule
                specs[f"{mod_name}.{name}"] = dim if name == "weight" else \
                    (0 if split_bias else None)
        if rule is None:
            for name, _ in mod.named_parameters(recurse=False):
                specs[f"{mod_name}.{name}" if mod_name else name] = None
    return specs


def _split_modules(model: nn.Module):
    """(parent, attribute, module, (dim, split_bias)) of every linear the
    rules split."""
    for mod_name, mod in model.named_modules():
        for child_name, child in mod.named_children():
            full = f"{mod_name}.{child_name}" if mod_name else child_name
            rule = _rule(full)
            if rule is not None and isinstance(child, (nn.Linear,
                                                       ShardedLinear)):
                yield mod, child_name, child, rule


def shard_params(model: nn.Module, mesh: Mesh,
                 axis: str = INDEX_AXIS) -> nn.Module:
    """Lay ``model`` out tensor-parallel over the mesh's ``axis``, in
    place: each split linear becomes a ``ShardedLinear`` that keeps this
    process's blocks, block s on shard s's device.  Returns the model."""
    shards, group = _axis_shards(mesh, axis)
    n = mesh.shape[axis]
    _check_divides(model, n)
    for parent, name, child, (dim, _) in list(_split_modules(model)):
        if isinstance(child, ShardedLinear):
            raise ValueError(f"{name} is already split; constrain_params "
                             f"takes a model that may be")
        setattr(parent, name, ShardedLinear(child, dim, shards, n, group))
    return model


def is_sharded(model: nn.Module, mesh: Mesh, axis: str = INDEX_AXIS) -> bool:
    """Whether every split linear of ``model`` is in the mesh's layout;
    raises where the model is split over other shards or devices."""
    shards, _ = _axis_shards(mesh, axis)
    ids = tuple(s for s, _ in shards)
    devs = tuple(torch.device(d) for _, d in shards)
    kinds = [child for *_, child, _ in _split_modules(model)]
    split = [c for c in kinds if isinstance(c, ShardedLinear)]
    if not split:
        return False
    if len(split) != len(kinds) or any(
            c.devices != devs or c.shard_ids != ids or
            c.n_shards != mesh.shape[axis] for c in split):
        raise ValueError("the model is split over other devices than the "
                         "mesh's index shards")
    return True


def constrain_params(model: nn.Module, mesh: Mesh,
                     axis: str = INDEX_AXIS) -> nn.Module:
    """``shard_params`` made idempotent: a model already in the mesh's
    layout comes back unchanged."""
    if is_sharded(model, mesh, axis):
        return model
    return shard_params(model, mesh, axis)


def gather_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` under the unsharded names, in their order:
    each ``ShardedLinear``'s blocks joined back into one weight (and bias),
    bit for bit; the state dict itself where nothing is split.  Where
    other processes hold blocks, the blocks are gathered over the index
    group: every process of the group must call this, and each gets the
    whole state dict."""
    sharded = {name: mod for name, mod in model.named_modules()
               if isinstance(mod, ShardedLinear)}
    out = {}
    for key, val in model.state_dict().items():
        head, _, last = key.rpartition(".")
        owner = head.rpartition(".")[0] if last.isdigit() else head
        if owner not in sharded:
            out[key] = val
        elif f"{owner}.weight" not in out:
            out[f"{owner}.weight"], out[f"{owner}.bias"] = \
                sharded[owner].gathered()
    return out
