"""Tensor parallelism: the port's counterpart of the collectives XLA inserts
once the reference has placed a model's weights with
``jax.device_put(state, param_shardings(mesh, state, hidden_units))``.

``tensor_parallel(model, axis, hidden_units)`` walks any zoo model and
shards what ``parallel.mesh``'s rule shards, judged on the flat names and
flax-layout shapes of ``models/convert.py`` (a flax kernel is [in, out], a
torch ``Linear.weight`` [out, in]):

- a ``Dense`` with a [in, hidden] kernel becomes a ``ColumnParallelDense``:
  its weight splits along torch dim 0, its bias with it; forward
  ``copy_to_model``, the local product, ``gather_from_model``;
- a ``Dense`` with a [hidden, out] kernel becomes a ``RowParallelDense``:
  its weight splits along torch dim 1 and its bias stays whole; forward
  ``scatter_to_model``, the local product, ``reduce_from_model`` in f32,
  then the bias, added once;
- any other sharded parameter (a batch norm's bias where a conv stage is
  ``hidden`` wide: the rule reads shapes alone) is held in shards and
  gathered where it is used, a ``torch.nn.utils.parametrize``
  parametrization whose backward takes the local slice.

Every layer is replicated in and replicated out, so the rest of the model,
dropout's masks over the full width among it, runs as in one process, and
a replicated parameter gets the same gradient on every rank of the axis.

The axis (``ModelAxis``) takes one of two forms, with one layer code:

- **a process group** (training: the "model" group of a process-group
  mesh): each rank holds its shard, under the parameter's own name, so a
  rank's ``state_dict`` is ``shard_state_dict``'s for its coordinate (the
  gathered batch-norm biases under ``parametrizations.<leaf>.original``);
- **a single-process device list** (a row of a single-process mesh: the
  server, the dryrun): every shard is local, shard k on device k, and the
  collectives are ``.to`` the first device with ``cat`` or ``sum``, through
  which autograd works by itself.

Weights cross in full: ``full_state_dict`` / ``load_full_state_dict`` (and
the optimizer's and any by-name tensors') gather and split by the same
rule, ``shard_state_dict`` / ``gather_state_dict`` do it for one
coordinate of a mesh without a model, and ``place_sharded`` puts every
coordinate's shards on its device of a single-process mesh, as a
``ShardedStateDict`` the server keeps (``serve/server.py``).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
from torch.nn.utils import parametrize

from mla_tpu_torch.models.convert import _flat_key, _flat_shape, _to_torch_layout, _torch_key
from mla_tpu_torch.models.trunk import Dense
from mla_tpu_torch.parallel.distributed import (
    all_gather_cat,
    copy_to_model,
    gather_from_model,
    reduce_from_model,
    scatter_to_model,
)
from mla_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh, tp_spec

# flax-layout dimension -> torch-layout dimension, by rank (convert.py's rules)
_TORCH_DIM = {1: (0,), 2: (1, 0), 4: (2, 3, 1, 0)}


class ModelAxis:
    """The "model" axis a tensor-parallel layer splits over: a process
    ``group`` (this rank holds shard ``rank``) or a single-process list of
    ``devices`` (shard k on device k). Exactly one is given."""

    def __init__(self, group=None, devices: Optional[Sequence] = None):
        if (group is None) == (devices is None):
            raise ValueError("a tensor-parallel axis needs a process group or a device list "
                             "(exactly one)")
        self.group = group
        self.devices = None if devices is None else [torch.device(d) for d in devices]
        self.size = dist.get_world_size(group) if group is not None else len(self.devices)
        self.rank = dist.get_rank(group) if group is not None else None

    @property
    def local(self) -> bool:
        """True when every shard is in this process (the device-list form)."""
        return self.devices is not None

    def split(self, t: torch.Tensor, dim: int) -> List[torch.Tensor]:
        """The shards of ``t`` along ``dim`` this process holds, each a new
        tensor: its own (a group), or all, shard k on device k."""
        if t.shape[dim] % self.size:
            raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not split over "
                             f"{self.size}")
        parts = t.detach().chunk(self.size, dim)
        if not self.local:
            return [parts[self.rank].clone()]
        return [p.to(d, copy=True) for p, d in zip(parts, self.devices)]

    def join(self, parts: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
        """The whole tensor from the shards this process holds (a group:
        gathered over it, a collective), without autograd."""
        if not self.local:
            return all_gather_cat(parts[0].detach(), dim, self.group)
        return torch.cat([p.detach().to(parts[0].device) for p in parts], dim)


def _shard_param(t: torch.Tensor, dim: int, axis: ModelAxis):
    parts = [nn.Parameter(p) for p in axis.split(t, dim)]
    return parts[0] if not axis.local else nn.ParameterList(parts)


class ColumnParallelDense(nn.Module):
    """A ``Dense`` whose output features split over the axis: weight [out /
    n, in] and bias [out / n] per shard, replicated in and out."""

    def __init__(self, dense: Dense, axis: ModelAxis):
        super().__init__()
        self.axis, self.compute_dtype = axis, dense.compute_dtype
        self.in_features, self.out_features = dense.in_features, dense.out_features
        self.weight = _shard_param(dense.weight, 0, axis)
        self.bias = _shard_param(dense.bias, 0, axis)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if not self.axis.local:
            g = self.axis.group
            y = F.linear(copy_to_model(x, g).to(dt), self.weight.to(dt), self.bias.to(dt))
            return gather_from_model(y, -1, g)
        return torch.cat([F.linear(x.to(w.device, dt), w.to(dt), b.to(dt)).to(x.device)
                          for w, b in zip(self.weight, self.bias)], -1)


class RowParallelDense(nn.Module):
    """A ``Dense`` whose input features split over the axis: weight [out,
    in / n] per shard and the bias whole. Each shard's partial product
    takes its operands rounded to the compute dtype, as the whole layer
    does, and accumulates in f32 (a bf16 layer's partials are not rounded
    to bf16: products of bf16 values are exact in f32); the partials are
    summed in f32, the bias added once, and the sum cast to the compute
    dtype, one rounding as in the whole layer."""

    def __init__(self, dense: Dense, axis: ModelAxis):
        super().__init__()
        self.axis, self.compute_dtype = axis, dense.compute_dtype
        self.in_features, self.out_features = dense.in_features, dense.out_features
        self.weight = _shard_param(dense.weight, 1, axis)
        self.bias = nn.Parameter(dense.bias.detach().clone())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if not self.axis.local:
            g = self.axis.group
            xk = scatter_to_model(x, -1, g)
            total = reduce_from_model(F.linear(xk.to(dt).float(), self.weight.to(dt).float()), g)
        else:
            total = sum(F.linear(xk.to(w.device, dt).float(), w.to(dt).float()).to(x.device)
                        for xk, w in zip(x.chunk(self.axis.size, -1), self.weight))
        return (total + self.bias.to(dt).float()).to(dt)


class GatherAtUse(nn.Module):
    """Parametrization of a sharded parameter that is not a Dense's: the
    module reads the whole tensor, gathered from the shards each time it is
    used; the backward takes each shard's slice."""

    def __init__(self, axis: ModelAxis, dim: int):
        super().__init__()
        self.axis, self.dim = axis, dim

    def forward(self, *shards: torch.Tensor) -> torch.Tensor:
        if not self.axis.local:
            return gather_from_model(shards[0], self.dim, self.axis.group)
        return torch.cat([s.to(shards[0].device) for s in shards], self.dim)

    def right_inverse(self, full: torch.Tensor):
        parts = self.axis.split(full, self.dim)
        return parts[0] if not self.axis.local else tuple(parts)


def shard_dims(state_dict: Mapping, model_size: int, hidden_units: int) -> Dict[str, int]:
    """{state_dict key: the torch dimension the rule splits} for every
    sharded entry of a full torch-layout ``state_dict`` (tensors, or
    shapes), the rule judged on its flat name and flax-layout shape."""
    out = {}
    for key, t in state_dict.items():
        if key.endswith("num_batches_tracked"):
            continue
        shape = tuple(t.shape) if hasattr(t, "shape") else tuple(t)
        fshape = _flat_shape(shape)
        spec = tp_spec(tuple(_flat_key(key, len(shape)).split("/")), fshape, hidden_units,
                       model_size)
        for i, a in enumerate(spec):
            if a is not None:
                out[key] = _TORCH_DIM[len(fshape)][i]
    return out


class TensorParallelLayout:
    """What ``tensor_parallel`` did to a model: the axis, the rule's split
    dimensions by full ``state_dict`` key, the full model's key and
    parameter order, and each full name's tensors in this process
    (``internal[name]``: one name, or one per shard)."""

    def __init__(self, axis: ModelAxis, dims: Dict[str, int], keys: List[str],
                 param_names: List[str], internal: Dict[str, List[str]]):
        self.axis, self.dims, self.keys = axis, dims, keys
        self.param_names, self.internal = param_names, internal


def tensor_parallel(model: nn.Module, axis: ModelAxis, hidden_units: int) -> nn.Module:
    """Shard ``model`` in place over ``axis`` by the rule (see the module
    docstring) and return it; each shard is the slice of the weights the
    model held. The port's ``jax.device_put(state, param_shardings(...))``.
    In the device-list form the replicated parts stay where they are (the
    first device, by the caller's choice)."""
    if getattr(model, "tp_layout", None) is not None:
        raise ValueError("the model is tensor parallel already")
    sd = model.state_dict()
    dims = shard_dims(sd, axis.size, hidden_units)
    param_names = [n for n, _ in model.named_parameters()]
    internal = {k: [k] for k in sd}
    swapped = set()
    for name, mod in list(model.named_modules()):
        wkey, bkey = f"{name}.weight", f"{name}.bias"
        if not isinstance(mod, Dense) or wkey not in dims:
            continue
        if dims[wkey] == 0:
            if dims.get(bkey) != 0:
                raise ValueError(f"{name}: a column-parallel kernel needs its bias sharded")
            new, sharded = ColumnParallelDense(mod, axis), (wkey, bkey)
        else:
            if bkey in dims:
                raise ValueError(f"{name}: a row-parallel Dense keeps its bias whole")
            new, sharded = RowParallelDense(mod, axis), (wkey,)
        parent, _, leaf = name.rpartition(".")
        setattr(model.get_submodule(parent), leaf, new)
        swapped.update(sharded)
        for k in sharded:
            internal[k] = [k] if not axis.local else [f"{k}.{i}" for i in range(axis.size)]
    for key, dim in dims.items():
        if key in swapped:
            continue
        mod_name, _, leaf = key.rpartition(".")
        parametrize.register_parametrization(model.get_submodule(mod_name), leaf,
                                             GatherAtUse(axis, dim), unsafe=True)
        base = f"{mod_name}.parametrizations.{leaf}.original"
        internal[key] = [base] if not axis.local else [f"{base}{i}" for i in range(axis.size)]
    model.tp_layout = TensorParallelLayout(axis, dims, list(sd), param_names, internal)
    return model


def layout_of(model: nn.Module) -> Optional[TensorParallelLayout]:
    """The model's ``TensorParallelLayout``, or None when it is whole."""
    return getattr(model, "tp_layout", None)


def sharded_parameters(model: nn.Module) -> set:
    """The ids of the parameters that are shards (empty for a whole model)."""
    lay = layout_of(model)
    if lay is None:
        return set()
    params = dict(model.named_parameters())
    return {id(params[n]) for k in lay.dims for n in lay.internal[k]}


def gather_named(model: nn.Module, tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Tensors keyed by this process's names (``state_dict`` keys or
    parameter names: the EMA shadow, Adam's moments) -> keyed by the full
    model's, sharded ones joined; in the full model's order. On a process
    group a collective: every rank of the axis calls it with the same keys."""
    lay = layout_of(model)
    if lay is None:
        return dict(tensors)
    out = OrderedDict()
    for key in lay.keys:
        names = lay.internal[key]
        if names[0] not in tensors:
            continue
        parts = [tensors[n] for n in names]
        out[key] = lay.axis.join(parts, lay.dims[key]) if key in lay.dims else parts[0]
    return out


def split_named(model: nn.Module, tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`gather_named`: full tensors by the full model's
    names -> this process's shards by its own names."""
    lay = layout_of(model)
    if lay is None:
        return dict(tensors)
    out = {}
    for key, t in tensors.items():
        names = lay.internal[key]
        parts = lay.axis.split(t, lay.dims[key]) if key in lay.dims else [t]
        out.update(zip(names, parts))
    return out


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The whole model's ``state_dict`` (for a whole model, its own)."""
    return gather_named(model, model.state_dict())


def load_full_state_dict(model: nn.Module, state_dict: Mapping[str, torch.Tensor]) -> None:
    """Load a whole model's ``state_dict``: each shard takes its slice."""
    model.load_state_dict(split_named(model, state_dict))


def full_optimizer_state(model: nn.Module, optimizer: torch.optim.Optimizer) -> Dict:
    """The optimizer's ``state_dict`` as the whole model's optimizer would
    have it: Adam's moments gathered, indexed in the whole model's
    parameter order (a collective on a process group)."""
    lay = layout_of(model)
    sd = optimizer.state_dict()
    if lay is None:
        return sd
    names = [n for n, _ in model.named_parameters()]
    st = sd["state"]
    per_name = {names[i]: s for i, s in st.items()}
    moments = {k: gather_named(model, {n: s[k] for n, s in per_name.items()})
               for k in ("exp_avg", "exp_avg_sq")}
    state = {}
    for i, name in enumerate(lay.param_names):
        first = lay.internal[name][0]
        if first in per_name:
            state[i] = {"step": per_name[first]["step"].clone(),
                        **{k: moments[k][name] for k in moments}}
    return {"state": state, "param_groups": [{**g, "params": list(range(len(lay.param_names)))}
                                             for g in sd["param_groups"]]}


def load_full_optimizer_state(model: nn.Module, optimizer: torch.optim.Optimizer,
                              saved: Mapping) -> None:
    """Load a whole model's optimizer ``state_dict``: each shard's moments
    are the slices of the whole ones."""
    lay = layout_of(model)
    if lay is None:
        optimizer.load_state_dict(saved)
        return
    names = [n for n, _ in model.named_parameters()]
    index = {n: i for i, n in enumerate(names)}
    full = {lay.param_names[int(i)]: s for i, s in saved["state"].items()}
    moments = {k: split_named(model, {n: s[k] for n, s in full.items()})
               for k in ("exp_avg", "exp_avg_sq")}
    state = {}
    for name, s in full.items():
        for n in lay.internal[name]:
            state[index[n]] = {"step": s["step"].clone(), **{k: moments[k][n] for k in moments}}
    optimizer.load_state_dict({"state": state,
                               "param_groups": [{**g, "params": list(range(len(names)))}
                                                for g in saved["param_groups"]]})


def _torch_state(state: Mapping) -> Dict[str, torch.Tensor]:
    """A torch-layout ``state_dict`` from either one, or from the flat
    weight format ("params/.../kernel" keys, flax layout)."""
    if not any("/" in k for k in state):
        return {k: torch.as_tensor(v) for k, v in state.items()}
    return {_torch_key(k): torch.from_numpy(np.ascontiguousarray(
        _to_torch_layout(np.asarray(v, np.float32)))) for k, v in state.items()}


def shard_state_dict(flat: Mapping, mesh: Mesh, hidden_units: int,
                     coord: Tuple[int, int]) -> Dict[str, torch.Tensor]:
    """The shards device ``coord`` = (data, model) of ``mesh`` holds under
    the rule, from whole weights in the flat format (or a torch
    ``state_dict``): a torch-layout ``state_dict`` (its own key order) of
    new tensors, each sharded entry the coordinate's slice along its torch
    dimension, the rest whole."""
    sd = _torch_state(flat)
    n = mesh.shape[MODEL_AXIS]
    dims = shard_dims(sd, n, hidden_units)
    return {k: (t.chunk(n, dims[k])[coord[1]] if k in dims else t).clone()
            for k, t in sd.items()}


def gather_state_dict(shards: Sequence[Mapping[str, torch.Tensor]], hidden_units: int,
                      shapes: Mapping[str, Sequence[int]]) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`shard_state_dict` along the model axis:
    ``shards`` of model coordinates 0..n-1 -> whole tensors (on the first
    shard's devices). ``shapes`` are the whole model's torch-layout shapes,
    which decide what the rule split (a shard's own shape cannot)."""
    dims = shard_dims(shapes, len(shards), hidden_units)
    out = {}
    for k, t in shards[0].items():
        out[k] = (torch.cat([s[k].to(t.device) for s in shards], dims[k]) if k in dims
                  else t.clone())
    return out


class ShardedStateDict(dict):
    """{(data, model) coordinate: the shards that device of ``mesh`` holds}
    under the rule: weights already sharded over a single-process mesh (the
    port's tensors placed by ``param_shardings``). ``shapes`` is the whole
    model's torch-layout shapes and dtypes by key."""

    def __init__(self, shards: Mapping, mesh: Mesh, hidden_units: int, shapes: Mapping):
        super().__init__(shards)
        self.mesh, self.hidden_units, self.shapes = mesh, hidden_units, dict(shapes)

    def row(self, d: int) -> List[Dict[str, torch.Tensor]]:
        """Data row ``d``'s shards, in model order."""
        return [self[(d, m)] for m in range(self.mesh.shape[MODEL_AXIS])]

    def full(self, d: int = 0) -> Dict[str, torch.Tensor]:
        """The whole weights, gathered from data row ``d``."""
        return gather_state_dict(self.row(d), self.hidden_units,
                                 {k: s for k, (s, _) in self.shapes.items()})


def place_sharded(state_dict: Mapping, mesh: Mesh, hidden_units: int) -> ShardedStateDict:
    """Whole weights (a torch ``state_dict`` or the flat format) sharded
    over a single-process ``mesh`` by the rule, each coordinate's shards on
    its device."""
    sd = _torch_state(state_dict)
    grid = mesh.devices
    return ShardedStateDict(
        {(d, m): {k: v.to(grid[d, m]) for k, v in
                  shard_state_dict(sd, mesh, hidden_units, (d, m)).items()}
         for d in range(grid.shape[0]) for m in range(grid.shape[1])},
        mesh, hidden_units, {k: (tuple(v.shape), v.dtype) for k, v in sd.items()})


def load_shards(model: nn.Module, shards: Sequence[Mapping[str, torch.Tensor]]) -> None:
    """Load the shard ``state_dict`` of every model coordinate (in order;
    one per process of a group: this rank's alone) into a tensor-parallel
    model, each into its place, the whole entries from the first. Batch
    norm's step counters may be absent (the flat format has none)."""
    lay = layout_of(model)
    local = {}
    for key, t in shards[0].items():
        if key in lay.dims:
            local.update(zip(lay.internal[key], (s[key] for s in shards)))
        else:
            local[key] = t
    missing, unexpected = model.load_state_dict(local, strict=False)
    bad = [k for k in missing if not k.endswith("num_batches_tracked")] + list(unexpected)
    if bad:
        raise KeyError(f"shards do not fit the model: {bad}")
