"""The ("data", "model") device mesh, the placements and the tensor-parallel
rule (counterpart of ``mla_tpu/parallel/mesh.py``).

PyTorch has no single-controller sharded array, so the port's mesh is a
small object in one of two forms:

- **One process** (the stream-sharded server, context-parallel scoring):
  ``devices`` is a [data, model] object array of ``torch.device``s, by
  default the visible cards. A device may appear more than once: each entry
  is one shard with tensors of its own, so one card can hold several
  shards, as the tests' CPU runs hold eight. ``shard_batch`` splits a batch
  into a list of per-shard pieces, one per data row, each on the row's
  first device.
- **A process group** (training): the mesh spans the ranks, "model"
  innermost as in the reference, so rank r sits at (r // model, r % model);
  ``devices`` holds rank numbers, ``local_device`` this rank's card, and
  ``device_mesh`` the ``init_device_mesh`` over the group, whose
  ``group(axis)`` carries the axis' collectives. ``put_local_batch`` keeps
  this rank's rows on its device.

A placement (``Placement``) is a mesh and a spec, a tuple naming for each
tensor dimension the mesh axis it is split over (None: whole), as JAX's
``NamedSharding(mesh, PartitionSpec(...))``; the empty spec is replicated.
``param_shardings`` applies the reference's tensor-parallel rule to flat
weight names and flax-layout shapes (``models/convert.py``'s);
``parallel/tensor.py`` carries it out on a model.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from mla_tpu_torch._device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """A [data, model] grid of devices (one process) or of ranks (a
    process group). ``shape`` maps each axis name to its size, as JAX's
    ``Mesh.shape`` does."""

    def __init__(self, devices: np.ndarray, axis_names=(DATA_AXIS, MODEL_AXIS),
                 local_device: Optional[torch.device] = None, device_mesh=None):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))
        self.size = int(devices.size)
        self.local_device = local_device
        self.device_mesh = device_mesh

    @property
    def multiprocess(self) -> bool:
        return self.device_mesh is not None

    def group(self, axis: str = DATA_AXIS):
        """The process group of ``axis`` (a process-group mesh only)."""
        if self.device_mesh is None:
            raise ValueError("a single-process mesh has no process group")
        return self.device_mesh.get_group(axis)

    def coordinate(self, rank: int) -> Tuple[int, int]:
        """(data, model) index of ``rank`` on a process-group mesh ("model"
        innermost)."""
        return divmod(rank, self.shape[MODEL_AXIS])

    def axis_devices(self, axis: str = DATA_AXIS) -> list:
        """One device per index of ``axis``: the first device of each of its
        rows (single-process mesh)."""
        grid = self.devices if axis == self.axis_names[0] else self.devices.T
        return [row[0] for row in grid]


def make_mesh(data_parallel: int = -1, model_parallel: int = 1,
              devices: Optional[Sequence[torch.device]] = None, device=None) -> Mesh:
    """Build a ("data", "model") mesh. data_parallel=-1 takes every device
    the model axis leaves. Without ``devices``, in a process group the grid
    is the group's ranks (``device`` is this rank's card, resolved as every
    entry point does), and in one process the visible cards."""
    in_group = devices is None and dist.is_initialized()
    if in_group:
        devs = list(range(dist.get_world_size()))
    elif devices is not None:
        devs = [torch.device(d) for d in devices]
    else:
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    n = len(devs)
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} must divide device count {n}")
    dp = n // model_parallel if data_parallel == -1 else data_parallel
    if dp < 1 or dp * model_parallel > n:
        raise ValueError(
            f"data_parallel*model_parallel = {dp}*{model_parallel} exceeds {n} devices")
    arr = np.empty(dp * model_parallel, dtype=object)
    arr[:] = devs[: dp * model_parallel]
    arr = arr.reshape(dp, model_parallel)
    if not in_group:
        return Mesh(arr)
    if dp * model_parallel != n:
        raise ValueError(f"data_parallel*model_parallel = {dp}*{model_parallel} leaves "
                         f"ranks of the {n}-process group off the mesh")
    from torch.distributed.device_mesh import init_device_mesh

    local = resolve_device(device)
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dmesh = init_device_mesh(kind, (dp, model_parallel), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    return Mesh(arr, local_device=local, device_mesh=dmesh)


class Placement:
    """A tensor's placement: ``mesh`` and ``spec``, one axis name (or None)
    per split dimension; dimensions past the spec's length are whole."""

    def __init__(self, mesh: Mesh, spec: Sequence[Optional[str]] = ()):
        self.mesh = mesh
        self.spec = tuple(spec)


def batch_sharding(mesh: Mesh, ndim: int = 1) -> Placement:
    """Leading axis over "data", rest replicated."""
    return Placement(mesh, (DATA_AXIS,) + (None,) * (ndim - 1))


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, ())


def _tp_spec_for(path: Tuple[str, ...], shape: Tuple[int, ...], hidden: int) -> tuple:
    """The TP rule: shard the hidden width of the embedded-mapping FCs and
    the attention projections over "model". ``shape`` is the flax layout.

    - Dense kernels [in, hidden]   -> (None, "model")   (column parallel)
    - Dense kernels [hidden, out]  -> ("model", None)   (row parallel)
    - biases [hidden]              -> ("model",)
    Everything else (convs, norms, small heads) replicates. A [hidden,
    hidden] kernel is column parallel: the output width is tested first.
    """
    name = "/".join(str(p) for p in path)
    if "kernel" in name and len(shape) == 2:
        if shape[1] == hidden:
            return (None, MODEL_AXIS)
        if shape[0] == hidden:
            return (MODEL_AXIS, None)
    if "bias" in name and len(shape) == 1 and shape[0] == hidden:
        return (MODEL_AXIS,)
    return ()


def tp_spec(path: Tuple[str, ...], shape: Tuple[int, ...], hidden: int, model: int) -> tuple:
    """The rule's spec for a ``model``-wide axis: replicated when the axis is
    1 wide, and when it cannot split a named dimension evenly (the
    divisibility guard)."""
    if model == 1:
        return ()
    spec = _tp_spec_for(path, shape, hidden)
    if any(a is not None and shape[i] % model for i, a in enumerate(spec)):
        return ()
    return spec


def _shape(leaf) -> Tuple[int, ...]:
    """A leaf's shape: an array's or tensor's, or the leaf itself when it
    is a tuple of ints (``models.convert.flat_shapes``' values)."""
    if isinstance(leaf, tuple) and all(isinstance(d, (int, np.integer)) for d in leaf):
        return tuple(int(d) for d in leaf)
    return tuple(int(d) for d in (leaf.shape if hasattr(leaf, "shape") else np.shape(leaf)))


def param_shardings(mesh: Mesh, params: Mapping, hidden_units: int) -> Any:
    """The placement of every leaf of ``params`` under the TP rule, in the
    same structure: a flat mapping ("params/block0/fc0/kernel" -> array,
    tensor or flax-layout shape) or nested dicts, whose keys join with "/".
    With model_parallel == 1 every placement is replicated."""
    model = mesh.shape[MODEL_AXIS]

    def walk(tree, prefix):
        out = {}
        for k, v in tree.items():
            path = prefix + tuple(str(k).split("/"))
            if isinstance(v, Mapping):
                out[k] = walk(v, path)
            else:
                out[k] = Placement(mesh, tp_spec(path, _shape(v), hidden_units, model))
        return out

    return walk(params, ())


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))


def shard_batch(batch: Any, mesh: Mesh) -> list:
    """A batch (an array, or a dict / list / tuple of arrays) split along
    its leading axis over the data axis of a single-process mesh: a list
    with one piece per data row, on that row's first device."""
    devs = mesh.axis_devices(DATA_AXIS)

    def piece(x, k):
        x = _as_tensor(x)
        if x.shape[0] % len(devs):
            raise ValueError(f"batch of {x.shape[0]} not divisible by data={len(devs)}")
        per = x.shape[0] // len(devs)
        return x[k * per:(k + 1) * per].to(devs[k])

    return [_map(lambda x, k=k: piece(x, k), batch) for k in range(len(devs))]


def put_local_batch(local: Any, mesh: Mesh, global_batch: int) -> Any:
    """This process's rows of a global batch, placed for its part of the
    mesh: on a process-group mesh the local rows stay on this rank's device
    (each rank computes on its own rows); on a single-process mesh the
    local rows are the whole batch, split by ``shard_batch``."""
    if mesh.multiprocess:
        n = mesh.shape[DATA_AXIS]
        if global_batch % n:
            raise ValueError(f"global batch {global_batch} not divisible by {n} processes")
        return _map(lambda x: _as_tensor(x).to(mesh.local_device), local)
    return shard_batch(local, mesh)


def put_replicated(arr: Any, mesh: Mesh) -> Any:
    """A value every shard reads: on a process-group mesh one copy on this
    rank's device (every process passes the same value); on a
    single-process mesh a list with one copy per data row, a device's
    copy shared by its rows."""
    if mesh.multiprocess:
        return _map(lambda x: _as_tensor(x).to(mesh.local_device), arr)
    copies = {}
    out = []
    for d in mesh.axis_devices(DATA_AXIS):
        if d not in copies:
            copies[d] = _map(lambda x, d=d: _as_tensor(x).to(d), arr)
        out.append(copies[d])
    return out


def fetch(arr: Any) -> np.ndarray:
    """Host value of a tensor, or of a list of per-shard pieces joined
    along the leading axis."""
    if isinstance(arr, (list, tuple)):
        return np.concatenate([fetch(a) for a in arr])
    return arr.detach().cpu().numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)
