"""The ("data", "model") device mesh and batch placement (counterpart of
``mla_tpu/parallel/mesh.py`` lines 1-96; the tensor-parallel rule, lines
99-139, waits for ROADMAP.md queue A, item 9b).

PyTorch has no single-controller sharded array, so the port's mesh is a
small object in one of two forms:

- **One process** (the stream-sharded server, context-parallel scoring):
  ``devices`` is a [data, model] object array of ``torch.device``s, by
  default the visible cards. A device may appear more than once: each entry
  is one shard with tensors of its own, so one card can hold several
  shards, as the tests' CPU runs hold eight. ``shard_batch`` splits a batch
  into a list of per-shard pieces, one per data row, each on the row's
  first device.
- **A process group** (data-parallel training): the data axis spans the
  ranks; ``devices`` holds rank numbers, ``local_device`` this rank's card,
  and ``device_mesh`` the ``init_device_mesh`` over the group, whose
  ``group(axis)`` carries the axis' collectives. ``put_local_batch`` keeps
  this rank's rows on its device.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

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
