"""The process group (counterpart of ``mla_tpu/parallel/distributed.py``).

One call per process, before the model is built:

    from mla_tpu_torch.parallel.distributed import initialize
    initialize()          # reads the launcher's environment
    fit(cfg)              # data parallel over every rank

``python -m torch.distributed.run --nproc_per_node N -m mla_tpu_torch
train ...`` sets the environment ``initialize`` reads. Without one it is a
no-op, so the same entry point serves one process and many. Besides the
group it holds the helpers every parallel path shares: the reference's
``is_primary`` and ``local_batch_slice`` (by the rank's data coordinate
when a "model" axis is ``model_parallel`` ranks wide: the ranks of one
model group hold the same rows) and the model axis' four conjugate pairs, each a
``torch.autograd.Function`` whose backward is its forward's transpose:

  copy_to_model      identity           | all-reduce
  reduce_from_model  all-reduce         | identity
  scatter_to_model   this rank's slice  | all-gather
  gather_from_model  all-gather         | this rank's slice

Every one travels as an f32 ``all_reduce`` (an all-gather is the sum of
zero-padded slices, which is exact), the one collective gloo carries for
CUDA tensors too, so two ranks sharing one card (gloo; NCCL refuses) run
them; partial sums are taken in f32 and cast back to the input's dtype.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from mla_tpu_torch._device import rank_cuda_index

_TIMEOUT = datetime.timedelta(minutes=10)


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def _init_method(address: str) -> str:
    """"host:port" -> tcp://host:port; a URL (tcp://, file://, env://) as
    it is."""
    return address if "://" in address else f"tcp://{address}"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> bool:
    """Bring up the default process group; returns True if one is up.

    Each argument resolves in this order: the explicit value; the
    launcher's environment (MASTER_ADDR:MASTER_PORT, WORLD_SIZE, RANK, as
    ``python -m torch.distributed.run`` sets them); the reference's names
    (JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES, JAX_PROCESS_ID). A group is
    built once an address and a process count are known: of any size from
    the arguments or the launcher, of more than one process from the
    reference's names (as the reference does). Otherwise nothing happens
    and the result is False. ``coordinator_address`` is "host:port" or an
    init URL (``file:///path`` for a store on a shared file system).

    ``backend`` defaults to "nccl" when a card is visible and "gloo"
    otherwise; "gloo" also runs several ranks on one card, which NCCL
    refuses. With a card, the process first binds ``cuda:LOCAL_RANK``
    (modulo the visible cards), as every rank must before the group."""
    if dist.is_initialized():
        return True
    launcher_addr = (f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
                     if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT")
                     else None)
    launcher_n = _env_int("WORLD_SIZE")
    address = (coordinator_address or launcher_addr
               or os.environ.get("JAX_COORDINATOR_ADDRESS"))
    n = num_processes if num_processes is not None else _env_int("WORLD_SIZE",
                                                                 "JAX_NUM_PROCESSES")
    rank = process_id if process_id is not None else _env_int("RANK", "JAX_PROCESS_ID")
    if not address or not n:
        return False
    if n == 1 and num_processes is None and launcher_n is None:
        return False  # one process by the reference's names: nothing to do
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if torch.cuda.is_available():
        torch.cuda.set_device(rank_cuda_index())
    dist.init_process_group(backend, init_method=_init_method(address), world_size=n,
                            rank=rank or 0, timeout=_TIMEOUT)
    return True


def shutdown() -> None:
    """Destroy the default group if one is up (every rank calls it at the
    end of a run, so no process waits on a peer that has gone)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the process that writes checkpoints and logs."""
    return process_index() == 0


def local_batch_slice(global_batch: int, model_parallel: int = 1) -> slice:
    """This rank's contiguous slice of a global batch. The ranks form a
    [data, model_parallel] grid, "model" innermost: the data axis splits
    the batch, and the ranks of one model group take the same rows."""
    if process_count() % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} must divide "
                         f"{process_count()} processes")
    i, n = process_index() // model_parallel, process_count() // model_parallel
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} processes")
    per = global_batch // n
    return slice(i * per, (i + 1) * per)


def gather_rows(local: torch.Tensor, rows: slice, global_rows: int, group=None) -> torch.Tensor:
    """The global batch on every rank from each rank's ``rows``: each rank
    writes its rows into a zeroed [global_rows, ...] buffer and the buffers
    are summed, which is exact (every element is one value plus zeros) and
    uses only ``all_reduce``, which gloo carries for CUDA tensors too."""
    buf = local.new_zeros((global_rows,) + tuple(local.shape[1:]))
    buf[rows] = local
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf


def _sum_f32(x: torch.Tensor, group) -> torch.Tensor:
    """The f32 sum of ``x`` over ``group``, cast back to ``x``'s dtype."""
    out = x.float().contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out.to(x.dtype)


def _slice(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n, k = dist.get_world_size(group), dist.get_rank(group)
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not split over {n} ranks")
    return x.narrow(dim, k * (x.shape[dim] // n), x.shape[dim] // n).contiguous()


def all_gather_cat(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` joined along ``dim`` in rank order (no autograd):
    zero-padded slices summed in f32, cast back to ``x``'s dtype."""
    n, k = dist.get_world_size(group), dist.get_rank(group)
    dim = dim % x.dim()
    shape = list(x.shape)
    shape[dim] *= n
    buf = x.new_zeros(shape, dtype=torch.float32)
    buf.narrow(dim, k * x.shape[dim], x.shape[dim]).copy_(x)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum_f32(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum_f32(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _slice(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return all_gather_cat(grad, ctx.dim, ctx.group), None, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_cat(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _slice(grad, ctx.dim, ctx.group), None, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the backward sums the ranks' gradients (a
    replicated input to a layer whose ranks each see part of its use)."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's partial ``x``; identity backward."""
    return _ReduceFromModel.apply(x, group)


def scatter_to_model(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's slice of ``x`` along ``dim``; the backward all-gathers."""
    return _ScatterToModel.apply(x, dim, group)


def gather_from_model(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` joined along ``dim`` in rank order; the backward
    takes this rank's slice."""
    return _GatherFromModel.apply(x, dim, group)
