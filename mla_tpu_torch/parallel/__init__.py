"""Parallelism on the card (counterpart of ``mla_tpu/parallel``): the
process group and the model axis' collectives (``distributed``), the
("data", "model") device mesh, the placements and the tensor-parallel rule
(``mesh``), and the layers that carry the rule out (``tensor``). Data
parallelism trains one rank per process; tensor parallelism trains over
the "model" group of a process-group mesh, and serves over the rows of a
single-process one; the stream-sharded server and context-parallel scoring
shard over a single-process mesh."""

from mla_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    Placement,
    batch_sharding,
    fetch,
    make_mesh,
    param_shardings,
    put_local_batch,
    put_replicated,
    replicated,
    shard_batch,
)

_TENSOR = ("ModelAxis", "ColumnParallelDense", "RowParallelDense", "tensor_parallel",
           "shard_state_dict", "gather_state_dict", "place_sharded", "ShardedStateDict")


def __getattr__(name):
    # parallel.tensor imports the models, which import parallel.distributed:
    # loaded at first use, not with the package
    if name in _TENSOR:
        from mla_tpu_torch.parallel import tensor

        return getattr(tensor, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
