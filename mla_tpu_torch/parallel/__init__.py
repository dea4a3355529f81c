"""Parallelism on the card (counterpart of ``mla_tpu/parallel``): the
process group (``distributed``), the ("data", "model") device mesh and the
batch placement helpers (``mesh``). Data parallelism trains one rank per
process; the stream-sharded server and context-parallel scoring shard over
a single-process mesh. Tensor parallelism is not ported yet (ROADMAP.md
queue A, item 9b)."""

from mla_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    fetch,
    make_mesh,
    put_local_batch,
    put_replicated,
    shard_batch,
)
