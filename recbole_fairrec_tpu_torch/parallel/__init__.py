"""The parallel layer: a ``data × model`` mesh on ``torch.distributed``,
row-sharded embedding tables, the item-sharded top-k and sharded graph
propagation. Counterpart of ``recbole_fairrec_tpu/parallel/``."""

from .embedding import bucket_allgather_lookup, pad_table_rows, shard_table, sharded_gather
from .eval import distributed_topk_scores, local_candidates, merge_candidates
from .mesh import (
    BatchSplit,
    Mesh,
    RowShard,
    batch_sharding,
    batch_split,
    make_mesh,
    param_sharding,
    replicate,
    shard_params,
)
from .spmm import pad_rows_to_shards, shard_propagation_matrix, sharded_propagate

__all__ = [
    "BatchSplit",
    "Mesh",
    "RowShard",
    "batch_sharding",
    "batch_split",
    "make_mesh",
    "param_sharding",
    "replicate",
    "shard_params",
    "shard_table",
    "sharded_gather",
    "bucket_allgather_lookup",
    "pad_table_rows",
    "distributed_topk_scores",
    "local_candidates",
    "merge_candidates",
    "pad_rows_to_shards",
    "shard_propagation_matrix",
    "sharded_propagate",
]
