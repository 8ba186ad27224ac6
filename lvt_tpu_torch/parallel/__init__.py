"""Data and tensor parallelism across processes, one per GPU (counterpart of
lvt_tpu/parallel/)."""

from .collectives import (all_gather, all_reduce, copy_to_model, gather_features,
                          max_over_model, reduce_from_model, reduce_scatter)
from .mesh import (batch_rows, data_group, data_rank, global_batch, global_batch_group, layout,
                   model_group, model_parallel_group, tensor_parallel)
from .sharding import gather_tree, shard_tree, sharded_field_names, tp_dim, tp_dims

__all__ = [
    "all_gather",
    "all_reduce",
    "batch_rows",
    "copy_to_model",
    "data_group",
    "data_rank",
    "gather_features",
    "gather_tree",
    "global_batch",
    "global_batch_group",
    "layout",
    "max_over_model",
    "model_group",
    "model_parallel_group",
    "reduce_from_model",
    "reduce_scatter",
    "shard_tree",
    "sharded_field_names",
    "tensor_parallel",
    "tp_dim",
    "tp_dims",
]
