"""Data parallelism across processes, one per GPU (counterpart of
lvt_tpu/parallel/)."""

from .collectives import all_gather, all_reduce, reduce_scatter
from .mesh import batch_rows, data_group, global_batch, global_batch_group

__all__ = [
    "all_gather",
    "all_reduce",
    "batch_rows",
    "data_group",
    "global_batch",
    "global_batch_group",
    "reduce_scatter",
]
