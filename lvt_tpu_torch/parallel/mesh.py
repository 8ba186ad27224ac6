"""The data-parallel layout of a training run (counterpart of
lvt_tpu/parallel/mesh.py).

``lvt_tpu`` jits its train step over a (data, model) mesh of devices. The
port runs one process per GPU (``engine/launch.py``), so its data axis is the
process group: TPU.MESH_DATA -1 means every process. Tensor parallelism
(TPU.MESH_MODEL > 1) and spatial sharding (TPU.SHARD_SPATIAL) are not
ported (ROADMAP.md queue 1 item 13).

``lvt_tpu``'s step sees the whole global batch: under its jit every
train-mode batch norm and the EMA codebook's statistics reduce over all of
it, and the step's random draws are made for all of it. The port's trainer
runs its forward pass inside ``global_batch(group)``, and the code that
reduces over the batch reads ``global_batch_group()``: None outside that
context, where the batch is the process's own.
"""

import contextlib
from typing import Optional

import torch.distributed as dist

_NOT_PORTED = "is not ported to lvt_tpu_torch yet (ROADMAP.md queue 1 item 13)"


def data_group(cfg) -> Optional[dist.ProcessGroup]:
    """The process group of the data axis: the default group when one is
    initialised (at any size, one included), else None. Refuses the layouts
    that are not ported and a data axis that is not every process."""
    if cfg.TPU.MESH_MODEL != 1:
        raise NotImplementedError(f"TPU.MESH_MODEL {cfg.TPU.MESH_MODEL} (tensor parallelism) "
                                  + _NOT_PORTED)
    if cfg.TPU.SHARD_SPATIAL:
        raise NotImplementedError("TPU.SHARD_SPATIAL (spatial sharding) " + _NOT_PORTED)
    if not (dist.is_available() and dist.is_initialized()):
        world, group = 1, None
    else:
        world, group = dist.get_world_size(), dist.group.WORLD
    if cfg.TPU.MESH_DATA not in (-1, world):
        raise ValueError(f"TPU.MESH_DATA {cfg.TPU.MESH_DATA}: the data axis spans every "
                         f"process (-1 or {world})")
    return group


_GLOBAL_BATCH: Optional[dist.ProcessGroup] = None


@contextlib.contextmanager
def global_batch(group: Optional[dist.ProcessGroup]):
    """Within: the batch each rank of ``group`` holds is its part of one
    global batch (None: the process's batch is the whole batch)."""
    global _GLOBAL_BATCH
    outer, _GLOBAL_BATCH = _GLOBAL_BATCH, group
    try:
        yield
    finally:
        _GLOBAL_BATCH = outer


def global_batch_group() -> Optional[dist.ProcessGroup]:
    """The group whose ranks hold the global batch, inside
    ``global_batch``; else None."""
    return _GLOBAL_BATCH


def batch_rows(group: Optional[dist.ProcessGroup], local: int):
    """(global batch size, first row of this rank) when each rank holds
    ``local`` rows: ranks hold consecutive equal parts in rank order, as
    ``lvt_tpu``'s batch sharding lays them out."""
    if group is None:
        return local, 0
    return local * dist.get_world_size(group), local * dist.get_rank(group)
