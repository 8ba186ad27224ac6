"""The (data, model) layout of a run across processes (counterpart of
lvt_tpu/parallel/mesh.py).

``lvt_tpu`` jits its train step over a (data, model) mesh of devices. The
port runs one process per GPU (``engine/launch.py``) and lays the world of
processes out the same way: with M = TPU.MESH_MODEL, rank r sits at data
index r // M and model index r % M (``lvt_tpu``'s reshape of the device list
to (data, model) puts adjacent devices on the model axis). The ranks of one
data index form a model group: they hold the same batch rows and draw the
same random numbers, and tensor parallelism (``parallel/sharding.py``) splits
the weights over them. The ranks of one model index form a data group, over
which the gradients are averaged. TPU.MESH_DATA is -1 or world // M; M must
divide the world. With TPU.SHARD_SPATIAL the ranks of a model group hold
different rows of the same frames instead: the trainer gives rank r the
(r % M)-th of M equal bands of rows of each 4-D ``image`` batch
(``lvt_tpu``'s ``spatial_batch_sharding``), and the VQ-VAE's step runs inside
``spatial_parallel(model group)`` (``parallel/spatial.py``).

``lvt_tpu``'s step sees the whole global batch: under its jit every
train-mode batch norm and the EMA codebook's statistics reduce over all of
it, and the step's random draws are made for all of it. The port's trainer
runs its forward pass inside ``global_batch(data group)``, and the code that
reduces over the batch reads ``global_batch_group()``: None outside that
context, where the batch is the process's own. Likewise the forward passes
read ``model_parallel_group()``, which ``tensor_parallel(model group)`` sets:
None outside it, where every weight is whole; and ``spatial_group()``,
which ``spatial_parallel(model group)`` sets: None outside it, where every
rank holds whole frames.
"""

import contextlib
from typing import Dict, Optional, Tuple

import torch.distributed as dist

def _world() -> Tuple[int, int]:
    """(world size, rank): (1, 0) with no process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def layout(cfg, world: Optional[int] = None) -> Tuple[int, int]:
    """(data, model) sizes of the world (this process's, or one of
    ``world`` processes) under cfg's TPU.MESH_DATA and TPU.MESH_MODEL.
    Refuses a model axis that does not divide the world and a data axis
    other than the rest of it."""
    if world is None:
        world, _ = _world()
    model = cfg.TPU.MESH_MODEL
    if model < 1 or world % model:
        raise ValueError(f"TPU.MESH_MODEL {model} does not divide the world of {world} "
                         f"process(es): start a multiple of {model} (--num-gpus)")
    data = world // model
    if cfg.TPU.MESH_DATA not in (-1, data):
        raise ValueError(f"TPU.MESH_DATA {cfg.TPU.MESH_DATA}: the data axis spans the rest of "
                         f"the world (-1 or {data} = {world} processes / TPU.MESH_MODEL {model})")
    return data, model


def data_rank(cfg) -> Tuple[int, int]:
    """(this process's data index, the data axis's size): the rank and world
    that the loader, the seeds and the trainer read (rank // M, world // M)."""
    data, model = layout(cfg)
    return _world()[1] // model, data


_GROUPS: Dict[Tuple[int, int], Tuple[dist.ProcessGroup, dist.ProcessGroup]] = {}


def _groups(model: int):
    """(data group, model group) of this rank for a model axis of ``model``.
    ``dist.new_group`` must be called by every rank for every group, in one
    order: all of them are made once, on first use."""
    world, rank = _world()
    key = (world, model)
    if key not in _GROUPS:
        mine = [None, None]
        for m in range(model):  # data groups: one model index each
            g = dist.new_group(list(range(m, world, model)))
            if rank % model == m:
                mine[0] = g
        for d in range(world // model):  # model groups: one data index each
            g = dist.new_group(list(range(d * model, (d + 1) * model)))
            if rank // model == d:
                mine[1] = g
        _GROUPS[key] = tuple(mine)
    return _GROUPS[key]


def data_group(cfg) -> Optional[dist.ProcessGroup]:
    """The process group of the data axis: None with no process group; the
    default group when the model axis is 1 (at any size, one included); else
    this rank's data subgroup."""
    _, model = layout(cfg)
    if not (dist.is_available() and dist.is_initialized()):
        return None
    if model == 1:
        return dist.group.WORLD
    return _groups(model)[0]


def model_group(cfg) -> Optional[dist.ProcessGroup]:
    """This rank's model group (the ranks that share its data index), or None
    when TPU.MESH_MODEL is 1."""
    _, model = layout(cfg)
    return None if model == 1 else _groups(model)[1]


_GLOBAL_BATCH: Optional[dist.ProcessGroup] = None
_MODEL_PARALLEL: Optional[dist.ProcessGroup] = None
_SPATIAL: Optional[dist.ProcessGroup] = None


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


@contextlib.contextmanager
def tensor_parallel(group: Optional[dist.ProcessGroup]):
    """Within: the weights that ``parallel/sharding.py`` splits are held as
    this rank's part of them over ``group`` (None: whole)."""
    global _MODEL_PARALLEL
    outer, _MODEL_PARALLEL = _MODEL_PARALLEL, group
    try:
        yield
    finally:
        _MODEL_PARALLEL = outer


def model_parallel_group() -> Optional[dist.ProcessGroup]:
    """The model group inside ``tensor_parallel``; else None."""
    return _MODEL_PARALLEL


@contextlib.contextmanager
def spatial_parallel(group: Optional[dist.ProcessGroup]):
    """Within: each rank of ``group`` holds its band of rows of the same
    frames, the bands in rank order (None: whole frames)."""
    global _SPATIAL
    outer, _SPATIAL = _SPATIAL, group
    try:
        yield
    finally:
        _SPATIAL = outer


def spatial_group() -> Optional[dist.ProcessGroup]:
    """The group whose ranks hold bands of rows, inside
    ``spatial_parallel``; else None."""
    return _SPATIAL


def batch_rows(group: Optional[dist.ProcessGroup], local: int):
    """(global batch size, first row of this rank) when each rank holds
    ``local`` rows: ranks hold consecutive equal parts in rank order, as
    ``lvt_tpu``'s batch sharding lays them out."""
    if group is None:
        return local, 0
    return local * dist.get_world_size(group), local * dist.get_rank(group)
