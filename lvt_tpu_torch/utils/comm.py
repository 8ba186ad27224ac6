"""Cross-process communication over torch.distributed (counterpart of
lvt_tpu/utils/comm.py; reference vidgen/utils/comm.py).

The port runs one process per GPU (``engine/launch.py``). These helpers are
the host side of that world: rank and size, barriers, and the exchange of
small picklable objects, which runs on a gloo side group as the reference's
does (an NCCL group would move the pickled bytes through the card). With no
process group initialised every function takes the world-of-one path: one
rank, nothing to wait for, ``[data]`` gathered.
"""

import functools
from typing import Any, Dict, List

import numpy as np
import torch
import torch.distributed as dist

# the processes of this machine; set by engine.launch
_LOCAL_PROCESS_GROUP = None


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_world_size() -> int:
    return dist.get_world_size() if _initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if _initialized() else 0


def get_local_rank() -> int:
    """The rank within this machine: the index of the process's card."""
    if not _initialized():
        return 0
    if _LOCAL_PROCESS_GROUP is None:  # a world started outside launch(): one machine
        return get_rank()
    return dist.get_rank(group=_LOCAL_PROCESS_GROUP)


def get_local_size() -> int:
    """The number of processes on this machine."""
    if not _initialized():
        return 1
    if _LOCAL_PROCESS_GROUP is None:
        return get_world_size()
    return dist.get_world_size(group=_LOCAL_PROCESS_GROUP)


def is_main_process() -> bool:
    return get_rank() == 0


def synchronize() -> None:
    """Barrier across every process (reference comm.py:122-136); under NCCL
    on the card of this process."""
    if get_world_size() == 1:
        return
    if dist.get_backend() == dist.Backend.NCCL:
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


@functools.lru_cache()
def _gloo_group():
    """The world as a gloo group: the default group itself under gloo, a
    side group under NCCL (created once, by every rank)."""
    if dist.get_backend() == dist.Backend.NCCL:
        return dist.new_group(backend="gloo")
    return dist.group.WORLD


def all_gather(data: Any) -> List[Any]:
    """Every process's ``data`` (any picklable object) in rank order. The
    objects may differ in size from rank to rank: per-video lists when the
    test set does not divide by the world, dicts (lvt_tpu/utils/comm.py:46-76
    says why a uniform-array gather cannot carry them)."""
    if get_world_size() == 1:
        return [data]
    out = [None] * get_world_size()
    dist.all_gather_object(out, data, group=_gloo_group())
    return out


def gather(data: Any, dst: int = 0) -> List[Any]:
    """Every process's ``data`` in rank order on rank ``dst``; [] on the
    others."""
    if get_world_size() == 1:
        return [data]
    rank = get_rank()
    out = [None] * get_world_size() if rank == dst else None
    dist.gather_object(data, out, dst=dst, group=_gloo_group())
    return out if rank == dst else []


def shared_random_seed() -> int:
    """A random seed that every process shares: rank 0's draw (reference
    comm.py:220-231)."""
    return int(all_gather(int(np.random.randint(2 ** 31)))[0])


def reduce_dict(input_dict: Dict[str, Any], average: bool = True) -> Dict[str, Any]:
    """The values (numbers or one-element tensors) summed, or averaged, over
    every process, in one all-reduce; keys in sorted order. Every process
    gets the result (the reference reduces to rank 0 alone), so a check on
    it, such as the trainer's non-finite-loss guard, trips on every rank
    together. Tensors keep their device and come back as tensors; numbers
    come back as floats."""
    world = get_world_size()
    if world < 2:
        return input_dict
    names = sorted(input_dict)
    device = next((v.device for v in input_dict.values() if isinstance(v, torch.Tensor)),
                  torch.device("cpu"))
    if dist.get_backend() == dist.Backend.NCCL and device.type != "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    with torch.no_grad():
        values = torch.stack([torch.as_tensor(input_dict[k], dtype=torch.float64).to(device)
                              .reshape(()) for k in names])
        dist.all_reduce(values)
        if average:
            values = values / world
    return {k: (v.to(input_dict[k].dtype) if isinstance(input_dict[k], torch.Tensor)
                else float(v)) for k, v in zip(names, values)}
