"""Launch one process per GPU (counterpart of lvt_tpu/engine/launch.py;
reference vidgen/engine/launch.py:25-96).

``lvt_tpu`` drives every device of a host from one process. The port, like
the reference, runs one process per card: ``launch`` spawns them, joins
them into a process group with an explicit timeout, gives each its card
before anything touches one, and runs ``main_func`` in each.
"""

import datetime
import logging
import socket
import time
from typing import Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..parallel import mesh
from ..utils import comm

logger = logging.getLogger(__name__)

__all__ = ["DEFAULT_TIMEOUT", "launch"]

# how long a collective may wait for the other ranks before it raises
DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)


def _find_free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(main_func, num_gpus_per_machine: int, num_machines: int = 1, machine_rank: int = 0,
           dist_url: str = "auto", backend: Optional[str] = None, args=(),
           timeout: datetime.timedelta = DEFAULT_TIMEOUT,
           join_timeout: Optional[float] = None):
    """Run ``main_func(*args)`` in ``num_gpus_per_machine`` processes on
    this machine, ranks ``machine_rank * num_gpus_per_machine + i`` of a
    world of ``num_machines * num_gpus_per_machine``.

    ``backend``: "nccl" or "gloo"; None means NCCL. NCCL needs a card per
    process. gloo runs on the CPU, or puts several ranks on one card (rank
    i on card i modulo the count), which NCCL refuses; it is used only when
    asked for. A world of one with no backend named runs ``main_func`` here,
    with no process group, and returns its result (the reference's fast
    path); with a backend named, one process is spawned into a one-rank
    group of it.

    ``args`` reach the processes as torch.multiprocessing passes them: a
    CPU tensor among them becomes one shared-memory storage that every rank
    reads and writes.

    ``timeout`` bounds each collective's wait for the other ranks. A rank
    that raises, or exits with another code than 0, makes ``launch`` raise
    once the others are stopped. ``join_timeout``, in seconds, stops every
    rank still running after that long and raises ``TimeoutError``.
    """
    world_size = num_machines * num_gpus_per_machine
    if world_size < 1:
        raise ValueError(f"launch: a world of {world_size} processes")
    if backend is None:
        if world_size == 1:
            return main_func(*args)
        backend = "nccl"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"launch: backend {backend!r}; use 'nccl' or 'gloo'")
    if dist_url == "auto":
        if num_machines != 1:
            raise ValueError("dist_url='auto' is for one machine; pass tcp://<host>:<port> of "
                             "machine 0")
        dist_url = f"tcp://127.0.0.1:{_find_free_port()}"
    context = mp.start_processes(
        _distributed_worker, nprocs=num_gpus_per_machine, join=False, start_method="spawn",
        args=(main_func, world_size, num_gpus_per_machine, machine_rank, dist_url, backend,
              args, timeout))
    deadline = None if join_timeout is None else time.monotonic() + join_timeout
    # join() raises, after stopping the rest, once a rank has failed
    while not context.join(timeout=1.0):
        if deadline is not None and time.monotonic() > deadline:
            for p in context.processes:
                if p.is_alive():
                    p.kill()
            for p in context.processes:
                p.join(10)
            raise TimeoutError(f"launch: ranks still running after {join_timeout} s; killed")
    return None


def _distributed_worker(local_rank, main_func, world_size, num_gpus_per_machine, machine_rank,
                        dist_url, backend, args, timeout):
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("launch: the NCCL backend needs a CUDA card in every process")
        if num_gpus_per_machine > torch.cuda.device_count():
            raise RuntimeError(f"launch: {num_gpus_per_machine} NCCL processes on a machine "
                               f"with {torch.cuda.device_count()} card(s); gloo can share one")
    if torch.cuda.is_available():
        # before the process group or a kernel touches a card
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    global_rank = machine_rank * num_gpus_per_machine + local_rank
    dist.init_process_group(backend=backend, init_method=dist_url, world_size=world_size,
                            rank=global_rank, timeout=timeout)
    num_machines = world_size // num_gpus_per_machine
    for i in range(num_machines):  # every rank creates every group, in one order
        ranks = list(range(i * num_gpus_per_machine, (i + 1) * num_gpus_per_machine))
        group = dist.new_group(ranks)
        if i == machine_rank:
            comm._LOCAL_PROCESS_GROUP = group
    comm.synchronize()
    main_func(*args)
    comm.synchronize()
    comm._gloo_group.cache_clear()
    comm._LOCAL_PROCESS_GROUP = None
    mesh._GROUPS.clear()
    dist.destroy_process_group()
