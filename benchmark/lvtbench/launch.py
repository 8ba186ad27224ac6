"""Ranks for a cell on several cards: one process a card, started with the
``spawn`` method, joined in one process group (NCCL on cards, gloo on the
CPU) at ``tcp://localhost:<free port>``. Each rank runs the cell
(``runner.run_cell``) with its rank and the world's size; rank 0's result
comes back to the caller, with the forbidden modules any rank loaded."""

import os
import socket
import sys
import time


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank(rank, world, port, bench_dir, cell, seed, seconds, trace, device_type, t0, queue):
    sys.path.insert(0, bench_dir)
    import torch
    import torch.distributed as dist

    from lvtbench import runner

    backend = "nccl" if device_type == "cuda" else "gloo"
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(rank)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank)
    try:
        device = torch.device(device_type, rank) if device_type == "cuda" else torch.device("cpu")
        out, lines, bad = runner.run_cell(cell, seed, seconds, trace, device, t0, rank, world)
        queue.put((rank, out, lines, bad))
    except BaseException as e:
        queue.put((rank, None, [f"rank {rank}: {type(e).__name__}: {e}"], []))
        raise
    finally:
        dist.destroy_process_group()


def spawn(world, cell, seed, seconds, trace, device_type, t0, timeout=3000):
    """rank 0's (result, lines) and the forbidden modules of every rank; a
    rank that fails raises here."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    bench_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [ctx.Process(target=_rank, args=(r, world, port, bench_dir, cell, seed, seconds,
                                             trace, device_type, t0, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    got, deadline = {}, time.monotonic() + timeout
    try:
        while len(got) < world:
            got_one = queue.get(timeout=max(1.0, deadline - time.monotonic()))
            got[got_one[0]] = got_one
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
                p.join()
    failed = [line for g in got.values() if g[1] is None for line in g[2]]
    if failed:
        raise RuntimeError("; ".join(failed))
    bad = sorted({m for g in got.values() for m in g[3]})
    return got[0][1], got[0][2], bad
