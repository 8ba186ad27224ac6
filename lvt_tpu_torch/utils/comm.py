"""Single-process subset of lvt_tpu/utils/comm.py: the port trains on one
card in one process, so rank 0 of a world of 1 (the reference's
world_size == 1 fast paths, comm.py:54-79). Multi-GPU training
(torch.distributed) is a later port."""

import numpy as np


def get_world_size() -> int:
    return 1


def get_rank() -> int:
    return 0


def is_main_process() -> bool:
    return True


def shared_random_seed() -> int:
    """A random seed (shared by every process, of which there is one)."""
    return int(np.random.randint(2 ** 31))
