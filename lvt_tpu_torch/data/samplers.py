"""Index samplers (reference: vidgen/data/samplers/distributed_sampler.py).

numpy-RNG rewrites of the torch samplers. The reference's
RepeatFactorTrainingSampler is intentionally not rebuilt: it reads
annotation fields no vidgen dataset has and references a config key that
does not exist (build.py:90) — dead detectron2 leftover (SURVEY.md §2.4).
"""

import itertools
from typing import Optional

import numpy as np

from ..utils import comm


class TrainingSampler:
    """Infinite shuffled index stream, sharded rank::world_size
    (reference distributed_sampler.py:14-56)."""

    def __init__(self, size: int, shuffle: bool = True, seed: Optional[int] = None):
        assert size > 0
        self._size = size
        self._shuffle = shuffle
        if seed is None:
            seed = comm.shared_random_seed()
        self._seed = int(seed)
        self._rank = comm.get_rank()
        self._world_size = comm.get_world_size()

    def __iter__(self):
        yield from itertools.islice(
            self._infinite_indices(), self._rank, None, self._world_size)

    def _infinite_indices(self):
        g = np.random.default_rng(self._seed)
        while True:
            if self._shuffle:
                yield from g.permutation(self._size)
            else:
                yield from range(self._size)


class InferenceSampler:
    """Contiguous per-rank shard over the exact dataset, with optional
    random subset of n_samples (reference distributed_sampler.py:174-203)."""

    def __init__(self, size: int, n_samples: int = 0, seed: int = 0):
        assert size > 0
        self._size = size
        rank = comm.get_rank()
        world = comm.get_world_size()
        shard_size = (size - 1) // world + 1
        begin = shard_size * rank
        end = min(shard_size * (rank + 1), size)
        self._local_indices = list(range(begin, end))
        if n_samples > 0:
            g = np.random.default_rng(seed)
            self._local_indices = list(
                g.choice(self._local_indices, min(n_samples, len(self._local_indices)),
                         replace=False))

    def __iter__(self):
        yield from self._local_indices

    def __len__(self):
        return len(self._local_indices)
