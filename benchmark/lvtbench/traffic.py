"""The inputs of a traffic mix, made from the seed.

Generation: the priming frames of batch i, (batch, n_prime, H, W, 3) floats
holding whole numbers in [0, 255], noise drawn on the device from the seed
and i; the generator batch i samples its tokens from, seeded from the seed
and i (the check seeds one alike to replay its draws). Training: a pool of distinct code clips drawn on the host from the
seed, served in batches by a loader that walks a seed-drawn order of the
pool, one new order a pass, so that consecutive batches share no clip
within a pass.
"""

import numpy as np
import torch

from .weights import CLIPS, FRAMES, SAMPLING, stream_seed


def priming_frames(seed: int, i: int, batch: int, n_prime: int, height: int, width: int,
                   device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, FRAMES, i))
    x = torch.rand((batch, n_prime, height, width, 3), generator=gen, device=device)
    return torch.floor(x * 256.0).clamp_(max=255.0)


def sampling_generator(seed: int, i: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, SAMPLING, i))


class ClipLoader:
    """Host batches {"video": (batch, nc, T, H, W) int32} of the seed's pool
    of ``pool`` clips; iterating starts again from the first batch."""

    def __init__(self, seed: int, pool: int, batch: int, nc: int, nv: int, shape):
        if pool < batch:
            raise ValueError(f"a pool of {pool} clips cannot serve batches of {batch}")
        rng = np.random.default_rng(stream_seed(seed, CLIPS))
        self.clips = rng.integers(0, nv, size=(pool, nc) + tuple(shape), dtype=np.int32)
        self.seed, self.batch = seed, batch

    def order(self, n: int) -> np.ndarray:
        """The pool's order in pass n."""
        return np.random.default_rng(stream_seed(self.seed, CLIPS, n + 1)).permutation(
            len(self.clips))

    def __iter__(self):
        per_pass = len(self.clips) // self.batch
        k = 0
        while True:
            order = self.order(k // per_pass)
            j = (k % per_pass) * self.batch
            yield {"video": self.clips[order[j:j + self.batch]]}
            k += 1
