"""Seeding (counterpart of lvt_tpu/utils/env.py:seed_all_rng)."""

import datetime
import os
import random

import numpy as np
import torch

__all__ = ["seed_all_rng"]


def seed_all_rng(seed=None) -> int:
    """Seed python's, numpy's and torch's global generators; returns the seed
    used. None or a negative seed draws a fresh one (reference env.py:15-35).
    The trainer's own draws come from explicit torch.Generators."""
    if seed is None or seed < 0:
        seed = (
            os.getpid()
            + int(datetime.datetime.now().strftime("%S%f"))
            + int.from_bytes(os.urandom(2), "big")
        )
    np.random.seed(seed % (2 ** 32))
    random.seed(seed)
    torch.manual_seed(seed)
    return seed
