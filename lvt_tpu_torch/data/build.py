"""Loader builders (counterpart of lvt_tpu/data/build.py; reference
vidgen/data/build.py:41-145).

A ``torch.utils.data.DataLoader`` runs the mapper in DATALOADER.NUM_WORKERS
worker processes, forked as PyTorch does on Linux (0: in this process); the
workers load numpy files and never touch CUDA. Processes, not threads: the
eager train step holds the GIL while it dispatches its launches, and np.load
is mostly Python, so a thread loader and the step take turns instead of
overlapping. Batches are collated into stacked numpy arrays (not the
reference's list-of-dicts), so one copy moves the whole batch to the card.
The native IO library (``native/``) is built and loaded before the workers
fork, so that they inherit it instead of each building it at its first frame.
"""

import logging
from typing import List, Optional

import numpy as np
import torch.utils.data

from .. import native
from ..parallel.mesh import data_rank
from ..utils import comm
from .catalog import DatasetCatalog
from .mapper import DatasetMapper
from .samplers import InferenceSampler, TrainingSampler

logger = logging.getLogger(__name__)

_ARRAY_KEYS = ("image", "image_sequence", "video", "class")


def get_dataset_dicts(dataset_names) -> List[dict]:
    """The datasets' dicts, concatenated. Across processes rank 0 lists them
    first and the others after it: a dataset's first listing writes a cache
    of its paths into its root (utils/image.py, datasets/latents.py), and a
    rank that read that file while another wrote it would read it cut."""
    assert len(dataset_names)
    if not comm.is_main_process():
        comm.synchronize()
    all_dicts = [DatasetCatalog.get(name) for name in dataset_names]
    if comm.is_main_process():
        comm.synchronize()
    for name, dicts in zip(dataset_names, all_dicts):
        assert len(dicts), f"Dataset '{name}' is empty!"
    return [d for dicts in all_dicts for d in dicts]


def collate(samples: List[dict]) -> dict:
    """Stack array fields; keep other metadata as lists."""
    keys = set(samples[0])
    for s in samples[1:]:
        if set(s) != keys:
            # stacking assumes one schema per batch; mixing e.g. a
            # class-labeled kinetics dataset with unlabeled bair would
            # otherwise KeyError or silently drop labels
            raise ValueError(
                f"cannot collate heterogeneous samples: {sorted(keys)} vs "
                f"{sorted(set(s))} — the batched datasets produce different "
                f"field sets")
    out = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        if k in _ARRAY_KEYS:
            out[k] = np.stack([np.asarray(v) for v in vals])
        else:
            out[k] = vals
    return out


class _MappedDataset(torch.utils.data.Dataset):
    """Dataset dicts through the mapper; a sample the mapper refuses (None)
    is replaced by another drawn at random (reference MapDataset,
    data/common.py:37-58). Each worker process draws from a generator of its
    own, seeded in the worker from its DataLoader seed (which comes from the
    process's torch seed, SEED + rank), so that workers, on one rank or on
    several, do not all replace a refused sample by the same sequence;
    without workers one generator, seeded with the rank (the data axis's
    under tensor parallelism: ``parallel.mesh.data_rank``), serves the
    process."""

    def __init__(self, dataset_dicts, mapper, max_retries=50, rank=None):
        self._dicts = dataset_dicts
        self._mapper = mapper
        self._max_retries = max_retries
        self._fallback_rng = np.random.default_rng(comm.get_rank() if rank is None else rank)
        self._worker_rng = None  # made in the worker, on its first replacement

    def __len__(self):
        return len(self._dicts)

    def _rng(self):
        info = torch.utils.data.get_worker_info()
        if info is None:
            return self._fallback_rng
        if self._worker_rng is None:
            self._worker_rng = np.random.default_rng(info.seed)
        return self._worker_rng

    def __getitem__(self, idx):
        for _ in range(self._max_retries):
            d = self._mapper(self._dicts[idx])
            if d is not None:
                return d
            idx = int(self._rng().integers(len(self._dicts)))
        raise RuntimeError(f"Mapper failed {self._max_retries} times in a row")


class _DataAxisInferenceSampler(InferenceSampler):
    """``InferenceSampler``'s shard of a given rank of a given world: the data
    axis's, under tensor parallelism (the ranks of a model group evaluate
    the same videos together)."""

    def __init__(self, size: int, n_samples: int, rank: int, world: int, seed: int = 0):
        assert size > 0
        self._size = size
        shard_size = (size - 1) // world + 1
        self._local_indices = list(range(shard_size * rank, min(shard_size * (rank + 1), size)))
        if n_samples > 0:
            g = np.random.default_rng(seed)
            self._local_indices = list(g.choice(
                self._local_indices, min(n_samples, len(self._local_indices)), replace=False))


def build_train_loader(cfg, mapper: Optional[DatasetMapper] = None):
    """Infinite sharded training loader; global IMS_PER_BATCH split across
    processes, each rank reading its own part (reference build.py:41-107).
    With SEED <= 0 the sampler's seed is rank 0's draw, shared by all. Under
    tensor parallelism the batch is split over the data axis: the ranks of a
    model group read the same rows."""
    rank, world = data_rank(cfg)
    total = cfg.SOLVER.IMS_PER_BATCH
    assert total % world == 0 and total >= world, (
        f"SOLVER.IMS_PER_BATCH ({total}) must be divisible by the number of "
        f"data-parallel processes ({world}).")
    per_proc = total // world

    dataset_dicts = get_dataset_dicts(cfg.DATASETS.TRAIN)
    if mapper is None:
        mapper = DatasetMapper(cfg, is_train=True)

    name = cfg.DATALOADER.SAMPLER_TRAIN
    assert name == "TrainingSampler", f"Unknown training sampler: {name}"
    seed = cfg.SEED if cfg.SEED > 0 else None
    sampler = TrainingSampler(len(dataset_dicts), seed=seed)
    sampler._rank, sampler._world_size = rank, world  # the data axis's (the process's at M = 1)

    logger.info(f"Train loader: {len(dataset_dicts)} samples, "
                f"{per_proc}/process of global batch {total}")
    workers = cfg.DATALOADER.NUM_WORKERS
    native.available()
    loader = torch.utils.data.DataLoader(
        _MappedDataset(dataset_dicts, mapper, rank=rank), batch_size=per_proc, sampler=sampler,
        num_workers=workers, collate_fn=collate, drop_last=True,
        persistent_workers=workers > 0)
    return loader, len(dataset_dicts)


def build_test_loader(cfg, dataset_name: str, mapper: Optional[DatasetMapper] = None,
                      batch_size: int = 1):
    """One finite pass over the dataset in order (or over TEST.N_SAMPLES of
    it, drawn once from a fixed seed), batch 1 by default, the last batch
    kept (reference build.py:110-145); each data-parallel rank reads its
    shard."""
    dataset_dicts = get_dataset_dicts([dataset_name])
    if mapper is None:
        mapper = DatasetMapper(cfg, is_train=False)
    rank, world = data_rank(cfg)
    sampler = _DataAxisInferenceSampler(len(dataset_dicts), cfg.TEST.N_SAMPLES, rank, world)
    native.available()
    return torch.utils.data.DataLoader(
        _MappedDataset(dataset_dicts, mapper, rank=rank), batch_size=batch_size, sampler=sampler,
        num_workers=cfg.DATALOADER.NUM_WORKERS, collate_fn=collate, drop_last=False)
