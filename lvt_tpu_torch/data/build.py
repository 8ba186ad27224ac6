"""Loader builders (counterpart of lvt_tpu/data/build.py; reference
vidgen/data/build.py:41-107).

A ``torch.utils.data.DataLoader`` runs the mapper in DATALOADER.NUM_WORKERS
worker processes, forked as PyTorch does on Linux (0: in this process); the
workers load numpy files and never touch CUDA. Processes, not threads: the
eager train step holds the GIL while it dispatches its launches, and np.load
is mostly Python, so a thread loader and the step take turns instead of
overlapping. Batches are collated into stacked numpy arrays (not the
reference's list-of-dicts), so one copy moves the whole batch to the card.
"""

import logging
from typing import List, Optional

import numpy as np
import torch.utils.data

from ..utils import comm
from .catalog import DatasetCatalog
from .mapper import DatasetMapper
from .samplers import TrainingSampler

logger = logging.getLogger(__name__)

_ARRAY_KEYS = ("image", "image_sequence", "video", "class")


def get_dataset_dicts(dataset_names) -> List[dict]:
    assert len(dataset_names)
    all_dicts = [DatasetCatalog.get(name) for name in dataset_names]
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
    own, seeded in the worker from its DataLoader seed, so that workers do
    not all replace a refused sample by the same sequence; without workers
    one generator serves the process."""

    def __init__(self, dataset_dicts, mapper, max_retries=50):
        self._dicts = dataset_dicts
        self._mapper = mapper
        self._max_retries = max_retries
        self._fallback_rng = np.random.default_rng(0)
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


def build_train_loader(cfg, mapper: Optional[DatasetMapper] = None):
    """Infinite sharded training loader; global IMS_PER_BATCH split across
    host processes (reference build.py:41-107)."""
    world = comm.get_world_size()
    total = cfg.SOLVER.IMS_PER_BATCH
    assert total % world == 0 and total >= world, (
        f"SOLVER.IMS_PER_BATCH ({total}) must be divisible by the number of "
        f"processes ({world}).")
    per_proc = total // world

    dataset_dicts = get_dataset_dicts(cfg.DATASETS.TRAIN)
    if mapper is None:
        mapper = DatasetMapper(cfg, is_train=True)

    name = cfg.DATALOADER.SAMPLER_TRAIN
    assert name == "TrainingSampler", f"Unknown training sampler: {name}"
    seed = cfg.SEED if cfg.SEED > 0 else None
    sampler = TrainingSampler(len(dataset_dicts), seed=seed)

    logger.info(f"Train loader: {len(dataset_dicts)} samples, "
                f"{per_proc}/process of global batch {total}")
    workers = cfg.DATALOADER.NUM_WORKERS
    loader = torch.utils.data.DataLoader(
        _MappedDataset(dataset_dicts, mapper), batch_size=per_proc, sampler=sampler,
        num_workers=workers, collate_fn=collate, drop_last=True,
        persistent_workers=workers > 0)
    return loader, len(dataset_dicts)
