"""Training checkpoints with torch.save (the contract of
lvt_tpu/checkpoint/orbax_io.py: save, latest, load, prune, resume_or_load).

One file per step, ``<OUTPUT_DIR>/checkpoints/ckpt_<step>.pt``, holds the
whole training tree: nested dicts and lists of tensors and numbers. A save
writes a temporary file and renames it, so a checkpoint that exists is
complete. Loads read onto the CPU with ``weights_only=True`` and are placed
into the structure (device and dtype) of a target tree.
"""

import logging
import os
import re
import tempfile
from typing import Any, Optional

import torch

logger = logging.getLogger(__name__)

_CKPT_DIR = "checkpoints"
_CKPT_PREFIX = "ckpt_"
_CKPT_SUFFIX = ".pt"


def checkpoint_dir(output_dir: str) -> str:
    return os.path.join(os.path.abspath(output_dir), _CKPT_DIR)


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_cpu(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


def save_checkpoint(output_dir: str, step: int, tree: Any) -> str:
    d = checkpoint_dir(output_dir)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{_CKPT_PREFIX}{step}{_CKPT_SUFFIX}")
    fd, tmp = tempfile.mkstemp(suffix=".tmp", dir=d)
    os.close(fd)
    try:
        torch.save(_to_cpu(tree), tmp)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise
    logger.info(f"Saved checkpoint to {path}")
    return path


def _checkpoint_steps(output_dir: str):
    """Sorted [(step, name)] of the checkpoints under output_dir."""
    d = checkpoint_dir(output_dir)
    if not os.path.isdir(d):
        return []
    entries = []
    for name in os.listdir(d):
        m = re.fullmatch(rf"{_CKPT_PREFIX}(\d+){re.escape(_CKPT_SUFFIX)}", name)
        if m:
            entries.append((int(m.group(1)), name))
    entries.sort()
    return entries


def latest_checkpoint(output_dir: str) -> Optional[str]:
    entries = _checkpoint_steps(output_dir)
    if not entries:
        return None
    return os.path.join(checkpoint_dir(output_dir), entries[-1][1])


def _place(saved, target, partial: bool, path: str = ""):
    """``saved`` in the structure of ``target``: tensors take the target
    leaf's device and dtype; a target of None (or a number) takes the saved
    value as it is. Keys of target missing from saved raise; with partial,
    keys of saved missing from target are dropped, else they raise too."""
    if isinstance(target, dict):
        if not isinstance(saved, dict):
            raise ValueError(f"checkpoint: {path or '<root>'} is not a dict")
        missing = set(target) - set(saved)
        extra = set(saved) - set(target)
        if missing or (extra and not partial):
            raise ValueError(f"checkpoint: {path or '<root>'} keys differ: missing "
                             f"{sorted(map(str, missing))}, unexpected {sorted(map(str, extra))}")
        return {k: _place(saved[k], v, partial, f"{path}.{k}" if path else str(k))
                for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        if not isinstance(saved, (list, tuple)) or len(saved) != len(target):
            raise ValueError(f"checkpoint: {path} is not a list of {len(target)}")
        return [_place(s, t, partial, f"{path}.{i}") for i, (s, t) in enumerate(zip(saved, target))]
    if isinstance(target, torch.Tensor):
        if not isinstance(saved, torch.Tensor) or saved.shape != target.shape:
            raise ValueError(f"checkpoint: {path} has shape "
                             f"{getattr(saved, 'shape', None)}, want {tuple(target.shape)}")
        return saved.to(device=target.device, dtype=target.dtype)
    return saved


def load_checkpoint(path: str, target: Any = None, *, partial: bool = False) -> Any:
    """The tree saved at ``path``; with a target, placed into its structure
    (partial=True restores only the target's keys, e.g. params without the
    optimizer state)."""
    saved = torch.load(path, map_location="cpu", weights_only=True)
    return saved if target is None else _place(saved, target, partial)


def resume_or_load(output_dir: str, target: Any, *, resume: bool = True) -> Any:
    """The latest checkpoint under output_dir placed into target, if resume
    and one exists; else target unchanged."""
    if resume:
        path = latest_checkpoint(output_dir)
        if path is not None:
            logger.info(f"Resuming from {path}")
            return load_checkpoint(path, target)
    return target


def prune_checkpoints(output_dir: str, keep: int = 2) -> None:
    """Remove all but the newest ``keep`` checkpoints."""
    entries = _checkpoint_steps(output_dir)
    d = checkpoint_dir(output_dir)
    for _, name in entries[:-keep] if keep > 0 else entries:
        os.unlink(os.path.join(d, name))
