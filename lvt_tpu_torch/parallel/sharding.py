"""Tensor-parallel splitting of weights over a model group (counterpart of
lvt_tpu/parallel/sharding.py).

``lvt_tpu`` annotates each leaf with a ``NamedSharding`` over its mesh's
``model`` axis and lets XLA insert the collectives. The port holds each split
leaf as the rank's part only, and the forward passes put Megatron's
collectives where the splits need them (``parallel/collectives.py``;
``ops/attention.py``, ``models/vt.py``, ``models/vt_incremental.py``,
``ops/vq.py``). The rules are ``lvt_tpu``'s, keyed on the trailing field name
of each leaf's path, so one table serves params, model state, gradients and
every params-shaped optimizer moment:

* attention, head-parallel: ``wq/wk/wv`` (na, d, da) and the bias banks
  (na, ·) over heads; ``proj`` (na*da, d) row-parallel over its head-major
  rows;
* FFN: ``ffn_w1`` column-parallel with ``ffn_b1``, ``ffn_w2`` row-parallel;
* embeddings (``ctx_table``, ``slice_embedding``, ``class_embedding``,
  ``ch_embed``) over their feature dimension;
* the channel predictor: ``U_w`` column-parallel with ``U_b``, ``P_w``
  row-parallel;
* the EMA codebook (``embedding``, ``running_sum``, ``running_size``) over
  its K codes.

Every rule is guarded as ``lvt_tpu``'s ``tp_spec`` guards it: a leaf whose
rank does not match the rule, whose dimension the group's size does not
divide, or a group of one, is replicated. A split leaf's part of rank r is
the r-th of M equal consecutive chunks, as ``NamedSharding`` lays it out.

Which leaves are split is decided on the whole tree (``tp_dims``): a rank's
part alone cannot tell a split leaf from a replicated one of the same shape.
"""

from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from .collectives import _all_gather

MODEL = "model"

# field name -> per-dim template (its length must equal the leaf's rank)
TP_RULES: Dict[str, Tuple[Optional[str], ...]] = {
    # attention: head-parallel
    "wq": (MODEL, None, None),
    "wk": (MODEL, None, None),
    "wv": (MODEL, None, None),
    "proj": (MODEL, None),
    "dt_bank": (MODEL, None),
    "dh_bank": (MODEL, None),
    "dw_bank": (MODEL, None),
    # FFN: column-parallel -> row-parallel
    "ffn_w1": (None, MODEL),
    "ffn_b1": (MODEL,),
    "ffn_w2": (MODEL, None),
    # embeddings: feature-dim split
    "ctx_table": (None, None, None, None, None, MODEL),
    "slice_embedding": (None, MODEL),
    "class_embedding": (None, MODEL),
    "ch_embed": (None, None, MODEL),
    # channel predictor: column-parallel -> row-parallel
    "U_w": (None, MODEL),
    "U_b": (MODEL,),
    "P_w": (MODEL, None),
    # VQ EMA codebook: split the K code axis
    "embedding": (None, MODEL, None),
    "running_sum": (None, MODEL, None),
    "running_size": (None, MODEL),
}


def tp_dim(field: str, shape, size: int) -> Optional[int]:
    """The dimension along which the leaf ``field`` of the whole ``shape`` is
    split over a model group of ``size`` ranks; None where it is replicated
    (no rule, a rank mismatch, an indivisible dimension, or size 1)."""
    template = TP_RULES.get(field)
    if template is None or len(template) != len(shape) or size <= 1:
        return None
    dim = template.index(MODEL)
    return dim if shape[dim] % size == 0 else None


def _is_leaf(x) -> bool:
    return not isinstance(x, (dict, list, tuple))


def _map(fn, tree, field: str = ""):
    """fn(field, leaf) over a nested dict/list tree; ``field`` is the
    trailing dict key of the leaf's path (list indices skipped: ``U_w`` is a
    list)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v, field) for v in tree]
    return fn(field, tree)


def _zip_map(fn, tree, dims):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, dims[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_zip_map(fn, v, d) for v, d in zip(tree, dims)]
    return fn(tree, dims)


def tp_dims(tree, size: int):
    """A tree of ``tree``'s structure holding each leaf's split dimension
    (``tp_dim``; None for replicated leaves and for anything not a
    tensor)."""
    return _map(lambda f, x: tp_dim(f, tuple(x.shape), size)
                if isinstance(x, torch.Tensor) else None, tree)


def sharded_field_names(tree, size: int) -> set:
    """The field names of the leaves the rules split over ``size`` ranks."""
    hit = set()

    def visit(f, x):
        if isinstance(x, torch.Tensor) and tp_dim(f, tuple(x.shape), size) is not None:
            hit.add(f)
    _map(visit, tree)
    return hit


def shard_leaf(x: torch.Tensor, dim: Optional[int], rank: int, size: int) -> torch.Tensor:
    """Rank ``rank``'s part of a whole leaf (a contiguous copy), or the leaf
    itself where ``dim`` is None."""
    if dim is None:
        return x
    return x.chunk(size, dim=dim)[rank].contiguous()


def shard_tree(tree, rank: int, size: int, dims=None):
    """Rank ``rank``'s parts of a whole tree (params, model state, gradient
    sums) over ``size`` ranks; ``dims`` from ``tp_dims`` of the whole tree
    (made here when not given). Replicated leaves are the tree's own."""
    if dims is None:
        dims = tp_dims(tree, size)
    return _zip_map(lambda x, d: shard_leaf(x, d, rank, size), tree, dims)


def gather_leaf(x: torch.Tensor, dim: Optional[int], group) -> torch.Tensor:
    """The whole leaf from every rank's part (no gradient); the leaf itself
    where ``dim`` is None."""
    if dim is None:
        return x
    parts = _all_gather(x.detach().movedim(dim, 0)[None], group)
    return torch.cat(list(parts), dim=0).movedim(0, dim)


def gather_tree(tree, group, dims):
    """The whole tree from every rank's parts over ``group``: the inverse of
    ``shard_tree`` for the same ``dims``. Every rank of the group calls it."""
    return _zip_map(lambda x, d: gather_leaf(x, d, group), tree, dims)


def full_like(tree, dims, size: int):
    """Empty tensors of the whole leaves' shapes (each rank's part's dtype and
    device), in ``tree``'s structure: the target a layout-free checkpoint is
    read into."""
    def full(x, d):
        if d is None:
            return x
        shape = list(x.shape)
        shape[d] *= size
        return torch.empty(shape, dtype=x.dtype, device=x.device)
    return _zip_map(full, tree, dims)


def _moments(state: dict, dim, shape, fn):
    """fn(moment, dim) for every tensor of a parameter's optimizer state that
    has the parameter's shape (``step`` and other scalars as they are)."""
    return {k: fn(v, dim) if isinstance(v, torch.Tensor) and tuple(v.shape) == tuple(shape)
            and v.dim() > 0 else v for k, v in state.items()}


def shard_optimizer_state(state_dict: Dict[str, Any], param_dims, param_shapes, rank: int,
                          size: int) -> Dict[str, Any]:
    """A torch optimizer's state_dict of whole parameters cut to rank
    ``rank``'s parts: ``param_dims[i]``/``param_shapes[i]`` are parameter i's
    split dimension and whole shape, in the state_dict's index order."""
    state = {i: _moments(s, param_dims[i], param_shapes[i],
                         lambda v, d: shard_leaf(v, d, rank, size))
             for i, s in state_dict["state"].items()}
    return dict(state_dict, state=state)


def gather_optimizer_state(state_dict: Dict[str, Any], param_dims, param_shapes,
                           group) -> Dict[str, Any]:
    """The inverse of ``shard_optimizer_state``: ``param_shapes`` are the
    rank's parts' shapes. Every rank of the group calls it."""
    state = {i: _moments(s, param_dims[i], param_shapes[i],
                         lambda v, d: gather_leaf(v, d, group))
             for i, s in state_dict["state"].items()}
    return dict(state_dict, state=state)


def group_rank(group) -> Tuple[int, int]:
    """(rank within ``group``, its size)."""
    return dist.get_rank(group), dist.get_world_size(group)
