"""Differentiable collectives over a process group (counterpart of
lvt_tpu/parallel/collectives.py; reference vidgen/layers/all_gather.py:13-133,
batch_norm.py:148-160).

``lvt_tpu``'s are ``jax.lax`` collectives, whose transposes are the matching
collectives; here they are autograd Functions, as the reference writes them:
the backward of ``all_gather`` is a reduce-scatter of the gradient, that of
``reduce_scatter`` an all-gather, and ``all_reduce`` (a sum) is its own
backward. Every rank of the group calls each one, forward and backward, in
the same order. The gathered and scattered axis is 0 and every rank's part
has the same shape (``tiled``, as ``lvt_tpu`` calls them).

Tensor parallelism takes Megatron's two conjugate operators and a feature
gather, over a model group whose ranks compute the same replicated values:
``copy_to_model`` (identity forward, all-reduce backward) goes before a
column-parallel product, ``reduce_from_model`` (all-reduce forward, identity
backward) after a row-parallel one, and ``gather_features`` (all-gather on
the last axis forward, the rank's own slice of the gradient backward) after
a feature-split lookup. The data-parallel ``all_reduce`` and ``all_gather``
would be wrong there: their backward sums the gradient over the ranks, and
each rank's gradient of a replicated value is already the whole one, so
every gradient upstream would come out M times too large. These three sum
and move bf16 and other narrow floats as fp32 (one rounding of the sum, and
a dtype every backend takes).

Under a gloo group, CUDA tensors go straight through the all-reduces (sum
and ``max_over_model``'s maximum); the gather and the reduce-scatter are
staged through host copies, because gloo does not take CUDA tensors for
them. The backend is never switched: an NCCL group runs every op on the
card.

``max_over_model`` is no autograd Function: it takes the maximum of the
quantized sampler's absmax scales over the model group (``ops/quant.py``),
whose rows and columns no rank holds whole.
"""

from typing import List, Optional

import torch
import torch.distributed as dist

__all__ = ["all_gather", "reduce_scatter", "all_reduce", "copy_to_model", "reduce_from_model",
           "gather_features", "local_features", "max_over_model"]


def _world(group) -> int:
    return dist.get_world_size(group=group)


def _staged(group, x: torch.Tensor) -> bool:
    """Whether ``x`` takes a host copy for a gather or reduce-scatter: a CUDA
    tensor in a gloo group."""
    return x.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, op=op, group=group)
    return y


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    src = x.contiguous()
    host = _staged(group, src)
    if host:
        src = src.cpu()
    parts: List[torch.Tensor] = [torch.empty_like(src) for _ in range(_world(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=0)
    return out.to(x.device) if host else out


def _reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    world = _world(group)
    if x.shape[0] % world:
        raise ValueError(f"reduce_scatter: axis 0 ({x.shape[0]}) does not divide by the "
                         f"group's {world} ranks")
    src = x.contiguous()
    host = _staged(group, src)
    if host:
        src = src.cpu()
    parts = [p.contiguous() for p in src.chunk(world, dim=0)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    return out.to(x.device) if host else out


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group), None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce_scatter(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group), None


def all_reduce(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """The sum of ``x`` over the group's ranks; the gradient is summed over
    them too (``jax.lax.psum``)."""
    return _AllReduce.apply(x, group)


def all_gather(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along axis 0 in rank order; the
    gradient is the reduce-scatter of the output's (``jax.lax.all_gather``,
    tiled)."""
    return _AllGather.apply(x, group)


def reduce_scatter(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """The sum over ranks of ``x``, of which this rank keeps its chunk of
    axis 0; the gradient is the all-gather of the chunks'
    (``jax.lax.psum_scatter``, tiled)."""
    return _ReduceScatter.apply(x, group)


def _narrow(x: torch.Tensor) -> bool:
    return x.is_floating_point() and x.dtype not in (torch.float32, torch.float64)


def _sum_fp32(x: torch.Tensor, group) -> torch.Tensor:
    """``_all_reduce`` with a narrow float summed in fp32 and rounded once."""
    return _all_reduce(x.float(), group).to(x.dtype) if _narrow(x) else _all_reduce(x, group)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return _sum_fp32(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum_fp32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFeatures(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.width = group, x.shape[-1]
        parts = _all_gather((x.float() if _narrow(x) else x).movedim(-1, 0), group)
        return parts.movedim(0, -1).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        rank = dist.get_rank(ctx.group)
        return g.narrow(-1, rank * ctx.width, ctx.width), None


def copy_to_model(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """``x`` as it is; its gradient summed over the model group (before a
    column-parallel product: each rank's product sends back its part of the
    input's gradient)."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """The sum of ``x`` over the model group; the gradient passes as it is
    (after a row-parallel product: every rank's partial product is summed,
    and each needs the whole output's gradient, which it has)."""
    return _ReduceFromModel.apply(x, group)


def gather_features(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """The ranks' ``x`` concatenated along the last axis in rank order; the
    gradient is the rank's own slice of the output's (after a lookup split
    over its features, before replicated work)."""
    return _GatherFeatures.apply(x, group)


def local_features(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """The rank's equal consecutive part of the last axis of a replicated
    ``x``, whose gradient (zero outside the part) is summed over the model
    group (before a row-parallel product whose input is replicated)."""
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    width = x.shape[-1] // size
    return copy_to_model(x, group).narrow(-1, rank * width, width)


def max_over_model(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the model group, on every rank;
    no gradient. A narrow float is taken as fp32, which loses nothing: the
    maximum is one of the values."""
    return _all_reduce((x.float() if _narrow(x) else x).detach(), group,
                       dist.ReduceOp.MAX).to(x.dtype)
