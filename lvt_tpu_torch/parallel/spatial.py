"""Frames split by rows over a group of ranks (TPU.SHARD_SPATIAL; counterpart
of lvt_tpu/parallel/mesh.py ``spatial_batch_sharding``, whose halo exchanges
XLA's partitioner inserts).

Inside ``parallel.mesh.spatial_parallel(group)`` rank r of the group holds
the r-th of M equal bands of rows of every frame, (b, H / M, W, C). The
layers that read across rows take what they need from the neighbours:

* a convolution reads the rows just above and below its band (``conv_rows``,
  ``conv_transpose_rows``), exchanged by ``halo_rows``. At the frame's top
  and bottom there is no neighbour and zeros stand in, which is the
  convolution's own zero padding there;
* moments over the rows of a frame or of a batch (the norms, the EMA
  codebook's statistics, the losses) are summed over the group.

The values are those of the whole frame. The gradients follow one rule: each
rank back-propagates its own band's share of the loss (``row_mean``: the
forward value is the whole frame's mean, its backward gives each rank's mean
1 / M), a halo's gradient is sent back to the rank that owns those rows, and
a sum of moments has the sum over the group as its backward
(``parallel.collectives.all_reduce``). A replicated weight's gradient is then
the sum of the ranks' gradients, which the trainer forms after each step.

Every rank of the group calls each exchange, forward and backward, in the
same order. Under a gloo group a CUDA tensor is staged through the host and a
narrow float moves as fp32 (``parallel/collectives.py``); an NCCL group keeps
everything on the card.
"""

from collections import Counter
from typing import Tuple

import torch
import torch.distributed as dist

from .collectives import _all_gather, _narrow
from .sharding import group_rank

__all__ = ["split_rows", "gather_rows", "halo_rows", "conv_rows", "conv_transpose_rows",
           "check_rows", "row_mean", "exchange", "CALLS"]

# calls of the halo exchange: "forward" (one a convolution that reads past
# its band) and "backward" (one where the band's input needs a gradient)
CALLS: Counter = Counter()


def _band(height: int, size: int, what: str) -> int:
    if height % size:
        raise ValueError(f"{what}: a height of {height} rows does not split into {size} equal "
                         f"bands")
    return height // size


def split_rows(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """This rank's band of rows of frames x (b, H, W, C): rows [r H / M,
    (r + 1) H / M), contiguous. Raises ValueError where M does not divide H."""
    rank, size = group_rank(group)
    h = _band(x.shape[1], size, f"split_rows of {tuple(x.shape)}")
    return x.narrow(1, rank * h, h).contiguous()


def exchange(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """Every rank's ``x`` stacked in rank order, (M, *x.shape), in x's dtype:
    the one collective of the row exchanges (no gradient)."""
    wide = x.float() if _narrow(x) else x
    return _all_gather(wide[None], group).to(x.dtype)


def gather_rows(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """Whole frames (b, M h, W, C) from every rank's band x (b, h, W, C), on
    every rank (no gradient)."""
    return torch.cat(list(exchange(x, group)), dim=1)


class _HaloRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, above, below, group):
        rank, size = group_rank(group)
        h = x.shape[1]
        ctx.group, ctx.above, ctx.below, ctx.h = group, above, below, h
        CALLS["forward"] += 1
        # my first `below` rows are the rank above's lower halo, my last
        # `above` rows the rank below's upper halo
        parts = exchange(torch.cat([x[:, :below], x[:, h - above:]], dim=1), group)

        def zeros(rows):
            return x.new_zeros(x.shape[:1] + (rows,) + x.shape[2:])
        top = parts[rank - 1][:, below:] if rank > 0 else zeros(above)
        bottom = parts[rank + 1][:, :below] if rank < size - 1 else zeros(below)
        return torch.cat([top, x, bottom], dim=1)

    @staticmethod
    def backward(ctx, g):
        rank, size = group_rank(ctx.group)
        above, below, h = ctx.above, ctx.below, ctx.h
        CALLS["backward"] += 1
        # each halo's gradient goes back to the rank that owns its rows
        parts = exchange(torch.cat([g[:, :above], g[:, above + h:]], dim=1), ctx.group)
        grad = g[:, above:above + h].clone()
        if rank < size - 1 and above:  # the rank below read my last rows
            grad[:, h - above:] += parts[rank + 1][:, :above]
        if rank > 0 and below:  # the rank above read my first rows
            grad[:, :below] += parts[rank - 1][:, above:]
        return grad, None, None, None


def halo_rows(x: torch.Tensor, above: int, below: int,
              group: dist.ProcessGroup) -> torch.Tensor:
    """The band x (b, h, W, C) with ``above`` rows of the rank above on top
    and ``below`` rows of the rank below underneath, zeros where the frame
    ends: (b, above + h + below, W, C). Its gradient adds each halo row's
    gradient to the row it was taken from, on its owner."""
    h = x.shape[1]
    if not (0 <= above <= h and 0 <= below <= h):
        raise ValueError(f"halo_rows: a band of {h} rows {tuple(x.shape)} cannot lend "
                         f"{above} rows above and {below} below")
    if not above and not below:
        return x
    return _HaloRows.apply(x, above, below, group)


def conv_rows(x: torch.Tensor, k: int, stride: int, padding: int,
              group: dist.ProcessGroup) -> torch.Tensor:
    """The band x (b, h, W, C) as a convolution of k rows, ``stride`` and
    ``padding`` reads it for its h / stride output rows with no row padding
    of its own: ``padding`` rows of the rank above and k - stride - padding
    of the rank below. Raises ValueError where h is not a multiple of the
    stride, or where the convolution's output rows do not split into the
    bands (its whole output has H / stride rows only when k - stride <= 2
    padding < k; the rows below must be none or more)."""
    h = x.shape[1]
    if h % stride:
        raise ValueError(f"conv over a band of rows {tuple(x.shape)}: its height {h} is not a "
                         f"multiple of the stride {stride}")
    if not (k - stride <= 2 * padding < k and padding <= k - stride):
        raise ValueError(f"conv of {k} rows, stride {stride}, padding {padding} over bands of "
                         f"rows {tuple(x.shape)}: its output rows do not split into the bands")
    return halo_rows(x, padding, k - stride - padding, group)


def conv_transpose_rows(x: torch.Tensor, k: int, stride: int, padding: int,
                        group: dist.ProcessGroup) -> Tuple[torch.Tensor, int]:
    """(the band x widened by the input rows a transposed convolution of k
    rows, ``stride`` and ``padding`` reads for this rank's stride * h output
    rows, the first of those rows in its output with no row padding). Raises
    ValueError unless k = stride + 2 padding (the whole output then has
    stride * H rows)."""
    if k != stride + 2 * padding:
        raise ValueError(f"transposed conv of {k} rows, stride {stride}, padding {padding} over "
                         f"bands of rows {tuple(x.shape)}: its output rows do not split into "
                         f"the bands")
    above, below = -(-(k - 1 - padding) // stride), (stride - 1 + padding) // stride
    return halo_rows(x, above, below, group), above * stride + padding


def check_rows(x: torch.Tensor, factor: int, what: str) -> None:
    """Raises ValueError where a band's height is not a multiple of
    ``factor`` (a pooling that would mix two ranks' rows)."""
    if x.shape[1] % factor:
        raise ValueError(f"{what} over a band of rows {tuple(x.shape)}: its height "
                         f"{x.shape[1]} is not a multiple of {factor}")


class _RowMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, group):
        ctx.size = dist.get_world_size(group)
        out = v.detach().float().clone()
        dist.all_reduce(out, group=group)
        return (out / ctx.size).to(v.dtype)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.size, None


def row_mean(v: torch.Tensor, group) -> torch.Tensor:
    """The whole frame's mean from each rank's mean ``v`` over its band
    (the bands are equal): the group's average, whose gradient gives each
    rank's own mean 1 / M of the output's, its share. ``v`` as it is where
    ``group`` is None."""
    return v if group is None else _RowMean.apply(v, group)
