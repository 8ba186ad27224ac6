"""Embedding row gathers (counterpart of lvt_tpu/ops/embedding.py).

``take_rows(table, idx)`` is ``table[idx]``. Its backward sums the incoming
rows per table row in fp32 and rounds the sum once to the table's dtype, as
the JAX package's one-hot-matmul backward does (fp32 accumulation, then a
cast); autograd of a bf16 gather would add in bf16. ``index_put_`` with
``accumulate=True`` sorts the indices, so the sum is the same from run to
run on the card too.
"""

import torch


class _TakeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.shape, ctx.dtype = table.shape, table.dtype
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        de = ctx.shape[-1]
        acc = torch.zeros(ctx.shape, dtype=torch.float32, device=g.device)
        acc.index_put_((idx.reshape(-1),), g.reshape(-1, de).float(), accumulate=True)
        return acc.to(ctx.dtype), None


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of a (V, de) table at integer indices idx (any shape, values in
    [0, V)): (*idx.shape, de)."""
    if table.dim() != 2:
        raise ValueError(f"take_rows: table must be (V, de), got {tuple(table.shape)}")
    return _TakeRows.apply(table, idx.long())
