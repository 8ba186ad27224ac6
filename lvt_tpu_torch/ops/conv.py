"""Convolution primitives with the reference's semantics (counterpart of
lvt_tpu/ops/conv.py).

Public layouts are the JAX package's: activations channels-last (NHWC for
2-D, NDHWC for 3-D), weights HWIO / DHWIO, transposed-conv weights
(kh, kw, out, in). Each function moves to PyTorch's channels-first layout
around one ``torch.nn.functional`` call; the bias is added afterwards, as
the JAX package adds it. These are plain PyTorch: the JAX package leaves
them to XLA, outside any kernel.

Inside ``parallel.mesh.spatial_parallel`` (frames split by rows over a
group, ``parallel/spatial.py``) ``conv2d`` and ``conv_transpose2d`` take
their band's halo rows from the neighbouring ranks and compute this rank's
band of the whole frame's output; the columns are padded as before.

* ``conv2d`` / ``conv_transpose2d``: torch.nn.Conv2d / ConvTranspose2d
  arithmetic (ResEncoder / ResDecoder).
* ``masked_conv3d``: the decoder's causal 3-D conv, a constant binary mask
  on the weight and asymmetric padding (kt-1, 0), (kh-1, 0), (kw//2, kw//2).
* ``subscale_context_encode``: the VT encoder's Conv3d over a one-hot
  (nc*nv)-channel code video, computed as a sum of embedding rows, one per
  (channel, kernel tap) "slot"; pad codes (< 0) read a zero row. The
  environment variable LVT_CTX_IMPL picks how the sum is formed, read at
  each call as the JAX package reads it (``ctx_encode_impl``): "" (auto),
  "gather_sum", "chunk" (with LVT_CTX_CHUNK), "chain", "onehot", "minor";
  an unknown value computes "gather_sum". Every formulation shares one
  backward, a per-slot fp32 segment sum (``_CtxEncode``).
"""

import os
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.mesh import spatial_group
from ..parallel.spatial import conv_rows, conv_transpose_rows


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def conv2d(x, w, b=None, stride=1, padding=0):
    """NHWC conv. w: (kh, kw, in, out); inputs follow the weight dtype."""
    stride, padding = _pair(stride), _pair(padding)
    x = x.to(w.dtype)
    group = spatial_group()
    if group is not None:  # the band with its halo rows; no row padding
        x, padding = conv_rows(x, w.shape[0], stride[0], padding[0], group), (0, padding[1])
    out = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=stride,
                   padding=padding)
    out = out.permute(0, 2, 3, 1)
    return out + b if b is not None else out


def conv_transpose2d(x, w, b=None, stride=2, padding=1):
    """torch.nn.ConvTranspose2d semantics on NHWC. w: (kh, kw, out, in),
    i.e. torch's (in, out, kh, kw) weight permuted. Output size =
    (n-1)*s - 2p + k."""
    stride, padding = _pair(stride), _pair(padding)
    x = x.to(w.dtype)
    group = spatial_group()
    first = None
    if group is not None:  # the widened band, cropped to this rank's output rows
        rows = stride[0] * x.shape[1]
        x, first = conv_transpose_rows(x, w.shape[0], stride[0], padding[0], group)
        padding = (0, padding[1])
    out = F.conv_transpose2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=stride,
                             padding=padding)
    out = out.permute(0, 2, 3, 1)
    if first is not None:
        out = out[:, first:first + rows]
    return out + b if b is not None else out


@lru_cache(maxsize=8)
def _causal_mask_np(kt: int, kh: int, kw: int) -> np.ndarray:
    """(kt, kh, kw, 1, 1) binary mask zeroing the current pixel and
    everything to its right in the current row of the current frame."""
    m = np.ones((kt, kh, kw, 1, 1), dtype=np.float32)
    m[kt - 1, kh - 1, kw // 2 :] = 0.0
    return m


def masked_conv3d(x, w, b=None):
    """Causal 3-D conv on (b, t, h, w, c); w: (kt, kh, kw, in, out). The
    padding keeps the output size while only past raster positions feed
    each output."""
    x = x.to(w.dtype)
    kt, kh, kw = w.shape[:3]
    w = w * torch.as_tensor(_causal_mask_np(kt, kh, kw), device=w.device).to(w.dtype)
    xc = x.permute(0, 4, 1, 2, 3)
    xc = F.pad(xc, (kw // 2, kw // 2, kh - 1, 0, kt - 1, 0))
    out = F.conv3d(xc, w.permute(4, 3, 0, 1, 2)).permute(0, 2, 3, 4, 1)
    return out + b if b is not None else out


# auto-select: above this many bytes of gather_sum's (b, nc*K, thw, de)
# intermediate, "chain" (the JAX package's threshold, so that both packages
# pick the same formulation at every shape)
CTX_GATHER_BYTES = 2 ** 31


def ctx_encode_impl(b: int, slots: int, thw: int, de: int, itemsize: int) -> str:
    """The formulation a call computes: LVT_CTX_IMPL, or where it is empty
    "chain" once gather_sum's intermediate of b * slots * thw * de elements
    would pass CTX_GATHER_BYTES, else "gather_sum". A value that names no
    formulation is returned as it is and computes "gather_sum"."""
    impl = os.environ.get("LVT_CTX_IMPL", "")
    if not impl:
        impl = "chain" if b * slots * thw * de * itemsize > CTX_GATHER_BYTES else "gather_sum"
    return impl


def ctx_chunk(b: int, slots: int, thw: int, de: int, itemsize: int) -> int:
    """The slots "chunk" gathers at a time: LVT_CTX_CHUNK, or where it is 0
    the most whose intermediate stays within CTX_GATHER_BYTES."""
    return int(os.environ.get("LVT_CTX_CHUNK", "0")) or max(
        1, min(slots, CTX_GATHER_BYTES // (b * thw * de * itemsize)))


def _ctx_gather_indices(ctx: torch.Tensor, stride, table_shape):
    """Strided window indices into the padded flat table: (b, nc*K, t*h*w)
    int32 with each slot's base offset added (a pad code reads row 0 of its
    slot), and (t, h, w)."""
    nc, kt, kh, kw, nv, de = table_shape
    st, sh, sw = stride
    b = ctx.shape[0]
    Tp, Hp, Wp = ctx.shape[2:]
    t, h, w = (Tp - kt) // st + 1, (Hp - kh) // sh + 1, (Wp - kw) // sw + 1
    wins = [ctx[:, :, dt:dt + (t - 1) * st + 1:st, dh:dh + (h - 1) * sh + 1:sh,
                dw:dw + (w - 1) * sw + 1:sw]
            for dt in range(kt) for dh in range(kh) for dw in range(kw)]
    K = kt * kh * kw
    idx = torch.stack(wins, dim=2).to(torch.int32)  # (b, nc, K, t, h, w)
    idx.add_(1).clamp_(0, nv)  # pad (-1) -> row 0
    base = torch.arange(nc * K, dtype=torch.int32, device=ctx.device) * (nv + 1)
    idx.add_(base.reshape(1, nc, K, 1, 1, 1))
    return idx.reshape(b, nc * K, t * h * w), (t, h, w)


def _slot_rows(table: torch.Tensor) -> torch.Tensor:
    """The table as (nc*K*(nv+1), de) rows, row 0 of each slot zeros."""
    nc, kt, kh, kw, nv, de = table.shape
    flat = table.reshape(nc * kt * kh * kw, nv, de)
    return torch.cat([flat.new_zeros(flat.shape[0], 1, de), flat], dim=1).reshape(-1, de)


def _ctx_encode_impl(ctx: torch.Tensor, table: torch.Tensor, stride) -> torch.Tensor:
    """The context sum (b, t, h, w, de) in the formulation LVT_CTX_IMPL
    picks, each with the JAX package's rounding points: "chain", "chunk"
    and "onehot" keep their accumulator in the table's dtype; "gather_sum"
    and "minor" reduce the gathered tensor over its slot axis."""
    nc, kt, kh, kw, nv, de = table.shape
    S = nc * kt * kh * kw
    gidx, (t, h, w) = _ctx_gather_indices(ctx, stride, table.shape)
    b, thw = gidx.shape[0], t * h * w
    flat = _slot_rows(table)
    impl = ctx_encode_impl(b, S, thw, de, flat.element_size())
    if impl == "chunk":
        # CH slots gathered at a time, summed, then added to the accumulator
        CH = ctx_chunk(b, S, thw, de, flat.element_size())
        gperm = gidx.transpose(1, 2)  # (b, thw, S)
        acc = flat.new_zeros(b, thw, de)
        for s0 in range(0, S, CH):  # one expression: each chunk freed before the next
            acc = acc + flat.index_select(0, gperm[:, :, s0:s0 + CH].reshape(-1)).reshape(
                b, thw, -1, de).sum(dim=2)
        return acc.reshape(b, t, h, w, de)
    if impl == "chain":
        # one slot's rows gathered and added at a time: no (b, S, thw, de)
        # intermediate, one (b*thw, de) buffer reused
        acc = flat.new_zeros(b * thw, de)
        rows = torch.empty_like(acc)
        for s in range(S):
            torch.index_select(flat, 0, gidx[:, s].reshape(-1), out=rows)
            acc += rows
        return acc.reshape(b, t, h, w, de)
    if impl == "onehot":
        # one product a slot: one_hot(local index) (b*thw, nv+1) @ the
        # slot's rows (nv+1, de), in the table's dtype
        cols = torch.arange(nv + 1, dtype=gidx.dtype, device=gidx.device)
        acc = flat.new_zeros(b * thw, de)
        for s in range(S):  # one expression: each one-hot freed before the next
            acc += ((gidx[:, s].reshape(-1, 1) - s * (nv + 1)) == cols).to(flat.dtype) @ flat[
                s * (nv + 1):(s + 1) * (nv + 1)]
        return acc.reshape(b, t, h, w, de)
    if impl == "minor":
        # reduced over the axis next to the features
        emb = flat.index_select(0, gidx.transpose(1, 2).reshape(-1))
        return emb.reshape(b, thw, S, de).sum(dim=2).reshape(b, t, h, w, de)
    emb = flat.index_select(0, gidx.reshape(-1))  # (b*S*thw, de)
    return emb.reshape(b, S, thw, de).sum(dim=1).reshape(b, t, h, w, de)


def ctx_table_grad(ctx: torch.Tensor, g: torch.Tensor, stride, kernel, nv: int,
                   dtype: torch.dtype) -> torch.Tensor:
    """d(table) of the context sum for the incoming gradient g (b, t, h, w,
    de): for each (channel, kernel tap) slot the fp32 segment sums of g's
    (b*thw, de) rows by the slot's local index, as lvt_tpu's one-hot
    products one_hot^T @ g (true fp32 with TF32 off; no host sync, and the
    same sums from run to run on the card), row 0 (the pad row) dropped and
    the whole cast once to ``dtype``. The kernel size comes from the table,
    not from the ctx grid: Tp - (t-1)*st is not kt for the even kernels
    whose grid carries an extra padded row."""
    kt, kh, kw = kernel
    nc, de = ctx.shape[1], g.shape[-1]
    S = nc * kt * kh * kw
    gidx, _ = _ctx_gather_indices(ctx, stride, (nc, kt, kh, kw, nv, de))
    gf = g.reshape(-1, de).float()  # (b*thw, de)
    cols = torch.arange(nv + 1, dtype=gidx.dtype, device=gidx.device)
    dflat = gf.new_empty(S, nv + 1, de)
    for s in range(S):
        local = gidx[:, s].reshape(-1, 1) - s * (nv + 1)
        torch.mm((local == cols).float().t(), gf, out=dflat[s])
    return dflat[:, 1:].reshape(nc, kt, kh, kw, nv, de).to(dtype)


class _CtxEncode(torch.autograd.Function):
    """The context sum with one backward for every formulation. It saves
    the integer codes only: the gather indices are formed again in the
    backward, and no (b, nc*K, thw, de) tensor is made there."""

    @staticmethod
    def forward(fctx, ctx, table, stride):
        fctx.save_for_backward(ctx)
        fctx.stride, fctx.table_shape, fctx.dtype = stride, table.shape, table.dtype
        return _ctx_encode_impl(ctx, table, stride)

    @staticmethod
    def backward(fctx, g):
        (ctx,) = fctx.saved_tensors
        nc, kt, kh, kw, nv, de = fctx.table_shape
        return None, ctx_table_grad(ctx, g, fctx.stride, (kt, kh, kw), nv, fctx.dtype), None


def subscale_context_encode(ctx: torch.Tensor, table: torch.Tensor,
                            bias: Optional[torch.Tensor],
                            stride: Tuple[int, int, int], nv: int) -> torch.Tensor:
    """Conv3d(one_hot(ctx)) with VALID padding, as a sum of embedding rows.

    ctx:   (b, nc, T', H', W') int codes, negative = pad (contributes zero)
    table: (nc, kt, kh, kw, nv, de) embedding-form conv weight
    Returns (b, t, h, w, de).
    """
    if table.shape[4] != nv:
        raise ValueError(f"subscale_context_encode: table {tuple(table.shape)} has no {nv} codes")
    emb = _CtxEncode.apply(ctx, table, tuple(stride))
    return emb + bias if bias is not None else emb
