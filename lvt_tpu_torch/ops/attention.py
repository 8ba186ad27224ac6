"""Block-local multi-head attention with decomposed relative position bias
(counterpart of lvt_tpu/ops/attention.py; reference vt_attention.py:52-202).

* the (T, H, W) grid is cut into contiguous ``block_size`` tiles and full
  attention runs inside each tile;
* per-head additive bias B = Bt + Bh + Bw gathered from learned delta banks;
* causal masking (when ``causal``) fills with -1e4 *after* adding B;
* pre-LN heads, concat-proj residual, then a LN-Linear-ReLU-Linear FFN with
  its own residual.

Layout is channels-last (b, T, H, W, d) throughout. ``attention_core`` is
the one place the attention product runs, forward and backward: on a CUDA
tensor it launches the hand-written kernels (csrc/block_attention.cuh, and
csrc/block_attention_bwd.cuh for the gradient), on a CPU tensor it runs the
plain PyTorch versions of the same functions. A layer's parameters are a dict
with the field names of lvt_tpu's ``BlockAttnParams``.
"""

import math
from functools import lru_cache
from typing import Dict, Tuple

import numpy as np
import torch

from ._lib import LIBRARY, check_launch

LayerParams = Dict[str, torch.Tensor]


@lru_cache(maxsize=64)
def _axis_delta(s: int) -> np.ndarray:
    """(s, s) index into a (2s-1) bank: i - j + s - 1."""
    r = np.arange(s)
    return r[:, None] - r[None, :] + (s - 1)


def causal_mask(n: int, device=None) -> torch.Tensor:
    """(n, n) bool, True above the diagonal = masked; made on ``device``
    (no host copy, so a CUDA graph can capture it)."""
    return torch.ones((n, n), dtype=torch.bool, device=device).triu(1)


def relative_bias(dt_bank, dh_bank, dw_bank, block_size) -> torch.Tensor:
    """Banks (na, 2s-1) -> bias (na, thw, thw) in the banks' dtype, the three
    terms summed in fp32. Each bank is gathered per axis, (na, s, s), and the
    three are broadcast over the (t, h, w) x (t, h, w) token pairs, so the
    backward is a sum over the broadcast axes plus a scatter of s*s values.
    A gather of the whole (na, thw, thw) would scatter thw^2 values into ~2s
    slots per head in the backward, and the colliding indices serialize on
    the card (2.2 ms per bank at thw = 256, half a DSFVT train step's device
    time); the JAX package avoids the same scatter with a membership matmul
    (lvt_tpu/ops/attention.py:relative_bias)."""
    t, h, w = block_size
    dev = dt_bank.device
    bt, bh, bw = (bank.float()[:, torch.as_tensor(_axis_delta(s), device=dev)]
                  for bank, s in ((dt_bank, t), (dh_bank, h), (dw_bank, w)))
    na = bt.shape[0]
    bias = (bt.reshape(na, t, 1, 1, t, 1, 1) + bh.reshape(na, 1, h, 1, 1, h, 1)
            + bw.reshape(na, 1, 1, w, 1, 1, w))
    return bias.reshape(na, t * h * w, t * h * w).to(dt_bank.dtype)


def split_blocks(x: torch.Tensor, block_size):
    """(b, T, H, W, d) -> (b * nb, thw, d) with contiguous tiles; block index
    runs (bt, bh, bw) row-major per batch element."""
    b, T, H, W, d = x.shape
    t, h, w = block_size
    nbt, nbh, nbw = T // t, H // h, W // w
    x = x.reshape(b, nbt, t, nbh, h, nbw, w, d)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(b * nbt * nbh * nbw, t * h * w, d), (b, nbt, nbh, nbw, t, h, w, d)


def merge_blocks(x: torch.Tensor, geom) -> torch.Tensor:
    b, nbt, nbh, nbw, t, h, w, d = geom
    x = x.reshape(b, nbt, nbh, nbw, t, h, w, d)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b, nbt * t, nbh * h, nbw * w, d)


# --------------------------------------------------------------------------
# Attention core: softmax(q k^T / sqrt(da) + B [+ causal fill]) v
# --------------------------------------------------------------------------

def attention_core_plain(q, k, v, bias, causal: bool) -> torch.Tensor:
    """Plain PyTorch version of kernel 1. q, k, v: (nb, na, n, da); bias:
    (na, n, n). Products and softmax in fp32; P rounded to v's dtype before
    P.V, as the TPU kernel does; output in q's dtype."""
    n, da = q.shape[-2:]
    s = torch.einsum("bani,bami->banm", q.float(), k.float()) * (1.0 / math.sqrt(da))
    s = s + bias.float()[None]
    if causal:
        s = s.masked_fill(causal_mask(n, q.device), -1e4)
    p = torch.softmax(s, dim=-1).to(v.dtype).float()
    return torch.einsum("banm,bamd->band", p, v.float()).to(q.dtype)


def _check_kernel_inputs(name, q, k, v, bias, *more):
    """Raise unless q, k, v (and ``more`` of their shape) and the bias are
    what kernels 1 and 10 take: one CUDA device (the current one), float32 or
    bfloat16 (n <= 256) io, da in {64, 128}, n <= 1024, a float32 (na, n, n)
    bias, contiguous, 16-byte aligned."""
    io = (q, k, v, *more)
    if not (q.is_cuda and all(t.device == q.device for t in (*io, bias))):
        raise ValueError(f"{name}: all inputs must be on one CUDA device")
    if q.dtype not in (torch.float32, torch.bfloat16) or any(t.dtype != q.dtype for t in io):
        raise ValueError(f"{name}: q, k, v{', g' if more else ''} must share float32 or "
                         f"bfloat16, got {[t.dtype for t in io]}")
    if bias.dtype != torch.float32:
        raise ValueError(f"{name}: bias must be float32, got {bias.dtype}")
    if q.dim() != 4 or any(t.shape != q.shape for t in io):
        raise ValueError(f"{name}: q, k, v{', g' if more else ''} must share one "
                         f"(nb, na, n, da) shape, got {[tuple(t.shape) for t in io]}")
    nb, na, n, da = q.shape
    if da not in (64, 128) or not 1 <= n <= 1024:
        raise ValueError(f"{name}: needs da in (64, 128) and n <= 1024, got da={da}, n={n}")
    if q.dtype == torch.bfloat16 and n > 256:
        raise ValueError(f"{name}: bfloat16 needs n <= 256, got n={n}")
    if bias.shape != (na, n, n):
        raise ValueError(f"{name}: bias must be {(na, n, n)}, got {tuple(bias.shape)}")
    if not all(t.is_contiguous() for t in (*io, bias)):
        raise ValueError(f"{name}: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in io):  # the kernels read them 16 bytes at a time
        raise ValueError(f"{name}: q, k, v{', g' if more else ''} must be 16-byte aligned")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: inputs must lie on the current CUDA device")


def block_attention_fwd_cuda(q, k, v, bias, causal: bool) -> torch.Tensor:
    """Kernel 1 (csrc/block_attention.cuh) on CUDA tensors. q, k, v:
    (nb, na, n, da) contiguous, float32 or bfloat16, da in {64, 128},
    n <= 1024 in float32 and n <= 256 in bfloat16; bias (na, n, n)
    contiguous float32."""
    _check_kernel_inputs("block_attention_fwd_cuda", q, k, v, bias)
    nb, na, n, da = q.shape
    lib = LIBRARY.get()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    err = lib.lvt_block_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
        nb, na, n, da, int(causal), 0 if q.dtype == torch.float32 else 1,
        1.0 / math.sqrt(da), stream)
    check_launch("block_attention_fwd", err)
    block_attention_fwd_cuda.launches += 1
    return out


block_attention_fwd_cuda.launches = 0


def attention_core_bwd_plain(q, k, v, bias, g, causal: bool):
    """Plain PyTorch version of kernel 10, the recompute backward of kernel 1
    (lvt_tpu/ops/attention.py:attention_core_pallas_bwd), with its rounding
    points: s and p in fp32; dv = p_io^T g with p rounded to the io dtype;
    ds = p (dp - rowsum(dp p)) in fp32, 0 where masked; dq = ds_io k / sqrt(da)
    and dk = ds_io^T q / sqrt(da) with ds rounded to the io dtype; dbias = ds
    summed over the nb blocks in fp32, then cast to the bias dtype.
    Returns (dq, dk, dv, dbias)."""
    n, da = q.shape[-2:]
    io = q.dtype
    scale = 1.0 / math.sqrt(da)
    s = torch.einsum("bani,bami->banm", q.float(), k.float()) * scale
    s = s + bias.float()[None]
    mask = causal_mask(n, q.device) if causal else None
    if causal:
        s = s.masked_fill(mask, -1e4)
    p = torch.softmax(s, dim=-1)
    gf = g.float()
    dv = torch.einsum("banm,band->bamd", p.to(io).float(), gf)
    dp = torch.einsum("band,bamd->banm", gf, v.float())
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    if causal:
        ds = ds.masked_fill(mask, 0.0)
    ds_io = ds.to(io).float()
    dq = torch.einsum("banm,bamd->band", ds_io, k.float()) * scale
    dk = torch.einsum("banm,band->bamd", ds_io, q.float()) * scale
    return dq.to(io), dk.to(io), dv.to(io), ds.sum(dim=0).to(bias.dtype)


DBIAS_PLANES = 8  # csrc/block_attention_bwd.cuh: bf16 dbias planes, each a run of blocks


def bwd_scratch(nb: int, na: int, n: int, dtype, device):
    """Kernel 10's scratch: the row statistics (3, nb, na, np), np = n
    rounded up to 64, and the dbias planes (planes, na, n, n), one per run of
    attention blocks in bfloat16 (at most DBIAS_PLANES) and one per block in
    float32, all float32."""
    np_ = (n + 63) // 64 * 64
    planes = min(nb, DBIAS_PLANES) if dtype == torch.bfloat16 else nb
    stats = torch.empty((3, nb, na, np_), dtype=torch.float32, device=device)
    part = torch.empty((planes, na, n, n), dtype=torch.float32, device=device)
    return stats, part


def block_attention_bwd_cuda(q, k, v, bias, g, causal: bool):
    """Kernel 10 (csrc/block_attention_bwd.cuh) on CUDA tensors: the inputs
    kernel 1 takes, plus its output's cotangent g of q's shape and dtype.
    Returns (dq, dk, dv) in the io dtype and dbias (na, n, n) float32,
    bit-identical from call to call (no atomics)."""
    _check_kernel_inputs("block_attention_bwd_cuda", q, k, v, bias, g)
    nb, na, n, da = q.shape
    lib = LIBRARY.get()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dbias = torch.empty_like(bias)
    stats, part = bwd_scratch(nb, na, n, q.dtype, q.device)
    stream = torch.cuda.current_stream().cuda_stream
    err = lib.lvt_block_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), g.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dbias.data_ptr(), stats.data_ptr(),
        part.data_ptr(), nb, na, n, da, int(causal), 0 if q.dtype == torch.float32 else 1,
        1.0 / math.sqrt(da), stream)
    check_launch("block_attention_bwd", err)
    block_attention_bwd_cuda.launches += 1
    return dq, dk, dv, dbias


block_attention_bwd_cuda.launches = 0


class _AttentionCore(torch.autograd.Function):
    """Kernel 1 forward, kernel 10 backward (lvt_tpu's
    ``_attention_core_pallas_ad``): the forward saves q, k, v and the bias,
    and the backward recomputes the softmax from them. On CPU tensors the
    same Function runs the plain forward and the explicit plain backward
    (not autograd of the plain forward), so the CPU tests exercise its glue:
    what is saved, the order of the gradients, their dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal: bool):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, bias)
        if q.device.type == "cuda":
            return block_attention_fwd_cuda(q, k, v, bias, causal)
        return attention_core_plain(q, k, v, bias, causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        if q.device.type == "cuda":
            dq, dk, dv, dbias = block_attention_bwd_cuda(q, k, v, bias, g.contiguous(),
                                                         ctx.causal)
        else:
            dq, dk, dv, dbias = attention_core_bwd_plain(q, k, v, bias, g, ctx.causal)
        return dq, dk, dv, dbias.to(bias.dtype), None


def attention_core(q, k, v, bias, causal: bool) -> torch.Tensor:
    """softmax(q k^T / sqrt(da) + bias [causal -1e4 fill]) v, differentiable:
    kernels 1 and 10 on CUDA tensors, their plain versions on CPU tensors."""
    if q.device.type == "cuda":
        return _AttentionCore.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                                    bias.float().contiguous(), causal)
    if q.device.type == "cpu":
        return _AttentionCore.apply(q, k, v, bias, causal)
    raise ValueError(f"attention_core: no kernel for device {q.device}")


# --------------------------------------------------------------------------
# Full layer
# --------------------------------------------------------------------------

def _layer_norm(x, scale, bias, eps=1e-5):
    """THE LayerNorm of the VT stack: statistics in fp32 with the biased
    variance (as jnp.var), output in x's dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def mha_tokens(x: torch.Tensor, p: LayerParams, bias: torch.Tensor, causal: bool) -> torch.Tensor:
    """Multi-head attention over token sequences x: (nb, n, d)."""
    nb, n, d = x.shape
    na, _, da = p["wq"].shape
    y = _layer_norm(x, p["ln_scale"], p["ln_bias"])
    q = torch.einsum("bnd,adk->bank", y, p["wq"])
    k = torch.einsum("bnd,adk->bank", y, p["wk"])
    v = torch.einsum("bnd,adk->bank", y, p["wv"])
    out = attention_core(q, k, v, bias, causal)  # (nb, na, n, da)
    out = out.permute(0, 2, 1, 3).reshape(nb, n, na * da)
    return out @ p["proj"] + x


def ffn_tokens(x: torch.Tensor, p: LayerParams) -> torch.Tensor:
    y = _layer_norm(x, p["ffn_ln_scale"], p["ffn_ln_bias"])
    y = torch.relu(y @ p["ffn_w1"] + p["ffn_b1"])
    return y @ p["ffn_w2"] + p["ffn_b2"] + x


def block_local_attention(x: torch.Tensor, p: LayerParams, block_size,
                          causal: bool) -> torch.Tensor:
    """One full BlockLocalAttention layer on (b, T, H, W, d)."""
    bias = relative_bias(p["dt_bank"], p["dh_bank"], p["dw_bank"], tuple(block_size))
    tokens, geom = split_blocks(x, block_size)
    tokens = mha_tokens(tokens, p, bias, causal)
    tokens = ffn_tokens(tokens, p)
    return merge_blocks(tokens, geom)
