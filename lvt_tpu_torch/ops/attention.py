"""Block-local multi-head attention with decomposed relative position bias
(counterpart of lvt_tpu/ops/attention.py; reference vt_attention.py:52-202).

* the (T, H, W) grid is cut into contiguous ``block_size`` tiles and full
  attention runs inside each tile;
* per-head additive bias B = Bt + Bh + Bw gathered from learned delta banks;
* causal masking (when ``causal``) fills with -1e4 *after* adding B;
* pre-LN heads, concat-proj residual, then a LN-Linear-ReLU-Linear FFN with
  its own residual.

Layout is channels-last (b, T, H, W, d) throughout. ``attention_core`` is
the one place the attention product runs: on a CUDA tensor it launches the
hand-written kernel (csrc/block_attention.cu), on a CPU tensor it runs the
plain PyTorch version of the same function. A layer's parameters are a dict
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
def _delta_indices(block_size: Tuple[int, int, int]):
    """Flattened per-axis delta index arrays (thw, thw), values in
    [0, 2*axis-2], into the dt/dh/dw banks."""
    t, h, w = block_size
    tt = np.arange(t).repeat(h * w)
    hh = np.tile(np.arange(h).repeat(w), t)
    ww = np.tile(np.arange(w), t * h)
    dt = tt[:, None] - tt[None, :] + (t - 1)
    dh = hh[:, None] - hh[None, :] + (h - 1)
    dw = ww[:, None] - ww[None, :] + (w - 1)
    return dt, dh, dw


def causal_mask(n: int, device=None) -> torch.Tensor:
    """(n, n) bool, True above the diagonal = masked; made on ``device``
    (no host copy, so a CUDA graph can capture it)."""
    return torch.ones((n, n), dtype=torch.bool, device=device).triu(1)


def relative_bias(dt_bank, dh_bank, dw_bank, block_size) -> torch.Tensor:
    """Banks (na, 2s-1) -> bias (na, thw, thw) in the banks' dtype, summed
    in fp32 (the JAX package sums the same three terms in a membership
    matmul with fp32 accumulation)."""
    dev = dt_bank.device
    dt, dh, dw = (torch.as_tensor(i, device=dev) for i in _delta_indices(tuple(block_size)))
    bias = dt_bank.float()[:, dt] + dh_bank.float()[:, dh] + dw_bank.float()[:, dw]
    return bias.to(dt_bank.dtype)


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


def block_attention_fwd_cuda(q, k, v, bias, causal: bool) -> torch.Tensor:
    """Kernel 1 (csrc/block_attention.cu) on CUDA tensors. q, k, v:
    (nb, na, n, da) contiguous, float32 or bfloat16, da in {64, 128},
    n <= 1024 in float32 and n <= 256 in bfloat16; bias (na, n, n)
    contiguous float32."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device
            and bias.device == q.device):
        raise ValueError("block_attention_fwd_cuda: all inputs must be on one CUDA device")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"block_attention_fwd_cuda: q, k, v must share float32 or "
                         f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if bias.dtype != torch.float32:
        raise ValueError(f"block_attention_fwd_cuda: bias must be float32, got {bias.dtype}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"block_attention_fwd_cuda: q, k, v must share one (nb, na, n, da) "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    nb, na, n, da = q.shape
    if da not in (64, 128) or not 1 <= n <= 1024:
        raise ValueError(f"block_attention_fwd_cuda: needs da in (64, 128) and n <= 1024, "
                         f"got da={da}, n={n}")
    if q.dtype == torch.bfloat16 and n > 256:
        raise ValueError(f"block_attention_fwd_cuda: bfloat16 needs n <= 256, got n={n}")
    if bias.shape != (na, n, n):
        raise ValueError(f"block_attention_fwd_cuda: bias must be {(na, n, n)}, "
                         f"got {tuple(bias.shape)}")
    if not all(t.is_contiguous() for t in (q, k, v, bias)):
        raise ValueError("block_attention_fwd_cuda: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):  # the kernel reads them 16 bytes at a time
        raise ValueError("block_attention_fwd_cuda: q, k, v must be 16-byte aligned")
    lib = LIBRARY.get()
    out = torch.empty_like(q)
    if q.device.index != torch.cuda.current_device():
        raise ValueError("block_attention_fwd_cuda: inputs must lie on the current CUDA device")
    stream = torch.cuda.current_stream().cuda_stream
    err = lib.lvt_block_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
        nb, na, n, da, int(causal), 0 if q.dtype == torch.float32 else 1,
        1.0 / math.sqrt(da), stream)
    check_launch("block_attention_fwd", err)
    block_attention_fwd_cuda.launches += 1
    return out


block_attention_fwd_cuda.launches = 0


def attention_core(q, k, v, bias, causal: bool) -> torch.Tensor:
    """Kernel 1 on a CUDA tensor, its plain version on a CPU tensor."""
    if q.device.type == "cuda":
        return block_attention_fwd_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                                        bias.float().contiguous(), causal)
    if q.device.type == "cpu":
        return attention_core_plain(q, k, v, bias, causal)
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
