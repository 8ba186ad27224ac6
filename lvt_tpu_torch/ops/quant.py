"""Absmax int8 quantization and the int8-weight product of the sampler
(counterpart of lvt_tpu/ops/quant_matmul.py and of ``_quantize_cols`` in
lvt_tpu/models/vt_incremental.py).

``matmul_i8w`` launches the hand-written kernel (csrc/matmul_i8w.cu) on a
CUDA tensor and runs the plain PyTorch version of the same function on a CPU
tensor. The int8 weight is held transposed, (N, K), so that the kernel finds
four consecutive K of one output column in one word. ``matmul_i8w_plan``
picks the kernel's columns per block on the host.

Under tensor parallelism a rank holds part of a row-split weight (proj, FFN
2: some of its input rows) and the matching part of each activation row.
The scales that span whole rows or columns are then taken over the model
group: ``quantize_cols(group=)`` takes each column's absmax over every
rank's rows, so that a rank's integers are those rows of the whole weight's
quantization, and ``row_amax`` hands kernel 11 each activation row's absmax
over the group's parts, so that a rank's int8 row is its part of the whole
row's. ``matmul_i8w_split`` then has the kernel write its exact int32 sums,
adds them over the group and scales once: the whole product, bit for bit.
"""

from functools import lru_cache
from typing import Optional

import torch

from ..parallel.collectives import max_over_model, reduce_from_model
from ._lib import CARD_SMS, LIBRARY, check_launch, counted

_FLOATS = (torch.float32, torch.bfloat16)
_OUT_TYPES = (torch.float32, torch.bfloat16, torch.int32)  # kernel 11's out_type 0, 1, 2

# Kernel 11's grid: blocks of 256 threads over I8W_ROWS activation rows and
# `cpb` output columns, the 256 / cpb threads of a column splitting its K.
# Every block quantizes its rows of y itself, so fewer, wider blocks repeat
# less of that work: cpb is the smallest of I8W_CPB whose blocks all fit one
# wave of one block an SM of the card, the largest where none does. On the
# H100 (tools/time_i8w_vq_parts_torch.py), b = 8, N = 512: 128 blocks read
# 0.0041 / 0.0046 ms at K = 512 / 1,024, 256 blocks 0.0045 / 0.0050; b = 16,
# N = 3,072: 384 blocks 0.0057, 768 blocks 0.0083.
I8W_ROWS = 8
I8W_CPB = (2, 4, 8, 16)


def matmul_i8w_plan(b: int, K: int, N: int):
    """(cpb, blocks along N, blocks along b) of kernel 11 for y (b, K) and
    an (N, K) weight (csrc/matmul_i8w.cu takes cpb as it is given)."""
    groups = -(-b // I8W_ROWS)
    cpb = next((c for c in I8W_CPB if -(-N // c) * groups <= CARD_SMS), I8W_CPB[-1])
    return cpb, -(-N // cpb), groups


# the largest integer of each quantized width: int8 (127 levels each side)
# and int4 (7; the sampler's int4 KV cache)
QMAX = {"int8": 127, "int4": 7}


@lru_cache(maxsize=None)
def _qmax(device, dtype, qmax=127):
    # made by a kernel at first use: inside a CUDA graph's capture that kernel
    # would only be recorded, and the cached tensor left unwritten
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("absmax_scale: first use inside a CUDA graph capture; run the "
                           "captured work once before capturing it")
    return torch.full((), float(qmax), device=device, dtype=dtype)


def absmax_scale(amax, qmax: int = 127):
    """amax / qmax by a true division on every device. Dividing a CUDA tensor
    by a Python number multiplies by its reciprocal instead, an ulp apart
    from the CPU's and the kernels' quotient in some cases, and a scale an
    ulp apart rounds a value at a near-tie to another integer."""
    return amax / _qmax(amax.device, amax.dtype, qmax)


def quantize_rows_i8(y, amax=None):
    """(..., d) float -> ((..., d) int8, (..., 1) fp32 scales): absmax / 127
    per row, round half to even, clip to +-127. ``amax`` (...) takes the
    place of each row's own absmax (a row split over a model group: the
    group's)."""
    amax = y.abs().amax(dim=-1, keepdim=True) if amax is None else amax[..., None]
    sy = absmax_scale(amax.float())
    yi = torch.clamp(torch.round(y.float() / (sy + 1e-8)), -127.0, 127.0).to(torch.int8)
    return yi, sy


def quantize_cache_row(x, cdtype, qmax: int = 127):
    """New K or V rows per head, (..., da) -> (int8 rows, (...) scales):
    absmax / qmax per row, round half to even, clip to +-qmax (127: the int8
    cache, 7: the int4 cache's levels, still one per int8 byte here). The
    scale and the division stay in the parameter dtype on purpose (not fp32
    as in ``quantize_rows_i8``): these are the numerics the JAX package's
    quantized caches were measured and tested at
    (lvt_tpu/models/vt_incremental.py, the int8 and int4 cache write)."""
    s = absmax_scale(x.abs().amax(dim=-1).to(cdtype), qmax)
    x8 = torch.clamp(torch.round(x / (s[..., None] + 1e-8)), -float(qmax), float(qmax))
    return x8.to(torch.int8), s


def pack_int4(x8):
    """(..., da) int8 values in [-8, 7] -> (..., da / 2) int8, two signed
    nibbles a byte: element 2i in the low nibble, 2i + 1 in the high one.
    Exact: the high nibble's value times 16 fits the byte, and the low
    nibble is the value's two's complement masked to 4 bits."""
    return (x8[..., 1::2] << 4) | (x8[..., 0::2] & 15)


def unpack_int4(packed, out, scratch):
    """``pack_int4`` undone into ``out`` (..., da), any float or int dtype,
    by arithmetic shifts through ``scratch``, an int8 tensor of packed's
    shape: the high nibble is the byte shifted right by 4, the low one the
    byte shifted left by 4 and back. Nothing is allocated, so a CUDA graph
    that unpacks a growing prefix of a cache takes no block per call."""
    torch.bitwise_right_shift(packed, 4, out=scratch)
    out[..., 1::2].copy_(scratch)
    torch.bitwise_left_shift(packed, 4, out=scratch)
    scratch.bitwise_right_shift_(4)
    out[..., 0::2].copy_(scratch)
    return out


def quantize_cols(w, cdtype, group=None):
    """(in, out) weight -> ((in, out) int8, (out,) scale in ``cdtype``), the
    arithmetic in w's dtype. Exact fold: y @ (W8 * s) == (y @ W8) * s. With
    a model ``group`` w is the rank's rows of a row-split weight, and each
    column's absmax is the maximum over the group's rows."""
    amax = w.abs().amax(dim=0)
    s = absmax_scale(amax if group is None else max_over_model(amax, group))
    wi = torch.clamp(torch.round(w / (s[None, :] + 1e-8)), -127, 127).to(torch.int8)
    return wi, s.to(cdtype)


def matmul_i8w_plain(y, wt, sw, out_dtype: Optional[torch.dtype] = None,
                     row_amax: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of kernel 11. y (b, K) float; wt (N, K) int8, the
    quantized (K, N) weight transposed; sw (N,) column scales; row_amax (b,)
    fp32 or None. The rows of y are quantized to int8 (by row_amax / 127
    where it is given, else by their own absmax), the integer product is
    exact (summed in float64), and the output is scaled by sy, then sw, in
    fp32 and rounded once; out_dtype int32 gives the integer sums unscaled."""
    yi, sy = quantize_rows_i8(y, row_amax)
    acc = yi.double() @ wt.double().t()
    if out_dtype == torch.int32:
        return acc.to(torch.int32)
    return (acc.float() * sy * sw.reshape(1, -1).float()).to(out_dtype or y.dtype)


@counted
def matmul_i8w_cuda(y, wt, sw, out_dtype: Optional[torch.dtype] = None,
                    row_amax: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel 11 (csrc/matmul_i8w.cu) on CUDA tensors: the shapes and types of
    ``matmul_i8w_plain``, all contiguous, y and wt 16-byte aligned, K a
    multiple of 16, row_amax fp32. One launch, its grid from
    ``matmul_i8w_plan``."""
    out_dtype = out_dtype or y.dtype
    if not (y.is_cuda and wt.device == y.device and sw.device == y.device):
        raise ValueError("matmul_i8w_cuda: all inputs must be on one CUDA device")
    if y.dtype not in _FLOATS or sw.dtype not in _FLOATS or out_dtype not in _OUT_TYPES \
            or wt.dtype != torch.int8:
        raise ValueError(f"matmul_i8w_cuda: wants y and sw in float32 or bfloat16, the output "
                         f"in float32, bfloat16 or int32 and an int8 weight, got {y.dtype}, "
                         f"{sw.dtype}, {out_dtype}, {wt.dtype}")
    if y.dim() != 2 or wt.dim() != 2 or wt.shape[1] != y.shape[1] \
            or tuple(sw.shape) != (wt.shape[0],):
        raise ValueError(f"matmul_i8w_cuda: want y (b, K), wt (N, K), sw (N,), got "
                         f"{tuple(y.shape)}, {tuple(wt.shape)}, {tuple(sw.shape)}")
    b, K = y.shape
    N = wt.shape[0]
    if b < 1 or K % 16 or not 16 <= K <= 16384:
        raise ValueError(f"matmul_i8w_cuda: needs b >= 1 and K a multiple of 16 in "
                         f"[16, 16384], got b={b}, K={K}")
    if not all(t.is_contiguous() for t in (y, wt, sw)):
        raise ValueError("matmul_i8w_cuda: inputs must be contiguous")
    if wt.data_ptr() % 16 or y.data_ptr() % 16:  # both are read 16 bytes at a time
        raise ValueError("matmul_i8w_cuda: y and wt must be 16-byte aligned")
    if y.device.index != torch.cuda.current_device():
        raise ValueError("matmul_i8w_cuda: inputs must lie on the current CUDA device")
    if row_amax is not None and (row_amax.device != y.device or row_amax.dtype != torch.float32
                                 or tuple(row_amax.shape) != (b,)
                                 or not row_amax.is_contiguous()):
        raise ValueError(f"matmul_i8w_cuda: row_amax must be contiguous float32 {(b,)} on y's "
                         f"device, got {row_amax.dtype} {tuple(row_amax.shape)} on "
                         f"{row_amax.device}")
    lib = LIBRARY.get()
    out = torch.empty((b, N), dtype=out_dtype, device=y.device)
    err = lib.lvt_matmul_i8w(
        y.data_ptr(), wt.data_ptr(), sw.data_ptr(),
        0 if row_amax is None else row_amax.data_ptr(), out.data_ptr(), b, K, N,
        int(y.dtype == torch.bfloat16), int(sw.dtype == torch.bfloat16),
        _OUT_TYPES.index(out_dtype), matmul_i8w_plan(b, K, N)[0],
        torch.cuda.current_stream().cuda_stream)
    check_launch("matmul_i8w", err)
    matmul_i8w_cuda.launches += 1
    if row_amax is not None:
        matmul_i8w_cuda.row_amax_launches += 1
    return out


matmul_i8w_cuda.row_amax_launches = 0  # the launches given row_amax (a model group's)


def matmul_i8w(y, wt, sw, out_dtype: Optional[torch.dtype] = None,
               row_amax: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel 11 on a CUDA tensor, its plain version on a CPU tensor."""
    if y.device.type == "cuda":
        y = y.contiguous()
        return matmul_i8w_cuda(y if y.data_ptr() % 16 == 0 else y.clone(), wt, sw, out_dtype,
                               row_amax)
    if y.device.type == "cpu":
        return matmul_i8w_plain(y, wt, sw, out_dtype, row_amax)
    raise ValueError(f"matmul_i8w: no kernel for device {y.device}")


def matmul_i8w_split(y, wt, sw, group, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Kernel 11 over a product split by its input rows over a model group
    (proj, FFN 2 under tensor parallelism): y (b, K / M) the rank's features
    of each row, wt (N, K / M) its rows of the weight, transposed, sw (N,)
    the whole weight's column scales (``quantize_cols`` with the group).
    Each row of y is quantized by the group's absmax of the whole row, the
    kernel writes the rank's int32 sums, the group adds them exactly, and
    sy and sw apply once as the kernel's epilogue applies them: the output
    of ``matmul_i8w`` on the whole rows, bit for bit."""
    amax = max_over_model(y.abs().amax(dim=-1).float(), group)
    acc = reduce_from_model(matmul_i8w(y, wt, sw, torch.int32, row_amax=amax), group)
    return (acc.float() * absmax_scale(amax)[:, None] * sw.float()).to(out_dtype or y.dtype)
