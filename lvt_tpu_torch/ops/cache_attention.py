"""Per-pixel decode attention over a KV cache in the parameter dtype or in
int8 (counterpart of the attention step of lvt_tpu/models/vt_incremental.py
and of the decode kernels of lvt_tpu/ops/cache_attention.py).

The port's cache keeps heads apart: one layer's K and V are (b, na, R, da),
preallocated at R = the block run and written in place one row per pixel; an
int8 cache has per-row scales (b, na, R) beside it. Every function here reads
rows [0, live) only: in the JAX package the rows above carry a -1e9 (or
-1e30) logit, whose exp is exactly 0, so they add nothing to a maximum, a sum
or a quantization scale, and leaving them out is the same function.

=================================  ======  ==================================
function                           kernel  csrc
=================================  ======  ==================================
``decode_attention``               2       decode_attention.cu
``decode_attention_i8``            3       decode_attention_i8.cu
``decode_attention_i8_step``       3       decode_attention_i8.cu
``decode_attention_i8_live``       4       decode_attention_i8.cu
``decode_attention_i8_live_step``  4       decode_attention_i8.cu
``cache_attention_i8``             5       decode_attention_i8.cu
``decode_attention_i8kv``          12      decode_attention_i8.cu
=================================  ======  ==================================

The ``*_step`` functions are the sampler's call: kernel 3 or 4 with the
quantization of q and of the new cache row folded in (one launch per layer
and pixel on the card; on the CPU the PyTorch sequence it replaces).

Kernel 12 is the probe kernel of tools/probe_decode_kernel.py: on no path of
the sampler, as in the JAX package; tools/probe_decode_kernel_torch.py drives
it.

On a CUDA tensor each launches its hand-written kernel; on a CPU tensor it
runs the plain PyTorch version of the same function (``*_plain``).
"""

from typing import Optional

import torch

from ._lib import CARD_SMS, LIBRARY, check_launch, counted
from .quant import absmax_scale, quantize_cache_row, quantize_rows_i8


def decode_attention_plain(q, kc, vc, live: int, bias, scale: float) -> torch.Tensor:
    """Plain PyTorch version of kernel 2. q (b, na, da) in the cache dtype;
    kc, vc (b, na, R, da); bias (na, R) fp32. Logits and softmax in fp32,
    weights rounded to the cache dtype before the V product, output
    (b, na*da) in the cache dtype."""
    b, na, da = q.shape
    k = kc[:, :, :live].float()
    v = vc[:, :, :live].float()
    logits = torch.einsum("bak,bajk->baj", q.float(), k) * scale + bias[None, :, :live].float()
    w = torch.softmax(logits, dim=-1).to(kc.dtype).float()
    out = torch.einsum("baj,bajk->bak", w, v)
    return out.to(kc.dtype).reshape(b, na * da)


# kernel 2's launch plan: C blocks (a thread-block cluster) per (batch row,
# head), C the least power of two up to MAX_CLUSTER that puts at least
# CARD_SMS blocks on the card, twice as many once live exceeds LONG_LIVE
# rows (measured on the H100 by tools/time_decode_parts_torch.py: at b = 8
# and 16, live = 256, the doubled cluster is faster, at live = 64 slower);
# rank r of a cluster owns the live rows [r * chunk, min((r + 1) * chunk,
# live)), chunk = ceil(live / C)
MAX_CLUSTER = 16
LONG_LIVE = 128


def decode_plan(b: int, na: int, live: int):
    """(C, chunk) of kernel 2 for b batch rows, na heads, live rows: the
    cluster size and the rows each rank owns (csrc/decode_attention.cu
    computes the same chunk from live and C)."""
    blocks = CARD_SMS * (2 if live > LONG_LIVE else 1)
    c = 1
    while c < MAX_CLUSTER and b * na * c < blocks:
        c *= 2
    return c, -(-live // c)


# Kernels 3 and 4 are one launch of clusters too (a plain launch for one
# block per (batch row, head)), each rank owning a contiguous range of live
# rows: kernel 3 `chunk` rows (a multiple of I8_ROW_ALIGN, so that a rank's
# scales start on 16 bytes), kernel 4 whole tiles of rtile rows. A rank of 4
# warps loads up to 4 * I8_WARP_BYTES of K rows (64 rows at da = 128) and as
# many V bytes into registers at entry ("direct"), one of 8 warps twice
# that; a longer range lands in bulk copies of at most I8_TILE_BYTES
# (kernel 4: whole tiles in a copy, or whole copies in a tile), I8_STAGES of
# each in flight. The plan, from a sweep of every cluster size, ring and
# direct, 4 and 8 warps, on the H100 (tools/time_decode_i8_torch.py; na = 8,
# da = 128, b in 1, 8, 16 x live in 16, 64, 128, 256): one rank while 8
# warps hold its rows (4 warps while 4 do), else the fewest ranks of 4 warps
# that hold theirs. A direct rank beat a ring at every size; one rank beat a
# cluster while it could hold the rows (kernel 3 at b = 8, live = 128: one
# rank of 8 warps 0.0052 ms, two of 4 0.0061-0.0065); past that, more and
# smaller ranks won (live = 256: four ranks of 4 warps 0.0074, two of 8
# 0.0077, eight of 4 0.0080). Shared memory of a rank mirrors
# csrc/decode_attention_i8.cu smem_layout; where it would exceed a block's,
# the cluster grows.
I8_ROW_ALIGN = 8
I8_TILE_BYTES = 8192
I8_STAGES = 4
I8_WARP_BYTES = 4 * 32 * 16
I8_MAX_SMEM = 232448


def _up16(x: int) -> int:
    return (x + 15) // 16 * 16


def i8_smem_bytes(da: int, c: int, chunk: int, ring_rows: int, tiles: int, live_kernel: bool,
                  direct: bool = False):
    """Dynamic shared memory of one rank of kernel 3 (live_kernel False) or
    4: the K and V rings (none when the rows are read directly), logits and
    scales of its rows, what the other ranks push, the column sums, q8, the
    new rows and the mbarriers."""
    stages = 0 if direct else max(1, min(I8_STAGES, -(-chunk // ring_rows)))
    warps = 8 if direct and chunk * da > 4 * I8_WARP_BYTES else 4
    per = da // c
    o = 2 * stages * I8_TILE_BYTES
    o = _up16(o + 4 * chunk)
    o = _up16(o + 4 * chunk)
    o = _up16(o + 4 * chunk)
    o = _up16(o + 4 * (tiles if live_kernel else 2 * c))
    o = _up16(o + 4 * (2 * tiles if live_kernel else c))
    o = _up16(o + 4 * (tiles if live_kernel else c) * per)
    o = _up16(o + 4 * warps * da)
    o = _up16(o + 4 * warps)
    o = _up16(o + da)
    o = _up16(o + 2 * da)
    o = _up16(o + 16)
    return o + 8 * (2 * stages + 3)


def i8_ring_rows(rtile: int, da: int) -> int:
    """Rows of one bulk copy of kernel 4: as many whole tiles as
    I8_TILE_BYTES holds, or the largest divisor of a longer tile that fits."""
    cap = I8_TILE_BYTES // da
    if rtile <= cap:
        return cap // rtile * rtile
    return max(d for d in range(1, cap + 1) if rtile % d == 0)


def decode_i8_plan(live: int, da: int = 128):
    """(C, chunk, direct) of kernel 3 over `live` rows of width da: the
    cluster size, the live rows of each rank (rank r owns [r * chunk,
    min((r + 1) * chunk, live))) and whether a rank reads its rows directly
    (else through the ring of bulk copies)."""
    c = 1
    if _i8_chunk(live, 1) * da > 8 * I8_WARP_BYTES:
        while c < MAX_CLUSTER and _i8_chunk(live, c) * da > 4 * I8_WARP_BYTES:
            c *= 2
    ring = I8_TILE_BYTES // da
    while c < MAX_CLUSTER and \
            i8_smem_bytes(da, c, _i8_chunk(live, c), ring, c, False) > I8_MAX_SMEM:
        c *= 2
    chunk = _i8_chunk(live, c)
    return c, chunk, chunk * da <= 8 * I8_WARP_BYTES


def _i8_chunk(live: int, c: int) -> int:
    """ceil(live / c) rounded up to I8_ROW_ALIGN rows."""
    return -(-live // (c * I8_ROW_ALIGN)) * I8_ROW_ALIGN


def decode_i8_live_plan(live: int, rtile: int, da: int = 128):
    """(C, chunk, ring_rows, direct) of kernel 4 for tiles of `rtile` rows:
    the cluster size, the rows of each rank (whole tiles: rank r owns tiles
    [r * chunk / rtile, (r + 1) * chunk / rtile) of the live ones), the rows
    of one bulk copy, and whether a rank reads its rows directly."""
    tiles = -(-live // rtile)
    ring = i8_ring_rows(rtile, da)

    def chunk(c):
        return -(-tiles // c) * rtile

    c = 1
    if chunk(1) * da > 8 * I8_WARP_BYTES:
        while c < MAX_CLUSTER and c < tiles and chunk(c) * da > 4 * I8_WARP_BYTES:
            c *= 2
    while c < MAX_CLUSTER and i8_smem_bytes(da, c, chunk(c), ring, tiles, True) > I8_MAX_SMEM:
        c *= 2
    return c, chunk(c), ring, chunk(c) * da <= 8 * I8_WARP_BYTES


@counted
def decode_attention_cuda(q, kc, vc, live: int, bias, scale: float) -> torch.Tensor:
    """Kernel 2 (csrc/decode_attention.cu) on CUDA tensors: the shapes and
    types of ``decode_attention_plain``, all contiguous, da in {64, 128}.
    One cluster launch, its size from ``decode_plan``."""
    if not (q.is_cuda and kc.device == q.device and vc.device == q.device
            and bias.device == q.device):
        raise ValueError("decode_attention_cuda: all inputs must be on one CUDA device")
    if kc.dtype not in (torch.float32, torch.bfloat16) or vc.dtype != kc.dtype \
            or q.dtype != kc.dtype:
        raise ValueError(f"decode_attention_cuda: q and the caches must share float32 or "
                         f"bfloat16, got {q.dtype}, {kc.dtype}, {vc.dtype}")
    if bias.dtype != torch.float32:
        raise ValueError(f"decode_attention_cuda: bias must be float32, got {bias.dtype}")
    if q.dim() != 3 or kc.dim() != 4 or vc.shape != kc.shape:
        raise ValueError(f"decode_attention_cuda: want q (b, na, da) and caches "
                         f"(b, na, R, da), got {tuple(q.shape)}, {tuple(kc.shape)}, "
                         f"{tuple(vc.shape)}")
    b, na, R, da = kc.shape
    if tuple(q.shape) != (b, na, da) or tuple(bias.shape) != (na, R):
        raise ValueError(f"decode_attention_cuda: q must be {(b, na, da)} and bias "
                         f"{(na, R)}, got {tuple(q.shape)}, {tuple(bias.shape)}")
    if da not in (64, 128) or not 1 <= live <= R or R > 32768:
        raise ValueError(f"decode_attention_cuda: needs da in (64, 128) and "
                         f"1 <= live <= R <= 32768, got da={da}, live={live}, R={R}")
    if not all(t.is_contiguous() for t in (q, kc, vc, bias)):
        raise ValueError("decode_attention_cuda: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, kc, vc)):  # the kernel reads them 16 bytes at a time
        raise ValueError("decode_attention_cuda: q, kc, vc must be 16-byte aligned")
    lib = LIBRARY.get()
    out = torch.empty((b, na * da), dtype=kc.dtype, device=kc.device)
    if q.device.index != torch.cuda.current_device():
        raise ValueError("decode_attention_cuda: inputs must lie on the current CUDA device")
    stream = torch.cuda.current_stream().cuda_stream
    err = lib.lvt_decode_attention(
        q.data_ptr(), kc.data_ptr(), vc.data_ptr(), bias.data_ptr(), out.data_ptr(),
        b, na, R, da, int(live), decode_plan(b, na, int(live))[0],
        0 if kc.dtype == torch.float32 else 1, float(scale), stream)
    check_launch("decode_attention", err)
    decode_attention_cuda.launches += 1
    return out


def decode_attention(q, kc, vc, live: int, bias, scale: float) -> torch.Tensor:
    """Kernel 2 on a CUDA tensor, its plain version on a CPU tensor."""
    if kc.device.type == "cuda":
        return decode_attention_cuda(q.contiguous(), kc, vc, live, bias, scale)
    if kc.device.type == "cpu":
        return decode_attention_plain(q, kc, vc, live, bias, scale)
    raise ValueError(f"decode_attention: no kernel for device {kc.device}")


# --------------------------------------------------------------------------
# int8 caches: kernels 3, 4 and 5
# --------------------------------------------------------------------------

_FLOATS = (torch.float32, torch.bfloat16)


def _i8_logits(q8, sq, k8, ks, live: int, bias, scale: float) -> torch.Tensor:
    """fp32 logits (b, na, live) of kernels 3 and 4: the exact integer
    product q8 . k8 (summed in float64), times sq * scale, times ks, plus
    the bias row."""
    dots = torch.einsum("bak,bajk->baj", q8.double(), k8[:, :, :live].double()).float()
    logits = dots * (sq.float() * scale)[:, :, None]
    return logits * ks[:, :, :live].float() + bias[None, :, :live].float()


def _i8_weighted_rows(w8, v8) -> torch.Tensor:
    """Exact integer sum_j w8_j v8_j (float64), as fp32: (b, na, da)."""
    return torch.einsum("baj,bajk->bak", w8.double(), v8.double()).float()


def i8_weight_step(q8, sq, k8, ks, vs, live: int, bias, scale: float) -> torch.Tensor:
    """(b, na) fp32: one quantization step of kernel 3's weight row,
    max_j(softmax_j * vs_j) / 127. A weight that rounds the other way moves
    an output of kernel 3 by this times one |v8|; kernel 4's per-tile steps,
    carried to its normalised output, are no larger."""
    w = torch.softmax(_i8_logits(q8, sq, k8, ks, live, bias, scale), dim=-1)
    return absmax_scale((w * vs[:, :, :live].float()).abs().amax(dim=-1))


def decode_attention_i8_plain(q8, sq, k8, ks, v8, vs, live: int, bias, scale: float,
                              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain PyTorch version of kernel 3. q8 (b, na, da) int8 with scales sq
    (b, na) fp32; k8, v8 (b, na, R, da) int8 (or their values as float64,
    which are not cast again) with row scales ks, vs (b, na, R); bias
    (na, R) fp32. int32 q8 . k8 -> fp32 softmax -> times vs
    -> one absmax int8 quantization of the weight row -> int32 w8 . v8 ->
    times the row's scale. Output (b, na*da) in ``out_dtype`` (default: the
    scales' dtype)."""
    b, na, da = q8.shape
    w = torch.softmax(_i8_logits(q8, sq, k8, ks, live, bias, scale), dim=-1)
    w = w * vs[:, :, :live].float()
    sw = absmax_scale(w.abs().amax(dim=-1, keepdim=True))
    w8 = torch.clamp(torch.round(w / (sw + 1e-8)), -127.0, 127.0)
    out = _i8_weighted_rows(w8, v8[:, :, :live]) * sw
    return out.to(out_dtype or ks.dtype).reshape(b, na * da)


def decode_attention_i8_live_plain(q8, sq, k8, ks, v8, vs, live: int, bias, scale: float,
                                   out_dtype: Optional[torch.dtype] = None,
                                   rtile: int = 64) -> torch.Tensor:
    """Plain PyTorch version of kernel 4: kernel 3's operands (bias with no
    causal mask) walked in tiles of min(rtile, R) rows with the online-softmax
    recurrence; the unnormalised p * vs is quantized per tile, and the sum is
    divided by the denominator after the last live tile."""
    b, na, da = q8.shape
    R = k8.shape[2]
    rtile = min(rtile, R)
    if R % rtile:
        raise ValueError(f"rtile={rtile} must divide the buffer rows ({R})")
    logits = _i8_logits(q8, sq, k8, ks, live, bias, scale)
    m = torch.full((b, na, 1), -1e30, dtype=torch.float32, device=q8.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, na, da), dtype=torch.float32, device=q8.device)
    for j0 in range(0, live, rtile):
        j1 = min(j0 + rtile, live)
        lg = logits[:, :, j0:j1]
        m_new = torch.maximum(m, lg.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(lg - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        pw = p * vs[:, :, j0:j1].float()
        sw = absmax_scale(pw.abs().amax(dim=-1, keepdim=True))
        w8 = torch.clamp(torch.round(pw / (sw + 1e-8)), -127.0, 127.0)
        acc = acc * alpha + _i8_weighted_rows(w8, v8[:, :, j0:j1]) * sw
        m = m_new
    out = acc / (l + 1e-30)
    return out.to(out_dtype or ks.dtype).reshape(b, na * da)


def cache_attention_i8_plain(q, k8, ks, v8, vs, extra, scale: float,
                             live: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of kernel 5. q (b, na, da) float; k8, v8
    (b, na, CL, da) int8; ks, vs (b, na, CL) fp32; extra (b or 1, na, CL)
    fp32, the bias row with any mask folded in. Everything in fp32, the
    weights included; output (b, na, da) in q's dtype. ``live`` reads rows
    [0, live) only (default: all CL)."""
    live = k8.shape[2] if live is None else live
    logits = torch.einsum("bad,bajd->baj", q.float(), k8[:, :, :live].float()) * scale
    logits = logits * ks[:, :, :live] + extra[:, :, :live]
    w = torch.softmax(logits, dim=-1) * vs[:, :, :live]
    return torch.einsum("baj,bajd->bad", w, v8[:, :, :live].float()).to(q.dtype)


def _check_i8_cache(name, lead, k8, ks, v8, vs, live, scale_dtypes, das=(64, 128),
                    lead_strided=False):
    """The checks the int8 wrappers share, ``lead`` the query (with
    ``lead_strided`` it may have a batch stride); returns (b, na, R, da)."""
    tensors = (lead, k8, ks, v8, vs)
    if not (lead.is_cuda and all(t.device == lead.device for t in tensors)):
        raise ValueError(f"{name}: all inputs must be on one CUDA device")
    if lead.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: inputs must lie on the current CUDA device")
    if k8.dtype != torch.int8 or v8.dtype != torch.int8:
        raise ValueError(f"{name}: the caches must be int8, got {k8.dtype}, {v8.dtype}")
    if ks.dtype not in scale_dtypes or vs.dtype != ks.dtype:
        raise ValueError(f"{name}: ks and vs must share a dtype of {scale_dtypes}, got "
                         f"{ks.dtype}, {vs.dtype}")
    if lead.dim() != 3 or k8.dim() != 4 or v8.shape != k8.shape:
        raise ValueError(f"{name}: want a query (b, na, da) and caches (b, na, R, da), got "
                         f"{tuple(lead.shape)}, {tuple(k8.shape)}, {tuple(v8.shape)}")
    b, na, R, da = k8.shape
    if tuple(lead.shape) != (b, na, da) or tuple(ks.shape) != (b, na, R) or vs.shape != ks.shape:
        raise ValueError(f"{name}: the query must be {(b, na, da)} and the scales {(b, na, R)}, "
                         f"got {tuple(lead.shape)}, {tuple(ks.shape)}, {tuple(vs.shape)}")
    if da not in das or not 1 <= live <= R or R > 32768:
        raise ValueError(f"{name}: needs da in {das} and 1 <= live <= R <= 32768, got "
                         f"da={da}, live={live}, R={R}")
    if not all(t.is_contiguous() for t in tensors[int(lead_strided):]):
        raise ValueError(f"{name}: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (k8, v8)):  # the kernels read rows 16 bytes at a time
        raise ValueError(f"{name}: the caches must be 16-byte aligned")
    return b, na, R, da


def _check_i8_query(name, q8, sq, bias, b, na, R, out_dtype):
    if q8.dtype != torch.int8 or q8.data_ptr() % 16:
        raise ValueError(f"{name}: q8 must be int8 and 16-byte aligned, got {q8.dtype}")
    if sq.dtype != torch.float32 or tuple(sq.shape) != (b, na) or not sq.is_contiguous() \
            or sq.device != q8.device:
        raise ValueError(f"{name}: sq must be contiguous float32 {(b, na)} on q8's device, got "
                         f"{sq.dtype} {tuple(sq.shape)}")
    if bias.dtype != torch.float32 or tuple(bias.shape) != (na, R) or not bias.is_contiguous() \
            or bias.device != q8.device:
        raise ValueError(f"{name}: bias must be contiguous float32 {(na, R)} on q8's device, "
                         f"got {bias.dtype} {tuple(bias.shape)}")
    if out_dtype not in _FLOATS:
        raise ValueError(f"{name}: the output must be float32 or bfloat16, got {out_dtype}")


@counted
def decode_attention_i8_cuda(q8, sq, k8, ks, v8, vs, live: int, bias, scale: float,
                             out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Kernel 3 (csrc/decode_attention_i8.cu) on CUDA tensors: the shapes and
    types of ``decode_attention_i8_plain``, all contiguous, da in {64, 128}.
    One cluster launch, its size from ``decode_i8_plan``."""
    name = "decode_attention_i8_cuda"
    out_dtype = out_dtype or ks.dtype
    b, na, R, da = _check_i8_cache(name, q8, k8, ks, v8, vs, live, _FLOATS)
    _check_i8_query(name, q8, sq, bias, b, na, R, out_dtype)
    out = torch.empty((b, na * da), dtype=out_dtype, device=k8.device)
    c, chunk, direct = decode_i8_plan(int(live), da)
    err = LIBRARY.get().lvt_decode_attention_i8(
        q8.data_ptr(), sq.data_ptr(), k8.data_ptr(), ks.data_ptr(), v8.data_ptr(),
        vs.data_ptr(), bias.data_ptr(), out.data_ptr(), b, na, R, da, int(live), c, chunk,
        int(direct), int(ks.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        float(scale), torch.cuda.current_stream().cuda_stream)
    check_launch("decode_attention_i8", err)
    decode_attention_i8_cuda.launches += 1
    return out


def _live_plan(name, R, da, live, rtile):
    """Kernel 4's tile and launch plan; refuses a tile that does not divide
    the buffer or more live tiles than a cluster's shared memory holds."""
    rtile = min(int(rtile), R)
    if rtile < 1 or R % rtile:
        raise ValueError(f"{name}: rtile={rtile} must divide the buffer rows ({R})")
    c, chunk, ring, direct = decode_i8_live_plan(int(live), rtile, da)
    tiles = -(-int(live) // rtile)
    if i8_smem_bytes(da, c, chunk, ring, tiles, True, direct) > I8_MAX_SMEM:
        raise ValueError(f"{name}: {tiles} live tiles of {rtile} rows do not fit a cluster's "
                         "shared memory; take longer tiles")
    return rtile, c, chunk, ring, int(direct)


@counted
def decode_attention_i8_live_cuda(q8, sq, k8, ks, v8, vs, live: int, bias, scale: float,
                                  out_dtype: Optional[torch.dtype] = None,
                                  rtile: int = 64) -> torch.Tensor:
    """Kernel 4 (csrc/decode_attention_i8.cu) on CUDA tensors: the shapes and
    types of ``decode_attention_i8_live_plain``; min(rtile, R) must divide R.
    One cluster launch, its size from ``decode_i8_live_plan``."""
    name = "decode_attention_i8_live_cuda"
    out_dtype = out_dtype or ks.dtype
    b, na, R, da = _check_i8_cache(name, q8, k8, ks, v8, vs, live, _FLOATS)
    _check_i8_query(name, q8, sq, bias, b, na, R, out_dtype)
    plan = _live_plan(name, R, da, live, rtile)
    out = torch.empty((b, na * da), dtype=out_dtype, device=k8.device)
    err = LIBRARY.get().lvt_decode_attention_i8_live(
        q8.data_ptr(), sq.data_ptr(), k8.data_ptr(), ks.data_ptr(), v8.data_ptr(),
        vs.data_ptr(), bias.data_ptr(), out.data_ptr(), b, na, R, da, int(live), *plan,
        int(ks.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        float(scale), torch.cuda.current_stream().cuda_stream)
    check_launch("decode_attention_i8_live", err)
    decode_attention_i8_live_cuda.launches += 1
    return out


# --------------------------------------------------------------------------
# kernels 3 and 4 with the quantization of q and of the new cache row folded in
# --------------------------------------------------------------------------

def _step_plain(attend, q, kv, k8, ks, v8, vs, live: int, *args, q_out: bool = False):
    """The sampler's sequence around kernel 3 or 4, in PyTorch: the new rows
    quantized and written at row live - 1, q quantized, then ``attend``."""
    kv8, kvs = quantize_cache_row(kv, ks.dtype)
    k8[:, :, live - 1], v8[:, :, live - 1] = kv8[:, 0], kv8[:, 1]
    ks[:, :, live - 1], vs[:, :, live - 1] = kvs[:, 0], kvs[:, 1]
    q8, sq = quantize_rows_i8(q)
    out = attend(q8, sq[..., 0], k8, ks, v8, vs, live, *args)
    return (out, q8, sq[..., 0]) if q_out else out


def decode_attention_i8_step_plain(q, kv, k8, ks, v8, vs, live: int, bias, scale: float,
                                   out_dtype: Optional[torch.dtype] = None,
                                   q_out: bool = False):
    """Plain PyTorch version of kernel 3 with the fold. q (b, na, da) and the
    new K and V rows kv (b, 2, na, da) in the scales' dtype; the caches as
    ``decode_attention_i8_plain`` takes them. Writes the new rows, quantized
    by ``ops.quant.quantize_cache_row``, and their scales into row live - 1
    of the caches (in place), quantizes q by ``quantize_rows_i8`` and
    attends over rows [0, live). Returns the output, and with ``q_out`` also
    q8 (b, na, da) and sq (b, na)."""
    return _step_plain(decode_attention_i8_plain, q, kv, k8, ks, v8, vs, live, bias, scale,
                       out_dtype, q_out=q_out)


def decode_attention_i8_live_step_plain(q, kv, k8, ks, v8, vs, live: int, bias, scale: float,
                                        out_dtype: Optional[torch.dtype] = None,
                                        rtile: int = 64, q_out: bool = False):
    """Plain PyTorch version of kernel 4 with the fold: as
    ``decode_attention_i8_step_plain``, attending as
    ``decode_attention_i8_live_plain``."""
    return _step_plain(decode_attention_i8_live_plain, q, kv, k8, ks, v8, vs, live, bias, scale,
                       out_dtype, rtile, q_out=q_out)


def _step_cuda(name, entry, q, kv, k8, ks, v8, vs, live, bias, scale, out_dtype, q_out,
               tile_args):
    """Launch kernel 3 or 4 with the fold (``entry``: the C function) on
    CUDA tensors; ``tile_args(R, da)`` gives the plan's arguments."""
    out_dtype = out_dtype or ks.dtype
    if q.dim() != 3 or kv.dim() != 4:
        raise ValueError(f"{name}: want q (b, na, da) and kv (b, 2, na, da), got "
                         f"{tuple(q.shape)}, {tuple(kv.shape)}")
    b, na, R, da = _check_i8_cache(name, q, k8, ks, v8, vs, live, _FLOATS, lead_strided=True)
    if kv.device != k8.device:
        raise ValueError(f"{name}: kv must lie on the caches' CUDA device")
    if q.dtype != ks.dtype or kv.dtype != ks.dtype:
        raise ValueError(f"{name}: q, kv and the scales must share one dtype (the new rows' "
                         f"scales are formed in it), got {q.dtype}, {kv.dtype}, {ks.dtype}")
    if tuple(q.shape) != (b, na, da) or tuple(kv.shape) != (b, 2, na, da):
        raise ValueError(f"{name}: q must be {(b, na, da)} and kv {(b, 2, na, da)}, got "
                         f"{tuple(q.shape)}, {tuple(kv.shape)}")
    if q.stride()[1:] != (da, 1) or kv.stride()[1:] != (na * da, da, 1):
        raise ValueError(f"{name}: q and kv may have a batch stride only; got strides "
                         f"{q.stride()}, {kv.stride()}")
    if bias.dtype != torch.float32 or tuple(bias.shape) != (na, R) or not bias.is_contiguous() \
            or bias.device != k8.device:
        raise ValueError(f"{name}: bias must be contiguous float32 {(na, R)} on the caches' "
                         f"device, got {bias.dtype} {tuple(bias.shape)}")
    if out_dtype not in _FLOATS:
        raise ValueError(f"{name}: the output must be float32 or bfloat16, got {out_dtype}")
    plan = tile_args(R, da)
    out = torch.empty((b, na * da), dtype=out_dtype, device=k8.device)
    q8 = torch.empty((b, na, da), dtype=torch.int8, device=k8.device) if q_out else None
    sq = torch.empty((b, na), dtype=torch.float32, device=k8.device) if q_out else None
    err = getattr(LIBRARY.get(), entry)(
        q.data_ptr(), kv.data_ptr(), q.stride(0), kv.stride(0),
        q8.data_ptr() if q_out else None, sq.data_ptr() if q_out else None,
        k8.data_ptr(), ks.data_ptr(), v8.data_ptr(), vs.data_ptr(), bias.data_ptr(),
        out.data_ptr(), b, na, R, da, int(live), *plan, int(ks.dtype == torch.bfloat16),
        int(out_dtype == torch.bfloat16), float(scale), torch.cuda.current_stream().cuda_stream)
    check_launch(name, err)
    return (out, q8, sq) if q_out else out


@counted
def decode_attention_i8_step_cuda(q, kv, k8, ks, v8, vs, live: int, bias, scale: float,
                                  out_dtype: Optional[torch.dtype] = None,
                                  q_out: bool = False):
    """Kernel 3 with the fold (csrc/decode_attention_i8.cu,
    lvt_decode_attention_i8_step) on CUDA tensors: the operands of
    ``decode_attention_i8_step_plain``; q and kv may have a batch stride
    (the sampler passes views of its fused QKV product). One cluster launch,
    its size from ``decode_i8_plan``."""
    out = _step_cuda("decode_attention_i8_step_cuda", "lvt_decode_attention_i8_step", q, kv, k8,
                     ks, v8, vs, live, bias, scale, out_dtype, q_out,
                     lambda R, da: [int(x) for x in decode_i8_plan(int(live), da)])
    decode_attention_i8_step_cuda.launches += 1
    return out


@counted
def decode_attention_i8_live_step_cuda(q, kv, k8, ks, v8, vs, live: int, bias, scale: float,
                                       out_dtype: Optional[torch.dtype] = None,
                                       rtile: int = 64, q_out: bool = False):
    """Kernel 4 with the fold (lvt_decode_attention_i8_live_step) on CUDA
    tensors: the operands of ``decode_attention_i8_live_step_plain``, q and
    kv as ``decode_attention_i8_step_cuda`` takes them."""
    name = "decode_attention_i8_live_step_cuda"
    out = _step_cuda(name, "lvt_decode_attention_i8_live_step", q, kv, k8, ks, v8, vs, live,
                     bias, scale, out_dtype, q_out,
                     lambda R, da: _live_plan(name, R, da, live, rtile))
    decode_attention_i8_live_step_cuda.launches += 1
    return out


def _float_query_cuda(name, entry, das, q, k8, ks, v8, vs, extra, scale, live):
    """Kernels 5 and 12 share their operands: a float q over int8 caches with
    fp32 scales and an fp32 ``extra`` row."""
    live = k8.shape[2] if live is None and k8.dim() == 4 else live
    b, na, R, da = _check_i8_cache(name, q, k8, ks, v8, vs, live, (torch.float32,), das)
    if q.dtype not in _FLOATS:
        raise ValueError(f"{name}: q must be float32 or bfloat16, got {q.dtype}")
    if extra.dtype != torch.float32 or extra.dim() != 3 or extra.shape[0] not in (1, b) \
            or tuple(extra.shape[1:]) != (na, R) or not extra.is_contiguous() \
            or extra.device != q.device:
        raise ValueError(f"{name}: extra must be contiguous float32 (b or 1, {na}, {R}) on q's "
                         f"device, got {extra.dtype} {tuple(extra.shape)}")
    out = torch.empty((b, na, da), dtype=q.dtype, device=q.device)
    err = getattr(LIBRARY.get(), entry)(
        q.data_ptr(), k8.data_ptr(), ks.data_ptr(), v8.data_ptr(), vs.data_ptr(),
        extra.data_ptr(), out.data_ptr(), b, na, R, da, int(live), extra.shape[0],
        int(q.dtype == torch.bfloat16), float(scale), torch.cuda.current_stream().cuda_stream)
    check_launch(name, err)
    return out


@counted
def cache_attention_i8_cuda(q, k8, ks, v8, vs, extra, scale: float,
                            live: Optional[int] = None) -> torch.Tensor:
    """Kernel 5 (csrc/decode_attention_i8.cu) on CUDA tensors: the shapes and
    types of ``cache_attention_i8_plain``, all contiguous, da in {64, 128}."""
    out = _float_query_cuda("cache_attention_i8_cuda", "lvt_cache_attention_i8", (64, 128),
                            q, k8, ks, v8, vs, extra, scale, live)
    cache_attention_i8_cuda.launches += 1
    return out


def decode_attention_i8kv_plain(q, k8, ks, v8, vs, extra, scale: float,
                                live: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of kernel 12, the probe kernel: kernel 5's
    operands, q (b, na, da) in the io dtype and not quantized. K and V
    converted from int8 exactly and the products summed in fp32; logits =
    (q . K) * scale * ks + extra; the softmax normalised by a division; the
    weight row softmax * vs rounded once to the io dtype before the V
    product; output (b, na, da) rounded to io."""
    live = k8.shape[2] if live is None else live
    logits = torch.einsum("bad,bajd->baj", q.float(), k8[:, :, :live].float()) * scale
    logits = logits * ks[:, :, :live] + extra[:, :, :live]
    w = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    w = w / w.sum(dim=-1, keepdim=True)
    w = (w * vs[:, :, :live]).to(q.dtype)
    return torch.einsum("baj,bajd->bad", w.float(), v8[:, :, :live].float()).to(q.dtype)


@counted
def decode_attention_i8kv_cuda(q, k8, ks, v8, vs, extra, scale: float,
                               live: Optional[int] = None) -> torch.Tensor:
    """Kernel 12 (csrc/decode_attention_i8.cu) on CUDA tensors: the shapes
    and types of ``decode_attention_i8kv_plain``, all contiguous, da in
    {16, 64, 128}."""
    out = _float_query_cuda("decode_attention_i8kv_cuda", "lvt_decode_attention_i8kv",
                            (16, 64, 128), q, k8, ks, v8, vs, extra, scale, live)
    decode_attention_i8kv_cuda.launches += 1
    return out


def _dispatch(name, device, cuda_fn, plain_fn):
    if device.type == "cuda":
        return cuda_fn
    if device.type == "cpu":
        return plain_fn
    raise ValueError(f"{name}: no kernel for device {device}")


def decode_attention_i8(q8, sq, k8, ks, v8, vs, live: int, bias, scale: float,
                        out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Kernel 3 on a CUDA tensor, its plain version on a CPU tensor."""
    fn = _dispatch("decode_attention_i8", k8.device, decode_attention_i8_cuda,
                   decode_attention_i8_plain)
    return fn(q8.contiguous(), sq.contiguous(), k8, ks, v8, vs, live, bias, scale, out_dtype)


def decode_attention_i8_live(q8, sq, k8, ks, v8, vs, live: int, bias, scale: float,
                             out_dtype: Optional[torch.dtype] = None,
                             rtile: int = 64) -> torch.Tensor:
    """Kernel 4 on a CUDA tensor, its plain version on a CPU tensor."""
    fn = _dispatch("decode_attention_i8_live", k8.device, decode_attention_i8_live_cuda,
                   decode_attention_i8_live_plain)
    return fn(q8.contiguous(), sq.contiguous(), k8, ks, v8, vs, live, bias, scale, out_dtype,
              rtile)


def decode_attention_i8_step(q, kv, k8, ks, v8, vs, live: int, bias, scale: float,
                             out_dtype: Optional[torch.dtype] = None):
    """Kernel 3 with the fold on a CUDA tensor, its plain version (the
    PyTorch sequence it replaces) on a CPU tensor."""
    fn = _dispatch("decode_attention_i8_step", k8.device, decode_attention_i8_step_cuda,
                   decode_attention_i8_step_plain)
    return fn(q, kv, k8, ks, v8, vs, live, bias, scale, out_dtype)


def decode_attention_i8_live_step(q, kv, k8, ks, v8, vs, live: int, bias, scale: float,
                                  out_dtype: Optional[torch.dtype] = None, rtile: int = 64):
    """Kernel 4 with the fold on a CUDA tensor, its plain version on a CPU
    tensor."""
    fn = _dispatch("decode_attention_i8_live_step", k8.device,
                   decode_attention_i8_live_step_cuda, decode_attention_i8_live_step_plain)
    return fn(q, kv, k8, ks, v8, vs, live, bias, scale, out_dtype, rtile)


def cache_attention_i8(q, k8, ks, v8, vs, extra, scale: float,
                       live: Optional[int] = None) -> torch.Tensor:
    """Kernel 5 on a CUDA tensor, its plain version on a CPU tensor."""
    fn = _dispatch("cache_attention_i8", k8.device, cache_attention_i8_cuda,
                   cache_attention_i8_plain)
    return fn(q.contiguous(), k8, ks, v8, vs, extra, scale, live)


def decode_attention_i8kv(q, k8, ks, v8, vs, extra, scale: float,
                          live: Optional[int] = None) -> torch.Tensor:
    """Kernel 12 on a CUDA tensor, its plain version on a CPU tensor."""
    fn = _dispatch("decode_attention_i8kv", k8.device, decode_attention_i8kv_cuda,
                   decode_attention_i8kv_plain)
    return fn(q.contiguous(), k8, ks, v8, vs, extra, scale, live)
