"""The fused block-local transformer layer (counterpart of
lvt_tpu/ops/fused_layer.py): for token blocks (nb, n, d)

    LN -> QKV -> per-head softmax(QK^T/sqrt(da) + B [+ causal]) V
       -> proj + residual (fp32 x2) -> LN -> FFN + residual

as one differentiable function that is its own remat unit: the forward
saves its input and the post-attention residual ``x2``; the backward
recomputes the rest. Three kernels, each hand-written CUDA for sm_90a
(csrc/fused_layer.cu) beside its plain PyTorch version:

* kernel 7, ``fused_layer_tokens``: the forward (optionally also ``x2``);
* kernel 8, ``ffn_half_bwd``: backward of ``x2 + FFN(LN(x2))``;
* kernel 9, ``attn_half_bwd``: backward of the attention half for the heads
  [h0, h1).

On a CUDA tensor a wrapper launches its kernel or raises; on a CPU tensor it
runs the plain version, which keeps the kernels' rounding points. Those are
not the unfused layer's (ops/attention.py ``mha_tokens`` + ``ffn_tokens``):
``x2`` stays fp32 into the second LayerNorm and the last residual, and only
the saved copy is rounded to the io dtype; qkv is rounded once after the wide
product, each head's output after P.V, f after the ReLU.

Head groups: lvt_tpu splits kernel 9 into two calls of na/2 heads because
the full accumulator set exceeds its chip's on-chip memory, and sums the two
io-dtype ``dy`` partials in fp32. On the H100 the accumulators are device
memory scratch, so ``_FusedLayer`` makes ONE call over all heads: ``dy`` is
rounded to the io dtype once (exact in fp32; in bf16 one rounding where
lvt_tpu has two, a difference of one bf16 ulp of dy). lvt_tpu's odd-head
branch (the XLA vjp of the attention half) has no counterpart for the same
reason: any head count runs kernel 9.
"""

import math
from typing import Dict

import torch

from ._lib import LIBRARY, check_launch, counted
from .attention import attention_core_bwd_plain, attention_core_plain, bwd_scratch

LayerParams = Dict[str, torch.Tensor]

# the layer's parameters that the kernels read, in the order _FusedLayer
# takes them (the bias banks reach the layer through ``bias``)
PARAM_KEYS = ("ln_scale", "ln_bias", "wq", "wk", "wv", "proj", "ffn_ln_scale", "ffn_ln_bias",
              "ffn_w1", "ffn_b1", "ffn_w2", "ffn_b2")

# rows of a row tile of kernel 8's column-sum partials, by io dtype
# (csrc/fused_layer.cu: TileF32's 16-row programs in fp32, the wgmma
# products' 128-row tiles in bf16); and the largest width
_TILE_ROWS = {torch.float32: 16, torch.bfloat16: 128}
MAX_D = 512


def _ln_fwd_f32(xf, gamma, beta):
    """fp32 LayerNorm forward over the last axis: (y, yhat, r). The one
    definition of the LN recompute shared by the forward, both backward
    kernels' plain versions and the tail of ``_FusedLayer.backward``."""
    mu = xf.mean(dim=-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    r = torch.rsqrt(var + 1e-5)
    yhat = xc * r
    return yhat * gamma + beta, yhat, r


def _ln_bwd_f32(dy, yhat, r, gamma):
    """fp32 LayerNorm backward: (dgamma, dbeta, dx), the first two summed
    over every axis but the last."""
    d = dy.shape[-1]
    dls = (dy * yhat).reshape(-1, d).sum(dim=0)
    dlb = dy.reshape(-1, d).sum(dim=0)
    dyh = dy * gamma
    m1 = dyh.mean(dim=-1, keepdim=True)
    m2 = (dyh * yhat).mean(dim=-1, keepdim=True)
    return dls, dlb, r * (dyh - m1 - yhat * m2)


def _wqkv_flat(wq, wk, wv):
    """(na, d, da) x3 -> (d, 3*na*da), columns [q heads | k heads | v heads]."""
    na, d, da = wq.shape
    return torch.cat([w.permute(1, 0, 2).reshape(d, na * da) for w in (wq, wk, wv)], dim=1)


def _unflat_dwqkv(dwqkv, nh: int, da: int):
    """Invert _wqkv_flat on a (d, 3*nh*da) gradient: dwq, dwk, dwv (nh, d, da)."""
    d = dwqkv.shape[0]
    parts = dwqkv.reshape(d, 3, nh, da).permute(1, 2, 0, 3)
    return parts[0], parts[1], parts[2]


def _mm(a, b):
    """Product of two io-dtype operands, summed in fp32."""
    return a.float() @ b.float()


def _heads(flat, nh: int, da: int):
    """(nb, n, nh*da) -> (nb, nh, n, da)"""
    nb, n, _ = flat.shape
    return flat.reshape(nb, n, nh, da).permute(0, 2, 1, 3)


def _unheads(x):
    """(nb, nh, n, da) -> (nb, n, nh*da)"""
    nb, nh, n, da = x.shape
    return x.permute(0, 2, 1, 3).reshape(nb, n, nh * da)


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------

def fused_layer_tokens_plain(tok, p: LayerParams, bias, causal: bool, with_x2: bool = False):
    """Plain PyTorch version of kernel 7. tok: (nb, n, d); bias: (na, n, n).
    Returns (nb, n, d) in tok's dtype, or (out, x2) with the post-attention
    residual rounded to tok's dtype when with_x2."""
    io = tok.dtype
    na, _, da = p["wq"].shape
    x = tok.float()
    y = _ln_fwd_f32(x, p["ln_scale"].float(), p["ln_bias"].float())[0].to(io)
    qkv = _mm(y, _wqkv_flat(p["wq"], p["wk"], p["wv"])).to(io)
    q, k, v = (_heads(t, na, da) for t in qkv.split(na * da, dim=-1))
    o_all = _unheads(attention_core_plain(q, k, v, bias, causal))
    x2 = _mm(o_all, p["proj"]) + x  # residual, fp32
    y2 = _ln_fwd_f32(x2, p["ffn_ln_scale"].float(), p["ffn_ln_bias"].float())[0].to(io)
    f = torch.relu(_mm(y2, p["ffn_w1"]) + p["ffn_b1"].float()).to(io)
    out = (_mm(f, p["ffn_w2"]) + p["ffn_b2"].float() + x2).to(io)
    return (out, x2.to(io)) if with_x2 else out


def ffn_half_bwd_plain(x2, g, p: LayerParams):
    """Plain PyTorch version of kernel 8, the backward of
    out = x2 + FFN(LN(x2)) from the saved (rounded) x2 and the cotangent g.
    Returns (dx2, dw1, db1, dw2, db2, dls, dlb): dx2 in x2's dtype, the rest
    summed in fp32 over all rows and cast to the weights' dtype."""
    return _ffn_half_bwd_plain_gated(x2, g, p, None)


def _ffn_half_bwd_plain_gated(x2, g, p: LayerParams, gate):
    """``ffn_half_bwd_plain`` with the ReLU gate f_pre > 0 replaced by
    ``gate`` (rows, d) bool where it is given: the card test replays kernel
    8's own gate into it."""
    io = x2.dtype
    d = x2.shape[-1]
    gam = p["ffn_ln_scale"].float()
    y2f, yhat, r = _ln_fwd_f32(x2.float(), gam, p["ffn_ln_bias"].float())
    y2 = y2f.to(io)
    f_pre = _mm(y2, p["ffn_w1"]) + p["ffn_b1"].float()
    f = torch.relu(f_pre).to(io)
    go32 = g.float()
    dw2 = _mm(f.reshape(-1, d).T, g.reshape(-1, d))
    db2 = go32.reshape(-1, d).sum(dim=0)
    df = _mm(g, p["ffn_w2"].T)
    on = f_pre > 0.0 if gate is None else gate.reshape(f_pre.shape)
    dfp = torch.where(on, df, torch.zeros_like(df))
    dfp_io = dfp.to(io)
    dw1 = _mm(y2.reshape(-1, d).T, dfp_io.reshape(-1, d))
    db1 = dfp.reshape(-1, d).sum(dim=0)
    dy2 = _mm(dfp_io, p["ffn_w1"].T)
    dls, dlb, dx2_ln = _ln_bwd_f32(dy2, yhat, r, gam)
    dt = p["ffn_w1"].dtype
    return ((dx2_ln + go32).to(io), dw1.to(dt), db1.to(dt), dw2.to(dt), db2.to(dt), dls.to(dt),
            dlb.to(dt))


def attn_half_bwd_plain(x, dx2, p: LayerParams, bias, causal: bool, h0: int, h1: int):
    """Plain PyTorch version of kernel 9, the backward of the attention half
    for the heads [h0, h1). x: (nb, n, d) layer input; dx2: (nb, n, d)
    cotangent at the post-attention residual, in x's dtype. Returns
    (dy_part (nb, n, d) in x's dtype: these heads' share of the cotangent at
    LN(x); dwqkv (d, 3*nh*da) fp32 in the _wqkv_flat layout; dproj
    (nh*da, d) fp32; dbias (nh, n, n) fp32)."""
    io = x.dtype
    d = x.shape[-1]
    da = p["wq"].shape[2]
    nh = h1 - h0
    y = _ln_fwd_f32(x.float(), p["ln_scale"].float(), p["ln_bias"].float())[0].to(io)
    wqkv = _wqkv_flat(p["wq"][h0:h1], p["wk"][h0:h1], p["wv"][h0:h1])
    qkv = _mm(y, wqkv).to(io)
    q, k, v = (_heads(t, nh, da).contiguous() for t in qkv.split(nh * da, dim=-1))
    proj = p["proj"][h0 * da:h1 * da]
    do = _heads(_mm(dx2, proj.T).to(io), nh, da).contiguous()
    bias_h = bias[h0:h1].float()
    o_all = _unheads(attention_core_plain(q, k, v, bias_h, causal))
    dq, dk, dv, dbias = attention_core_bwd_plain(q, k, v, bias_h, do, causal)
    dproj = _mm(o_all.reshape(-1, nh * da).T, dx2.reshape(-1, d))
    dqkv = torch.cat([_unheads(t) for t in (dq, dk, dv)], dim=-1)  # (nb, n, 3*nh*da)
    dwqkv = _mm(y.reshape(-1, d).T, dqkv.reshape(-1, 3 * nh * da))
    dy = _mm(dqkv, wqkv.T).to(io)
    return dy, dwqkv, dproj, dbias


# --------------------------------------------------------------------------
# The kernels' wrappers
# --------------------------------------------------------------------------

def _check_fused_inputs(name, p: LayerParams, bias, *acts):
    """Raise unless the activations ``acts`` (one (nb, n, d) shape, float32
    or bfloat16, contiguous, on the current CUDA device), the parameters (of
    the activations' dtype) and the bias (float32 (heads, n, n), or None for
    kernel 8, which reads none) are what
    kernels 7, 8 and 9 take: d a multiple of 64 up to MAX_D, da in {64, 128},
    n <= 1024 in float32 and n <= 256 in bfloat16."""
    x = acts[0]
    tensors = (*acts, *(p[k] for k in PARAM_KEYS))
    if not (x.is_cuda and all(t.device == x.device for t in tensors)
            and (bias is None or bias.device == x.device)):
        raise ValueError(f"{name}: all inputs must be on one CUDA device")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: inputs must lie on the current CUDA device")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: activations must be float32 or bfloat16, got {x.dtype}")
    if any(t.dtype != x.dtype for t in tensors):
        raise ValueError(f"{name}: activations and parameters must share {x.dtype}, got "
                         f"{sorted({str(t.dtype) for t in tensors})}")
    if x.dim() != 3 or any(t.shape != x.shape for t in acts):
        raise ValueError(f"{name}: activations must share one (nb, n, d) shape, got "
                         f"{[tuple(t.shape) for t in acts]}")
    nb, n, d = x.shape
    na, dw, da = p["wq"].shape
    if d % 64 or not 64 <= d <= MAX_D or dw != d:
        raise ValueError(f"{name}: needs d a multiple of 64 up to {MAX_D}, got d={d} "
                         f"(wq {tuple(p['wq'].shape)})")
    if da not in (64, 128) or not 1 <= n <= 1024:
        raise ValueError(f"{name}: needs da in (64, 128) and n <= 1024, got da={da}, n={n}")
    if x.dtype == torch.bfloat16 and n > 256:
        raise ValueError(f"{name}: bfloat16 needs n <= 256, got n={n}")
    want = {"ln_scale": (d,), "ln_bias": (d,), "wq": (na, d, da), "wk": (na, d, da),
            "wv": (na, d, da), "proj": (na * da, d), "ffn_ln_scale": (d,), "ffn_ln_bias": (d,),
            "ffn_w1": (d, d), "ffn_b1": (d,), "ffn_w2": (d, d), "ffn_b2": (d,)}
    for k, shape in want.items():
        if tuple(p[k].shape) != shape:
            raise ValueError(f"{name}: {k} must be {shape}, got {tuple(p[k].shape)}")
    if bias is not None and (bias.dtype != torch.float32 or bias.shape[1:] != (n, n)
                             or not bias.is_contiguous()):
        raise ValueError(f"{name}: bias must be contiguous float32 (heads, {n}, {n}), got "
                         f"{bias.dtype} {tuple(bias.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: activations and parameters must be contiguous")
    if any(t.data_ptr() % 16 for t in acts):  # the kernels read them 16 bytes at a time
        raise ValueError(f"{name}: activations must be 16-byte aligned")


def _splits(rows: int) -> int:
    """Row ranges that a weight gradient's sum over ``rows`` rows is cut
    into; their partial sums are added in a fixed order."""
    return max(1, min(16, (rows + 255) // 256))


def _dtype_code(dtype) -> int:
    return 0 if dtype == torch.float32 else 1


def fwd_y_shape(nb: int, n: int, d: int, io):
    """Kernel 7's scratch ``y``: none in fp32; in bf16 (4, nb, n, d) bf16:
    LN(x) for the QKV product, then the FFN's y2 (plane 0), f (plane 1) and
    x2 in fp32 (planes 2 and 3)."""
    return None if io == torch.float32 else (4, nb, n, d)


def ffn_bwd_scratch(rows: int, d: int, io):
    """Kernel 8's fp32 scratch ``part_r``: (row tiles, its length in floats).
    It holds the row tiles' column sums of dfp, g, dy2 * yhat and dy2, (tiles,
    4, d), a tile being ``_TILE_ROWS[io]`` rows; in bf16 then dy2 (rows, d),
    the rows' LN mean and rstd (rows each) and the ReLU gate, (rows, d)
    bytes."""
    tiles = -(-rows // _TILE_ROWS[io])
    rest = 0 if io == torch.float32 else rows * d + 2 * rows + rows * d // 4
    return tiles, tiles * 4 * d + rest


@counted
def fused_layer_fwd_cuda(tok, p: LayerParams, bias, causal: bool, with_x2: bool = False):
    """Kernel 7 (csrc/fused_layer.cu) on CUDA tensors; arguments and result
    as ``fused_layer_tokens_plain``, the bias float32. The qkv, per-head
    output and LN / FFN scratch (``fwd_y_shape``) come from PyTorch's
    allocator on the current stream."""
    _check_fused_inputs("fused_layer_fwd_cuda", p, bias, tok)
    nb, n, d = tok.shape
    na, _, da = p["wq"].shape
    if bias.shape[0] != na:
        raise ValueError(f"fused_layer_fwd_cuda: bias must have {na} heads, got {bias.shape[0]}")
    # weights as (outputs, inputs) rows: what the kernels' B operand reads
    wqkv_t = _wqkv_flat(p["wq"], p["wk"], p["wv"]).t().contiguous()
    proj_t, w1_t, w2_t = (p[k].t().contiguous() for k in ("proj", "ffn_w1", "ffn_w2"))
    qkv = torch.empty((3, nb, na, n, da), dtype=tok.dtype, device=tok.device)
    o = torch.empty((nb, na, n, da), dtype=tok.dtype, device=tok.device)
    y_shape = fwd_y_shape(nb, n, d, tok.dtype)
    y = None if y_shape is None else torch.empty(y_shape, dtype=tok.dtype, device=tok.device)
    out = torch.empty_like(tok)
    x2 = torch.empty_like(tok) if with_x2 else None
    err = LIBRARY.get().lvt_fused_layer_fwd(
        tok.data_ptr(), p["ln_scale"].data_ptr(), p["ln_bias"].data_ptr(), wqkv_t.data_ptr(),
        proj_t.data_ptr(), p["ffn_ln_scale"].data_ptr(), p["ffn_ln_bias"].data_ptr(),
        w1_t.data_ptr(), p["ffn_b1"].data_ptr(), w2_t.data_ptr(), p["ffn_b2"].data_ptr(),
        bias.data_ptr(), qkv.data_ptr(), o.data_ptr(), 0 if y is None else y.data_ptr(),
        x2.data_ptr() if with_x2 else 0, out.data_ptr(),
        nb, n, d, na, da, int(causal), _dtype_code(tok.dtype), 1.0 / math.sqrt(da),
        torch.cuda.current_stream().cuda_stream)
    check_launch("fused_layer_fwd", err)
    fused_layer_fwd_cuda.launches += 1
    return (out, x2) if with_x2 else out


@counted
def ffn_half_bwd_cuda(x2, g, p: LayerParams):
    """Kernel 8 (csrc/fused_layer.cu) on CUDA tensors; arguments and result
    as ``ffn_half_bwd_plain``. Bit-identical from call to call: the sums over
    the rows are taken per row range and added in a fixed order."""
    return _ffn_half_bwd_launch(x2, g, p)[0]


def _ffn_half_bwd_launch(x2, g, p: LayerParams):
    """Kernel 8's launch: (``ffn_half_bwd_cuda``'s outputs, acts, part_r),
    the last two its scratch: acts (3, rows, d) holds y2, f and dfp, part_r
    is laid out as ``ffn_bwd_scratch`` says."""
    _check_fused_inputs("ffn_half_bwd_cuda", p, None, x2, g)
    nb, n, d = x2.shape
    rows = nb * n
    dev, io = x2.device, x2.dtype
    splits = _splits(rows)
    _, part_len = ffn_bwd_scratch(rows, d, io)
    w1_t = p["ffn_w1"].t().contiguous()
    dx2 = torch.empty_like(x2)
    dw = torch.empty((2, d, d), dtype=torch.float32, device=dev)     # dw1, dw2
    sums = torch.empty((4, d), dtype=torch.float32, device=dev)      # db1, db2, dls, dlb
    acts = torch.empty((3, rows, d), dtype=io, device=dev)           # y2, f, dfp
    part_w = torch.empty((splits, d, d), dtype=torch.float32, device=dev)
    part_r = torch.empty(part_len, dtype=torch.float32, device=dev)
    err = LIBRARY.get().lvt_ffn_half_bwd(
        x2.data_ptr(), g.data_ptr(), p["ffn_ln_scale"].data_ptr(), p["ffn_ln_bias"].data_ptr(),
        w1_t.data_ptr(), p["ffn_w1"].data_ptr(), p["ffn_b1"].data_ptr(), p["ffn_w2"].data_ptr(),
        dx2.data_ptr(), dw.data_ptr(), sums.data_ptr(), acts.data_ptr(), part_w.data_ptr(),
        part_r.data_ptr(), rows, d, splits, _dtype_code(io),
        torch.cuda.current_stream().cuda_stream)
    check_launch("ffn_half_bwd", err)
    ffn_half_bwd_cuda.launches += 1
    dt = p["ffn_w1"].dtype
    return ((dx2, dw[0].to(dt), sums[0].to(dt), dw[1].to(dt), sums[1].to(dt), sums[2].to(dt),
             sums[3].to(dt)), acts, part_r)


@counted
def attn_half_bwd_cuda(x, dx2, p: LayerParams, bias, causal: bool, h0: int, h1: int):
    """Kernel 9 (csrc/fused_layer.cu) on CUDA tensors; arguments and result
    as ``attn_half_bwd_plain``, the bias float32 (na, n, n). Bit-identical
    from call to call (fixed-order sums, no atomics)."""
    _check_fused_inputs("attn_half_bwd_cuda", p, bias, x, dx2)
    nb, n, d = x.shape
    na, _, da = p["wq"].shape
    if bias.shape[0] != na or not 0 <= h0 < h1 <= na:
        raise ValueError(f"attn_half_bwd_cuda: needs a bias of {na} heads and 0 <= h0 < h1 <= "
                         f"{na}, got {bias.shape[0]} heads, h0={h0}, h1={h1}")
    nh = h1 - h0
    rows, wide = nb * n, 3 * nh * da
    dev, io = x.device, x.dtype
    splits = _splits(rows)
    wqkv = _wqkv_flat(p["wq"][h0:h1], p["wk"][h0:h1], p["wv"][h0:h1])  # (d, wide)
    wqkv_t = wqkv.t().contiguous()
    proj = p["proj"][h0 * da:h1 * da]  # (nh*da, d) rows: contiguous
    bias_h = bias[h0:h1]
    dy = torch.empty_like(x)
    dwqkv = torch.empty((d, wide), dtype=torch.float32, device=dev)
    dproj = torch.empty((nh * da, d), dtype=torch.float32, device=dev)
    dbias = torch.empty((nh, n, n), dtype=torch.float32, device=dev)
    y = torch.empty((rows, d), dtype=io, device=dev)
    qkv = torch.empty((3, nb, nh, n, da), dtype=io, device=dev)
    do_o = torch.empty((2, nb, nh, n, da), dtype=io, device=dev)      # do, o
    dqkv = torch.empty((3, nb, nh, n, da), dtype=io, device=dev)
    stats, part_b = bwd_scratch(nb, nh, n, io, dev)
    part_w = torch.empty((splits, d, wide), dtype=torch.float32, device=dev)
    err = LIBRARY.get().lvt_attn_half_bwd(
        x.data_ptr(), dx2.data_ptr(), p["ln_scale"].data_ptr(), p["ln_bias"].data_ptr(),
        wqkv_t.data_ptr(), wqkv.data_ptr(), proj.data_ptr(), bias_h.data_ptr(),
        dy.data_ptr(), dwqkv.data_ptr(), dproj.data_ptr(), dbias.data_ptr(),
        y.data_ptr(), qkv.data_ptr(), do_o.data_ptr(), dqkv.data_ptr(), stats.data_ptr(),
        part_b.data_ptr(), part_w.data_ptr(), nb, n, d, nh, da, int(causal), splits,
        _dtype_code(io), 1.0 / math.sqrt(da), torch.cuda.current_stream().cuda_stream)
    check_launch("attn_half_bwd", err)
    attn_half_bwd_cuda.launches += 1
    return dy, dwqkv, dproj, dbias


def _route(name, x, cuda_fn, plain_fn):
    if x.device.type == "cuda":
        return cuda_fn
    if x.device.type == "cpu":
        return plain_fn
    raise ValueError(f"{name}: no kernel for device {x.device}")


def fused_layer_tokens(tok, p, bias, causal: bool, with_x2: bool = False):
    """Kernel 7 on CUDA tensors, its plain version on CPU tensors."""
    fn = _route("fused_layer_tokens", tok, fused_layer_fwd_cuda, fused_layer_tokens_plain)
    return fn(tok, p, bias, causal, with_x2)


def ffn_half_bwd(x2, g, p):
    """Kernel 8 on CUDA tensors, its plain version on CPU tensors."""
    return _route("ffn_half_bwd", x2, ffn_half_bwd_cuda, ffn_half_bwd_plain)(x2, g, p)


def attn_half_bwd(x, dx2, p, bias, causal: bool, h0: int, h1: int):
    """Kernel 9 on CUDA tensors, its plain version on CPU tensors."""
    fn = _route("attn_half_bwd", x, attn_half_bwd_cuda, attn_half_bwd_plain)
    return fn(x, dx2, p, bias, causal, h0, h1)


# --------------------------------------------------------------------------
# The differentiable layer
# --------------------------------------------------------------------------

class _FusedLayer(torch.autograd.Function):
    """What lvt_tpu's ``_fused_layer_ad`` does: the forward is kernel 7 and
    saves tok, x2, the parameters and the bias (without grad it runs the
    single-output variant and saves nothing); the backward is kernel 8 from
    the saved x2, kernel 9 over all heads, then the LayerNorm backward over
    dy plus the residual path in plain PyTorch. Gradients of the weights come
    back in the weights' dtype, dbias in the bias's."""

    @staticmethod
    def forward(ctx, tok, bias, causal, *params):
        p = dict(zip(PARAM_KEYS, params))
        ctx.causal = causal
        if not any(ctx.needs_input_grad):
            return fused_layer_tokens(tok, p, bias.float(), causal, with_x2=False)
        out, x2 = fused_layer_tokens(tok, p, bias.float(), causal, with_x2=True)
        ctx.save_for_backward(tok, x2, bias, *params)
        return out

    @staticmethod
    def backward(ctx, g):
        tok, x2, bias, *params = ctx.saved_tensors
        p = dict(zip(PARAM_KEYS, params))
        na, _, da = p["wq"].shape
        dx2, dw1, db1, dw2, db2, dls2, dlb2 = ffn_half_bwd(x2, g.contiguous(), p)
        dy, dwqkv, dproj, dbias = attn_half_bwd(tok, dx2, p, bias.float(), ctx.causal, 0, na)
        dt = p["wq"].dtype
        dwq, dwk, dwv = (w.to(dt) for w in _unflat_dwqkv(dwqkv, na, da))
        # LN backward over dy plus the residual path, with the shared helpers
        gam = p["ln_scale"].float()
        _, yhat, r = _ln_fwd_f32(tok.float(), gam, 0.0)
        dls1, dlb1, dtok_ln = _ln_bwd_f32(dy.float(), yhat, r, gam)
        dtok = (dtok_ln + dx2.float()).to(tok.dtype)
        grads = {"ln_scale": dls1.to(p["ln_scale"].dtype), "ln_bias": dlb1.to(p["ln_bias"].dtype),
                 "wq": dwq, "wk": dwk, "wv": dwv, "proj": dproj.to(p["proj"].dtype),
                 "ffn_ln_scale": dls2, "ffn_ln_bias": dlb2, "ffn_w1": dw1, "ffn_b1": db1,
                 "ffn_w2": dw2, "ffn_b2": db2}
        return (dtok, dbias.to(bias.dtype), None, *(grads[k] for k in PARAM_KEYS))


def fused_block_layer(tok, p: LayerParams, bias, causal: bool):
    """The differentiable fused layer on token blocks (nb, n, d). The bias
    banks of ``p`` get their gradient through ``bias`` (relative_bias)."""
    return _FusedLayer.apply(tok.contiguous(), bias.contiguous(), bool(causal),
                             *(p[k] for k in PARAM_KEYS))


def fused_layer_supported(layers, blocks) -> bool:
    """The geometry gate of TPU.FUSED_LAYER, a rule of the model (the same
    on every device): every layer shares one block size and one head shape,
    as in lvt_tpu, and the geometry is one kernels 7, 8 and 9 take on the
    H100. Their fp32 row-tile programs keep rows of width d in shared memory
    (kernel 8: four fp32 copies of a 16 x d tile plus a 36 KB weight tile;
    173 KB of the 227 KB a block may use at d = 512), their bf16 row passes
    a row in one warp's registers (16 values a lane at d = 512), and the
    weight products walk d in steps of 64, so d is a multiple of 64 up to
    512; the attention inside is kernels 1 and
    10's device code, so da is 64 or 128 and a block holds n <= 256 tokens
    (their bf16 bound, kept for fp32 too so that one geometry takes one path
    in both dtypes). lvt_tpu's limits on its chip's on-chip memory (the
    bias and the backward working set) have no counterpart: here those are
    device memory scratch. Any other geometry runs the unfused layers."""
    if len(set(map(tuple, blocks))) != 1:
        return False
    shapes = {tuple(l["wq"].shape) for l in layers}
    if len(shapes) != 1:
        return False
    na, d, da = next(iter(shapes))
    t, h, w = blocks[0]
    return d % 64 == 0 and 64 <= d <= MAX_D and da in (64, 128) and t * h * w <= 256
