"""Incremental (KV-cached) subscale decoder for AR sampling (counterpart of
lvt_tpu/models/vt_incremental.py), with the K/V cache in the parameter dtype
or in int8 and the per-pixel layer weights native or in int8.

Every decoder component is causal in raster order (the masked conv reads
positions < p, masked block-local attention attends to positions <= p,
FFN/LN are per-token), so position p's activations never change once
computed and are cached:

* ``emb``    — summed channel embeddings of the final codes, read by the
               causal conv of later pixels;
* per layer  — K/V caches, one row written per pixel before it attends;
* per slice  — the zl projection and the bias tables.

The port owns its cache layout and updates it in place: one buffer of
(L, b, na, R, da) per K and V, allocated once per slice, with R = the block
run (the slice when blocks do not tile it as contiguous runs). Pixel p writes
row p_loc = p mod R and attends to rows [0, p_loc] through the functions of
``ops.cache_attention`` (kernels 2, 3 and 4 on the card). Rows left from the
previous block run lie at or above p_loc + 1 and are never read; within a
run, cross-block entries carry a -1e9 bias, which gives them exactly zero
weight as in the JAX package. The JAX package's fused-lane cache layout,
block-diagonal q and segmented cache growth answer the TPU and its compiler
and have no counterpart here: they do not change what is computed.

With ``kv_dtype="int8"`` the caches are int8 with one absmax scale per
(head, row), kept in the parameter dtype as the JAX package keeps them:
(L, b, na, R) beside each cache.
"""

import math
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from ..ops.attention import _layer_norm, relative_bias
from ..ops.cache_attention import (decode_attention, decode_attention_i8_live_step,
                                   decode_attention_i8_plain, decode_attention_i8_step)
from ..ops.posenc import _signal_np
from ..ops.quant import matmul_i8w, quantize_cols, quantize_rows_i8
from ..ops.quant import quantize_cache_row as _quantize_cache_row
from .vt import (VTConfig, _embed_sum_codes, _predictor_head, _predictor_u,
                 vt_sample_pixel_channels)


@lru_cache(maxsize=16)
def conv_tap_table(slice_shape: Tuple[int, int, int], kernel: Tuple[int, int, int] = (3, 3, 3)):
    """For each flat raster position p of the (t, h, w) slice grid, the flat
    indices read by the causal masked conv's unmasked taps.

    Returns (nbr (thw, K'), tap_ids (K',)) with nbr = -1 out of bounds;
    tap_ids index into the flattened kernel."""
    t, h, w = slice_shape
    kt, kh, kw = kernel
    taps = []
    for kti in range(kt):
        for khi in range(kh):
            for kwi in range(kw):
                dt, dh, dw = kti - (kt - 1), khi - (kh - 1), kwi - kw // 2
                if dt == 0 and dh == 0 and dw >= 0:
                    continue  # causally masked taps
                taps.append((kti * kh * kw + khi * kw + kwi, dt, dh, dw))
    thw = t * h * w
    nbr = np.full((thw, len(taps)), -1, np.int64)
    for p in range(thw):
        ti, rem = divmod(p, h * w)
        hi, wi = divmod(rem, w)
        for j, (_, dt, dh, dw) in enumerate(taps):
            a, b, c = ti + dt, hi + dh, wi + dw
            if 0 <= a < t and 0 <= b < h and 0 <= c < w:
                nbr[p, j] = (a * h + b) * w + c
    return nbr, np.asarray([tp[0] for tp in taps], np.int64)


@lru_cache(maxsize=16)
def block_structure(slice_shape: Tuple[int, int, int], block: Tuple[int, int, int]):
    """(block_id (thw,), rel_idx (thw,)): which attention block each raster
    position belongs to and its index within the block (split_blocks
    order)."""
    t, h, w = slice_shape
    bt, bh, bw = block
    thw = t * h * w
    block_id = np.empty(thw, np.int64)
    rel_idx = np.empty(thw, np.int64)
    nbh, nbw = h // bh, w // bw
    for p in range(thw):
        ti, rem = divmod(p, h * w)
        hi, wi = divmod(rem, w)
        block_id[p] = ((ti // bt) * nbh + hi // bh) * nbw + wi // bw
        rel_idx[p] = ((ti % bt) * bh + hi % bh) * bw + wi % bw
    return block_id, rel_idx


@lru_cache(maxsize=16)
def posenc_rows(slice_shape: Tuple[int, int, int], d: int) -> np.ndarray:
    """(thw, d) positional-encoding table in raster order."""
    return _signal_np(tuple(slice_shape), d).reshape(-1, d)


def _bias_rows(lp, blk, slice_shape, block_local: bool, R: int):
    """Layer bias as (rows, na, R) fp32: row r is the bias of the pixel that
    writes cache row r (block-local runs: r = p mod R) or of pixel r (slice-
    wide caches), against every cache row; -1e9 across attention blocks."""
    Bl = relative_bias(lp["dt_bank"], lp["dh_bank"], lp["dw_bank"], tuple(blk)).float()
    if block_local:  # within a run the block-relative index is p mod R
        return Bl.permute(1, 0, 2).contiguous()
    bid, rel = block_structure(tuple(slice_shape), tuple(blk))
    dev = Bl.device
    rel_t = torch.as_tensor(rel, device=dev)
    full = Bl[:, rel_t][:, :, rel_t]  # (na, thw, thw) in raster order
    same = torch.as_tensor(bid[:, None] == bid[None, :], device=dev)
    full = torch.where(same[None], full, torch.full_like(full, -1e9))
    return full.permute(1, 0, 2).contiguous()


def _check_knobs(kv_dtype, weight_dtype, mm_dtype, attn_impl):
    """The JAX sampler's refusals, in its order and with its error classes."""
    if kv_dtype not in ("native", "int8", "int4"):
        raise ValueError(f"kv_dtype must be 'native', 'int8' or 'int4', got {kv_dtype!r}")
    if weight_dtype not in ("native", "int8", "int8-pallas"):
        raise ValueError("weight_dtype must be 'native', 'int8' or 'int8-pallas', "
                         f"got {weight_dtype!r}")
    if mm_dtype not in ("native", "int8"):
        raise ValueError(f"mm_dtype must be 'native' or 'int8', got {mm_dtype!r}")
    if mm_dtype == "int8" and kv_dtype != "int8":
        raise ValueError("mm_dtype='int8' requires kv_dtype='int8' "
                         "(the dots read the int8 cache bytes directly)")
    if attn_impl not in ("xla", "pallas", "pallas-live"):
        raise ValueError(f"attn_impl must be 'xla', 'pallas' or 'pallas-live', "
                         f"got {attn_impl!r}")
    if attn_impl == "pallas-live" and kv_dtype != "int8":
        raise ValueError("attn_impl='pallas-live' requires kv_dtype='int8' "
                         "(full-buffer int8 flash-decode kernel)")
    if kv_dtype == "int4":
        raise NotImplementedError("kv_dtype='int4' is not ported to lvt_tpu_torch; "
                                  "use 'native' or 'int8'")


def sample_slice_incremental(params, c: VTConfig, slice_shape, zl, sl, gen, primed, temp,
                             greedy: bool = False, kv_dtype: str = "native",
                             seg_size: int = 0, weight_dtype: str = "native",
                             mm_dtype: str = "native", attn_impl: str = "xla",
                             teacher_logits: bool = False):
    """Exact AR sampling of one slice with cached decoder state.

    params: the netG tree; zl: (b, t, h, w, d) encoder output; sl: (b, nc,
    t, h, w) initial codes (primed positions already correct); primed:
    (thw,) host bool array; gen: torch.Generator for temperature sampling.
    Returns the sampled slice codes.

    teacher_logits=True runs the rollout teacher-forced: every position
    keeps its code from ``sl``, channel conditioning uses the given previous
    channels (vt_logits semantics), and the fp32 per-pixel channel logits
    (b, thw, nc, nv) are returned as a second output.

    kv_dtype: "native" keeps K/V in the parameter dtype; "int8" quantizes
    each cache row with one absmax scale per (head, row). The scales fold
    exactly into the attention algebra, so only the int8 rounding of K and V
    differs. "int4" is not ported (NotImplementedError).

    attn_impl: with a native cache, "xla" and "pallas" both run kernel 2
    (``decode_attention``), the one function the JAX package computes either
    way. With an int8 cache, "xla" is plain PyTorch over the live rows (the
    JAX package runs no kernel there): the cache cast to the parameter dtype,
    fp32 logits and softmax, the weights rounded to the parameter dtype and
    then multiplied by the V scales in it; "pallas" runs kernel 3
    (``decode_attention_i8_step``: int8 q, exact integer products, the weight
    row quantized to int8 after the V scales are folded in) and "pallas-live"
    kernel 4 (``decode_attention_i8_live_step``: the same in 64-row tiles
    with an online softmax); on the card each is one launch per layer that
    also quantizes q and writes the new cache row. "pallas-live" needs
    kv_dtype="int8".

    mm_dtype: "int8" (needs kv_dtype="int8") with attn_impl="xla" computes
    kernel 3's function through its plain version on any device.

    weight_dtype: "int8" holds the four products of each layer (fused QKV,
    proj, FFN 1, FFN 2) as int8 weights with per-column scales, quantized
    once per slice: (y @ W8 cast to the parameter dtype) * s. "int8-pallas"
    runs them through kernel 11 (``ops.quant.matmul_i8w``), which also
    quantizes the activation rows. The conv, the projector and the predictor
    stay native.

    seg_size is accepted and ignored (see the module docstring).
    """
    _check_knobs(kv_dtype, weight_dtype, mm_dtype, attn_impl)
    use_int8 = kv_dtype == "int8"
    dec, pred = params["decoder"], params["predictor"]
    layers = dec["layers"]
    t, h, w = slice_shape
    thw = t * h * w
    b, nc = sl.shape[:2]
    na, _, da = layers[0]["wq"].shape
    if len({tuple(lp["wq"].shape) for lp in layers}) != 1:
        raise ValueError("incremental sampler needs one head count across decoder layers; "
                         "use sample_video(incremental=False) for heterogeneous stacks")
    L = len(layers)
    dev = zl.device
    cdtype = dec["conv_w"].dtype
    scale = 1.0 / math.sqrt(da)

    # causal conv: cache emb gets one zero row at index thw that every
    # out-of-bounds tap (-1) reads instead
    nbr_np, tap_ids_np = conv_tap_table((t, h, w))
    nbr = torch.as_tensor(np.where(nbr_np < 0, thw, nbr_np), device=dev)  # (thw, K')
    conv_w = dec["conv_w"].reshape(-1, c.de, c.d)[torch.as_tensor(tap_ids_np, device=dev)]
    conv_w = conv_w.reshape(-1, c.d)  # (K' * de, d)
    pos_rows = torch.as_tensor(posenc_rows((t, h, w), c.d), device=dev).to(cdtype)
    zlproj = (zl @ dec["projector"]).reshape(b, thw, c.d)

    blocks = [tuple(bk) for bk in c.blocks_d]
    bt0, bh0, bw0 = blocks[0]
    block_local = len(set(blocks)) == 1 and bh0 == h and bw0 == w and t % bt0 == 0
    R = bt0 * h * w if block_local else thw
    bias_rows = [_bias_rows(lp, blk, slice_shape, block_local, R)
                 for lp, blk in zip(layers, blocks)]
    # fused QKV: columns [q heads | k heads | v heads], as the JAX sampler
    weights = [{"qkv": torch.cat([lp[n].permute(1, 0, 2).reshape(c.d, na * da)
                                  for n in ("wq", "wk", "wv")], dim=1),
                "proj": lp["proj"], "ffn1": lp["ffn_w1"], "ffn2": lp["ffn_w2"]} for lp in layers]
    if weight_dtype != "native":
        # quantized once here; each product below reads the int8 bytes. Kernel
        # 11 takes the weight transposed, (N, K).
        weights = [{k: quantize_cols(w, cdtype) for k, w in lw.items()} for lw in weights]
        if weight_dtype == "int8-pallas":
            weights = [{k: (wi.t().contiguous(), s) for k, (wi, s) in lw.items()}
                       for lw in weights]

    def mm(y, w):
        if weight_dtype == "native":
            return y @ w
        if weight_dtype == "int8-pallas":
            return matmul_i8w(y, w[0], w[1], cdtype)
        return (y @ w[0].to(cdtype)) * w[1]

    def attend_i8(l, qkv, live, bias):
        """Write the new rows (row live - 1) into layer l's int8 cache and
        attend over rows [0, live)."""
        kc, vc, ks, vs = kcache[l], vcache[l], kscale[l], vscale[l]
        if attn_impl != "xla":  # kernel 3 or 4, the cache write and q's quantization folded in
            fn = decode_attention_i8_step if attn_impl == "pallas" else \
                decode_attention_i8_live_step
            return fn(qkv[:, 0], qkv[:, 1:], kc, ks, vc, vs, live, bias, scale, cdtype)
        kv8, kvs = _quantize_cache_row(qkv[:, 1:], cdtype)  # K and V rows at once
        kc[:, :, live - 1], vc[:, :, live - 1] = kv8[:, 0], kv8[:, 1]
        ks[:, :, live - 1], vs[:, :, live - 1] = kvs[:, 0], kvs[:, 1]
        q = qkv[:, 0]
        if mm_dtype == "native":
            logits = torch.einsum("bak,bajk->baj", q.float(), kc[:, :, :live].to(cdtype).float())
            logits = logits / math.sqrt(da) * ks[:, :, :live].float() + bias[None, :, :live]
            wgt = torch.softmax(logits, dim=-1).to(cdtype) * vs[:, :, :live]
            out = torch.einsum("baj,bajk->bak", wgt.float(), vc[:, :, :live].to(cdtype).float())
            return out.to(cdtype).reshape(b, na * da)
        q8, sq = quantize_rows_i8(q)
        return decode_attention_i8_plain(q8, sq[..., 0], kc, ks, vc, vs, live, bias, scale,
                                         cdtype)

    sl_flat = sl.reshape(b, nc, thw).clone()
    emb = torch.zeros((b, thw + 1, c.de), dtype=cdtype, device=dev)
    emb[:, :thw] = _embed_sum_codes(dec, c, sl_flat.movedim(1, -1)).to(cdtype)
    kcache = torch.zeros((L, b, na, R, da), dtype=torch.int8 if use_int8 else cdtype, device=dev)
    vcache = torch.zeros_like(kcache)
    if use_int8:
        kscale = torch.zeros((L, b, na, R), dtype=cdtype, device=dev)
        vscale = torch.zeros_like(kscale)
    step_logits = []

    for p in range(thw):
        p_loc = p % R
        rows = emb[:, nbr[p]]  # (b, K', de), pad taps read the zero row
        x = rows.reshape(b, -1) @ conv_w + dec["conv_b"]
        x = x + pos_rows[p] + zlproj[:, p]
        for l, lp in enumerate(layers):
            y = _layer_norm(x, lp["ln_scale"], lp["ln_bias"])
            qkv = mm(y, weights[l]["qkv"]).reshape(b, 3, na, da)
            bias = bias_rows[l][p_loc if block_local else p]
            if use_int8:
                out = attend_i8(l, qkv, p_loc + 1, bias)
            else:
                kcache[l, :, :, p_loc] = qkv[:, 1]  # in place: the one new row
                vcache[l, :, :, p_loc] = qkv[:, 2]
                out = decode_attention(qkv[:, 0], kcache[l], vcache[l], p_loc + 1, bias, scale)
            x = mm(out, weights[l]["proj"]) + x
            yf = _layer_norm(x, lp["ffn_ln_scale"], lp["ffn_ln_bias"])
            yf = torch.relu(mm(yf, weights[l]["ffn1"]) + lp["ffn_b1"])
            x = mm(yf, weights[l]["ffn2"]) + lp["ffn_b2"] + x

        y_pix = _layer_norm(x, pred["ln_scale"], pred["ln_bias"])
        if teacher_logits:
            final = sl_flat[:, :, p]
            step_logits.append(torch.stack(
                [_predictor_head(pred, c, k, _predictor_u(pred, c, k, y_pix, final), dec).float()
                 for k in range(c.nc)], dim=1))  # (b, nc, nv)
        elif primed[p]:
            final = sl_flat[:, :, p]
        else:
            final = vt_sample_pixel_channels(params, c, y_pix, gen, temp, greedy=greedy)
            sl_flat[:, :, p] = final.to(sl_flat.dtype)
        emb[:, p] = _embed_sum_codes(dec, c, final).to(cdtype)

    out = sl_flat.reshape(b, nc, t, h, w)
    if teacher_logits:
        return out, torch.stack(step_logits, dim=1)  # (b, thw, nc, nv)
    return out
