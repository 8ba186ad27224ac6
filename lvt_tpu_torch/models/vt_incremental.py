"""Incremental (KV-cached) subscale decoder for AR sampling (counterpart of
lvt_tpu/models/vt_incremental.py, native-dtype KV).

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
row p_loc = p mod R and attends to rows [0, p_loc] through
``ops.cache_attention.decode_attention`` (kernel 2 on the card). Rows left
from the previous block run lie at or above p_loc + 1 and are never read;
within a run, cross-block entries carry a -1e9 bias, which gives them
exactly zero weight as in the JAX package.
"""

import math
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from ..ops.attention import _layer_norm, relative_bias
from ..ops.cache_attention import decode_attention
from ..ops.posenc import _signal_np
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


def sample_slice_incremental(params, c: VTConfig, slice_shape, zl, sl, gen, primed, temp,
                             greedy: bool = False, kv_dtype: str = "native",
                             seg_size: int = 0, teacher_logits: bool = False):
    """Exact AR sampling of one slice with cached decoder state.

    params: the netG tree; zl: (b, t, h, w, d) encoder output; sl: (b, nc,
    t, h, w) initial codes (primed positions already correct); primed:
    (thw,) host bool array; gen: torch.Generator for temperature sampling.
    Returns the sampled slice codes.

    teacher_logits=True runs the rollout teacher-forced: every position
    keeps its code from ``sl``, channel conditioning uses the given previous
    channels (vt_logits semantics), and the fp32 per-pixel channel logits
    (b, thw, nc, nv) are returned as a second output.

    kv_dtype: only "native" (K/V in the parameter dtype) is ported.
    seg_size is accepted and ignored (see the module docstring).
    """
    if kv_dtype != "native":
        raise NotImplementedError(f"kv_dtype={kv_dtype!r} is not ported to lvt_tpu_torch yet")
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
    wqkv = [torch.cat([lp[n].permute(1, 0, 2).reshape(c.d, na * da)
                       for n in ("wq", "wk", "wv")], dim=1) for lp in layers]

    sl_flat = sl.reshape(b, nc, thw).clone()
    emb = torch.zeros((b, thw + 1, c.de), dtype=cdtype, device=dev)
    emb[:, :thw] = _embed_sum_codes(dec, c, sl_flat.movedim(1, -1)).to(cdtype)
    kcache = torch.zeros((L, b, na, R, da), dtype=cdtype, device=dev)
    vcache = torch.zeros_like(kcache)
    step_logits = []

    for p in range(thw):
        p_loc = p % R
        rows = emb[:, nbr[p]]  # (b, K', de), pad taps read the zero row
        x = rows.reshape(b, -1) @ conv_w + dec["conv_b"]
        x = x + pos_rows[p] + zlproj[:, p]
        for l, lp in enumerate(layers):
            y = _layer_norm(x, lp["ln_scale"], lp["ln_bias"])
            qkv = (y @ wqkv[l]).reshape(b, 3, na, da)
            kcache[l, :, :, p_loc] = qkv[:, 1]  # in place: the one new row
            vcache[l, :, :, p_loc] = qkv[:, 2]
            out = decode_attention(qkv[:, 0], kcache[l], vcache[l], p_loc + 1,
                                   bias_rows[l][p_loc if block_local else p], scale)
            x = out @ lp["proj"] + x
            yf = _layer_norm(x, lp["ffn_ln_scale"], lp["ffn_ln_bias"])
            yf = torch.relu(yf @ lp["ffn_w1"] + lp["ffn_b1"])
            x = yf @ lp["ffn_w2"] + lp["ffn_b2"] + x

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
