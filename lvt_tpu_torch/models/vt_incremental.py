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
* per slice  — the zl projection (the bias tables are the same for every
               slice and made once).

A slice's pixel loop reads nothing back to the host: the primed pixels are
kept by a select on the device, as the JAX sampler's ``lax.scan`` keeps
them, so on the card ``models/rollout_graph.py`` captures the whole loop as
one CUDA graph and replays it for every slice.

The port owns its cache layout and updates it in place: one buffer of
(L, b, na, R, da) per K and V, allocated once per ``SliceDecoder`` (one
sampler configuration) and reused by every slice, with R = the block run
(the slice when blocks do not tile it as contiguous runs). Pixel p writes
row p_loc = p mod R and attends to rows [0, p_loc] through the functions of
``ops.cache_attention`` (kernels 2, 3 and 4 on the card). Rows left from the
previous block run lie at or above p_loc + 1 and are never read; within a
run, cross-block entries carry a -1e9 bias, which gives them exactly zero
weight as in the JAX package. The JAX package's fused-lane cache layout,
block-diagonal q and segmented cache growth answer the TPU and its compiler
and have no counterpart here: they do not change what is computed.

With ``kv_dtype="int8"`` the caches are int8 with one absmax scale per
(head, row), kept in the parameter dtype as the JAX package keeps them:
(L, b, na, R) beside each cache. ``kv_dtype="int4"`` quantizes the same way
to the levels -7..7 and packs two signed nibbles a byte along da: caches of
(L, b, na, R, da / 2) int8, half of int8's bytes, as the JAX package's
``jnp.int4`` storage halves them. Its attention is the plain PyTorch path
of the int8 cache with ``attn_impl="xla"``, the live rows unpacked by
arithmetic shifts into the same preallocated buffer.

``streams=S`` splits the batch into S blocks of b / S consecutive rows, each
an independent rollout with caches of its own, stepped in turn at every
pixel as the JAX package's ``multi_step`` steps its streams. Every
computation of a block runs at b / S rows, so a block's codes are those of a
one-stream rollout of its rows. On the card each block is one branch of the
slice's CUDA graph, on a CUDA stream of its own (``models/rollout_graph.py``).

Under tensor parallelism (a ``SliceDecoder`` made inside
``parallel.mesh.tensor_parallel``, on the rank's part of the netG tree) the
caches hold the rank's heads and kernels 2, 3 and 4 attend over them; the
partial products after ``proj`` and after FFN 2 are summed over the model
group in fp32 before the residual and rounded once, as the whole product
is; the embedding rows are gathered whole, and the
predictor is split as in ``models/vt.py``. Every mode runs there. The
quantized caches' scales, and q's in ``mm_dtype`` "int8", are per (head,
row), so a rank computes its heads' own. Two scales span what no rank holds
whole, and are taken over the group (``parallel.collectives.max_over_model``):
the column scales of the row-split weights (``proj``, FFN 2: each column's
absmax over every rank's rows, so a rank's integers are its rows of the
whole weight's), and, with kernel 11, the absmax of each activation row
before them (``row_amax``). Kernel 11 then writes its exact int32 sums, the
group adds them and the scales apply once, so the product is the whole
rows' bit for bit, as the JAX package computes it in one kernel call; with
"int8" weights the column scale multiplies the group's sum, as the JAX
package's (y @ W8) * s does with its sum inside the product. With
``streams`` the blocks run in turn, each block's collectives in order, on
every rank of the group.
"""

import contextlib
import math
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from ..ops.attention import _layer_norm, relative_bias
from ..ops.cache_attention import (decode_attention, decode_attention_i8_live_step,
                                   decode_attention_i8_plain, decode_attention_i8_step)
from ..ops.posenc import _signal_np
from ..ops.quant import (QMAX, matmul_i8w, matmul_i8w_split, pack_int4, quantize_cols,
                         quantize_rows_i8, unpack_int4)
from ..ops.quant import quantize_cache_row as _quantize_cache_row
from ..parallel.collectives import local_features, reduce_from_model
from .vt import (VTConfig, _embed_sum_codes, _layer_shards, _predictor_head, _predictor_u,
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


def _check_knobs(kv_dtype, weight_dtype, mm_dtype, attn_impl, streams, b):
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
    if streams < 1 or b % streams:
        raise ValueError(f"streams={streams} must be >=1 and divide the batch ({b})")
    if attn_impl == "pallas" and kv_dtype not in ("int8", "native"):
        raise ValueError("attn_impl='pallas' supports kv_dtype 'int8' (kernel 3 over int8 "
                         f"caches) or 'native' (kernel 2), not {kv_dtype!r}")


# Stream s of a temperature rollout of S > 1 streams draws from a generator
# seeded with the s-th of S draws torch.randint(STREAM_SEEDS, (S,)) from the
# caller's generator: the port's counterpart of the JAX sampler's split of
# its key into S.
STREAM_SEEDS = 2 ** 62


def stream_seeds(gen, streams: int, device):
    """The S seeds of a rollout's streams, drawn from ``gen`` (None: the
    default generator of ``device``) on the generator's device and read back
    to the host."""
    if gen is None:
        device = torch.device(device)
        gen = (torch.default_generator if device.type == "cpu" else
               torch.cuda.default_generators[device.index if device.index is not None
                                             else torch.cuda.current_device()])
    return torch.randint(STREAM_SEEDS, (streams,), generator=gen, device=gen.device).tolist()


def stream_generators(gen, streams: int, device, greedy: bool = False):
    """The generator of each stream of a rollout: at one stream the caller's
    ``gen`` itself, so nothing changes; at S streams S new generators on
    ``device``, seeded by ``stream_seeds``. A greedy rollout draws nothing
    and leaves ``gen`` as it is."""
    if streams == 1:
        return [gen]
    if greedy:
        return [None] * streams
    return [torch.Generator(device=device).manual_seed(seed)
            for seed in stream_seeds(gen, streams, device)]


def _on(streams, s):
    """Stream s of a graph's branches as the current stream, or nothing
    (streams None: the current stream runs every block)."""
    return contextlib.nullcontext() if streams is None else torch.cuda.stream(streams[s])


class _Caches:
    """One stream's cache state, for its bs rows: the K and V caches
    ``k``, ``v`` (L, bs, na, R, da) in the parameter dtype or int8, or (L,
    bs, na, R, da / 2) int8 of packed int4 pairs; with a quantized cache the
    per-row scales ``ks``, ``vs`` (L, bs, na, R) in the parameter dtype; with
    attn_impl "xla" over a quantized cache the float buffers ``kvf`` that
    the live rows are read through, and for int4 the int8 scratch ``nib``
    of the unpack."""

    def __init__(self, L, bs, na, R, da, cdtype, dev, kv_dtype, mm_dtype, attn_impl):
        quantized = kv_dtype != "native"
        width = da // 2 if kv_dtype == "int4" else da
        self.k = torch.zeros((L, bs, na, R, width), dtype=torch.int8 if quantized else cdtype,
                             device=dev)
        self.v = torch.zeros_like(self.k)
        if quantized:
            self.ks = torch.zeros((L, bs, na, R), dtype=cdtype, device=dev)
            self.vs = torch.zeros_like(self.ks)
        if quantized and attn_impl == "xla":
            # the live rows of one layer's K and V as floats (fp32; float64,
            # the exact integer products of kernel 3's plain version, with
            # mm_dtype "int8"), in buffers of the cache's length made once: a
            # temporary that grew with the live rows would take a new block
            # at every pixel of a CUDA graph's capture, whose private pool
            # keeps them all (at b = 1024 one fp32 cast of 256 rows is
            # 1.07 GB; the capture ran out of the card)
            self.kvf = torch.empty((2, bs, na, R, da), device=dev,
                                   dtype=torch.float32 if mm_dtype == "native" else torch.float64)
        if kv_dtype == "int4":  # the unpack's shifts land here, for the same reason
            self.nib = torch.empty((bs, na, R, width), dtype=torch.int8, device=dev)


class SliceDecoder:
    """The incremental decoder of one sampler configuration: the set-up that
    every slice shares, made once (conv tap table, positional rows, bias
    rows, fused and quantized weights, each stream's caches), and the pixel
    loop.

    params: the netG tree; b: the batch; the knobs as
    ``sample_slice_incremental`` takes them. ``inputs`` makes a slice's own
    inputs, ``sample`` runs its pixel loop and ``teacher`` the teacher-forced
    one. The caches are reused from slice to slice without clearing: pixel p
    writes its row before any pixel reads it, and reads only rows written
    since its block run began. With ``streams`` S the rows [s * b / S, (s +
    1) * b / S) are stream s (``rows``), with caches of their own
    (``caches``)."""

    def __init__(self, params, c: VTConfig, slice_shape, b: int, device,
                 kv_dtype: str = "native", weight_dtype: str = "native",
                 mm_dtype: str = "native", attn_impl: str = "xla", streams: int = 1):
        _check_knobs(kv_dtype, weight_dtype, mm_dtype, attn_impl, streams, b)
        self.params, self.c = params, c
        self.shards = _layer_shards(c, c.n_head_d) or [None] * len(params["decoder"]["layers"])
        self.weight_dtype, self.mm_dtype, self.attn_impl = weight_dtype, mm_dtype, attn_impl
        self.kv_dtype, self.streams = kv_dtype, streams
        self.qmax = QMAX.get(kv_dtype)  # None: the native cache
        dec = self.dec = params["decoder"]
        layers = self.layers = dec["layers"]
        t, h, w = slice_shape
        thw = self.thw = t * h * w
        self.b = b
        self.na, _, self.da = na, _, da = layers[0]["wq"].shape
        if len({tuple(lp["wq"].shape) for lp in layers}) != 1:
            raise ValueError("incremental sampler needs one head count across decoder layers; "
                             "use sample_video(incremental=False) for heterogeneous stacks")
        if kv_dtype == "int4" and da % 2:
            raise ValueError(f"kv_dtype='int4' packs two values a byte along da; da={da} is odd")
        L = len(layers)
        dev = torch.device(device)
        cdtype = self.cdtype = dec["conv_w"].dtype
        self.scale = 1.0 / math.sqrt(da)

        # causal conv: cache emb gets one zero row at index thw that every
        # out-of-bounds tap (-1) reads instead
        nbr_np, tap_ids_np = conv_tap_table((t, h, w))
        self.nbr = torch.as_tensor(np.where(nbr_np < 0, thw, nbr_np), device=dev)  # (thw, K')
        conv_w = dec["conv_w"].reshape(-1, c.de, c.d)[torch.as_tensor(tap_ids_np, device=dev)]
        self.conv_w = conv_w.reshape(-1, c.d)  # (K' * de, d)
        self.pos_rows = torch.as_tensor(posenc_rows((t, h, w), c.d), device=dev).to(cdtype)

        blocks = [tuple(bk) for bk in c.blocks_d]
        bt0, bh0, bw0 = blocks[0]
        self.block_local = len(set(blocks)) == 1 and bh0 == h and bw0 == w and t % bt0 == 0
        R = self.R = bt0 * h * w if self.block_local else thw
        self.bias_rows = [_bias_rows(lp, blk, slice_shape, self.block_local, R)
                          for lp, blk in zip(layers, blocks)]
        # fused QKV: columns [q heads | k heads | v heads], as the JAX sampler
        weights = [{"qkv": torch.cat([lp[n].permute(1, 0, 2).reshape(c.d, na * da)
                                      for n in ("wq", "wk", "wv")], dim=1),
                    "proj": lp["proj"], "ffn1": lp["ffn_w1"], "ffn2": lp["ffn_w2"]}
                   for lp in layers]
        if weight_dtype != "native":
            # quantized once here; each product reads the int8 bytes. Kernel
            # 11 takes the weight transposed, (N, K). A row-split weight's
            # column scales are the model group's.
            weights = [{k: quantize_cols(w, cdtype, self._row_group(l, k)) for k, w in lw.items()}
                       for l, lw in enumerate(weights)]
            if weight_dtype == "int8-pallas":
                weights = [{k: (wi.t().contiguous(), s) for k, (wi, s) in lw.items()}
                           for lw in weights]
        self.weights = weights
        bs = b // streams
        self.rows = [slice(s * bs, (s + 1) * bs) for s in range(streams)]
        self.caches = [_Caches(L, bs, na, R, da, cdtype, dev, kv_dtype, mm_dtype, attn_impl)
                       for _ in range(streams)]

    def cache_bytes(self) -> int:
        """Bytes of the K and V caches of every stream (numel x element
        size; the scales and the buffers of the plain path apart)."""
        return sum(t.numel() * t.element_size() for st in self.caches for t in (st.k, st.v))

    def _row_group(self, l, name):
        """The model group over which layer l's product ``name`` is split by
        its input rows (proj, FFN 2), or None where the rank holds it whole
        or split by its columns."""
        shard = self.shards[l]
        split = shard is not None and {"proj": shard.proj, "ffn2": shard.ffn}.get(name, False)
        return shard.group if split else None

    def _mm(self, y, w):
        if self.weight_dtype == "native":
            return y @ w
        if self.weight_dtype == "int8-pallas":
            return matmul_i8w(y, w[0], w[1], self.cdtype)
        return (y @ w[0].to(self.cdtype)) * w[1]

    def _mm_rows(self, y, w, group):
        """A row-split product, y the rank's features and w its rows of the
        weight, summed over the model group and rounded to the compute dtype
        once, after the sum, as the whole product is: the ranks' partial
        products are fp32. With kernel 11 the whole rows' product, bit for
        bit (``matmul_i8w_split``); with int8 weights the column scale
        multiplies the rounded sum, as it multiplies the whole product."""
        if self.weight_dtype == "int8-pallas":
            return matmul_i8w_split(y, w[0], w[1], group, self.cdtype)
        native = self.weight_dtype == "native"
        acc = reduce_from_model(y.float() @ (w if native else w[0]).float(), group)
        acc = acc.to(self.cdtype)
        return acc if native else acc * w[1]

    def _attend_q(self, st: _Caches, l, qkv, live, bias):
        """Write the new rows (row live - 1) into layer l's quantized cache of
        stream state ``st`` and attend over rows [0, live)."""
        kc, vc, ks, vs = st.k[l], st.v[l], st.ks[l], st.vs[l]
        cdtype, na, da = self.cdtype, self.na, self.da
        if self.attn_impl != "xla":  # kernel 3 or 4, the cache write and q's quantization folded in
            fn = decode_attention_i8_step if self.attn_impl == "pallas" else \
                decode_attention_i8_live_step
            return fn(qkv[:, 0], qkv[:, 1:], kc, ks, vc, vs, live, bias, self.scale, cdtype)
        kv8, kvs = _quantize_cache_row(qkv[:, 1:], cdtype, self.qmax)  # K and V rows at once
        if self.kv_dtype == "int4":
            kv8 = pack_int4(kv8)
        kc[:, :, live - 1], vc[:, :, live - 1] = kv8[:, 0], kv8[:, 1]
        ks[:, :, live - 1], vs[:, :, live - 1] = kvs[:, 0], kvs[:, 1]
        q = qkv[:, 0]
        kf, vf = st.kvf[0], st.kvf[1]
        if self.kv_dtype == "int4":
            nib = st.nib[:, :, :live]
            unpack_int4(kc[:, :, :live], kf[:, :, :live], nib)
            unpack_int4(vc[:, :, :live], vf[:, :, :live], nib)
        else:
            kf[:, :, :live].copy_(kc[:, :, :live])
            vf[:, :, :live].copy_(vc[:, :, :live])
        if self.mm_dtype == "native":
            # the cache cast to the parameter dtype and on to fp32: exact, so
            # one cast of the integer rows straight to fp32
            logits = torch.einsum("bak,bajk->baj", q.float(), kf[:, :, :live])
            logits = logits / math.sqrt(da) * ks[:, :, :live].float() + bias[None, :, :live]
            wgt = torch.softmax(logits, dim=-1).to(cdtype) * vs[:, :, :live]
            out = torch.einsum("baj,bajk->bak", wgt.float(), vf[:, :, :live])
            return out.to(cdtype).reshape(q.shape[0], na * da)
        # the plain version casts its int8 K and V to float64; given them so,
        # it casts nothing
        q8, sq = quantize_rows_i8(q)
        return decode_attention_i8_plain(q8, sq[..., 0], kf, ks, vf, vs, live, bias, self.scale,
                                         cdtype)

    def inputs(self, zl, sl, streams=None):
        """One slice's own inputs: zl's projection of each stream's rows (a
        list of S tensors (b / S, thw, d)), a copy of the codes (b, nc, thw)
        and their embedding rows (b, thw + 1, de), the last row the zero row
        of the conv's padding taps. zl: (b, t, h, w, d); sl: (b, nc, t, h, w).
        ``streams``: the CUDA streams of a graph's S branches; each waits for
        the current stream, then makes its rows' projection and embedding
        rows (``sample`` joins them back)."""
        c, b, thw = self.c, self.b, self.thw
        sl_flat = sl.reshape(b, sl.shape[1], thw).clone()
        emb = torch.zeros((b, thw + 1, c.de), dtype=self.cdtype, device=zl.device)
        if streams is not None:
            current = torch.cuda.current_stream(zl.device)
            for st in streams:
                st.wait_stream(current)
        zlproj = []
        for s, r in enumerate(self.rows):
            with _on(streams, s):
                zlproj.append((zl[r] @ self.dec["projector"]).reshape(-1, thw, c.d))
                emb[r, :thw] = _embed_sum_codes(self.dec, c, sl_flat[r].movedim(1, -1)).to(
                    self.cdtype)
        return zlproj, sl_flat, emb

    def _pixel(self, p: int, emb, zlproj, st: _Caches):
        """The decoder at pixel p for one stream's rows (emb, zlproj: its
        rows), its K/V rows written into the stream's caches ``st``:
        (rows, d), after the predictor's LayerNorm."""
        c, b = self.c, emb.shape[0]
        p_loc = p % self.R
        rows = emb[:, self.nbr[p]]  # (b, K', de), pad taps read the zero row
        x = rows.reshape(b, -1) @ self.conv_w + self.dec["conv_b"]
        x = x + self.pos_rows[p] + zlproj[:, p]
        for l, lp in enumerate(self.layers):
            y = _layer_norm(x, lp["ln_scale"], lp["ln_bias"])
            qkv = self._mm(y, self.weights[l]["qkv"]).reshape(b, 3, self.na, self.da)
            bias = self.bias_rows[l][p_loc if self.block_local else p]
            if self.qmax is not None:
                out = self._attend_q(st, l, qkv, p_loc + 1, bias)
            else:
                st.k[l, :, :, p_loc] = qkv[:, 1]  # in place: the one new row
                st.v[l, :, :, p_loc] = qkv[:, 2]
                out = decode_attention(qkv[:, 0], st.k[l], st.v[l], p_loc + 1, bias, self.scale)
            shard = self.shards[l]
            if shard is not None and shard.proj:  # the rank's rows, summed before the residual
                if not shard.heads:
                    out = local_features(out, shard.group)
                x = self._mm_rows(out, self.weights[l]["proj"], shard.group) + x
            else:
                x = self._mm(out, self.weights[l]["proj"]) + x
            yf = _layer_norm(x, lp["ffn_ln_scale"], lp["ffn_ln_bias"])
            yf = torch.relu(self._mm(yf, self.weights[l]["ffn1"]) + lp["ffn_b1"])
            if shard is not None and shard.ffn:
                x = self._mm_rows(yf, self.weights[l]["ffn2"], shard.group) + lp["ffn_b2"] + x
            else:
                x = self._mm(yf, self.weights[l]["ffn2"]) + lp["ffn_b2"] + x
        pred = self.params["predictor"]
        return _layer_norm(x, pred["ln_scale"], pred["ln_bias"])

    def sample(self, zlproj, sl_flat, emb, primed, gen, temp, greedy: bool = False,
               streams=None):
        """The slice's pixel loop. Every pixel is sampled, and where the
        (thw,) bool tensor ``primed`` is set the old code is kept, as the JAX
        sampler's ``jnp.where(primed[p], old, sampled)``; sl_flat and emb are
        written in place. At each pixel the streams step in order, stream s
        drawing from ``gen[s]`` (a list of one generator a stream,
        ``stream_generators``; at one stream also the generator itself), on
        ``streams[s]`` where the CUDA streams of a graph's branches are given
        (``inputs`` forked them), which the current stream joins at the end.
        Nothing here reads a value back to the host, so one CUDA graph
        captures the whole loop (``models/rollout_graph.py``)."""
        gens = gen if isinstance(gen, (list, tuple)) else [gen]
        if len(gens) != self.streams:
            raise ValueError(f"sample: {len(gens)} generator(s) for {self.streams} streams "
                             "(stream_generators makes them)")
        for p in range(self.thw):
            for s, r in enumerate(self.rows):
                with _on(streams, s):
                    y_pix = self._pixel(p, emb[r], zlproj[s], self.caches[s])
                    sampled = vt_sample_pixel_channels(self.params, self.c, y_pix, gens[s], temp,
                                                       greedy=greedy)
                    final = torch.where(primed[p], sl_flat[r, :, p], sampled.to(sl_flat.dtype))
                    sl_flat[r, :, p] = final
                    emb[r, p] = _embed_sum_codes(self.dec, self.c, final).to(self.cdtype)
        if streams is not None:
            current = torch.cuda.current_stream(sl_flat.device)
            for st in streams:
                current.wait_stream(st)

    def teacher(self, zlproj, sl_flat, emb):
        """The teacher-forced loop: every pixel keeps its code (``inputs``
        made the embedding rows of all of them), and the channel
        conditioning reads the given previous channels (vt_logits
        semantics). No head feeds a later pixel, so the loop only steps the
        decoder (the streams in turn at each pixel) and the predictor heads
        run once a stream, over every pixel's output. Returns the fp32
        channel logits (b, thw, nc, nv) in batch order."""
        c, pred = self.c, self.params["predictor"]
        ys = [[] for _ in self.rows]
        for p in range(self.thw):
            for s, r in enumerate(self.rows):
                ys[s].append(self._pixel(p, emb[r], zlproj[s], self.caches[s]))
        codes = sl_flat.movedim(1, -1)  # (b, thw, nc)
        logits = []
        for s, r in enumerate(self.rows):
            y = torch.stack(ys[s], dim=1)
            logits.append(torch.stack([_predictor_head(pred, c, k, _predictor_u(
                pred, c, k, y, codes[r]), self.dec).float() for k in range(c.nc)], dim=2))
        return logits[0] if self.streams == 1 else torch.cat(logits, dim=0)

    def run(self, zl, sl, primed, gen, temp, greedy: bool = False):
        """One slice sampled eagerly: its inputs, then ``sample``, the
        streams' generators made from ``gen`` by ``stream_generators``.
        Returns the codes (b, nc, t, h, w)."""
        zlproj, sl_flat, emb = self.inputs(zl, sl)
        self.sample(zlproj, sl_flat, emb, primed,
                    stream_generators(gen, self.streams, zl.device, greedy), temp, greedy)
        return sl_flat.reshape(sl.shape)


def sample_slice_incremental(params, c: VTConfig, slice_shape, zl, sl, gen, primed, temp,
                             greedy: bool = False, kv_dtype: str = "native",
                             seg_size: int = 0, weight_dtype: str = "native",
                             mm_dtype: str = "native", attn_impl: str = "xla",
                             streams: int = 1, teacher_logits: bool = False):
    """Exact AR sampling of one slice with cached decoder state, eagerly.

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
    differs. "int4" rounds the same way to the levels -7..7 and stores two
    a byte (half of int8's bytes); it runs with attn_impl "xla" only, as in
    the JAX package, through the int8 cache's plain PyTorch path.

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
    once per ``SliceDecoder``: (y @ W8 cast to the parameter dtype) * s. "int8-pallas"
    runs them through kernel 11 (``ops.quant.matmul_i8w``), which also
    quantizes the activation rows. The conv, the projector and the predictor
    stay native.

    streams: S independent rollouts of b / S consecutive rows each, stepped
    in turn at every pixel (see the module docstring); greedy codes and
    teacher logits equal a one-stream rollout's. At temperature, stream s
    draws from a generator seeded from ``gen`` (``stream_generators``), as
    the JAX sampler splits its key S ways. S must divide b.

    seg_size is accepted and ignored (see the module docstring).
    """
    dec = SliceDecoder(params, c, slice_shape, sl.shape[0], zl.device, kv_dtype, weight_dtype,
                       mm_dtype, attn_impl, streams)
    if teacher_logits:
        zlproj, sl_flat, emb = dec.inputs(zl, sl)
        return sl_flat.reshape(sl.shape), dec.teacher(zlproj, sl_flat, emb)
    primed = torch.as_tensor(np.asarray(primed, bool), device=zl.device)
    return dec.run(zl, sl, primed, gen, temp, greedy)
