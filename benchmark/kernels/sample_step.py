"""One pixel step of the KV-cached rollout, whole: the bytes it must move
and its operations (``tools/mfu_torch.py`` ``sample_roofline``'s accounting,
copied), averaged over the rollout, for the port's cache layout (one buffer
of a block run's rows; pixel p of a run attends to its rows [0, p]).

Bytes: the K and V cache rows read and the new row written; every
per-pixel product's weights read again (the weight stream); the
causal convolution's embedding rows, the pixel's own rows (embedding,
projected context, bias rows), the logits of the channel heads; and each
slice's context encode and encoder output, spread over its pixels.
Operations: the decoder's products, attention, the channel heads, the
convolution, and the slice's encoder stack spread over its pixels."""

CONV_TAPS = 25  # the unmasked taps of the decoder's causal 3 x 3 x 3 convolution


def per_step(v: dict, video: dict, b: int, kv: str = "native", dtype: str = "bfloat16"):
    """(bytes, operations, pixel steps of a rollout) of one pixel step."""
    T, H, W = video["T"], video["H"], video["W"]
    st, sh, sw = v["STRIDE"]
    t, h, w = T // st, H // sh, W // sw
    thw = t * h * w
    L = len(v["BLOCKS_D"])
    na, da, d, de, nc, nv = v["N_HEAD_D"][0], v["DA"], v["D"], v["DE"], v["NC"], v["NV"]
    nada = na * da
    act = 2 if dtype == "bfloat16" else 4
    kv_bytes = {"int8": 1.0, "int4": 0.5, "native": float(act)}[kv]
    bt, bh, bw = v["BLOCKS_D"][0]
    block_local = len({tuple(x) for x in v["BLOCKS_D"]}) == 1 and bh == h and bw == w \
        and t % bt == 0
    blk_run = bt * h * w if block_local else thw
    mean_cl = (blk_run + 1) / 2.0
    n_prime = video["N_PRIME_TEST"]
    frames = [[(a + st * i) for i in range(t)] for a in range(st) for _ in range(sh * sw)]
    sampled = sum(1 for f in frames if max(f) >= n_prime)
    Kp = CONV_TAPS

    quant = kv in ("int8", "int4")
    terms = {
        "kv_cache_reads": 2 * L * b * na * mean_cl * da * kv_bytes,
        "kv_scale_reads": 2 * L * b * na * mean_cl * act if quant else 0.0,
        "kv_cache_writes": 2 * L * b * na * da * kv_bytes + (2 * L * b * na * act if quant else 0.0),
    }
    per_layer_w = d * 3 * nada + nada * d + 2 * d * d + 8 * d
    pred_w = sum((d + k * nv) * d + d * nv for k in range(nc)) + 4 * d
    terms["weight_stream"] = (L * per_layer_w + pred_w + Kp * de * d) * act
    terms["emb_conv_gather"] = b * Kp * de * act
    terms["emb_row_write"] = b * de * act + b * nc * de * act
    terms["zlproj_row"] = b * d * act
    terms["bias_rows"] = L * na * mean_cl * 4.0
    terms["pred_logits"] = b * nc * nv * 4.0
    terms["zl_zlproj_slice"] = (3 * b * thw * d * act) / thw
    kt, kh, kw = v["KERNEL"]
    ncK = nc * kt * kh * kw
    ctx_vol = ((t - 1) * st + kt) * ((h - 1) * sh + kh) * ((w - 1) * sw + kw)
    terms["ctx_gidx_slice"] = (2 * b * ncK * thw * 4 + b * nc * ctx_vol * 4) / thw
    terms["ctx_table_rows_slice"] = (b * thw * ncK * de * act) / thw
    nbytes = float(sum(terms.values()))

    ops = b * L * 2.0 * (d * 3 * nada + nada * d + 2 * d * d)
    ops += b * L * 2 * 2 * na * mean_cl * da
    ops += b * 2.0 * sum((d + k * nv) * d + d * nv for k in range(nc))
    ops += b * 2.0 * Kp * de * d
    enc = 0.0
    for (ebt, ebh, ebw), nh in zip(v["BLOCKS_E"], v["N_HEAD_E"]):
        enc += b * thw * (8 * d * nh * da + 4 * d * d + 4 * (ebt * ebh * ebw) * nh * da)
    enc += b * thw * 2 * d * d
    ops += enc / thw
    return nbytes, ops, sampled * thw
