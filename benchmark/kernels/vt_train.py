"""One training step of the Video Transformer, whole: its matmul operations
(2 M N K each), forward and twice that backward (``tools/mfu_torch.py``
``_analytic_vt_train_flops``, copied). Per token and layer: QKV 6 d na da,
the head projection 2 na da d, the FFN 4 d^2, attention 4 n na da over a
block of n; the encoder and the decoder each see one slice of every clip;
the channel heads add their U and P products on the decoder's tokens.
Left out: the context encode (a one-hot convolution, gathered forward and
segment-summed backward), the causal convolution, LayerNorms, the
optimizer."""


def flops(v: dict, video: dict, batch: int) -> float:
    T, H, W = video["T"], video["H"], video["W"]
    st, sh, sw = v["STRIDE"]
    thw = (T // st) * (H // sh) * (W // sw)
    d = v["D"]

    def stack(blocks, heads):
        total = 0.0
        for (bt, bh, bw), na in zip(blocks, heads):
            nada = na * v["DA"]
            total += batch * thw * (8 * d * nada + 4 * d * d + 4 * (bt * bh * bw) * nada)
        return total

    fwd = stack(v["BLOCKS_E"], v["N_HEAD_E"]) + stack(v["BLOCKS_D"], v["N_HEAD_D"])
    for k in range(v["NC"]):
        fwd += batch * thw * 2 * (d + k * v["NV"]) * d
        fwd += batch * thw * 2 * d * v["NV"]
    return 3.0 * fwd
