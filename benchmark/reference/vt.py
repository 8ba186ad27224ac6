"""Plain reference of the subscale Video Transformer (Rakhimov et al.,
"Latent Video Transformer", arXiv:2006.10704): teacher-forced logits of a
slice and the training loss, in float32 with TF32 off, or in a control's
precision (``reference.precision``).

A frozen copy of the plain path of the port (``models/vt.py`` ``vt_logits``,
``VideoTransformer.loss``; ``ops/attention.py``, ``ops/conv.py``,
``ops/posenc.py``), written against the ``vt`` section of a configuration
file (the port's ``MODEL.AUTOREGRESSIVE.VT`` keys). The parameter tree has
the port's names and nesting, so that the benchmark can hand one tree to
both. Only the configurations the benchmark runs are covered: no class
embedding, per-channel output heads (SHARE_P and SHARE_EMBEDDINGS false).
"""

import math
from functools import lru_cache
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .precision import FP32, Precision
from .subscale import build_plan

# Parameter init of the benchmark's seed-made weights: the port's init
# distributions (xavier-uniform and xavier-normal products, standard normal
# embeddings), except that LayerNorm scales, biases and relative-position
# banks, zeros or ones at the port's init, are drawn around them so that
# every leaf carries information a wrong kernel could lose.
LN_JITTER = 0.1  # LayerNorm scales: 1 + U(-0.1, 0.1)
BIAS_RANGE = 0.1  # biases: U(-0.1, 0.1)
BANK_RANGE = 0.5  # relative-position banks: U(-0.5, 0.5)


def check_supported(v: Dict) -> None:
    if v["CLASS_NUM"] > 0 or v["SHARE_P"] or v["SHARE_EMBEDDINGS"]:
        raise ValueError("the reference covers no class embedding and per-channel heads only")


def _xavier_uniform(fan_in, fan_out):
    return ("uniform", math.sqrt(6.0 / (fan_in + fan_out)))


def _xavier_normal(fan_in, fan_out):
    return ("normal", math.sqrt(2.0 / (fan_in + fan_out)))


def _layer_specs(prefix, blk, na, d, da) -> List[Tuple]:
    t, h, w = blk
    return [
        (prefix + ("ln_scale",), (d,), ("one", LN_JITTER)),
        (prefix + ("ln_bias",), (d,), ("uniform", BIAS_RANGE)),
        (prefix + ("wq",), (na, d, da), _xavier_normal(d, da)),
        (prefix + ("wk",), (na, d, da), _xavier_normal(d, da)),
        (prefix + ("wv",), (na, d, da), _xavier_normal(d, da)),
        (prefix + ("proj",), (na * da, d), _xavier_normal(na * da, d)),
        (prefix + ("ffn_ln_scale",), (d,), ("one", LN_JITTER)),
        (prefix + ("ffn_ln_bias",), (d,), ("uniform", BIAS_RANGE)),
        (prefix + ("ffn_w1",), (d, d), _xavier_uniform(d, d)),
        (prefix + ("ffn_b1",), (d,), ("uniform", BIAS_RANGE)),
        (prefix + ("ffn_w2",), (d, d), _xavier_uniform(d, d)),
        (prefix + ("ffn_b2",), (d,), ("uniform", BIAS_RANGE)),
        (prefix + ("dt_bank",), (na, 2 * t - 1), ("uniform", BANK_RANGE)),
        (prefix + ("dh_bank",), (na, 2 * h - 1), ("uniform", BANK_RANGE)),
        (prefix + ("dw_bank",), (na, 2 * w - 1), ("uniform", BANK_RANGE)),
    ]


def param_specs(v: Dict) -> List[Tuple]:
    """[(path, shape, init)] of the netG tree; init is ("uniform", lim),
    ("normal", std) or ("one", jitter)."""
    check_supported(v)
    nc, nv, de, d, da = v["NC"], v["NV"], v["DE"], v["D"], v["DA"]
    st, sh, sw = v["STRIDE"]
    kt, kh, kw = v["KERNEL"]
    K = kt * kh * kw
    specs = [
        (("encoder", "ctx_table"), (nc, kt, kh, kw, nv, de), _xavier_uniform(nc * nv * K, de * K)),
        (("encoder", "ctx_bias"), (de,), ("uniform", BIAS_RANGE)),
        (("encoder", "slice_embedding"), (st * sh * sw, de), ("normal", 1.0)),
        (("encoder", "projector"), (de, d), _xavier_uniform(de, d)),
    ]
    for i, (blk, na) in enumerate(zip(v["BLOCKS_E"], v["N_HEAD_E"])):
        specs += _layer_specs(("encoder", "layers", i), blk, na, d, da)
    specs += [
        (("decoder", "ch_embed"), (nc, nv, de), ("normal", 1.0)),
        (("decoder", "conv_w"), (3, 3, 3, de, d), _xavier_uniform(de * 27, d * 27)),
        (("decoder", "conv_b"), (d,), ("uniform", BIAS_RANGE)),
        (("decoder", "projector"), (d, d), _xavier_uniform(d, d)),
    ]
    for i, (blk, na) in enumerate(zip(v["BLOCKS_D"], v["N_HEAD_D"])):
        specs += _layer_specs(("decoder", "layers", i), blk, na, d, da)
    specs += [(("predictor", "ln_scale"), (d,), ("one", LN_JITTER)),
              (("predictor", "ln_bias"), (d,), ("uniform", BIAS_RANGE))]
    for k in range(nc):
        specs.append((("predictor", "U_w", k), (d + k * nv, d), _xavier_uniform(d + k * nv, d)))
    for k in range(nc):
        specs.append((("predictor", "U_b", k), (d,), ("uniform", BIAS_RANGE)))
    for k in range(nc):
        specs.append((("predictor", "P_w", k), (d, nv), _xavier_uniform(d, nv)))
    for k in range(nc):
        specs.append((("predictor", "P_b", k), (nv,), ("uniform", BIAS_RANGE)))
    return specs


def plan_of(v: Dict, shape):
    return build_plan(tuple(v["STRIDE"]), tuple(shape), tuple(v["KERNEL"]))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def layer_norm(x, scale, bias, eps=1e-5):
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def _delta(s: int, device):
    r = torch.arange(s, device=device)
    return r[:, None] - r[None, :] + (s - 1)


def relative_bias(p, blk):
    """(na, n, n): dt[ti - tj] + dh[hi - hj] + dw[wi - wj] over a block's
    raster positions."""
    t, h, w = blk
    dev = p["dt_bank"].device
    bt = p["dt_bank"].float()[:, _delta(t, dev)]
    bh = p["dh_bank"].float()[:, _delta(h, dev)]
    bw = p["dw_bank"].float()[:, _delta(w, dev)]
    na = bt.shape[0]
    bias = (bt.reshape(na, t, 1, 1, t, 1, 1) + bh.reshape(na, 1, h, 1, 1, h, 1)
            + bw.reshape(na, 1, 1, w, 1, 1, w))
    return bias.reshape(na, t * h * w, t * h * w)


def block_layer(x, p, blk, causal: bool, prec: Precision = FP32):
    """One block-local attention layer (pre-LN heads with relative bias,
    then the LN-Linear-ReLU-Linear FFN, each with its residual) on (b, T, H,
    W, d), attention inside each contiguous block of ``blk``."""
    b, T, H, W, d = x.shape
    t, h, w = blk
    nbt, nbh, nbw = T // t, H // h, W // w
    tok = x.reshape(b, nbt, t, nbh, h, nbw, w, d).permute(0, 1, 3, 5, 2, 4, 6, 7)
    tok = tok.reshape(-1, t * h * w, d)
    n = t * h * w
    na, _, da = p["wq"].shape
    y = layer_norm(tok, p["ln_scale"], p["ln_bias"])
    q = prec.einsum("bnd,adk->bank", y, p["wq"])
    k = prec.einsum("bnd,adk->bank", y, p["wk"])
    v = prec.einsum("bnd,adk->bank", y, p["wv"])
    s = prec.einsum("bani,bami->banm", q, k) / math.sqrt(da) + relative_bias(p, blk)[None]
    if causal:
        s = s.masked_fill(torch.ones((n, n), dtype=torch.bool, device=s.device).triu(1), -1e4)
    out = prec.einsum("banm,bamd->band", torch.softmax(s, dim=-1), v)
    out = out.permute(0, 2, 1, 3).reshape(-1, n, na * da)
    tok = prec.mm(out, p["proj"]) + tok
    y = layer_norm(tok, p["ffn_ln_scale"], p["ffn_ln_bias"])
    y = torch.relu(prec.mm(y, p["ffn_w1"]) + p["ffn_b1"].float())
    tok = prec.mm(y, p["ffn_w2"]) + p["ffn_b2"].float() + tok
    tok = tok.reshape(b, nbt, nbh, nbw, t, h, w, d).permute(0, 1, 4, 2, 5, 3, 6, 7)
    return tok.reshape(b, T, H, W, d)


def context_encode(ctx, table, bias, stride, prec: Precision = FP32):
    """Conv3d of the one-hot code video ctx (b, nc, T', H', W'), negative =
    pad (a zero input), VALID padding and ``stride``, as the sum over
    (channel, kernel tap) of the table's row at the code there: (b, t, h, w,
    de)."""
    nc, kt, kh, kw, nv, de = table.shape
    st, sh, sw = stride
    Tp, Hp, Wp = ctx.shape[2:]
    t, h, w = (Tp - kt) // st + 1, (Hp - kh) // sh + 1, (Wp - kw) // sw + 1
    tq = prec.q(table)
    acc = None
    for dt in range(kt):
        for dh in range(kh):
            for dw in range(kw):
                win = ctx[:, :, dt:dt + (t - 1) * st + 1:st, dh:dh + (h - 1) * sh + 1:sh,
                          dw:dw + (w - 1) * sw + 1:sw]
                for c in range(nc):
                    codes = win[:, c]
                    rows = tq[c, dt, dh, dw][codes.clamp(min=0).long()]
                    rows = rows * (codes >= 0)[..., None].float()
                    acc = rows if acc is None else acc + rows
    return acc + bias.float()


def masked_conv3d(x, wgt, bias, prec: Precision = FP32):
    """Causal 3-D convolution on (b, t, h, w, c), weight (kt, kh, kw, in,
    out): taps at the current position, to its right in its row, and below
    it in the current frame are zero; the padding keeps the size."""
    kt, kh, kw = wgt.shape[:3]
    mask = torch.ones((kt, kh, kw, 1, 1), device=wgt.device)
    mask[kt - 1, kh - 1, kw // 2:] = 0.0
    wq = prec.q(wgt) * mask
    xc = F.pad(prec.q(x).permute(0, 4, 1, 2, 3), (kw // 2, kw // 2, kh - 1, 0, kt - 1, 0))
    out = F.conv3d(xc, wq.permute(4, 3, 0, 1, 2)).permute(0, 2, 3, 4, 1)
    return out + bias.float()


@lru_cache(maxsize=8)
def _posenc_np(shape, d, min_ts=1.0, max_ts=1.0e4):
    nd = len(shape)
    nts = d // (nd * 2)
    inv = min_ts * np.exp(np.arange(nts, dtype=np.float32) * -(np.log(max_ts / min_ts) / nts))
    total = np.zeros(shape + (d,), dtype=np.float32)
    for dim, length in enumerate(shape):
        scaled = np.arange(length, dtype=np.float32)[:, None] * inv[None, :]
        band = np.zeros((length, d), dtype=np.float32)
        band[:, dim * 2 * nts:(dim + 1) * 2 * nts] = np.concatenate(
            [np.sin(scaled), np.cos(scaled)], axis=1)
        bshape = [1] * nd + [d]
        bshape[dim] = length
        total = total + band.reshape(bshape)
    return total


def posenc(shape, d, device):
    """The 3-D sinusoidal encoding (t, h, w, d): per axis a band of sin then
    cos channels, bands axis-major from channel 0."""
    return torch.as_tensor(_posenc_np(tuple(shape), d), device=device)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def prepare_slices(v: Dict, video, slice_idx):
    """video (b, nc, T, H, W) codes, slice_idx (b,) -> (context (b, nc, T',
    H', W') with PAD_VALUE where nothing is seen, slice codes (b, nc, t, h,
    w), flat video index of each slice position (b, t, h, w))."""
    b, nc, T, H, W = video.shape
    plan = plan_of(v, (T, H, W))
    dev = video.device
    sidx = torch.as_tensor(slice_idx).long().cpu().numpy()
    ctx_src = torch.as_tensor(plan.ctx_src[sidx], device=dev)
    sl_src = torch.as_tensor(plan.slice_src[sidx], device=dev)
    flat = video.reshape(b, nc, -1).long()
    ctx = torch.gather(flat, 2, ctx_src.clamp(min=0).reshape(b, 1, -1).expand(b, nc, -1))
    ctx = ctx.reshape((b, nc) + tuple(ctx_src.shape[1:]))
    ctx = ctx.masked_fill((ctx_src < 0)[:, None], v["PAD_VALUE"])
    sl = torch.gather(flat, 2, sl_src.reshape(b, 1, -1).expand(b, nc, -1))
    return ctx, sl.reshape((b, nc) + tuple(sl_src.shape[1:])), sl_src


def logits(params, v: Dict, ctx, slice_codes, slice_idx, prec: Precision = FP32):
    """Teacher-forced logits (b, t, h, w, nc, nv) of every position and
    channel of a slice given its context and its own codes."""
    enc, dec, pred = params["encoder"], params["decoder"], params["predictor"]
    nc, nv, d = v["NC"], v["NV"], v["D"]
    x = context_encode(ctx, enc["ctx_table"], enc["ctx_bias"], v["STRIDE"], prec)
    x = x + enc["slice_embedding"].float()[torch.as_tensor(slice_idx, device=x.device).long()][
        :, None, None, None, :]
    x = prec.mm(x, enc["projector"])
    for p, blk in zip(enc["layers"], v["BLOCKS_E"]):
        x = block_layer(x, p, blk, False, prec)
    zl = x
    codes = slice_codes.movedim(1, -1).long()  # (b, t, h, w, nc)
    embq = prec.q(dec["ch_embed"])
    emb = sum(embq[k][codes[..., k]] for k in range(nc))
    x = masked_conv3d(emb, dec["conv_w"], dec["conv_b"], prec)
    x = x + posenc(x.shape[1:4], d, x.device)
    x = x + prec.mm(zl, dec["projector"])
    for p, blk in zip(dec["layers"], v["BLOCKS_D"]):
        x = block_layer(x, p, blk, True, prec)
    y = layer_norm(x, pred["ln_scale"], pred["ln_bias"])
    outs = []
    for k in range(nc):
        uw = pred["U_w"][k]
        u = prec.mm(y, uw[:d]) + pred["U_b"][k].float()
        uq = prec.q(uw)
        for j in range(k):
            u = u + uq[d + j * nv + codes[..., j]]
        outs.append(prec.mm(torch.relu(u), pred["P_w"][k]) + pred["P_b"][k].float())
    return torch.stack(outs, dim=-2)


def loss(params, v: Dict, video, slice_idx, n_prime: int, prec: Precision = FP32):
    """Cross-entropy of one slice a video (slice_idx), averaged over the
    positions outside the first ``n_prime`` frames for each channel, then
    over the channels."""
    ctx, sl, src = prepare_slices(v, video, slice_idx)
    lg = logits(params, v, ctx, sl, slice_idx, prec)
    H, W = video.shape[3:]
    targets = sl.movedim(1, -1)  # (b, t, h, w, nc)
    ce = torch.logsumexp(lg, dim=-1) - torch.gather(lg, -1, targets[..., None])[..., 0]
    valid = (src // (H * W) >= n_prime)[..., None].expand(ce.shape).float()
    per_channel = (ce * valid).sum(dim=(0, 1, 2, 3)) / valid.sum(dim=(0, 1, 2, 3)).clamp(min=1.0)
    return per_channel.mean()


def train_slice_indices(v: Dict, seed: int, step: int, batch: int, T: int) -> torch.Tensor:
    """The slice a video of step ``step``'s batch trains on, as the trainer
    of the port draws it: from a CPU generator seeded with ((seed + 1) *
    1,000,003 + step) mod 2^63, uniform over the slices, from N_PRIME on
    where a slice is one whole frame (stride (T, 1, 1))."""
    st, sh, sw = v["STRIDE"]
    lo = v["N_PRIME"] if (T // st == 1 and sh == 1 and sw == 1) else 0
    gen = torch.Generator().manual_seed(((seed + 1) * 1_000_003 + step) % 2 ** 63)
    return torch.randint(lo, st * sh * sw, (batch,), generator=gen)


def sampled_slices(v: Dict, shape, n_prime: int) -> List[int]:
    """The slices a rollout samples: those with a position outside the
    first ``n_prime`` frames."""
    plan = plan_of(v, tuple(shape))
    H, W = shape[1:]
    return [s for s in range(plan.num_slices)
            if not (plan.slice_src[s].reshape(-1) // (H * W) < n_prime).all()]
