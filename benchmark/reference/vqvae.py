"""Plain reference of the VQ-VAE with a product codebook (PR-DVQVAE2:
ResEncoder, NUM sub-codebooks of SIZE codes, ResDecoder; Razavi et al.,
arXiv:1906.00446, as the LVT paper uses it): the codes of frames and the
frames of codes, in float32 with TF32 off, or in a control's precision.

A frozen copy of the port's plain path (``models/vqvae.py`` ``encode`` /
``decode``, ``models/encoders.py`` ``ResEncoder``, ``models/decoders.py``
``ResDecoder``, ``models/layers2d.py``, ``ops/conv.py``, ``ops/vq.py``),
written against the ``vqvae`` section of a configuration file (the port's
``MODEL`` keys). Frames are NHWC floats in [0, 255]; weights in the port's
layouts (convolutions HWIO, transposed convolutions (kh, kw, out, in)).
Covered: no norms, no spectral norm, an EMA codebook.
"""

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .precision import FP32, Precision

BIAS_RANGE = 0.05  # the seed-made biases (zeros at the port's init): U(-0.05, 0.05)


def check_supported(q: Dict) -> None:
    e, g = q["ENCODER"], q["GENERATOR"]
    if (e["NAME"], g["NAME"]) != ("ResEncoder", "ResDecoder") or e["NORM"] or g["NORM"] \
            or e.get("SPECTRAL") or g.get("SPECTRAL") or not q["CODEBOOK"]["EMA"]:
        raise ValueError("the reference covers ResEncoder / ResDecoder without norms and an "
                         "EMA codebook only")


def encoder_spec(q: Dict) -> List[Tuple]:
    e = q["ENCODER"]
    nf, res = e["NF"], e["RES_CHANNELS"]
    spec = [("conv", e["IN_CHANNELS"], nf // 2, 4, 2, 1), ("relu",),
            ("conv", nf // 2, nf, 4, 2, 1), ("relu",), ("conv", nf, nf, 3, 1, 1)]
    spec += [("resblock", nf, res)] * e["N_LAYERS"]
    return spec + ([(e["OUT_ACTIVATION"],)] if e["OUT_ACTIVATION"] else [])


def generator_spec(q: Dict) -> List[Tuple]:
    g = q["GENERATOR"]
    nf, res = g["NF"], g["RES_CHANNELS"]
    spec = [("conv", g["IN_CHANNELS"], nf, 3, 1, 1)] + [("resblock", nf, res)] * g["N_LAYERS"]
    spec += [("relu",), ("convT", nf, nf // 2, 4, 2, 1), ("relu",),
             ("convT", nf // 2, g["OUT_CHANNELS"], 4, 2, 1)]
    return spec + ([(g["OUT_ACTIVATION"],)] if g["OUT_ACTIVATION"] else [])


def _xavier(k, cin, cout, transposed=False):
    fan_in, fan_out = (cout * k * k, cin * k * k) if transposed else (cin * k * k, cout * k * k)
    return ("uniform", math.sqrt(6.0 / (fan_in + fan_out)))


def _net_specs(name, spec) -> List[Tuple]:
    out = []
    for i, layer in enumerate(spec):
        if layer[0] in ("conv", "convT"):
            _, cin, cout, k, _, _ = layer
            shape = (k, k, cout, cin) if layer[0] == "convT" else (k, k, cin, cout)
            out.append((("params", name, i, "w"), shape, _xavier(k, cin, cout, layer[0] == "convT")))
            out.append((("params", name, i, "b"), (cout,), ("uniform", BIAS_RANGE)))
        elif layer[0] == "resblock":
            _, dim, res = layer
            out += [(("params", name, i, "w1"), (3, 3, dim, res), _xavier(3, dim, res)),
                    (("params", name, i, "w2"), (1, 1, res, dim), _xavier(1, res, dim)),
                    (("params", name, i, "b1"), (res,), ("uniform", BIAS_RANGE)),
                    (("params", name, i, "b2"), (dim,), ("uniform", BIAS_RANGE))]
    return out


def param_specs(q: Dict) -> List[Tuple]:
    """[(path, shape, init)] of the (params, state) pair: ("params", "netE"
    | "netG", layer, leaf) and ("state", "netC", "embedding")."""
    check_supported(q)
    cb = q["CODEBOOK"]
    num, K = cb["NUM"], cb["SIZE"]
    return (_net_specs("netE", encoder_spec(q)) + _net_specs("netG", generator_spec(q))
            + [(("state", "netC", "embedding"), (num, K, cb["DIM"] // num), ("uniform", 1.0 / K))])


def _apply(spec, params, x, prec: Precision):
    for layer, p in zip(spec, params):
        kind = layer[0]
        if kind == "conv":
            x = conv2d(x, p["w"], p["b"], layer[4], layer[5], prec)
        elif kind == "convT":
            x = conv_transpose2d(x, p["w"], p["b"], layer[4], layer[5], prec)
        elif kind == "resblock":
            r = torch.relu(x)
            y = torch.relu(conv2d(r, p["w1"], p["b1"], 1, 1, prec))
            x = r + conv2d(y, p["w2"], p["b2"], 1, 0, prec)
        elif kind == "relu":
            x = torch.relu(x)
        elif kind == "tanh":
            x = torch.tanh(x)
        elif kind == "sigmoid":
            x = torch.sigmoid(x)
        else:
            raise ValueError(f"the reference has no layer {kind!r}")
    return x


def conv2d(x, w, b, stride, pad, prec: Precision = FP32):
    out = F.conv2d(prec.q(x).permute(0, 3, 1, 2), prec.q(w).permute(3, 2, 0, 1),
                   stride=stride, padding=pad)
    return out.permute(0, 2, 3, 1) + b.float()


def conv_transpose2d(x, w, b, stride, pad, prec: Precision = FP32):
    out = F.conv_transpose2d(prec.q(x).permute(0, 3, 1, 2), prec.q(w).permute(3, 2, 0, 1),
                             stride=stride, padding=pad)
    return out.permute(0, 2, 3, 1) + b.float()


def features(q: Dict, params, frames, prec: Precision = FP32):
    """frames (n, H, W, C) in [0, 255] -> the encoder's features (n, h, w, D)."""
    x = frames.float()
    if q["SCALE_TO_ZEROONE"]:
        x = x / 255.0
    mean = torch.tensor(q["PIXEL_MEAN"], device=x.device)
    std = torch.tensor(q["PIXEL_STD"], device=x.device)
    return _apply(encoder_spec(q), params["netE"], (x - mean) / std, prec)


def scores(z, embedding, prec: Precision = FP32):
    """||c_k||^2 - 2 z.c_k of each feature row's sub-vectors against its
    sub-codebook, the squared distance less ||z||^2 (the same argmin):
    z (n, h, w, D), embedding (num, K, Dc) -> (n * h * w, num, K)."""
    num, K, Dc = embedding.shape
    zg = prec.q(z.reshape(-1, num, Dc))
    e = prec.q(embedding)
    return (e ** 2).sum(-1)[None] - 2.0 * torch.einsum("ngd,gkd->ngk", zg, e)


def encode(q: Dict, params, state, frames, prec: Precision = FP32):
    """frames (n, H, W, C) -> codes (n, h, w, num), the nearest code of each
    sub-vector, ties to the lower index."""
    z = features(q, params, frames, prec)
    return torch.argmin(scores(z, state["netC"]["embedding"], prec), dim=-1).reshape(
        z.shape[:-1] + (-1,))


def decode(q: Dict, params, state, codes, prec: Precision = FP32):
    """codes (n, h, w, num) -> frames (n, H, W, C) in [0, 255], as the port's
    generate() returns them: clip(denormalize(y) * 255, 0, 255) where
    SCALE_TO_ZEROONE, else clip(denormalize(y), 0, 255)."""
    emb = state["netC"]["embedding"].float()
    zq = torch.cat([emb[g][codes[..., g].long()] for g in range(emb.shape[0])], dim=-1)
    y = _apply(generator_spec(q), params["netG"], zq, prec)
    mean = torch.tensor(q["PIXEL_MEAN"], device=y.device)
    std = torch.tensor(q["PIXEL_STD"], device=y.device)
    factor = 255.0 if q["SCALE_TO_ZEROONE"] else 1.0
    return ((y * std + mean) * factor).clamp(0.0, 255.0)
