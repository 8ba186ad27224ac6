"""UNet over latent code indices (counterpart of lvt_tpu/models/unet.py;
reference vidgen/modeling/encoder/unet.py).

Embedding(512, 256) of code indices -> a 4-level UNet (DoubleConv with batch
norm, 2x2 max-pool down, bilinear upsampling with align_corners=True up,
each followed by a centered pad to the skip's size and a concat) -> 1x1 conv
-> sigmoid. NHWC throughout. As in lvt_tpu, ``models/__init__.py`` does not
import this module: ``UNet`` registers on ``import
lvt_tpu_torch.models.unet``; no shipped config names it.
"""

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.conv import conv2d
from .encoders import ENCODER_REGISTRY
from .norms import apply_norm, init_norm


def _kaiming(gen: torch.Generator, k: int, cin: int, cout: int):
    """torch.nn.Conv2d's default init (kaiming_uniform_ with a = sqrt(5)):
    weight and bias uniform in +-1/sqrt(fan_in); w (k, k, cin, cout)."""
    bound = float(np.sqrt(1.0 / (cin * k * k)))
    w = torch.empty(k, k, cin, cout).uniform_(-bound, bound, generator=gen)
    b = torch.empty(cout).uniform_(-bound, bound, generator=gen)
    return w, b


def _init_double_conv(gen: torch.Generator, cin: int, cmid: int, cout: int):
    w1, b1 = _kaiming(gen, 3, cin, cmid)
    w2, b2 = _kaiming(gen, 3, cmid, cout)
    n1p, n1s = init_norm("BN", cmid)
    n2p, n2s = init_norm("BN", cout)
    return ({"w1": w1, "b1": b1, "w2": w2, "b2": b2, "n1": n1p, "n2": n2p},
            {"n1": n1s, "n2": n2s})


def _apply_double_conv(p, s, x, train):
    x = conv2d(x, p["w1"], p["b1"], stride=1, padding=1)
    x, ns1 = apply_norm("BN", p["n1"], s["n1"], x, train)
    x = torch.relu(x)
    x = conv2d(x, p["w2"], p["b2"], stride=1, padding=1)
    x, ns2 = apply_norm("BN", p["n2"], s["n2"], x, train)
    return torch.relu(x), {"n1": ns1, "n2": ns2}


def _max_pool2(x):
    """2x2 max-pool, stride 2, VALID, on NHWC."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def _interp_matrix_ac(n_out: int, n_in: int) -> np.ndarray:
    """(n_out, n_in) align_corners=True linear-interpolation matrix: output i
    samples the input at i * (n_in - 1) / (n_out - 1)."""
    if n_in == 1 or n_out == 1:
        pos = np.zeros(n_out)
    else:
        pos = np.arange(n_out) * (n_in - 1) / (n_out - 1)
    i0 = np.floor(pos).astype(np.int64)
    i1 = np.minimum(i0 + 1, n_in - 1)
    f = (pos - i0).astype(np.float32)
    m = np.zeros((n_out, n_in), np.float32)
    m[np.arange(n_out), i0] += 1.0 - f
    m[np.arange(n_out), i1] += f
    return m


def _bilinear_up2(x):
    """scale_factor=2 bilinear with align_corners=True on NHWC, as
    lvt_tpu's two fixed interpolation matrices (fp32; a bf16 x is promoted
    as lvt_tpu's einsum promotes it)."""
    b, h, w, c = x.shape
    dt = torch.promote_types(x.dtype, torch.float32)
    my = torch.from_numpy(_interp_matrix_ac(2 * h, h)).to(x.device, dt)
    mx = torch.from_numpy(_interp_matrix_ac(2 * w, w)).to(x.device, dt)
    return torch.einsum("Hh,bhwc,Ww->bHWc", my, x.to(dt), mx)


class UNetNet:
    CHANNELS = [64, 128, 256, 512, 512]  # bilinear: down4 -> 1024 // 2

    def __init__(self, cfg, **kwargs):
        self.in_channels = 256  # embedding dim
        self.out_channels = cfg.MODEL.ENCODER.OUT_CHANNELS
        self.nv = 512

    def init(self, gen: torch.Generator):
        C = self.CHANNELS
        params: Dict[str, Any] = {"emb": torch.empty(self.nv, 256).normal_(generator=gen)}
        state: Dict[str, Any] = {}
        params["inc"], state["inc"] = _init_double_conv(gen, 256, C[0], C[0])
        for i, (ci, co) in enumerate(zip(C[:4], C[1:])):
            params[f"down{i+1}"], state[f"down{i+1}"] = _init_double_conv(gen, ci, co, co)
        # up blocks (bilinear): DoubleConv(in, out, mid=in // 2) on cat(skip, up(x))
        ups = [(1024, 256, 512), (512, 128, 256), (256, 64, 128), (128, 64, 64)]
        for i, (cin, cout, cmid) in enumerate(ups):
            params[f"up{i+1}"], state[f"up{i+1}"] = _init_double_conv(gen, cin, cmid, cout)
        wo, bo = _kaiming(gen, 1, 64, self.out_channels)
        params["outc"] = {"w": wo, "b": bo}
        return params, state

    def apply(self, params, state, codes, *, train=False):
        """codes: (b, h, w) int latent indices -> ((b, h, w, out) in (0, 1),
        the new batch-norm state)."""
        x = params["emb"][codes.long()]  # (b, h, w, 256)
        ns: Dict[str, Any] = {}
        x1, ns["inc"] = _apply_double_conv(params["inc"], state["inc"], x, train)
        feats = [x1]
        xk = x1
        for i in range(1, 5):
            xk, ns[f"down{i}"] = _apply_double_conv(params[f"down{i}"], state[f"down{i}"],
                                                    _max_pool2(xk), train)
            feats.append(xk)
        x = feats[4]
        for i, skip in enumerate([feats[3], feats[2], feats[1], feats[0]]):
            x = _bilinear_up2(x)
            # centered pad to the skip's spatial size (the reference's F.pad)
            dh, dw = skip.shape[1] - x.shape[1], skip.shape[2] - x.shape[2]
            if dh or dw:
                x = F.pad(x, (0, 0, dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
            x = torch.cat([skip, x], dim=-1)
            x, ns[f"up{i+1}"] = _apply_double_conv(params[f"up{i+1}"], state[f"up{i+1}"], x,
                                                   train)
        x = conv2d(x, params["outc"]["w"], params["outc"]["b"], stride=1, padding=0)
        return torch.sigmoid(x), ns


@ENCODER_REGISTRY.register()
def UNet(cfg, **kwargs) -> UNetNet:
    return UNetNet(cfg, **kwargs)
