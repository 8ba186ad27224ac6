"""Encoder architectures as descriptor-list builders (counterpart of
lvt_tpu/models/encoders.py; reference vidgen/modeling/encoder/).

Each entry returns a ``SeqNet`` bundling the static spec with its norm /
spectral settings; params come from ``SeqNet.init``.
"""

from typing import List, NamedTuple, Tuple

import torch

from ..utils.registry import Registry
from .layers2d import apply_seq, init_seq, out_activation_spec

ENCODER_REGISTRY = Registry("ENCODER")


class SeqNet(NamedTuple):
    spec: Tuple[Tuple, ...]
    norm: str
    use_spectral: bool
    init_type: str

    def init(self, gen: torch.Generator):
        return init_seq(gen, list(self.spec), self.init_type, self.norm, self.use_spectral)

    def apply(self, params, state, x, *, train=False):
        """(y, new_state) of the net on NHWC x."""
        return apply_seq(list(self.spec), params, state, x, norm=self.norm,
                         use_spectral=self.use_spectral, train=train)


def _maybe_norm(norm: str) -> List[Tuple]:
    return [("norm",)] if norm != "" else []


@ENCODER_REGISTRY.register()
def ResEncoder(cfg, **kwargs) -> SeqNet:
    """VQ-VAE2-style strided encoder: stride-4 = two 4x4/s2 convs + 3x3, or
    stride-2 = one 4x4/s2 + 3x3, then N ResBlocks and an optional output
    activation."""
    e = cfg.MODEL.ENCODER
    in_channels = kwargs.get("in_channels", e.IN_CHANNELS)
    stride = kwargs.get("stride", 4)
    nf, res, norm = e.NF, e.RES_CHANNELS, e.NORM
    spec: List[Tuple] = []
    if stride == 4:
        spec += [("conv", in_channels, nf // 2, 4, 2, 1)] + _maybe_norm(norm) + [("relu",)]
        spec += [("conv", nf // 2, nf, 4, 2, 1)] + _maybe_norm(norm) + [("relu",)]
        spec += [("conv", nf, nf, 3, 1, 1)] + _maybe_norm(norm)
    elif stride == 2:
        spec += [("conv", in_channels, nf // 2, 4, 2, 1)] + _maybe_norm(norm) + [("relu",)]
        spec += [("conv", nf // 2, nf, 3, 1, 1)] + _maybe_norm(norm)
    else:
        raise ValueError(f"ResEncoder stride must be 2 or 4, got {stride}")
    for _ in range(e.N_LAYERS):
        spec.append(("resblock", nf, res))
    spec += out_activation_spec(e.OUT_ACTIVATION)
    return SeqNet(tuple(spec), norm, e.SPECTRAL, cfg.MODEL.INIT_TYPE)


@ENCODER_REGISTRY.register()
def ConvEncoder(cfg, **kwargs) -> SeqNet:
    """Plain conv stack with AvgPool downsampling (reference
    convencoder.py:28-68)."""
    e = cfg.MODEL.ENCODER
    nf, norm = e.NF, e.NORM
    spec: List[Tuple] = [("conv", e.IN_CHANNELS, nf, 3, 1, 1)] + _maybe_norm(norm) + [("lrelu", 0.2)]
    kp = nf
    for i in range(e.N_LAYERS):
        k = nf << i
        spec += [("conv", kp, k, 3, 1, 1)] + _maybe_norm(norm) + [("lrelu", 0.2)]
        spec += [("conv", k, k, 3, 1, 1)] + _maybe_norm(norm) + [("lrelu", 0.2)]
        spec += [("avgpool", 2)]
        kp = k
    k = nf << e.N_LAYERS
    spec += [("conv", kp, k, 3, 1, 1)] + _maybe_norm(norm) + [("lrelu", 0.2)]
    spec += [("conv", k, e.OUT_CHANNELS, 3, 1, 1)] + _maybe_norm(norm)
    spec += out_activation_spec(e.OUT_ACTIVATION)
    return SeqNet(tuple(spec), norm, e.SPECTRAL, cfg.MODEL.INIT_TYPE)


class VQVAE2EncoderNet(NamedTuple):
    """Two-level hierarchical encoder (reference resencoder.py:79-119):
    bottom stride-4 + top stride-2 branches plus 1x1 quantize convs and a
    top decoder, exposed as named sub-nets with a mode-switch apply."""

    enc_b: SeqNet
    enc_t: SeqNet
    quantize_conv_t: SeqNet
    dec_t: SeqNet
    quantize_conv_b: SeqNet

    def init(self, gen: torch.Generator):
        params, state = {}, {}
        for name in self._fields:
            params[name], state[name] = getattr(self, name).init(gen)
        return params, state

    def apply(self, params, state, x, mode, *, train=False):
        net = getattr(self, mode)
        y, ns = net.apply(params[mode], state[mode], x, train=train)
        return y, dict(state, **{mode: ns})


@ENCODER_REGISTRY.register()
def VQVAE2Encoder(cfg, **kwargs) -> VQVAE2EncoderNet:
    from .decoders import _res_decoder_spec

    e = cfg.MODEL.ENCODER
    embed_dim = cfg.MODEL.CODEBOOK.DIM
    norm, spectral, init_t = e.NORM, e.SPECTRAL, cfg.MODEL.INIT_TYPE
    mk = lambda spec: SeqNet(tuple(spec), norm, spectral, init_t)

    enc_b = ResEncoder(cfg, in_channels=e.IN_CHANNELS, stride=4)
    enc_t = ResEncoder(cfg, in_channels=e.NF, stride=2)
    q_t = mk([("conv", e.NF, embed_dim, 1, 1, 0)] + _maybe_norm(norm))
    dec_t = mk(_res_decoder_spec(embed_dim, e.NF, e.RES_CHANNELS, embed_dim,
                                 norm, e.N_LAYERS, "", stride=2))
    q_b = mk([("conv", embed_dim + e.NF, embed_dim, 1, 1, 0)] + _maybe_norm(norm))
    return VQVAE2EncoderNet(enc_b, enc_t, q_t, dec_t, q_b)


def build_encoder(cfg, **kwargs):
    return ENCODER_REGISTRY.get(cfg.MODEL.ENCODER.NAME)(cfg, **kwargs)
