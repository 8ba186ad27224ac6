"""Decoder ("generator") architectures (counterpart of
lvt_tpu/models/decoders.py; reference vidgen/modeling/generator/)."""

from typing import List, NamedTuple, Tuple

import torch

from ..utils.registry import Registry
from .encoders import SeqNet, _maybe_norm
from .layers2d import out_activation_spec

GENERATOR_REGISTRY = Registry("GENERATOR")


def _res_decoder_spec(in_channels, nf, res_channels, out_channels, norm,
                      n_layers, out_activation, stride) -> List[Tuple]:
    """3x3 conv, ResBlocks, ReLU, then transposed-conv upsampling (x4 = two
    4x4/s2, x2 = one)."""
    spec: List[Tuple] = [("conv", in_channels, nf, 3, 1, 1)] + _maybe_norm(norm)
    for _ in range(n_layers):
        spec.append(("resblock", nf, res_channels))
    spec.append(("relu",))
    if stride == 4:
        spec += [("convT", nf, nf // 2, 4, 2, 1)] + _maybe_norm(norm) + [("relu",)]
        spec += [("convT", nf // 2, out_channels, 4, 2, 1)]
    elif stride == 2:
        spec += [("convT", nf, out_channels, 4, 2, 1)] + _maybe_norm(norm)
    else:
        raise ValueError(f"ResDecoder stride must be 2 or 4, got {stride}")
    spec += out_activation_spec(out_activation)
    return spec


@GENERATOR_REGISTRY.register()
def ResDecoder(cfg, **kwargs) -> SeqNet:
    g = cfg.MODEL.GENERATOR
    spec = _res_decoder_spec(
        g.IN_CHANNELS, g.NF, g.RES_CHANNELS, g.OUT_CHANNELS, g.NORM, g.N_LAYERS,
        kwargs.get("out_activation", g.OUT_ACTIVATION), kwargs.get("stride", 4),
    )
    return SeqNet(tuple(spec), g.NORM, g.SPECTRAL, cfg.MODEL.INIT_TYPE)


@GENERATOR_REGISTRY.register()
def ResShuffleDecoder(cfg, **kwargs) -> SeqNet:
    """PixelShuffle upsampling variant (reference resdecoder.py:78-129)."""
    g = cfg.MODEL.GENERATOR
    nf, norm = g.NF, g.NORM
    spec: List[Tuple] = [("conv", g.IN_CHANNELS, nf, 3, 1, 1)] + _maybe_norm(norm)
    for _ in range(g.N_LAYERS):
        spec.append(("resblock", nf, g.RES_CHANNELS))
    spec.append(("relu",))
    stride = kwargs.get("stride", 4)
    if stride == 4:
        spec += [("conv", nf, nf // 2 * 4, 3, 1, 1)] + _maybe_norm(norm)
        spec += [("pixelshuffle", 2), ("relu",)]
        spec += [("conv", nf // 2, g.OUT_CHANNELS * 4, 3, 1, 1), ("pixelshuffle", 2)]
    elif stride == 2:
        spec += [("conv", nf, g.OUT_CHANNELS * 4, 3, 1, 1)] + _maybe_norm(norm)
        spec += [("pixelshuffle", 2)]
    else:
        raise ValueError(f"ResShuffleDecoder supports stride 2 or 4, got {stride}")
    spec += out_activation_spec(kwargs.get("out_activation", g.OUT_ACTIVATION))
    return SeqNet(tuple(spec), norm, g.SPECTRAL, cfg.MODEL.INIT_TYPE)


@GENERATOR_REGISTRY.register()
def ConvDecoder(cfg, **kwargs) -> SeqNet:
    """Upsample-conv decoder (reference convdecoder.py:25-57). The
    reference's final two convs both read ``kp`` channels, which only
    type-checks when nf == kp; they are wired in sequence (kp -> nf -> out),
    as in the JAX package."""
    g = cfg.MODEL.GENERATOR
    nf, norm = g.NF, g.NORM
    spec: List[Tuple] = []
    kp = g.IN_CHANNELS
    for scale in range(g.N_LAYERS - 1, -1, -1):
        k = nf << scale
        spec += [("conv", kp, k, 3, 1, 1)] + _maybe_norm(norm) + [("lrelu", 0.2)]
        spec += [("conv", k, k, 3, 1, 1)] + _maybe_norm(norm) + [("lrelu", 0.2)]
        spec += [("upsample", 2)]
        kp = k
    spec += [("conv", kp, nf, 3, 1, 1), ("conv", nf, g.OUT_CHANNELS, 3, 1, 1)]
    spec += out_activation_spec(g.OUT_ACTIVATION)
    return SeqNet(tuple(spec), norm, g.SPECTRAL, cfg.MODEL.INIT_TYPE)


class VQVAE2DecoderNet(NamedTuple):
    """Two-level decoder (reference resdecoder.py:132-158): upsample the top
    quant, concat with bottom quant, run a stride-4 ResDecoder."""

    upsample_t: SeqNet
    dec: SeqNet

    def init(self, gen: torch.Generator):
        params, state = {}, {}
        params["upsample_t"], state["upsample_t"] = self.upsample_t.init(gen)
        params["dec"], state["dec"] = self.dec.init(gen)
        return params, state

    def apply(self, params, state, quant_t, quant_b, *, train=False):
        up, ns_u = self.upsample_t.apply(params["upsample_t"], state["upsample_t"],
                                         quant_t, train=train)
        x = torch.cat([up, quant_b], dim=-1)
        y, ns_d = self.dec.apply(params["dec"], state["dec"], x, train=train)
        return y, {"upsample_t": ns_u, "dec": ns_d}


@GENERATOR_REGISTRY.register()
def VQVAE2Decoder(cfg, **kwargs) -> VQVAE2DecoderNet:
    g = cfg.MODEL.GENERATOR
    embed_dim = cfg.MODEL.CODEBOOK.DIM
    mk = lambda spec: SeqNet(tuple(spec), g.NORM, g.SPECTRAL, cfg.MODEL.INIT_TYPE)
    upsample_t = mk([("convT", embed_dim, embed_dim, 4, 2, 1)] + _maybe_norm(g.NORM))
    dec = mk(_res_decoder_spec(embed_dim + embed_dim, g.NF, g.RES_CHANNELS,
                               g.OUT_CHANNELS, g.NORM, g.N_LAYERS,
                               g.OUT_ACTIVATION, stride=4))
    return VQVAE2DecoderNet(upsample_t, dec)


def build_generator(cfg, **kwargs):
    return GENERATOR_REGISTRY.get(cfg.MODEL.GENERATOR.NAME)(cfg, **kwargs)
