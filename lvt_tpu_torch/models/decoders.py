"""Decoder ("generator") architectures (counterpart of
lvt_tpu/models/decoders.py): ResDecoder only, the PR-DVQVAE2 decoder."""

from typing import List, Tuple

from ..utils.registry import Registry
from .encoders import SeqNet
from .layers2d import out_activation_spec

GENERATOR_REGISTRY = Registry("GENERATOR")


def _res_decoder_spec(in_channels, nf, res_channels, out_channels,
                      n_layers, out_activation, stride) -> List[Tuple]:
    """3x3 conv, ResBlocks, ReLU, then transposed-conv upsampling (x4 = two
    4x4/s2, x2 = one)."""
    spec: List[Tuple] = [("conv", in_channels, nf, 3, 1, 1)]
    for _ in range(n_layers):
        spec.append(("resblock", nf, res_channels))
    spec.append(("relu",))
    if stride == 4:
        spec += [("convT", nf, nf // 2, 4, 2, 1), ("relu",)]
        spec += [("convT", nf // 2, out_channels, 4, 2, 1)]
    elif stride == 2:
        spec += [("convT", nf, out_channels, 4, 2, 1)]
    else:
        raise ValueError(f"ResDecoder stride must be 2 or 4, got {stride}")
    spec += out_activation_spec(out_activation)
    return spec


@GENERATOR_REGISTRY.register()
def ResDecoder(cfg, **kwargs) -> SeqNet:
    g = cfg.MODEL.GENERATOR
    spec = _res_decoder_spec(
        g.IN_CHANNELS, g.NF, g.RES_CHANNELS, g.OUT_CHANNELS, g.N_LAYERS,
        kwargs.get("out_activation", g.OUT_ACTIVATION), kwargs.get("stride", 4),
    )
    return SeqNet(tuple(spec), g.NORM, g.SPECTRAL, cfg.MODEL.INIT_TYPE)


def build_generator(cfg, **kwargs):
    return GENERATOR_REGISTRY.get(cfg.MODEL.GENERATOR.NAME)(cfg, **kwargs)
