"""Encoder architectures as descriptor lists (counterpart of
lvt_tpu/models/encoders.py): ResEncoder only, the PR-DVQVAE2 encoder."""

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

    def apply(self, params, state, x):
        return apply_seq(list(self.spec), params, state, x, norm=self.norm,
                         use_spectral=self.use_spectral)


@ENCODER_REGISTRY.register()
def ResEncoder(cfg, **kwargs) -> SeqNet:
    """VQ-VAE2-style strided encoder: stride-4 = two 4x4/s2 convs + 3x3, or
    stride-2 = one 4x4/s2 + 3x3, then N ResBlocks and an optional output
    activation."""
    e = cfg.MODEL.ENCODER
    in_channels = kwargs.get("in_channels", e.IN_CHANNELS)
    stride = kwargs.get("stride", 4)
    nf, res = e.NF, e.RES_CHANNELS
    spec: List[Tuple] = []
    if stride == 4:
        spec += [("conv", in_channels, nf // 2, 4, 2, 1), ("relu",)]
        spec += [("conv", nf // 2, nf, 4, 2, 1), ("relu",)]
        spec += [("conv", nf, nf, 3, 1, 1)]
    elif stride == 2:
        spec += [("conv", in_channels, nf // 2, 4, 2, 1), ("relu",)]
        spec += [("conv", nf // 2, nf, 3, 1, 1)]
    else:
        raise ValueError(f"ResEncoder stride must be 2 or 4, got {stride}")
    for _ in range(e.N_LAYERS):
        spec.append(("resblock", nf, res))
    spec += out_activation_spec(e.OUT_ACTIVATION)
    return SeqNet(tuple(spec), e.NORM, e.SPECTRAL, cfg.MODEL.INIT_TYPE)


def build_encoder(cfg, **kwargs):
    return ENCODER_REGISTRY.get(cfg.MODEL.ENCODER.NAME)(cfg, **kwargs)
