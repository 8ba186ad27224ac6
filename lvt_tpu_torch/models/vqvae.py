"""VQ-VAE meta-architecture, inference (counterpart of lvt_tpu/models/vqvae.py
VQVAE.normalize/denormalize/encode/decode).

Params and state keep the JAX package's three subtrees: ``netE`` (encoder),
``netG`` (generator/decoder), ``netC`` (codebook). The EMA codebook is
state, a dict with the fields of ``EmaCodebookState``. Frames are NHWC;
indices (b, h, w, num).
"""

from typing import Any, Dict, Tuple

import torch

from ..ops import vq as vq_ops
from . import to_device
from .decoders import build_generator
from .encoders import build_encoder


class VQVAE:
    def __init__(self, cfg):
        self.cfg = cfg
        cb = cfg.MODEL.CODEBOOK
        if not cb.EMA:
            raise NotImplementedError("only EMA codebooks are ported to lvt_tpu_torch yet")
        self.num, self.K, self.D = cb.NUM, cb.SIZE, cb.DIM
        self.encoder = build_encoder(cfg)
        self.generator = build_generator(cfg)
        self.pixel_mean = torch.tensor(cfg.MODEL.PIXEL_MEAN, dtype=torch.float32)
        self.pixel_std = torch.tensor(cfg.MODEL.PIXEL_STD, dtype=torch.float32)

    def init(self, gen: torch.Generator, device="cpu") -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """Random weights from ``gen``; the codebook Uniform(-1/K, 1/K) with
        running_sum a copy of it and running_size zero, as the reference."""
        pe, se = self.encoder.init(gen)
        pg, sg = self.generator.init(gen)
        Dc = self.D // self.num
        emb = torch.empty(self.num, self.K, Dc).uniform_(-1.0 / self.K, 1.0 / self.K,
                                                         generator=gen)
        cb = {"embedding": emb, "running_size": torch.zeros(self.num, self.K),
              "running_sum": emb.clone()}
        params = {"netE": pe, "netG": pg, "netC": {}}
        state = {"netE": se, "netG": sg, "netC": cb}
        return to_device(params, device), to_device(state, device)

    def normalize(self, x):
        """(x - mean) / std on NHWC frames."""
        return (x - self.pixel_mean.to(x.device)) / self.pixel_std.to(x.device)

    def denormalize(self, y):
        return y * self.pixel_std.to(y.device) + self.pixel_mean.to(y.device)

    def encode(self, params, state, x):
        """NHWC frames -> (b, h, w, num) int32 code indices."""
        z_e = self.encoder.apply(params["netE"], state["netE"], x)
        return vq_ops.encode_indices(z_e, state["netC"])

    def decode(self, params, state, indices):
        """(b, h, w, num) indices -> NHWC frames."""
        z_q = vq_ops.embed_indices(indices, state["netC"])
        return self.generator.apply(params["netG"], state["netG"], z_q)

