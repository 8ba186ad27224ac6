"""Auto-encoder and VQ-VAE meta-architectures, functional form (counterpart
of lvt_tpu/models/vqvae.py; reference vidgen/modeling/meta_arch/ae.py,
vqvae.py).

Params and state keep the JAX package's three subtrees: ``netE`` (encoder),
``netG`` (generator/decoder), ``netC`` (codebook). An EMA codebook is state,
not params: a dict with the fields of ``EmaCodebookState``, replaced by the
quantizer's new one each train step. A non-EMA codebook keeps its embedding
in ``params["netC"]`` and trains it with the codebook MSE term
(``loss_dict``); its state keeps the running buffers and an empty
``embedding``. Frames are NHWC; indices (b, h, w, num).

Under tensor parallelism (``parallel.mesh.tensor_parallel``) the codebook is
the rank's part of it, split over its K codes (``ops/vq.py``); the encoder
and the generator are replicated. With frames split by rows
(``parallel.mesh.spatial_parallel``) x is this rank's band of rows: the
convolutions exchange halos, and each loss term is the whole frames' mean
(``parallel.spatial.row_mean``), whose backward gives each rank its band's
share. ``visualize_training`` and ``reconstruct`` take whole frames (the
trainer gathers the rows first).
"""

from typing import Any, Dict, Tuple

import torch

from ..ops import vq as vq_ops
from ..parallel.mesh import spatial_group
from ..parallel.spatial import row_mean
from . import to_device
from .decoders import build_generator
from .encoders import build_encoder
from .loss import pixel_loss_core


def _frames(batch):
    """The NHWC frames of a batch: {"image": (b, H, W, C)} or
    {"image_sequence": (b, t, H, W, C)} flattened over (b, t)."""
    if "image_sequence" in batch:
        x = batch["image_sequence"]
        return x.reshape((-1,) + tuple(x.shape[2:]))
    return batch["image"]


class _PixelNorm:
    """(x - mean) / std with MODEL.PIXEL_MEAN / PIXEL_STD, on x's device."""

    def __init__(self, cfg):
        self.pixel_mean = torch.tensor(cfg.MODEL.PIXEL_MEAN, dtype=torch.float32)
        self.pixel_std = torch.tensor(cfg.MODEL.PIXEL_STD, dtype=torch.float32)

    def normalize(self, x):
        """(x - mean) / std on NHWC frames."""
        return (x - self.pixel_mean.to(x.device)) / self.pixel_std.to(x.device)

    def denormalize(self, y):
        return y * self.pixel_std.to(y.device) + self.pixel_mean.to(y.device)


class VQVAE(_PixelNorm):
    """Two-stage-ready VQ-VAE (meta_arch VQVAEModel, vqvae.py:17-124)."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.cfg = cfg
        cb = cfg.MODEL.CODEBOOK
        self.num, self.K, self.D = cb.NUM, cb.SIZE, cb.DIM
        self.ema, self.beta = cb.EMA, cb.BETA
        self.encoder = build_encoder(cfg)
        self.generator = build_generator(cfg)
        assert cfg.LOSS.PIXEL.MODE in ("l1", "l2")
        self.pixel_loss_mode = cfg.LOSS.PIXEL.MODE
        self.pixel_loss_lambda = cfg.LOSS.PIXEL.LAMBDA

    # -- init ---------------------------------------------------------------
    def init(self, gen: torch.Generator, device="cpu") -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """Random weights from ``gen``; the codebook as ``init_codebook``."""
        pe, se = self.encoder.init(gen)
        pg, sg = self.generator.init(gen)
        cb = vq_ops.init_codebook(gen, self.num, self.K, self.D)
        if self.ema:
            params = {"netE": pe, "netG": pg, "netC": {}}
            state = {"netE": se, "netG": sg, "netC": cb}
        else:
            params = {"netE": pe, "netG": pg, "netC": {"embedding": cb["embedding"]}}
            state = {"netE": se, "netG": sg, "netC": dict(cb, embedding=torch.zeros(0))}
        return to_device(params, device), to_device(state, device)

    def _codebook_state(self, params, state) -> vq_ops.Codebook:
        if self.ema:
            return state["netC"]
        return dict(state["netC"], embedding=params["netC"]["embedding"])

    # -- core passes ---------------------------------------------------------
    def encode_features(self, params, state, x, *, train=False):
        """NHWC frames -> ((b, h, w, D) pre-quantization features, new
        encoder state)."""
        return self.encoder.apply(params["netE"], state["netE"], x, train=train)

    def decode_features(self, params, state, z, *, train=False):
        return self.generator.apply(params["netG"], state["netG"], z, train=train)

    def encode(self, params, state, x):
        """NHWC frames -> (b, h, w, num) int32 code indices."""
        z_e, _ = self.encode_features(params, state, x)
        return vq_ops.encode_indices(z_e, self._codebook_state(params, state), K=self.K)

    def decode(self, params, state, indices):
        """(b, h, w, num) indices -> NHWC frames."""
        z_q = vq_ops.embed_indices(indices, self._codebook_state(params, state), K=self.K)
        return self.decode_features(params, state, z_q)[0]

    def reconstruct(self, params, state, x):
        """frames -> (reconstruction, indices): the eval/inference pass."""
        z_e, _ = self.encode_features(params, state, x)
        cb = self._codebook_state(params, state)
        idx = vq_ops.encode_indices(z_e, cb, K=self.K)
        y, _ = self.decode_features(params, state, vq_ops.embed_indices(idx, cb, K=self.K))
        return y, idx

    def loss(self, params, state, x, *, train=True, use_kernel=None):
        """Supervised VQ-VAE loss (reference compute_supervised_loss,
        vqvae.py:66-91). x: NHWC normalized frames. Returns (total_loss,
        (loss_dict, new_state)); the loss terms are computed in fp32."""
        z_e, se = self.encode_features(params, state, x, train=train)
        cb = self._codebook_state(params, state)
        z_q_st, z_q, _, new_cb = vq_ops.quantize_st(z_e, cb, ema=self.ema, train=train,
                                                    use_kernel=use_kernel, K=self.K)
        x_tilde, sg = self.decode_features(params, state, z_q_st, train=train)

        loss_dict = {"loss_reconstruction": pixel_loss_core(
            self.pixel_loss_mode, self.pixel_loss_lambda, x_tilde, x)}
        if not self.ema:
            loss_dict["loss_dict"] = ((z_q.float() - z_e.detach().float()) ** 2).mean()
        loss_dict["loss_commitment"] = self.beta * (
            (z_e.float() - z_q.detach().float()) ** 2).mean()
        rows = spatial_group()
        loss_dict = {k: row_mean(v, rows) for k, v in loss_dict.items()}

        new_state = {"netE": se, "netG": sg, "netC": new_cb if self.ema else state["netC"]}
        return sum(loss_dict.values()), (loss_dict, new_state)

    def visualize_training(self, params, state, batch):
        """Reconstruction grids for TensorBoard (reference
        visualize_training, ae.py:86-99): first 3 frames, tiled, CHW uint8."""
        from ..utils.image import array2im

        x = batch.get("image")
        if x is None:
            x = batch["image_sequence"][0]
        with torch.no_grad():
            recon, _ = self.reconstruct(params, state, self.normalize(x[:3]))
        img = array2im(
            recon.permute(0, 3, 1, 2).float().cpu().numpy(),
            normalize=self.cfg.MODEL.GENERATOR.OUT_ACTIVATION == "tanh", tile=True)
        if img.ndim == 2:
            img = img[:, :, None]
        return {"reconstruction": img.transpose(2, 0, 1)}

    def train_loss(self, params, model_state, batch, gen=None):
        """The trainer's interface. batch: {"image": (b, H, W, C)} or
        {"image_sequence": (b, t, H, W, C)} raw frames (already /255 when
        INPUT.SCALE_TO_ZEROONE), normalized here on the device. ``gen`` is
        unused: the VQ-VAE's step draws nothing."""
        return self.loss(params, model_state, self.normalize(_frames(batch)), train=True)


class AutoEncoder(_PixelNorm):
    """Plain AE meta-arch (reference AutoEncoderModel, ae.py:21-244)."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.cfg = cfg
        self.encoder = build_encoder(cfg)
        self.generator = build_generator(cfg)

    def init(self, gen: torch.Generator, device="cpu"):
        pe, se = self.encoder.init(gen)
        pg, sg = self.generator.init(gen)
        return (to_device({"netE": pe, "netG": pg}, device),
                to_device({"netE": se, "netG": sg}, device))

    def encode(self, params, state, x, *, train=False):
        return self.encoder.apply(params["netE"], state["netE"], x, train=train)

    def decode(self, params, state, z, *, train=False):
        return self.generator.apply(params["netG"], state["netG"], z, train=train)

    def reconstruct(self, params, state, x):
        z, _ = self.encode(params, state, x)
        y, _ = self.decode(params, state, z)
        return y, z

    def interpolate_first_last(self, params, state, x):
        """Latent lerp between the first and last frame of a batch
        (reference ae.py:207-218)."""
        b = x.shape[0]
        start, _ = self.encode(params, state, x[:1])
        end, _ = self.encode(params, state, x[-1:])
        alphas = torch.linspace(0.0, 1.0, b, device=x.device).reshape(b, 1, 1, 1)
        y, _ = self.decode(params, state, start + alphas * (end - start))
        return y

    def loss(self, params, state, x, *, train=True, **_):
        """MSE autoencoding loss (reference compute_generator_loss,
        ae.py:170-181)."""
        z, se = self.encode(params, state, x, train=train)
        out, sg = self.decode(params, state, z, train=train)
        loss = row_mean(((out - x) ** 2).mean(), spatial_group())
        return loss, ({"loss_ae_mse": loss}, {"netE": se, "netG": sg})

    def train_loss(self, params, model_state, batch, gen=None):
        return self.loss(params, model_state, self.normalize(_frames(batch)), train=True)
