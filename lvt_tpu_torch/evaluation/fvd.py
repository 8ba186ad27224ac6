"""Fréchet Video Distance (the paper's headline metric, arXiv:2006.10704)
behind the evaluator protocol (counterpart of lvt_tpu/evaluation/fvd.py; the
reference ships no FVD evaluator).

FVD = |mu_r - mu_g|^2 + tr(S_r + S_g - 2 (S_r^{1/2} S_g S_r^{1/2})^{1/2}),
computed over I3D logits of real vs generated RGB videos. The real side
uses actual frames when the dataset provides them ("image_sequence");
latent-only datasets fall back to VQ reconstructions of the ground-truth
codes (comparable across runs here, NOT against published tables — the
fallback shares the VQ-VAE's artifacts with the generated side). The
feature network is pluggable:

* ``TEST.FVD.I3D_WEIGHTS`` set -> the real I3D (evaluation/i3d.py) with
  converted Kinetics-400 weights (.npz, the file lvt_tpu reads).
* unset -> a fixed stub conv feature net, so the whole pipeline runs without
  the 300 MB checkpoint; the metric is then labeled ``FVD_stub`` to prevent
  accidental paper-number comparisons. Its two weights are lvt_tpu's own
  draws (``jax.random.key(0)``), committed beside this file as
  ``fvd_stub_weights.npz``: both packages report the same ``FVD_stub`` on the
  same videos.

The feature networks run on the card (or the CPU where asked) in fp32; the
Fréchet distance runs in float64 numpy on the host, as in lvt_tpu.
"""

import logging
import os
from collections import OrderedDict
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import comm
from .evaluator import DatasetEvaluator
from .i3d import same_pad

logger = logging.getLogger(__name__)

STUB_WEIGHTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fvd_stub_weights.npz")


# --------------------------------------------------------------------------
# Fréchet distance (host-side, numpy)
# --------------------------------------------------------------------------

def _sqrtm_psd(m: np.ndarray) -> np.ndarray:
    """Matrix square root of a symmetric PSD matrix via eigh (no scipy)."""
    vals, vecs = np.linalg.eigh(m)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def frechet_distance(mu1, sigma1, mu2, sigma2) -> float:
    """Fréchet distance between two Gaussians. The cross term uses the
    symmetric form tr((S1^{1/2} S2 S1^{1/2})^{1/2}) — numerically stable and
    equal to tr((S1 S2)^{1/2}) for PSD inputs."""
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    sigma1 = np.asarray(sigma1, np.float64)
    sigma2 = np.asarray(sigma2, np.float64)
    diff = mu1 - mu2
    s1_half = _sqrtm_psd(sigma1)
    cross = _sqrtm_psd(s1_half @ sigma2 @ s1_half)
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * np.trace(cross))


def gaussian_stats(feats: np.ndarray):
    """(n, d) features -> (mu, sigma)."""
    feats = np.asarray(feats, np.float64)
    mu = feats.mean(axis=0)
    sigma = np.cov(feats, rowvar=False)
    if sigma.ndim == 0:  # d == 1
        sigma = sigma.reshape(1, 1)
    return mu, sigma


def fvd_from_features(real: np.ndarray, fake: np.ndarray) -> float:
    mu_r, s_r = gaussian_stats(real)
    mu_f, s_f = gaussian_stats(fake)
    return frechet_distance(mu_r, s_r, mu_f, s_f)


# --------------------------------------------------------------------------
# Feature networks
# --------------------------------------------------------------------------

def resize_frames(x: torch.Tensor, size: int) -> torch.Tensor:
    """(b, T, H, W, C) -> (b, T, size, size, C), bilinear as
    ``jax.image.resize(..., "bilinear")``: half-pixel centres, the edge
    weights renormalized, and a triangle widened by the scale (antialiasing)
    where a side shrinks."""
    b, t, h, w, c = x.shape
    if (h, w) == (size, size):
        return x
    y = x.reshape(b * t, h, w, c).permute(0, 3, 1, 2)
    y = F.interpolate(y, size=(size, size), mode="bilinear", align_corners=False,
                      antialias=True)
    return y.permute(0, 2, 3, 1).reshape(b, t, size, size, c)


def _video_tensor(video, device) -> torch.Tensor:
    """(b, T, H, W, 3) frames in [0, 255] -> fp32 in [-1, 1] on ``device``."""
    x = torch.as_tensor(np.asarray(video, np.float32)).to(device)
    return x / 127.5 - 1.0


def make_i3d_features(weights_path: str, resize: int = 224, device="cuda") -> Callable:
    """The real thing: videos (b, T, H, W, 3) uint8/[0,255] -> (b, 400)."""
    from .i3d import i3d_apply, load_i3d_npz

    params = load_i3d_npz(weights_path, device)

    @torch.no_grad()
    def features(video):
        x = resize_frames(_video_tensor(video, device), resize)
        return i3d_apply(params, x).cpu().numpy()

    return features


def make_stub_features(device="cuda") -> Callable:
    """Fixed tiny conv3d feature net, (b, T, H, W, 3) in [0, 255] -> (b, 64):
    the identical pipeline (decode -> features -> Fréchet) without I3D
    weights, on lvt_tpu's stub weights (``STUB_WEIGHTS``, its
    ``make_stub_features()`` default: dim 64, seed 0). NOT comparable to
    published FVD numbers."""
    with np.load(STUB_WEIGHTS) as f:  # (t, h, w, in, out), as lvt_tpu draws them
        w1, w2 = (torch.from_numpy(f[k]).permute(4, 3, 0, 1, 2).contiguous().to(device)
                  for k in ("w1", "w2"))

    def conv_relu(x, w):
        stride = (1, 2, 2)
        return F.relu(F.conv3d(same_pad(x, w.shape[2:], stride), w, stride=stride))

    @torch.no_grad()
    def features(video):
        x = _video_tensor(video, device).permute(0, 4, 1, 2, 3)
        x = conv_relu(conv_relu(x, w1), w2)
        return x.mean(dim=(2, 3, 4)).cpu().numpy()  # (b, 64)

    return features


# --------------------------------------------------------------------------
# Evaluator
# --------------------------------------------------------------------------

class FVDEvaluator(DatasetEvaluator):
    """Consumes VT sampling outputs: decodes ground-truth and sampled latent
    codes through the paired VQ-VAE (like VTSampler, on ``device``) and
    accumulates feature vectors; evaluate() gathers across ranks and reports
    the Fréchet distance."""

    def __init__(self, cfg, dataset_name, distributed=True, output_dir=None,
                 feature_fn: Optional[Callable] = None, device="cuda"):
        from .vt_sampler import decode_codes_fn, load_paired_vqvae

        self._dataset_name = dataset_name
        self._distributed = distributed

        # memoized: shares the model and weights with a co-running VTSampler
        self.vqvae, self._vq_params, self._vq_state, vq_cfg, _ = load_paired_vqvae(
            cfg, device=device)
        self._scale01 = vq_cfg.INPUT.SCALE_TO_ZEROONE
        # the dataloader's frame scaling follows the VT cfg (the mapper
        # divides by 255 when INPUT.SCALE_TO_ZEROONE) — needed to bring the
        # real side back to the [0, 255] the feature net expects
        self._input_scale01 = cfg.INPUT.SCALE_TO_ZEROONE
        self._decode_shared = decode_codes_fn(
            self.vqvae, self._vq_params, self._vq_state, self._scale01)

        weights = cfg.TEST.FVD.I3D_WEIGHTS
        if feature_fn is not None:
            self._features = feature_fn
            self._metric = "FVD"
        elif weights:
            self._features = make_i3d_features(weights, cfg.TEST.FVD.RESIZE, device)
            self._metric = "FVD"
        else:
            logger.warning(
                "TEST.FVD.I3D_WEIGHTS not set: using the stub feature net. "
                "The reported value is pipeline-valid but NOT comparable to "
                "published FVD numbers.")
            self._features = make_stub_features(device)
            self._metric = "FVD_stub"
        self.reset()

    def reset(self):
        self._real: List[np.ndarray] = []
        self._fake: List[np.ndarray] = []

    def _codes_to_rgb(self, codes: np.ndarray) -> np.ndarray:
        """(nc, T, h, w) codes -> (T, H, W, 3) float frames in [0, 255]."""
        return self._decode_shared(np.transpose(codes, (1, 0, 2, 3)))

    def process(self, inputs, outputs):
        for inp, out in zip(inputs, outputs):
            if "samples" not in out:
                continue
            # real side: actual RGB frames when the dataset carries them;
            # latent-only datasets fall back to the VQ reconstruction of the
            # ground-truth codes, which shares the VQ-VAE's artifacts with
            # the generated side (comparable across runs of this framework,
            # NOT against published FVD tables)
            if "image_sequence" in inp:
                real = np.asarray(inp["image_sequence"], np.float32)
                if self._input_scale01:
                    # the mapper delivered [0, 1]-scaled frames; the feature
                    # net expects [0, 255] (the fake side is decoded to that
                    # range by decode_codes_fn)
                    real = real * 255.0
                real = np.clip(real, 0.0, 255.0)
            else:
                real = self._codes_to_rgb(np.asarray(inp["video"]))
            self._real.append(np.asarray(self._features(real[None]))[0])
            # one batched feature call over all samples of this output
            if len(out["samples"]):
                fakes = np.stack([self._codes_to_rgb(np.asarray(s))
                                  for s in out["samples"]])
                self._fake.extend(np.asarray(self._features(fakes)))

    def evaluate(self):
        real, fake = self._real, self._fake
        if self._distributed:
            comm.synchronize()
            real = [f for part in comm.gather(real) for f in part]
            fake = [f for part in comm.gather(fake) for f in part]
            if not comm.is_main_process():
                return None
        if len(real) < 2 or len(fake) < 2:
            logger.warning(f"FVD needs >=2 real and fake videos; got "
                           f"{len(real)}/{len(fake)}")
            return OrderedDict({"generation": {self._metric: float("nan")}})
        value = fvd_from_features(np.stack(real), np.stack(fake))
        return OrderedDict({"generation": {self._metric: value}})
