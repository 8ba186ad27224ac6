"""VTSampler: decode sampled code videos with the paired VQ-VAE and dump
codes + png frames (counterpart of lvt_tpu/evaluation/vt_sampler.py;
reference vidgen/evaluation/vt_sampler.py:18-89), and the weights of the
paired VQ-VAE and of the VT for sampling (also the VT branch of
scripts/generate_videos.py).

Output layout preserved:
<output_dir>/samples/<dataset>/video_<sample_idx>_<video_idx>/{codes.npy, <i>.png}

A configured path is one of:
- a reference ``.pth`` file (the paper's released weights, per sub-net:
  ``configs/vt/DSFVT.yaml`` names netE, netG and netC files for the VQ-VAE
  and one for the VT), converted by ``checkpoint/torch_convert.py``;
- a checkpoint file written by tools/train_net_torch.py;
- a training OUTPUT_DIR, whose latest checkpoint is read.

For the VQ-VAE, a checkpoint named by any of the three paths loads first and
each configured ``.pth`` is then grafted on top of it, sub-net by sub-net, as
lvt_tpu does. Loaded weights take the device and dtype of the initialised
params, and must have their shapes. A configured path that does not exist,
or a ``.pth`` that cannot be read, raises naming its key: neither is ever
replaced by random weights.
"""

import logging
import os
import time
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from ..checkpoint import latest_checkpoint, load_checkpoint
from ..checkpoint.io import _place
from ..checkpoint.torch_convert import (convert_video_transformer, load_pretrained_vqvae,
                                        load_torch_state_dict)
from ..config import get_cfg
from ..utils import comm
from ..utils.image import save_image
from .evaluator import DatasetEvaluator

logger = logging.getLogger(__name__)


def _is_pth(path: str) -> bool:
    return path.endswith(".pth") and not os.path.isdir(path)


def _checkpoint_file(key: str, path: str) -> str:
    """The checkpoint that a configured path names: the file itself, or the
    latest checkpoint of an OUTPUT_DIR."""
    if os.path.isdir(path):
        found = latest_checkpoint(path)
        if found is None:
            raise FileNotFoundError(f"{key}={path!r} holds no checkpoint "
                                    "(checkpoints/ckpt_<step>.pt)")
        return found
    return path


def _read_pth(key: str, read):
    """``read()``, with a file that is no readable reference state dict
    reported under its configuration key."""
    try:
        return read()
    except (OSError, EOFError, RuntimeError, KeyError, ValueError) as exc:
        raise ValueError(f"{key}: cannot be read as a reference .pth state dict "
                         f"({type(exc).__name__}: {exc})") from exc


def load_vqvae_weights(model, params, state, enc_path: str, gen_path: str, cb_path: str):
    """(params, state, loaded): the VQ-VAE's weights from the configured
    paths, placed into ``params`` and ``state``; loaded is False where no
    path is configured. A port checkpoint named by any of the three paths
    loads first; each ``.pth`` path is then grafted on top of it
    (``load_pretrained_vqvae``: netE, netG, netC)."""
    named = {"ENCODER_WEIGHTS": enc_path, "GENERATOR_WEIGHTS": gen_path,
             "CODEBOOK_WEIGHTS": cb_path}
    missing = [f"{k}={p!r}" for k, p in named.items() if p and not os.path.exists(p)]
    if missing:
        # a configured-but-absent path must not silently degrade to random init
        raise FileNotFoundError(f"configured VQ-VAE weights do not exist: {', '.join(missing)}")
    configured = [(k, p) for k, p in named.items() if p]
    if not configured:
        return params, state, False
    ckpts = [(k, p) for k, p in configured if not _is_pth(p)]
    if ckpts:
        key, path = ckpts[0]
        tree = load_checkpoint(_checkpoint_file(f"TEST.VT_SAMPLER.VQ_VAE.{key}", path),
                               {"params": params, "model_state": state}, partial=True)
        params, state = tree["params"], tree["model_state"]
    pth = {k: p for k, p in configured if _is_pth(p)}
    if pth:
        keys = ", ".join(f"TEST.VT_SAMPLER.VQ_VAE.{k}={p!r}" for k, p in pth.items())
        grafted = _read_pth(keys, lambda: load_pretrained_vqvae(
            model, params, state, encoder_path=pth.get("ENCODER_WEIGHTS", ""),
            generator_path=pth.get("GENERATOR_WEIGHTS", ""),
            codebook_path=pth.get("CODEBOOK_WEIGHTS", "")))
        params, state = _place(grafted, (params, state), False)
    return params, state, True


_PAIRED_VQVAE_CACHE = {}


def load_paired_vqvae(cfg, gen: Optional[torch.Generator] = None, device="cuda"):
    """(model, params, state, vq_cfg, loaded): the VQ-VAE named in
    TEST.VT_SAMPLER.VQ_VAE.CFG, initialised from ``gen`` and then given the
    weights of TEST.VT_SAMPLER.VQ_VAE.{ENCODER,GENERATOR,CODEBOOK}_WEIGHTS.

    With no ``gen`` (the evaluators) it is initialised from seed 0 and
    memoized on the four path strings and the device: VTSampler and
    FVDEvaluator run in the same eval and need the identical model and
    weights, built once."""
    if gen is not None:
        return _load_paired_vqvae(cfg, gen, device)
    vq = cfg.TEST.VT_SAMPLER.VQ_VAE
    key = (vq.CFG, vq.ENCODER_WEIGHTS, vq.GENERATOR_WEIGHTS, vq.CODEBOOK_WEIGHTS,
           str(torch.device(device)))
    if key not in _PAIRED_VQVAE_CACHE:
        _PAIRED_VQVAE_CACHE[key] = _load_paired_vqvae(cfg, torch.Generator().manual_seed(0),
                                                      device)
    return _PAIRED_VQVAE_CACHE[key]


def _load_paired_vqvae(cfg, gen: torch.Generator, device):
    from ..models.vqvae import VQVAE

    vq = cfg.TEST.VT_SAMPLER.VQ_VAE
    vq_cfg = get_cfg()
    vq_cfg.merge_from_file(vq.CFG)
    model = VQVAE(vq_cfg)
    params, state = model.init(gen, device)
    params, state, loaded = load_vqvae_weights(model, params, state, vq.ENCODER_WEIGHTS,
                                               vq.GENERATOR_WEIGHTS, vq.CODEBOOK_WEIGHTS)
    return model, params, state, vq_cfg, loaded


def decode_codes_fn(model, params, state, scale_to_zeroone: bool):
    """(T, nc, h, w) int codes (numpy) -> (T, H, W, 3) float32 frames in
    [0, 255] (numpy): clip(denormalize(decode) x 255 where the VQ-VAE's
    INPUT.SCALE_TO_ZEROONE is set, else x 1), on the device of ``params``."""
    from ..models import tree_leaves

    factor = 255.0 if scale_to_zeroone else 1.0
    device = tree_leaves(params)[0].device

    @torch.no_grad()
    def decode_codes(codes: np.ndarray) -> np.ndarray:
        idx = torch.as_tensor(np.asarray(codes)).to(device).permute(0, 2, 3, 1)  # (T, h, w, nc)
        out = model.denormalize(model.decode(params, state, idx)) * factor
        return out.clamp(0.0, 255.0).cpu().numpy()

    return decode_codes


def load_vt_weights(cfg, params) -> Optional[dict]:
    """The VT's params from MODEL.GENERATOR.WEIGHTS where it is set (a
    reference ``.pth``, converted by ``convert_video_transformer``, or a port
    checkpoint), else from the latest checkpoint under OUTPUT_DIR, placed
    into ``params``; None where neither exists. A configured path that does
    not exist raises (scripts/generate_videos.py falls back to OUTPUT_DIR
    there: here configured weights are loaded or refused)."""
    from ..models.vt import VTConfig

    key = "MODEL.GENERATOR.WEIGHTS"
    path = cfg.MODEL.GENERATOR.WEIGHTS
    if path:
        if not os.path.exists(path):
            raise FileNotFoundError(f"configured VT weights do not exist: {key}={path!r}")
        if _is_pth(path):
            netG = _read_pth(f"{key}={path!r}", lambda: convert_video_transformer(
                load_torch_state_dict(path), VTConfig.from_cfg(cfg)))
            return _place({"netG": netG}, params, False)
        path = _checkpoint_file(key, path)
    else:
        path = latest_checkpoint(cfg.OUTPUT_DIR)
        if path is None:
            return None
    return load_checkpoint(path, {"params": params}, partial=True)["params"]


class VTSampler(DatasetEvaluator):
    """Decodes each output's sampled code videos with the paired VQ-VAE (on
    ``device``) and writes codes.npy and one png a frame per sample."""

    def __init__(self, cfg, dataset_name, distributed=True, output_dir=None, device="cuda"):
        self._dataset_name = dataset_name
        self._distributed = distributed
        self._output_dir = output_dir

        self.vqvae, self._vq_params, self._vq_state, vq_cfg, _ = load_paired_vqvae(
            cfg, device=device)
        self.scale_to_zeroone = vq_cfg.INPUT.SCALE_TO_ZEROONE
        self._decode_shared = decode_codes_fn(
            self.vqvae, self._vq_params, self._vq_state, self.scale_to_zeroone)

    def _decode_codes(self, codes):
        """(T, nc, h, w) int codes -> (T, H, W, 3) uint8 frames."""
        return self._decode_shared(codes).astype(np.uint8)

    def process(self, inputs, outputs):
        for inp, out in zip(inputs, outputs):
            samples = out["samples"]  # list of (nc, T, h, w) code arrays
            v_idx = inp["video_idx"]
            for sample_idx, sample in enumerate(samples):
                sample = np.asarray(sample)
                if sample.ndim == 3:
                    sample = sample[None]
                code = sample  # (nc, T, h, w)
                video = self._decode_codes(np.transpose(sample, (1, 0, 2, 3)))

                video_dir = os.path.join(self._output_dir, "samples",
                                         self._dataset_name,
                                         f"video_{sample_idx}_{v_idx}")
                os.makedirs(video_dir, exist_ok=True)
                np.save(os.path.join(video_dir, "codes.npy"), code)
                for frame_idx in range(len(video)):
                    frame_path = os.path.join(video_dir, f"{frame_idx}.png")
                    for attempt in range(10):  # flaky-FS retry (vt_sampler.py:74-81)
                        try:
                            save_image(video[frame_idx], frame_path)
                            break
                        except OSError:
                            if attempt == 9:
                                # a persistent failure (disk full, permissions)
                                # surfaces: a silently missing frame would read
                                # as success downstream
                                raise
                            logger.warning(f"save retry #{attempt} for {frame_path}")
                            time.sleep(3)

    def evaluate(self):
        if self._distributed:
            comm.synchronize()
            if not comm.is_main_process():
                return None
        return OrderedDict({"samples": {}})
