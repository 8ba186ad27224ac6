"""Weights of the paired VQ-VAE and of the VT for sampling (counterpart of
lvt_tpu/evaluation/vt_sampler.py:27-114, and of the VT branch of
scripts/generate_videos.py). The VTSampler evaluator itself is not ported
yet.

Weights are the port's own training checkpoints (lvt_tpu_torch/checkpoint/
io.py): a configured path is a checkpoint file written by
tools/train_net_torch.py, or a training OUTPUT_DIR, whose latest checkpoint
is read. A configured path that does not exist raises FileNotFoundError
naming its key, and a reference ``.pth`` file raises NotImplementedError: the
``.pth`` key layout is not ported yet. Neither is ever replaced by random
weights.
"""

import os
from typing import Optional

import torch

from ..checkpoint import latest_checkpoint, load_checkpoint
from ..config import get_cfg

PTH_NOT_PORTED = ("reference .pth weights need the .pth key layout, which lvt_tpu_torch does "
                  "not read yet (ROADMAP.md queue 1 item 7)")


def _checkpoint_file(key: str, path: str) -> str:
    """The checkpoint that a configured path names: the file itself, or the
    latest checkpoint of an OUTPUT_DIR."""
    if path.endswith(".pth"):
        raise NotImplementedError(f"{key}={path!r}: {PTH_NOT_PORTED}")
    if os.path.isdir(path):
        found = latest_checkpoint(path)
        if found is None:
            raise FileNotFoundError(f"{key}={path!r} holds no checkpoint "
                                    "(checkpoints/ckpt_<step>.pt)")
        return found
    return path


def load_vqvae_weights(params, state, enc_path: str, gen_path: str, cb_path: str):
    """(params, state, loaded): the VQ-VAE's whole training tree from the
    first configured path (any of the three may name it), placed into
    ``params`` and ``state``; loaded is False where no path is configured."""
    named = {"ENCODER_WEIGHTS": enc_path, "GENERATOR_WEIGHTS": gen_path,
             "CODEBOOK_WEIGHTS": cb_path}
    missing = [f"{k}={p!r}" for k, p in named.items() if p and not os.path.exists(p)]
    if missing:
        # a configured-but-absent path must not silently degrade to random init
        raise FileNotFoundError(f"configured VQ-VAE weights do not exist: {', '.join(missing)}")
    configured = [(k, p) for k, p in named.items() if p]
    pth = [f"TEST.VT_SAMPLER.VQ_VAE.{k}={p!r}" for k, p in configured if p.endswith(".pth")]
    if pth:  # a .pth anywhere is refused, not skipped
        raise NotImplementedError(f"{', '.join(pth)}: {PTH_NOT_PORTED}")
    if not configured:
        return params, state, False
    key, path = configured[0]
    tree = load_checkpoint(_checkpoint_file(f"TEST.VT_SAMPLER.VQ_VAE.{key}", path),
                           {"params": params, "model_state": state}, partial=True)
    return tree["params"], tree["model_state"], True


def load_paired_vqvae(cfg, gen: torch.Generator, device="cpu"):
    """(model, params, state, vq_cfg, loaded): the VQ-VAE named in
    TEST.VT_SAMPLER.VQ_VAE.CFG, initialised from ``gen`` and then given the
    weights of TEST.VT_SAMPLER.VQ_VAE.{ENCODER,GENERATOR,CODEBOOK}_WEIGHTS."""
    from ..models.vqvae import VQVAE

    vq = cfg.TEST.VT_SAMPLER.VQ_VAE
    vq_cfg = get_cfg()
    vq_cfg.merge_from_file(vq.CFG)
    model = VQVAE(vq_cfg)
    params, state = model.init(gen, device)
    params, state, loaded = load_vqvae_weights(params, state, vq.ENCODER_WEIGHTS,
                                               vq.GENERATOR_WEIGHTS, vq.CODEBOOK_WEIGHTS)
    return model, params, state, vq_cfg, loaded


def load_vt_weights(cfg, params) -> Optional[dict]:
    """The VT's params from MODEL.GENERATOR.WEIGHTS where it is set, else
    from the latest checkpoint under OUTPUT_DIR, placed into ``params``; None
    where neither exists. A configured path that does not exist raises
    (scripts/generate_videos.py falls back to OUTPUT_DIR there: here
    configured weights are loaded or refused)."""
    path = cfg.MODEL.GENERATOR.WEIGHTS
    if path:
        if not os.path.exists(path):
            raise FileNotFoundError(f"configured VT weights do not exist: "
                                    f"MODEL.GENERATOR.WEIGHTS={path!r}")
        path = _checkpoint_file("MODEL.GENERATOR.WEIGHTS", path)
    else:
        path = latest_checkpoint(cfg.OUTPUT_DIR)
        if path is None:
            return None
    return load_checkpoint(path, {"params": params}, partial=True)["params"]
