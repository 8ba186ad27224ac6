"""The system under test: the PyTorch port (``lvt_tpu_torch``) and its
generation entry (``scripts/generate_videos_torch.py``), at the checkout's
root (``runner.run_cell`` puts it on the path). Everything of the port is
imported when called.

A configuration file's ``vt`` section holds the port's MODEL.AUTOREGRESSIVE.VT
keys, its ``vqvae`` section the VQ-VAE's MODEL keys, its ``video`` section
the clip and its ``train`` section the trainer's; a traffic file adds the
sampler's knobs. ``port_cfg`` and ``vqvae_cfg`` set them on the port's
default config, key by key, and refuse a key the port does not have.
"""

import importlib.util
import os

from .cells import REPO


def _set(cfg, dotted: str, value):
    node = cfg
    keys = dotted.split(".")
    for k in keys[:-1]:
        node = node[k]
    if keys[-1] not in node:
        raise KeyError(f"the port's config has no key {dotted}")
    if isinstance(value, list):
        value = tuple(tuple(v) if isinstance(v, list) else v for v in value)
    dict.__setitem__(node, keys[-1], value)


def _put(cfg, prefix: str, section: dict):
    for k, v in section.items():
        if isinstance(v, dict):
            _put(cfg, f"{prefix}.{k}", v)
        else:
            _set(cfg, f"{prefix}.{k}", v)


def port_cfg(config: dict, traffic: dict, seed: int):
    """The port's config of the VT of ``config`` (training and sampling)."""
    from lvt_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.defrost()
    _set(cfg, "MODEL.META_ARCHITECTURE", "VideoTransformerModel")
    _put(cfg, "MODEL.AUTOREGRESSIVE.VT", config["vt"])
    T = config["video"]["T"]
    _set(cfg, "INPUT.N_FRAMES_PER_VIDEO_TRAIN", T)
    _set(cfg, "INPUT.N_FRAMES_PER_VIDEO_TEST", T)
    _set(cfg, "VIS_PERIOD", 0)
    _set(cfg, "SEED", 1 + int(seed) % (2 ** 31 - 2))
    tr = config["train"]
    _put(cfg, "SOLVER", tr["SOLVER"])
    _put(cfg, "TPU", tr["TPU"])
    _put(cfg, "TEST.VT_SAMPLER", traffic.get("sampler", {}))
    _set(cfg, "TEST.VT_SAMPLER.N_PRIME", config["video"]["N_PRIME_TEST"])
    return cfg


def vqvae_cfg(config: dict):
    """The port's config of the VQ-VAE of ``config``."""
    from lvt_tpu_torch.config import get_cfg

    q = config["vqvae"]
    cfg = get_cfg()
    cfg.defrost()
    _set(cfg, "MODEL.META_ARCHITECTURE", "VQVAEModel")
    for key in ("PIXEL_MEAN", "PIXEL_STD"):
        _set(cfg, f"MODEL.{key}", list(q[key]))
    for part in ("ENCODER", "GENERATOR", "CODEBOOK"):
        _put(cfg, f"MODEL.{part}", q[part])
    _set(cfg, "INPUT.SCALE_TO_ZEROONE", q["SCALE_TO_ZEROONE"])
    return cfg


def generation_entry():
    """scripts/generate_videos_torch.py as a module."""
    path = os.path.join(REPO, "scripts", "generate_videos_torch.py")
    spec = importlib.util.spec_from_file_location("generate_videos_torch", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
