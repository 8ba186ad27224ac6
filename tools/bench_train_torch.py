#!/usr/bin/env python
"""Training-throughput benchmark of the PyTorch port (lvt_tpu_torch); the
counterpart of tools/bench_train.py: steady-state s/it of the two flagship
training configs at their reference batch sizes (PR-DVQVAE2 at batch 32 on
seeded 64x64 frames, DSFVT at batch 64 on seeded latent videos), through
the port's Trainer step (lvt_tpu_torch/engine/trainer.py ``train_step``).

The measurement is the reference's ``_measure``: one batch already on the
card, 3 warm-up steps, then --steps steps, fenced by a host read of the
loss. ``run`` takes KEY VALUE config overrides of each config and a device
(the tests narrow the widths with them and run on the CPU).

Usage: python tools/bench_train_torch.py [--steps 20]
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np
import torch


def measure(trainer, steps):
    """Seconds a step: ``trainer.train_step`` chained on one batch already on
    the device, 3 warm-up steps first, fenced by a host read of the loss."""
    batch = trainer._put_batch(next(iter(trainer._data_loader)))
    for _ in range(3):  # first launches, cuBLAS and the kernels' libraries
        metrics = trainer.train_step(batch)
    float(next(iter(metrics.values())))
    t0 = time.perf_counter()
    for _ in range(steps):
        metrics = trainer.train_step(batch)
    float(next(iter(metrics.values())))  # hard fence
    return (time.perf_counter() - t0) / steps


def run(steps, device, vq_opts=(), vt_opts=()):
    """Both measurements on ``device``, each config with its KEY VALUE
    overrides; the reference's keys, and the device."""
    from lvt_tpu_torch.config import get_cfg
    from lvt_tpu_torch.engine.trainer import Trainer

    rng = np.random.default_rng(0)
    results = {}

    # ---- PR-DVQVAE2 @ reference batch 32, 64x64 frames
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(ROOT, "configs", "vqvae", "PR-DVQVAE2.yaml"))
    cfg.merge_from_list(list(vq_opts))
    frames = rng.random((128, 64, 64, 3)).astype(np.float32)

    class VQLoader:
        def __iter__(self):
            while True:
                idx = rng.integers(0, 128, size=32)
                yield {"image": frames[idx]}

    s = measure(Trainer(cfg, VQLoader(), device=device), steps)
    results["vqvae_batch32_s_per_it"] = round(s, 4)
    results["vqvae_images_per_sec"] = round(32 / s, 1)

    # ---- DSFVT @ reference batch 64
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(ROOT, "configs", "vt", "DSFVT.yaml"))
    cfg.merge_from_list(list(vt_opts))
    nv = cfg.MODEL.AUTOREGRESSIVE.VT.NV
    nc = cfg.MODEL.AUTOREGRESSIVE.VT.NC

    class VTLoader:
        def __iter__(self):
            while True:
                yield {"video": rng.integers(0, nv, size=(64, nc, 16, 16, 16)).astype(np.int32)}

    s = measure(Trainer(cfg, VTLoader(), device=device), steps)
    results["dsfvt_batch64_s_per_it"] = round(s, 4)
    results["dsfvt_videos_per_sec"] = round(64 / s, 1)
    device = torch.device(device)
    results["device"] = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return results


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=20)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: bench_train_torch runs on the card")
    results = run(args.steps, torch.device("cuda"))
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
