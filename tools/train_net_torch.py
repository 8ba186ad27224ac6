#!/usr/bin/env python
"""Training entry point of the PyTorch port (lvt_tpu_torch) on one NVIDIA
GPU; the counterpart of tools/train_net.py for training and --resume.

Examples:
  python tools/train_net_torch.py --config-file configs/vqvae/PR-DVQVAE2.yaml \
      OUTPUT_DIR out/prdvqvae2
  python tools/train_net_torch.py --config-file configs/vt/DSFVT.yaml \
      OUTPUT_DIR out/dsfvt
  python tools/train_net_torch.py --config-file configs/vt/DSFVT.yaml --resume \
      OUTPUT_DIR out/dsfvt

A VQ-VAE config (stage 1) trains on the frames of the image datasets named in
DATASETS.TRAIN (bair_train: PNG frames under datasets/bair/train); its
quantizer finds the nearest codes with kernel 6 (lvt_tpu_torch/ops/vq.py) and
keeps the EMA codebook in the model state, saved with every checkpoint.

DSFVT's default TPU.FUSED_LAYER True trains with the fused layer (kernels 7,
8 and 9 of lvt_tpu_torch/ops/fused_layer.py); TPU.FUSED_LAYER False runs the
unfused layers with per-layer remat.

A VT config's latent-code datasets are read from the CodesExtractor layout
(<root>/video_<i>/<frame>.npy); all dataset paths are those of
lvt_tpu_torch/data/datasets/builtin.py. --eval-only waits for the port of
evaluation.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch


def setup(args):
    from lvt_tpu_torch.config import get_cfg
    from lvt_tpu_torch.engine.defaults import default_setup

    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    cfg.merge_from_list(args.opts)
    cfg.freeze()
    default_setup(cfg, args)
    return cfg


def main(args, device="cuda"):
    """Train as the config says; returns the trainer. ``device`` is the
    card; the tests pass "cpu" to run the same path on the kernels' plain
    versions."""
    from lvt_tpu_torch.engine.defaults import DefaultTrainer

    if args.eval_only:
        raise NotImplementedError("--eval-only needs the evaluators, which are not ported "
                                  "to lvt_tpu_torch yet (ROADMAP.md queue 1)")
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train_net_torch.py needs a CUDA card (torch.cuda.is_available() "
                         "is false)")
    cfg = setup(args)
    trainer = DefaultTrainer(cfg, device=device)
    start_iter = trainer.resume_or_load(resume=args.resume)
    trainer.train(start_iter, cfg.SOLVER.MAX_ITER)
    return trainer


if __name__ == "__main__":
    from lvt_tpu_torch.engine.defaults import default_argument_parser

    args = default_argument_parser().parse_args()
    print("Command Line Args:", args)
    main(args)
