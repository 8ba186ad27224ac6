#!/usr/bin/env python
"""Training and evaluation entry point of the PyTorch port (lvt_tpu_torch)
on NVIDIA GPUs, one process per GPU; the counterpart of tools/train_net.py.

Examples:
  python tools/train_net_torch.py --config-file configs/vqvae/PR-DVQVAE2.yaml \
      OUTPUT_DIR out/prdvqvae2
  python tools/train_net_torch.py --config-file configs/vt/DSFVT.yaml \
      OUTPUT_DIR out/dsfvt
  python tools/train_net_torch.py --config-file configs/vt/DSFVT.yaml --resume \
      OUTPUT_DIR out/dsfvt
  python tools/train_net_torch.py --config-file configs/vqvae/PR-DVQVAE2.yaml \
      --eval-only OUTPUT_DIR out/prdvqvae2
  python tools/train_net_torch.py --config-file configs/vt/DSFVT.yaml --eval-only \
      TEST.EVALUATORS "BitsEvaluator,VTSampler,FVDEvaluator" OUTPUT_DIR out/dsfvt

A VQ-VAE config (stage 1) trains on the frames of the image datasets named in
DATASETS.TRAIN (bair_train: PNG frames under datasets/bair/train); its
quantizer finds the nearest codes with kernel 6 (lvt_tpu_torch/ops/vq.py) and
keeps the EMA codebook in the model state, saved with every checkpoint.

DSFVT's default TPU.FUSED_LAYER True trains with the fused layer (kernels 7,
8 and 9 of lvt_tpu_torch/ops/fused_layer.py); TPU.FUSED_LAYER False runs the
unfused layers with per-layer remat.

A VT config's latent-code datasets are read from the CodesExtractor layout
(<root>/video_<i>/<frame>.npy); all dataset paths are those of
lvt_tpu_torch/data/datasets/builtin.py.

--eval-only runs TEST.EVALUATORS over DATASETS.TEST with the latest
checkpoint under OUTPUT_DIR, or else the configured weights
(MODEL.{ENCODER,GENERATOR,CODEBOOK}.WEIGHTS for a VQ-VAE,
MODEL.GENERATOR.WEIGHTS for the VT: reference .pth files or port
checkpoints), then checks TEST.EXPECTED_RESULTS. For PR-DVQVAE2 that is the
reconstruction MSE and the latents of every test video under
OUTPUT_DIR/inference/<dataset>/ (CodesExtractor), which the VT's latent
datasets read; for DSFVT bits/dim (BitsEvaluator), sampled videos under
OUTPUT_DIR/inference/samples/ (VTSampler) and FVD (FVDEvaluator; FVD_stub
without TEST.FVD.I3D_WEIGHTS), with the paired VQ-VAE of
TEST.VT_SAMPLER.VQ_VAE. A training run with TEST.EVAL_PERIOD > 0 evaluates
the same way every EVAL_PERIOD steps and after the last.

--num-gpus N trains (or evaluates) data-parallel in N processes, one per
card, over NCCL (lvt_tpu_torch/engine/launch.py); SOLVER.IMS_PER_BATCH stays
the global batch, of which each process loads its part:
  python tools/train_net_torch.py --num-gpus 4 --config-file configs/vt/DSFVT.yaml \
      OUTPUT_DIR out/dsfvt
--dist-backend gloo puts the processes on gloo instead: several on one card,
or on the CPU. Evaluation shards the test set over the processes and rank 0
gathers the metrics. A process that fails makes the command exit non-zero.

TPU.MESH_MODEL M lays the N processes out as N / M data-parallel groups of M
tensor-parallel ranks (lvt_tpu_torch/parallel/): the attention heads, the FFN
and predictor columns, the embeddings' features and the codebook's codes are
split over each group of M. M must divide N:
  python tools/train_net_torch.py --num-gpus 2 --config-file configs/vt/DSFVT.yaml \
      TPU.MESH_MODEL 2 OUTPUT_DIR out/dsfvt_tp
Under TPU.MESH_MODEL the VT trains with its unfused layers (kernels 1 and
10) and samples with the eager native sampler (kernel 2); its checkpoints
hold the whole leaves, so a run resumes under another layout.
TPU.SHARD_SPATIAL True adds spatial parallelism: each rank of a group of M
trains a VQ-VAE on its band of H / M rows of every frame, its convolutions
exchanging the rows at the bands' edges (lvt_tpu_torch/parallel/spatial.py);
H / M must be a multiple of every stride the encoder takes. Only 4-D image
batches are split: image sequences and the VT's videos train as without the
key, and so does --eval-only. With a group of 2 on one card over gloo:
  python tools/train_net_torch.py --num-gpus 2 --dist-backend gloo \
      --config-file configs/vqvae/PR-DVQVAE2.yaml TPU.MESH_MODEL 2 \
      TPU.SHARD_SPATIAL True OUTPUT_DIR out/prdvqvae2_sp
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch


def load_cfg(args):
    """The frozen config of the command line: the file, then the overrides."""
    from lvt_tpu_torch.config import get_cfg

    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    cfg.merge_from_list(args.opts)
    cfg.freeze()
    return cfg


def setup(args):
    from lvt_tpu_torch.engine.defaults import default_setup

    cfg = load_cfg(args)
    default_setup(cfg, args)
    return cfg


def main(args, device="cuda"):
    """Train as the config says and return the trainer, or with --eval-only
    evaluate and return the results, in this process (one rank of
    ``launch``'s world, or the only process). ``device`` is the card; the
    tests pass "cpu" to run the same path on the kernels' plain versions."""
    from lvt_tpu_torch.engine.defaults import DefaultTrainer

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train_net_torch.py needs a CUDA card (torch.cuda.is_available() "
                         "is false)")
    cfg = setup(args)
    if args.eval_only:
        return evaluate(cfg, device)
    trainer = DefaultTrainer(cfg, device=device)
    start_iter = trainer.resume_or_load(resume=args.resume)
    trainer.train(start_iter, cfg.SOLVER.MAX_ITER)
    return trainer


def evaluate(cfg, device):
    """The model with the latest checkpoint under OUTPUT_DIR, or else its
    configured weights, through run_test and verify_results. A configured
    path that does not exist raises FileNotFoundError: the weights are never
    silently random."""
    from lvt_tpu_torch.checkpoint import latest_checkpoint, load_checkpoint
    from lvt_tpu_torch.engine.defaults import run_test
    from lvt_tpu_torch.engine.defaults import rank_device
    from lvt_tpu_torch.evaluation import verify_results
    from lvt_tpu_torch.evaluation.vt_sampler import load_vqvae_weights, load_vt_weights
    from lvt_tpu_torch.models import build_model
    from lvt_tpu_torch.models.vqvae import VQVAE, AutoEncoder
    from lvt_tpu_torch.utils import comm

    from lvt_tpu_torch.parallel import sharding
    from lvt_tpu_torch.parallel.mesh import model_group

    device = rank_device(device)
    model = build_model(cfg)
    params, state = model.init(torch.Generator().manual_seed(max(cfg.SEED, 0)), device)
    ckpt = latest_checkpoint(cfg.OUTPUT_DIR)
    if ckpt is not None:
        tree = load_checkpoint(ckpt, {"params": params, "model_state": state}, partial=True)
        params, state = tree["params"], tree["model_state"]
    elif isinstance(model, (VQVAE, AutoEncoder)):
        params, state, _ = load_vqvae_weights(
            model, params, state, cfg.MODEL.ENCODER.WEIGHTS, cfg.MODEL.GENERATOR.WEIGHTS,
            cfg.MODEL.CODEBOOK.WEIGHTS)
    else:
        loaded = load_vt_weights(cfg, params)
        if loaded is not None:
            params = loaded
    group = model_group(cfg)
    if group is not None:  # the whole weights, then this rank's parts of them
        rank, size = sharding.group_rank(group)
        params, state = (sharding.shard_tree(t, rank, size) for t in (params, state))
    results = run_test(cfg, model, params, state)
    if comm.is_main_process():
        verify_results(cfg, results)
    return results


def run(args, device="cuda"):
    """``main`` in each process of the world that --num-gpus,
    --num-machines, --machine-rank, --dist-url and --dist-backend describe
    (lvt_tpu_torch/engine/launch.py). One process with no backend named runs
    here and returns ``main``'s result; a spawned world returns None, and a
    process that fails makes it raise."""
    from lvt_tpu_torch.engine.launch import launch
    from lvt_tpu_torch.parallel.mesh import layout

    layout(load_cfg(args), args.num_gpus * args.num_machines)  # a layout the world cannot take
    return launch(main, args.num_gpus, num_machines=args.num_machines,
                  machine_rank=args.machine_rank, dist_url=args.dist_url,
                  backend=args.dist_backend, args=(args, device))


if __name__ == "__main__":
    from lvt_tpu_torch.engine.defaults import default_argument_parser

    args = default_argument_parser().parse_args()
    print("Command Line Args:", args)
    run(args)
