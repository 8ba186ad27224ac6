#!/usr/bin/env python
"""End-to-end video generation from priming frames on an NVIDIA GPU, with the
PyTorch port (lvt_tpu_torch); the counterpart of scripts/generate_videos.py.

Pipeline: load priming pngs -> PR-DVQVAE2 encode to latent codes -> zero-pad
to 16 frames -> DSFVT subscale AR sampling through the KV-cached decoder ->
VQ-VAE decode -> save pngs. The attention of the encoder stack and of every
decoded pixel runs in the port's hand-written CUDA kernels, and each slice's
256 pixel steps run as one replay of a CUDA graph.

TEST.VT_SAMPLER.KV_DTYPE (native | int8 | int4), ATTN_IMPL (xla | pallas |
pallas-live) and WEIGHT_DTYPE (native | int8 | int8-pallas) choose the
quantized sampler, e.g. an int8 KV cache read by the int8 decode kernel, or
an int4 cache (packed pairs, ATTN_IMPL xla):
  ... TEST.VT_SAMPLER.KV_DTYPE int8 TEST.VT_SAMPLER.ATTN_IMPL pallas
  ... TEST.VT_SAMPLER.KV_DTYPE int4

Weights: TEST.VT_SAMPLER.VQ_VAE.{ENCODER,GENERATOR,CODEBOOK}_WEIGHTS for the
VQ-VAE, MODEL.GENERATOR.WEIGHTS or else the latest checkpoint under
OUTPUT_DIR for the VT, each a reference .pth state dict (the paper's
released per-sub-net files, as configs/vt/DSFVT.yaml names them), a
checkpoint of tools/train_net_torch.py or a training OUTPUT_DIR
(lvt_tpu_torch/evaluation/vt_sampler.py). A configured path that does not
exist, or a .pth that cannot be read, raises; with nothing configured or
found, the weights are random from --seed, with a warning. The VT is built
on the latent grid of the encoded priming frames, so frames of any size the
VQ-VAE takes generate. --img-size S center-crops the priming frames to a
square and Lanczos-resizes them to S x S on the card before they are encoded
(lvt_tpu_torch/data/preprocess.py), e.g. Kinetics frames of any size to the
64 x 64 the VQ-VAEs take.

--batch B samples B videos from the priming frames, one row each of one
batch, written to OUTPUT_DIR/video_<j>/ (B = 1: to OUTPUT_DIR). --num-gpus N
rolls the batch out data-parallel in N processes, one per card (B divisible
by N; --dist-backend gloo puts them on gloo, e.g. several on one card): each
rolls out its consecutive rows, sampling from its own generator (--seed plus
its rank), and rank 0 gathers the frames and writes them
(lvt_tpu_torch/engine/launch.py).

Usage:
  python scripts/generate_videos_torch.py --config-file configs/vt/DSFVT.yaml \
      --video-dir example/ [OUTPUT_DIR out] [opts...]
  python scripts/generate_videos_torch.py --num-gpus 4 --batch 8 \
      --config-file configs/vt/DSFVT.yaml --video-dir example/ OUTPUT_DIR out
With the reference weights at the paths DSFVT.yaml names
(pretrained/PR-DVQVAE2/net{E,G,C}/model_final.pth) and the VT's:
  ... MODEL.GENERATOR.WEIGHTS <path of the VT's model_final.pth>
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import torch


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Sample a 16-frame video given priming frames (PyTorch port)")
    parser.add_argument("--config-file", required=True, metavar="FILE")
    parser.add_argument("--video-dir", required=True, help="folder with priming frame pngs")
    parser.add_argument("--img-size", type=int, default=0,
                        help="if >0, center-crop and Lanczos-resize the priming frames to this "
                             "size on the card before they are encoded "
                             "(lvt_tpu_torch/data/preprocess.py); 0 = the frames as loaded")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--batch", type=int, default=1,
                        help="videos sampled from the priming frames")
    parser.add_argument("--num-gpus", type=int, default=1,
                        help="processes (cards) that share the batch's rollouts")
    parser.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                        help="the process group's backend: NCCL unless gloo is asked for")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return parser.parse_args(argv)


def load_priming_frames(video_dir, n_prime):
    from lvt_tpu_torch.utils.image import get_image_paths, read_image

    paths = [x["image_path"] for x in get_image_paths(video_dir, use_cache=False)]
    if len(paths) < n_prime:
        raise SystemExit(
            f"--video-dir {video_dir!r} holds {len(paths)} image(s); "
            f"need at least TEST.VT_SAMPLER.N_PRIME={n_prime} priming frames")
    frames = np.stack([read_image(p, "RGB") for p in paths[:n_prime]], axis=0)
    return frames.astype(np.float32)  # (n_prime, H, W, 3)


def load_config(config_file, opts=()):
    from lvt_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(config_file)
    cfg.merge_from_list(list(opts or ()))
    return cfg


def build_models(cfg, seed: int, device, dtype=torch.float32, H: int = 16, W: int = 16):
    """VQ-VAE named in TEST.VT_SAMPLER.VQ_VAE.CFG and the VT on an (H, W)
    latent grid, both with random weights from ``seed`` (no weights are read:
    main() loads the configured ones). Returns (vqvae, vq_params, vq_state,
    vt, vt_params)."""
    from lvt_tpu_torch.models import cast_floats
    from lvt_tpu_torch.models.vqvae import VQVAE

    gen = torch.Generator().manual_seed(seed)
    vqvae = VQVAE(load_config(cfg.TEST.VT_SAMPLER.VQ_VAE.CFG))
    vq_params, vq_state = vqvae.init(gen, device)
    vt, vt_params = build_vt(cfg, gen, device, H, W)
    return vqvae, vq_params, vq_state, vt, cast_floats(vt_params, dtype)


def build_vt(cfg, gen: torch.Generator, device, h: int, w: int):
    """The VT on the (N_FRAMES_PER_VIDEO_TEST, h, w) latent grid, initialised
    from ``gen``. Returns (vt, params)."""
    from lvt_tpu_torch.models.vt import VideoTransformer

    vt = VideoTransformer(cfg, T=cfg.INPUT.N_FRAMES_PER_VIDEO_TEST, H=h, W=w)
    params, _ = vt.init(gen, device)
    return vt, params


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def encode_priming(vqvae, vq_params, vq_state, frames, img_size: int = 0):
    """frames (b, n_prime, H, W, 3) floats in [0, 255] -> codes (b, nc,
    n_prime, h, w). With ``img_size`` > 0 the frames, once scaled as the
    VQ-VAE's INPUT.SCALE_TO_ZEROONE says, are center-cropped and
    Lanczos-resized to img_size x img_size on their device before they are
    normalized, in lvt_tpu's order (scripts/generate_videos.py)."""
    from lvt_tpu_torch.data.preprocess import center_crop_resize

    b, n_prime = frames.shape[:2]
    x = frames.reshape((-1,) + frames.shape[2:])
    if vqvae.cfg.INPUT.SCALE_TO_ZEROONE:
        x = x / 255.0
    if img_size > 0:
        x = center_crop_resize(x, img_size)
    primed = vqvae.encode(vq_params, vq_state, vqvae.normalize(x))  # (b*n_prime, h, w, nc)
    h, w, nc = primed.shape[1:]
    return primed.reshape(b, n_prime, h, w, nc).permute(0, 4, 1, 2, 3)


@torch.no_grad()
def generate(vqvae, vq_params, vq_state, vt, vt_params, frames, n_prime, gen, *,
             greedy: bool = False, primed=None, img_size: int = 0):
    """frames (b, n_prime, H, W, 3) floats in [0, 255] on the device ->
    (videos (b, T, H, W, 3) in [0, 255], codes (b, nc, T, h, w), primed codes
    (b, nc, n_prime, h, w), rollout seconds). ``primed``, where given, is
    encode_priming's result for ``frames`` (and ``img_size``). The frames are decoded as
    lvt_tpu's decode_codes_fn does: clip(denormalize(x) * 255, 0, 255) where
    the VQ-VAE's INPUT.SCALE_TO_ZEROONE is set, else clip(denormalize(x), 0,
    255). The sampler's knobs come from the VT's config:
    TEST.VT_SAMPLER.KV_DTYPE, ATTN_IMPL and WEIGHT_DTYPE (SEG is accepted and
    ignored by the port's preallocated cache). On the card each slice is one
    replay of a CUDA graph that ``vt`` captures at the first slice of a
    configuration (models/rollout_graph.py): the rollout seconds of a
    configuration's first call include that capture."""
    knobs = vt.cfg.TEST.VT_SAMPLER
    b = frames.shape[0]
    if primed is None:
        primed = encode_priming(vqvae, vq_params, vq_state, frames, img_size)
    nc, _, h, w = primed.shape[1:]
    video = torch.zeros((b, nc, vt.T, h, w), dtype=torch.int64, device=frames.device)
    video[:, :, :n_prime] = primed
    _sync(frames.device)
    t0 = time.perf_counter()
    sampled = vt.sample_video(vt_params, video, gen, n_prime=n_prime, greedy=greedy,
                              kv_cache_dtype=knobs.KV_DTYPE, kv_seg_size=knobs.SEG,
                              attn_impl=knobs.ATTN_IMPL, weight_dtype=knobs.WEIGHT_DTYPE)
    _sync(frames.device)
    seconds = time.perf_counter() - t0
    idx = sampled.permute(0, 2, 3, 4, 1).reshape(b * vt.T, h, w, nc)
    out = vqvae.denormalize(vqvae.decode(vq_params, vq_state, idx))
    factor = 255.0 if vqvae.cfg.INPUT.SCALE_TO_ZEROONE else 1.0
    out = (out * factor).clamp(0.0, 255.0).reshape((b, vt.T) + out.shape[1:])
    return out, sampled, primed, seconds


def generate_sharded(vqvae, vq_params, vq_state, vt, vt_params, frames, n_prime, gen, *,
                     greedy: bool = False, img_size: int = 0):
    """generate() over the processes of the world (utils/comm): each rank
    rolls out its consecutive rows of ``frames``' batch (b divisible by the
    world), with ``gen``, and rank 0 gathers them in rank order (the
    sharding of lvt_tpu's sample_video over its data mesh,
    tests/test_multichip_sampling.py). Returns generate()'s result on rank 0,
    as CPU tensors, with the slowest rank's rollout seconds; None on the
    others. In a world of one it is generate()."""
    from lvt_tpu_torch.utils import comm

    world, rank = comm.get_world_size(), comm.get_rank()
    b = frames.shape[0]
    if b % world:
        raise ValueError(f"a batch of {b} videos does not divide over {world} processes")
    rows = frames[rank * (b // world):(rank + 1) * (b // world)]
    video, codes, primed, seconds = generate(vqvae, vq_params, vq_state, vt, vt_params, rows,
                                             n_prime, gen, greedy=greedy, img_size=img_size)
    parts = comm.gather((video.cpu(), codes.cpu(), primed.cpu(), seconds))
    if rank != 0:
        return None
    return (*(torch.cat([p[i] for p in parts]) for i in range(3)), max(p[3] for p in parts))


def main(argv=None, device="cuda"):
    """Generate as the command line says; returns generate()'s result (with
    --num-gpus above 1 or a --dist-backend, the processes' run and None).
    ``device`` is the card; the tests pass "cpu" to run the same path on the
    kernels' plain versions."""
    from lvt_tpu_torch.engine.launch import launch

    args = parse_args(argv)
    return launch(_main, args.num_gpus, backend=args.dist_backend, args=(args, device))


def _main(args, device):
    """main() in one process: rank 0 of the world, or the only process."""
    from lvt_tpu_torch.engine.defaults import rank_device
    from lvt_tpu_torch.evaluation.vt_sampler import load_paired_vqvae, load_vt_weights
    from lvt_tpu_torch.utils import comm
    from lvt_tpu_torch.utils.image import save_image

    cfg = load_config(args.config_file, args.opts)
    if cfg.TPU.MESH_MODEL != 1:
        raise NotImplementedError(
            f"TPU.MESH_MODEL {cfg.TPU.MESH_MODEL}: this script shards videos over the processes "
            "(data parallel); generation under tensor parallelism is not ported to it yet "
            "(ROADMAP.md queue 1 item 9). VideoTransformer.sample_video runs tensor-parallel "
            "inside lvt_tpu_torch.parallel.tensor_parallel")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script runs the port's CUDA kernels")
    device = rank_device(device)
    n_prime = cfg.TEST.VT_SAMPLER.N_PRIME
    gen = torch.Generator().manual_seed(args.seed)

    # the VQ-VAE and the priming codes first: the VT's grid is theirs
    vqvae, vq_params, vq_state, _, vq_loaded = load_paired_vqvae(cfg, gen, device)
    if not vq_loaded:
        print(f"WARNING: no VQ-VAE weights configured; random init (seed {args.seed})")
    frames = torch.from_numpy(load_priming_frames(args.video_dir, n_prime))[None].to(device)
    print(f"Loaded {frames.shape[1]} priming frames")
    primed = encode_priming(vqvae, vq_params, vq_state, frames, args.img_size)
    h, w = primed.shape[-2:]

    vt, vt_params = build_vt(cfg, gen, device, h, w)
    loaded = load_vt_weights(cfg, vt_params)
    if loaded is None:
        print(f"WARNING: no VT weights found; sampling with random init (seed {args.seed})")
    else:
        vt_params = loaded
    sample_gen = torch.Generator(device=device).manual_seed(args.seed + comm.get_rank())
    if comm.get_world_size() == 1 and args.batch == 1:
        out = generate(vqvae, vq_params, vq_state, vt, vt_params, frames, n_prime, sample_gen,
                       primed=primed)
    else:
        out = generate_sharded(vqvae, vq_params, vq_state, vt, vt_params,
                               frames.expand((args.batch,) + frames.shape[1:]), n_prime,
                               sample_gen, img_size=args.img_size)
    if out is None:  # not rank 0
        return None
    video, codes, primed, seconds = out
    print(f"Sampled {video.shape[0]} new video(s) in {comm.get_world_size()} process(es): "
          f"rollout {seconds:.3f} s")
    for j in range(video.shape[0]):
        out_dir = cfg.OUTPUT_DIR if video.shape[0] == 1 else os.path.join(cfg.OUTPUT_DIR,
                                                                          f"video_{j}")
        os.makedirs(out_dir, exist_ok=True)
        frames_out = video[j].to(torch.uint8).cpu().numpy()
        for i, frame in enumerate(frames_out):
            save_image(frame, os.path.join(out_dir, f"{i}.png"))
        print(f"Saved {len(frames_out)} frames to {out_dir}")
    return video, codes, primed, seconds


if __name__ == "__main__":
    main()
