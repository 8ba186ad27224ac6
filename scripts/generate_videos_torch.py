#!/usr/bin/env python
"""End-to-end video generation from priming frames on an NVIDIA GPU, with the
PyTorch port (lvt_tpu_torch); the counterpart of scripts/generate_videos.py.

Pipeline: load priming pngs -> PR-DVQVAE2 encode to latent codes -> zero-pad
to 16 frames -> DSFVT subscale AR sampling through the KV-cached decoder ->
VQ-VAE decode -> save pngs. The attention of the encoder stack and of every
decoded pixel runs in the port's hand-written CUDA kernels, and each slice's
256 pixel steps run as one replay of a CUDA graph.

TEST.VT_SAMPLER.KV_DTYPE (native | int8), ATTN_IMPL (xla | pallas |
pallas-live) and WEIGHT_DTYPE (native | int8 | int8-pallas) choose the
quantized sampler, e.g. an int8 KV cache read by the int8 decode kernel:
  ... TEST.VT_SAMPLER.KV_DTYPE int8 TEST.VT_SAMPLER.ATTN_IMPL pallas

Weights: TEST.VT_SAMPLER.VQ_VAE.{ENCODER,GENERATOR,CODEBOOK}_WEIGHTS for the
VQ-VAE, MODEL.GENERATOR.WEIGHTS or else the latest checkpoint under
OUTPUT_DIR for the VT, each a reference .pth state dict (the paper's
released per-sub-net files, as configs/vt/DSFVT.yaml names them), a
checkpoint of tools/train_net_torch.py or a training OUTPUT_DIR
(lvt_tpu_torch/evaluation/vt_sampler.py). A configured path that does not
exist, or a .pth that cannot be read, raises; with nothing configured or
found, the weights are random from --seed, with a warning. The VT is built
on the latent grid of the encoded priming frames, so frames of any size the
VQ-VAE takes generate.

Usage:
  python scripts/generate_videos_torch.py --config-file configs/vt/DSFVT.yaml \
      --video-dir example/ [OUTPUT_DIR out] [opts...]
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
    parser.add_argument("--seed", type=int, default=0)
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
def encode_priming(vqvae, vq_params, vq_state, frames):
    """frames (b, n_prime, H, W, 3) floats in [0, 255] -> codes (b, nc,
    n_prime, h, w)."""
    b, n_prime = frames.shape[:2]
    x = frames.reshape((-1,) + frames.shape[2:])
    if vqvae.cfg.INPUT.SCALE_TO_ZEROONE:
        x = x / 255.0
    primed = vqvae.encode(vq_params, vq_state, vqvae.normalize(x))  # (b*n_prime, h, w, nc)
    h, w, nc = primed.shape[1:]
    return primed.reshape(b, n_prime, h, w, nc).permute(0, 4, 1, 2, 3)


@torch.no_grad()
def generate(vqvae, vq_params, vq_state, vt, vt_params, frames, n_prime, gen, *,
             greedy: bool = False, primed=None):
    """frames (b, n_prime, H, W, 3) floats in [0, 255] on the device ->
    (videos (b, T, H, W, 3) in [0, 255], codes (b, nc, T, h, w), primed codes
    (b, nc, n_prime, h, w), rollout seconds). ``primed``, where given, is
    encode_priming's result for ``frames``. The frames are decoded as
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
        primed = encode_priming(vqvae, vq_params, vq_state, frames)
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


def main(argv=None, device="cuda"):
    """Generate as the command line says; returns generate()'s result.
    ``device`` is the card; the tests pass "cpu" to run the same path on the
    kernels' plain versions."""
    from lvt_tpu_torch.evaluation.vt_sampler import load_paired_vqvae, load_vt_weights
    from lvt_tpu_torch.utils.image import save_image

    args = parse_args(argv)
    cfg = load_config(args.config_file, args.opts)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script runs the port's CUDA kernels")
    n_prime = cfg.TEST.VT_SAMPLER.N_PRIME
    gen = torch.Generator().manual_seed(args.seed)

    # the VQ-VAE and the priming codes first: the VT's grid is theirs
    vqvae, vq_params, vq_state, _, vq_loaded = load_paired_vqvae(cfg, gen, device)
    if not vq_loaded:
        print(f"WARNING: no VQ-VAE weights configured; random init (seed {args.seed})")
    frames = torch.from_numpy(load_priming_frames(args.video_dir, n_prime))[None].to(device)
    print(f"Loaded {frames.shape[1]} priming frames")
    primed = encode_priming(vqvae, vq_params, vq_state, frames)
    h, w = primed.shape[-2:]

    vt, vt_params = build_vt(cfg, gen, device, h, w)
    loaded = load_vt_weights(cfg, vt_params)
    if loaded is None:
        print(f"WARNING: no VT weights found; sampling with random init (seed {args.seed})")
    else:
        vt_params = loaded
    sample_gen = torch.Generator(device=device).manual_seed(args.seed)
    video, codes, primed, seconds = generate(vqvae, vq_params, vq_state, vt, vt_params, frames,
                                             n_prime, sample_gen, primed=primed)
    print(f"Sampled new video: rollout {seconds:.3f} s")
    frames_out = video[0].to(torch.uint8).cpu().numpy()
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    for i, frame in enumerate(frames_out):
        save_image(frame, os.path.join(cfg.OUTPUT_DIR, f"{i}.png"))
    print(f"Saved {len(frames_out)} frames to {cfg.OUTPUT_DIR}")
    return video, codes, primed, seconds


if __name__ == "__main__":
    main()
