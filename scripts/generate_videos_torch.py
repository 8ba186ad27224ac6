#!/usr/bin/env python
"""End-to-end video generation from priming frames on an NVIDIA GPU, with the
PyTorch port (lvt_tpu_torch); the counterpart of scripts/generate_videos.py.

Pipeline: load priming pngs -> PR-DVQVAE2 encode to latent codes -> zero-pad
to 16 frames -> DSFVT subscale AR sampling through the KV-cached decoder ->
VQ-VAE decode -> save pngs. The attention of the encoder stack and of every
decoded pixel runs in the port's hand-written CUDA kernels.

The weights are random, made from --seed: loading trained .pth checkpoints
comes with the port of the checkpoint code.

Usage:
  python scripts/generate_videos_torch.py --config-file configs/vt/DSFVT.yaml \
      --video-dir example/ [OUTPUT_DIR out] [opts...]
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
    """VQ-VAE named in TEST.VT_SAMPLER.VQ_VAE.CFG and the VT, both with random
    weights from ``seed``. Returns (vqvae, vq_params, vq_state, vt, vt_params)."""
    from lvt_tpu_torch.models import cast_floats
    from lvt_tpu_torch.models.vqvae import VQVAE
    from lvt_tpu_torch.models.vt import VideoTransformer

    vq_cfg = load_config(cfg.TEST.VT_SAMPLER.VQ_VAE.CFG)
    gen = torch.Generator().manual_seed(seed)
    vqvae = VQVAE(vq_cfg)
    vq_params, vq_state = vqvae.init(gen, device)
    vt = VideoTransformer(cfg, T=cfg.INPUT.N_FRAMES_PER_VIDEO_TEST, H=H, W=W)
    vt_params, _ = vt.init(gen, device)
    return vqvae, vq_params, vq_state, vt, cast_floats(vt_params, dtype)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def generate(vqvae, vq_params, vq_state, vt, vt_params, frames, n_prime, gen, *,
             greedy: bool = False):
    """frames (b, n_prime, H, W, 3) floats in [0, 255] on the device ->
    (videos (b, T, H, W, 3) in [0, 1], codes (b, nc, T, h, w), primed codes
    (b, nc, n_prime, h, w), rollout seconds)."""
    b = frames.shape[0]
    x = frames.reshape((-1,) + frames.shape[2:])
    if vqvae.cfg.INPUT.SCALE_TO_ZEROONE:
        x = x / 255.0
    primed = vqvae.encode(vq_params, vq_state, vqvae.normalize(x))  # (b*n_prime, h, w, nc)
    h, w, nc = primed.shape[1:]
    primed = primed.reshape(b, n_prime, h, w, nc).permute(0, 4, 1, 2, 3)
    video = torch.zeros((b, nc, vt.T, h, w), dtype=torch.int64, device=frames.device)
    video[:, :, :n_prime] = primed
    _sync(frames.device)
    t0 = time.perf_counter()
    sampled = vt.sample_video(vt_params, video, gen, n_prime=n_prime, greedy=greedy)
    _sync(frames.device)
    seconds = time.perf_counter() - t0
    idx = sampled.permute(0, 2, 3, 4, 1).reshape(b * vt.T, h, w, nc)
    out = vqvae.denormalize(vqvae.decode(vq_params, vq_state, idx))
    out = out.clamp(0.0, 1.0).reshape((b, vt.T) + out.shape[1:])
    return out, sampled, primed, seconds


def main(argv=None):
    args = parse_args(argv)
    from lvt_tpu_torch.utils.image import save_image

    cfg = load_config(args.config_file, args.opts)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script runs the port's CUDA kernels")
    device = torch.device("cuda")
    n_prime = cfg.TEST.VT_SAMPLER.N_PRIME
    vqvae, vq_params, vq_state, vt, vt_params = build_models(cfg, args.seed, device)
    print("WARNING: no trained weights are loaded; sampling with random init "
          f"(seed {args.seed})")
    frames = load_priming_frames(args.video_dir, n_prime)
    print(f"Loaded {len(frames)} priming frames")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    video, codes, primed, seconds = generate(
        vqvae, vq_params, vq_state, vt, vt_params,
        torch.from_numpy(frames)[None].to(device), n_prime, gen)
    print(f"Sampled new video: rollout {seconds:.3f} s")
    frames_out = (video[0] * 255.0).to(torch.uint8).cpu().numpy()
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    for i, frame in enumerate(frames_out):
        save_image(frame, os.path.join(cfg.OUTPUT_DIR, f"{i}.png"))
    print(f"Saved {len(frames_out)} frames to {cfg.OUTPUT_DIR}")
    return video, codes, primed, seconds


if __name__ == "__main__":
    main()
