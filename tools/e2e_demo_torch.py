#!/usr/bin/env python
"""The whole two-stage chain on an NVIDIA GPU with synthetic data, with the
PyTorch port (lvt_tpu_torch); the counterpart of tools/e2e_demo.py:

  1. a moving-squares video dataset (64x64 PNGs, BAIR layout; with
     --class-conditional the Kinetics layout <class>/video_<i>/, the motion
     of the squares being the class)
  2. VQ-VAE training on its frames (PR-DVQVAE2, or K-DVQVAE)
  3. evaluation: reconstruction MSE and CodesExtractor's latents under
     <vqvae out>/inference/demo_train/; then every frame of the set encoded
     twice, with kernel 6 and with the plain fp32 nearest-code search, and
     the indices that differ counted and checked in float64
     (ops/vq.py index_differences)
  4. VT training on the extracted codes (DSFVT, or KDSFVT with CLASS_NUM 600)
  5. bits/dim on 4 of the latent videos
  6. a bf16 rollout primed with 5 frames of the first latent video, decoded
     by the stage-1 VQ-VAE to PNGs; with --class-conditional a second rollout
     with the same priming and the same generator but another class, whose
     codes must differ

Every stage runs at the configurations' full width on the card (--device
cuda, the default); --device cpu runs the same chain on the kernels' plain
versions. --vq-opts and --vt-opts take KEY VALUE config overrides for stages
2 and 4, as tools/train_net_torch.py takes its opts (the tests narrow the
widths with them).

Usage:
  python tools/e2e_demo_torch.py [--workdir output/e2e_demo_torch]
      [--iters1 300] [--iters2 300] [--class-conditional]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import torch
from PIL import Image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 16
N_PRIME = 5
BATCH = 16  # SOLVER.IMS_PER_BATCH of both trainings (--vq-opts / --vt-opts override it)


def _write_video(d, n_frames, size, rng, motion=None):
    """One moving-squares video; motion=(dx, dy) overrides the random drift
    (the class-conditional set makes the motion its class)."""
    os.makedirs(d, exist_ok=True)
    x0, y0 = rng.integers(5, 40, 2)
    dx, dy = rng.integers(-3, 4, 2) if motion is None else motion
    x1, y1 = rng.integers(5, 40, 2)
    dx1, dy1 = rng.integers(-3, 4, 2) if motion is None else motion
    c0 = rng.integers(100, 255, 3)
    c1 = rng.integers(100, 255, 3)
    yy, xx = np.mgrid[0:size, 0:size]
    bg = np.stack([(xx * 2) % 200, (yy * 2) % 200, ((xx + yy)) % 200], -1).astype(np.uint8)
    for t in range(n_frames):
        img = bg.copy()
        ax = int(np.clip(x0 + dx * t, 0, size - 12))
        ay = int(np.clip(y0 + dy * t, 0, size - 12))
        bx = int(np.clip(x1 + dx1 * t, 0, size - 8))
        by = int(np.clip(y1 + dy1 * t, 0, size - 8))
        img[ay:ay + 12, ax:ax + 12] = c0
        img[by:by + 8, bx:bx + 8] = c1
        Image.fromarray(img).save(os.path.join(d, f"{t}.png"))


def make_dataset(root, n_videos=64, n_frames=N_FRAMES, size=64, seed=0):
    """BAIR layout: <root>/video_<i>/<t>.png, drawn from a numpy seed."""
    rng = np.random.default_rng(seed)
    for v in range(n_videos):
        d = os.path.join(root, f"video_{v}")
        if os.path.exists(os.path.join(d, f"{n_frames - 1}.png")):
            continue
        _write_video(d, n_frames, size, rng)
    print(f"dataset ready: {n_videos} videos at {root}")


# Kinetics-600 class names reused for the synthetic classes: the Kinetics
# walkers map a directory's name to its class id through KINETICS_LABEL_IDX
DEMO_CLASSES = {
    "archery": (3, 0),          # horizontal motion
    "bowling": (0, 3),          # vertical motion
    "juggling balls": (2, 2),   # diagonal motion
}


def make_class_dataset(root, n_per_class=8, n_frames=N_FRAMES, size=64, seed=0):
    """Kinetics layout: <root>/<class name>/video_<i>/<t>.png; the squares'
    motion is the class, a signal the class-conditional VT can pick up."""
    rng = np.random.default_rng(seed)
    for cname, motion in DEMO_CLASSES.items():
        for v in range(n_per_class):
            d = os.path.join(root, cname, f"video_{v}")
            if os.path.exists(os.path.join(d, f"{n_frames - 1}.png")):
                continue
            _write_video(d, n_frames, size, rng, motion=motion)
    print(f"dataset ready: {len(DEMO_CLASSES)} classes x {n_per_class} videos at {root}")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="the two-stage chain on synthetic data")
    parser.add_argument("--workdir", default=os.path.join(REPO, "output", "e2e_demo_torch"))
    parser.add_argument("--iters1", type=int, default=300, help="VQ-VAE steps")
    parser.add_argument("--iters2", type=int, default=300, help="VT steps")
    parser.add_argument("--n-videos", type=int, default=0,
                        help="videos of the set (default 64; 22 per class with "
                             "--class-conditional)")
    parser.add_argument("--size", type=int, default=64, help="frame size of the set")
    parser.add_argument("--class-conditional", action="store_true",
                        help="K-DVQVAE -> class-labelled latents -> KDSFVT (CLASS_NUM 600) -> "
                             "class-conditioned sampling")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--vq-opts", nargs="*", default=[], help="KEY VALUE overrides, stage 2")
    parser.add_argument("--vt-opts", nargs="*", default=[], help="KEY VALUE overrides, stage 4")
    return parser.parse_args(argv)


def _register(name, fn, root):
    """(Re-)register a dataset under ``name``: a second run in one process
    points the name at its own files."""
    from lvt_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog

    DatasetCatalog._REGISTERED.pop(name, None)
    DatasetCatalog.register(name, fn)
    MetadataCatalog.get(name).set(root=root)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Stages:
    """Each stage's seconds (host clock, synchronized) and the launches of
    every kernel wrapper (ops/_lib.py COUNTED) that it made."""

    def __init__(self, device):
        self.device = device
        self.seconds, self.launches = {}, {}

    def run(self, name, fn):
        from lvt_tpu_torch.ops._lib import COUNTED

        _sync(self.device)
        before = {f.__name__: f.launches for f in COUNTED}
        t0 = time.perf_counter()
        out = fn()
        _sync(self.device)
        self.seconds[name] = time.perf_counter() - t0
        # a wrapper whose module the stage imported first started at 0
        self.launches[name] = {f.__name__: f.launches - before.get(f.__name__, 0)
                               for f in COUNTED if f.launches != before.get(f.__name__, 0)}
        return out


def _train(cfg, model, iters, device):
    from lvt_tpu_torch.data import build_train_loader
    from lvt_tpu_torch.engine.trainer import Trainer

    loader, _ = build_train_loader(cfg)
    trainer = Trainer(cfg, loader, model=model, device=device)
    trainer.train(0, iters)
    trainer.flush_metrics()
    return trainer


def _loss_ends(trainer, name):
    """(first, median of the last 20) of a logged loss."""
    hist = trainer.storage.history(name)
    return hist.values()[0][0], hist.median(20)


@torch.no_grad()
def kernel6_check(vqvae, params, state, root, device, scale01):
    """Every frame under ``root`` encoded to z_e, its indices found by kernel 6
    (on a CUDA device; the plain version on the CPU) and by the plain fp32
    version. Returns {"indices", "differ", "far", "kernel"}: ``far`` counts
    the differences that are no float64 near-tie (ops/vq.py
    index_differences)."""
    from lvt_tpu_torch.ops import vq
    from lvt_tpu_torch.utils.image import get_image_paths, read_image

    paths = [d["image_path"] for d in get_image_paths(root, use_cache=False)]
    cb = vqvae._codebook_state(params, state)
    emb = cb["embedding"]
    num, _, dc = emb.shape
    kernel = device.type == "cuda"
    n_diff = n_far = total = 0
    for i in range(0, len(paths), 256):
        x = torch.from_numpy(np.stack([read_image(p, "RGB") for p in paths[i:i + 256]])
                             .astype(np.float32)).to(device)
        if scale01:
            x = x / 255.0
        z = vqvae.encode_features(params, state, vqvae.normalize(x))[0]
        z = z.float().reshape(-1, num * dc)  # (N, D)
        got = vq.encode_indices(z, cb, use_kernel=kernel)  # (N, num)
        want = vq.encode_indices(z, cb, use_kernel=False)
        d, f = vq.index_differences(got, want, z.reshape(-1, num, dc), emb)
        n_diff, n_far, total = n_diff + d, n_far + f, total + want.numel()
    return {"indices": total, "differ": n_diff, "far": n_far, "kernel": kernel}


def main(argv=None):
    """Run the chain; returns a dict of what each stage measured."""
    args = parse_args(argv)
    from lvt_tpu_torch.config import get_cfg
    from lvt_tpu_torch.data.datasets.latents import get_latent_video_paths
    from lvt_tpu_torch.engine.defaults import rank_device, run_test
    from lvt_tpu_torch.models import cast_floats
    from lvt_tpu_torch.models.vt import VideoTransformer
    from lvt_tpu_torch.utils.image import get_video_paths
    from lvt_tpu_torch.utils.labels import KINETICS_IDX_LABEL, KINETICS_LABEL_IDX

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the chain on the CPU")
    device = rank_device(device)
    cc = args.class_conditional
    wd = args.workdir
    stages = _Stages(device)
    res = {"mode": "class-conditional" if cc else "bair", "device": str(device)}

    # ---- 1: the dataset
    video_root = os.path.join(wd, "videos_cls" if cc else "videos")
    if cc:
        stages.run("dataset", lambda: make_class_dataset(
            video_root, n_per_class=args.n_videos or 22, size=args.size))
    else:
        stages.run("dataset", lambda: make_dataset(video_root, n_videos=args.n_videos or 64,
                                                   size=args.size))
    _register("demo_train", lambda: get_video_paths(video_root, use_cache=False,
                                                    is_kinetics=cc), video_root)

    # ---- 2: VQ-VAE training at full width
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "vqvae",
                                     "K-DVQVAE.yaml" if cc else "PR-DVQVAE2.yaml"))
    cfg.DATASETS.TRAIN = ("demo_train",)
    cfg.DATASETS.TEST = ("demo_train",)
    if not cc:
        cfg.INPUT.N_FRAMES_PER_VIDEO_TRAIN = 2  # frames per sampled clip
    cfg.SOLVER.IMS_PER_BATCH = BATCH
    cfg.OUTPUT_DIR = os.path.join(wd, "vqvae_out_cls" if cc else "vqvae_out")
    cfg.merge_from_list(list(args.vq_opts))
    trainer = stages.run("vqvae_train", lambda: _train(cfg, None, args.iters1, device))
    rec = _loss_ends(trainer, "loss_reconstruction")
    res["loss_reconstruction"] = rec
    print(f"[stage1] {'K-DVQVAE' if cc else 'PR-DVQVAE2'} {args.iters1} iters in "
          f"{stages.seconds['vqvae_train']:.1f}s; recon {rec[0]:.4f} -> {rec[1]:.4f}; "
          f"data_time median {trainer.storage.history('data_time').median(args.iters1):.5f}s")
    res["data_time"] = trainer.storage.history("data_time").median(args.iters1)

    # ---- 3: MSE + the codes, then kernel 6 on the trained codebook
    vq, vq_params, vq_state = trainer.model, trainer.state.params, trainer.state.model_state
    results = stages.run("vqvae_eval", lambda: run_test(cfg, vq, vq_params, vq_state))
    res["mse"] = results["reconstruction"]["MSE"]
    codes_root = os.path.join(cfg.OUTPUT_DIR, "inference", "demo_train")
    n_code_videos = sum(d.startswith("video_") for _, dirs, _ in os.walk(codes_root)
                        for d in dirs)
    if n_code_videos == 0:
        raise RuntimeError(f"no codes extracted under {codes_root}")
    print(f"[stage2] eval in {stages.seconds['vqvae_eval']:.1f}s: MSE={res['mse']:.5f}; "
          f"extracted codes for {n_code_videos} videos -> {codes_root}")
    k6 = stages.run("kernel6_check", lambda: kernel6_check(
        vq, vq_params, vq_state, video_root, device, cfg.INPUT.SCALE_TO_ZEROONE))
    res["kernel6"] = k6
    print(f"[stage2] kernel 6 on the trained codebook: {k6['differ']} of {k6['indices']} "
          f"indices differ from the plain fp32 search, {k6['far']} of them no near-tie "
          f"(kernel launched: {k6['kernel']})")

    # ---- 4: the VT on the extracted codes
    _register("demo_latents", lambda: get_latent_video_paths(codes_root, use_cache=False,
                                                             is_kinetics=cc), codes_root)
    vt_cfg = get_cfg()
    vt_cfg.merge_from_file(os.path.join(REPO, "configs", "vt",
                                        "KDSFVT.yaml" if cc else "DSFVT.yaml"))
    vt_cfg.DATASETS.TRAIN = ("demo_latents",)
    vt_cfg.DATASETS.TEST = ("demo_latents",)
    if cc:
        # the Kinetics run conditions on the 600-way class id (reference
        # videotransformer.py:29-31)
        vt_cfg.MODEL.AUTOREGRESSIVE.VT.CLASS_NUM = 600
    vt_cfg.SOLVER.IMS_PER_BATCH = BATCH
    vt_cfg.TEST.N_SAMPLES = 4
    vt_cfg.OUTPUT_DIR = os.path.join(wd, "vt_out_cls" if cc else "vt_out")
    vt_cfg.merge_from_list(list(args.vt_opts))
    lat = get_latent_video_paths(codes_root, use_cache=False, is_kinetics=cc)[0]
    first = np.stack([np.load(os.path.join(lat["video_root"], f))
                      for f in lat["latent_names"]])  # (T, nc, h, w)
    vt = VideoTransformer(vt_cfg, T=first.shape[0], H=first.shape[2], W=first.shape[3])
    vt_trainer = stages.run("vt_train", lambda: _train(vt_cfg, vt, args.iters2, device))
    ce = _loss_ends(vt_trainer, "loss_cross_entropy")
    nv = vt_cfg.MODEL.AUTOREGRESSIVE.VT.NV
    res["loss_cross_entropy"] = ce
    print(f"[stage3] {'KDSFVT' if cc else 'DSFVT'} {args.iters2} iters in "
          f"{stages.seconds['vt_train']:.1f}s; CE {ce[0]:.3f} -> {ce[1]:.3f} nats "
          f"(uniform = {np.log(nv):.3f})")

    # ---- 5: bits/dim
    vt_cfg2 = vt_cfg.clone()
    vt_cfg2.TEST.EVALUATORS = "BitsEvaluator"
    bits = stages.run("bits", lambda: run_test(vt_cfg2, vt, vt_trainer.state.params, {}))
    res["bits_per_dim"] = bits["likelihood"]["bits_per_dim"]
    print(f"[stage4] bits/dim = {res['bits_per_dim']:.3f} (uniform = {np.log2(nv):.2f}) in "
          f"{stages.seconds['bits']:.1f}s")

    # ---- 6: bf16 rollouts primed with 5 frames, decoded to PNGs
    video = torch.from_numpy(first.transpose(1, 0, 2, 3)[None].astype(np.int64)).to(device)
    with torch.no_grad():  # bf16 copies of the fp32 masters, outside autograd
        params_bf16 = cast_floats(vt_trainer.state.params, torch.bfloat16)

    def rollout(cls=None):
        gen = torch.Generator(device=device).manual_seed(0)
        c = None if cls is None else torch.tensor([cls], device=device)
        return vt.sample_video(params_bf16, video, gen, n_prime=N_PRIME, class_idx=c)

    if cc:
        true_cls = int(lat["class"])
        alt_cls = next(c for c in (KINETICS_LABEL_IDX[n] for n in DEMO_CLASSES)
                       if c != true_cls)
        sample = stages.run("rollout", lambda: rollout(true_cls))
        # the same priming and generator, another class: the class embedding
        # reaches every sampled logit through the encoder
        sample_alt = stages.run("rollout_alt_class", lambda: rollout(alt_cls))
        n_diff = int((sample != sample_alt).sum())
        res["class_codes_differ"] = n_diff
        if n_diff == 0:
            raise RuntimeError("class conditioning had no effect on sampling")
        print(f"[class-conditional] sampling conditioned on {KINETICS_IDX_LABEL[true_cls]!r} "
              f"(id {true_cls}) vs {KINETICS_IDX_LABEL[alt_cls]!r} (id {alt_cls}): {n_diff} "
              f"of {sample.numel()} codes differ OK")
    else:
        sample = stages.run("rollout", rollout)
    res["codes"] = sample.cpu()

    def decode():
        with torch.no_grad():
            idx = sample[0].permute(1, 2, 3, 0)  # (T, h, w, nc)
            out = vq.denormalize(vq.decode(vq_params, vq_state, idx))
            factor = 255.0 if cfg.INPUT.SCALE_TO_ZEROONE else 1.0
            return (out * factor).clamp(0.0, 255.0).cpu()

    frames = stages.run("decode", decode)
    res["frames"] = frames
    gen_dir = os.path.join(wd, "generated_cls" if cc else "generated")
    os.makedirs(gen_dir, exist_ok=True)
    for i, frame in enumerate(frames.to(torch.uint8).numpy()):
        Image.fromarray(frame).save(os.path.join(gen_dir, f"{i}.png"))
    res["generated_dir"] = gen_dir
    print(f"[stage5] sampled in {stages.seconds['rollout']:.1f}s (the graph's capture "
          f"included) and decoded {len(frames)} frames -> {gen_dir}")
    res["seconds"], res["launches"] = stages.seconds, stages.launches
    print("E2E CLASS-CONDITIONAL DEMO OK" if cc else "E2E DEMO OK")
    return res


if __name__ == "__main__":
    main()
