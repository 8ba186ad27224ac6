#!/usr/bin/env python
"""Training rates through the input pipeline, with the PyTorch port
(lvt_tpu_torch); the counterpart of tools/bench_pipeline.py.

Each rate is measured twice, side by side: with the native IO library
(lvt_tpu_torch/native: PNG frames and latent .npy files decoded in C++) and
with it switched off, so that frames are read with PIL and latents with
numpy. Three modes, over synthetic datasets on disk:

  --gen           write the datasets:
                    <workdir>/latents/video_<i>/<t>.npy: the CodesExtractor
                      layout, (nc, h, w) int32 codes, 16 frames a video (the
                      VT's input);
                    <workdir>/frames/video_<i>/<t>.png: BAIR-layout 64x64 RGB
                      moving squares (tools/e2e_demo_torch.py make_dataset;
                      PR-DVQVAE2's input).
  --loader-only   iterate build_train_loader with no device in the loop:
                    batches/s and videos/s (DSFVT) or frames/s (PR-DVQVAE2).
  (default)       --steps (>= 200) trainer steps (Trainer.run_step: the
                    loader, the copy to the card, the step) on the card, then
                    the same trainer's step alone on one batch already on
                    the card: s/iteration, items/s, the device-only s/step,
                    data_time (mean and max) and the host-to-device copy of
                    one batch. Every time is a host clock read after
                    torch.cuda.synchronize().

Usage:
  python tools/bench_pipeline_torch.py --gen
  python tools/bench_pipeline_torch.py --loader-only --config vqvae
  python tools/bench_pipeline_torch.py --config vt --steps 200
"""

import argparse
import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKDIR = os.path.join(REPO, "output", "bench_pipeline_torch")


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------

def gen_latents(root, n_videos=1024, n_frames=16, nc=4, h=16, w=16, nv=512, seed=0):
    """Latent .npy trees as CodesExtractor writes them, from a numpy seed."""
    rng = np.random.default_rng(seed)
    for v in range(n_videos):
        d = os.path.join(root, f"video_{v}")
        if os.path.exists(os.path.join(d, f"{n_frames - 1}.npy")):
            continue
        os.makedirs(d, exist_ok=True)
        codes = rng.integers(0, nv, size=(n_frames, nc, h, w)).astype(np.int32)
        for t in range(n_frames):
            np.save(os.path.join(d, f"{t}.npy"), codes[t])
    print(f"latents ready: {n_videos} videos x {n_frames} frames at {root}")


def gen_frames(root, n_videos=256, n_frames=16, size=64, seed=0):
    """BAIR-layout PNG trees: the e2e demo's moving squares."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from e2e_demo_torch import make_dataset

    make_dataset(root, n_videos=n_videos, n_frames=n_frames, size=size, seed=seed)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def build_cfg(which, workdir, batch=0, workers=-1):
    """DSFVT over <workdir>/latents ("vt") or PR-DVQVAE2 over the frames of
    <workdir>/frames, one frame a sample ("vqvae"); ``batch`` > 0 and
    ``workers`` >= 0 override the config's."""
    from lvt_tpu_torch.config import get_cfg
    from lvt_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
    from lvt_tpu_torch.data.datasets.latents import get_latent_video_paths
    from lvt_tpu_torch.utils.image import get_image_paths

    cfg = get_cfg()
    if which == "vt":
        root, name = os.path.join(workdir, "latents"), "pipe_latents"
        listing = lambda: get_latent_video_paths(root, use_cache=False)  # noqa: E731
        cfg.merge_from_file(os.path.join(REPO, "configs", "vt", "DSFVT.yaml"))
    else:
        root, name = os.path.join(workdir, "frames"), "pipe_frames"
        # PR-DVQVAE2 trains on single frames (bair_train, load_images=True)
        listing = lambda: get_image_paths(root, use_cache=False)  # noqa: E731
        cfg.merge_from_file(os.path.join(REPO, "configs", "vqvae", "PR-DVQVAE2.yaml"))
    if name not in DatasetCatalog.list():
        DatasetCatalog.register(name, listing)
        MetadataCatalog.get(name).set(root=root)
    if batch:
        cfg.SOLVER.IMS_PER_BATCH = batch
    if workers >= 0:
        cfg.DATALOADER.NUM_WORKERS = workers
    cfg.DATASETS.TRAIN = (name,)
    cfg.DATASETS.TEST = (name,)
    cfg.OUTPUT_DIR = os.path.join(workdir, f"out_{which}")
    return cfg


class _NoLibrary:
    def get(self):
        return None


@contextlib.contextmanager
def reader(kind):
    """``kind`` "native": the native IO library (it must load); "pil": no
    native library, so that frames are read with PIL and latents with numpy.
    Loaders and their worker processes must be made inside."""
    from lvt_tpu_torch import native

    if kind == "native":
        if not native.available():
            raise RuntimeError("the native IO library did not load (see the WARNING above)")
        yield
        return
    saved, native.LIBRARY = native.LIBRARY, _NoLibrary()
    try:
        yield
    finally:
        native.LIBRARY = saved


# ---------------------------------------------------------------------------
# measurements
# ---------------------------------------------------------------------------

def measure_loader(cfg, which, batches):
    """Steady-state batches/s of build_train_loader (a warm-up first)."""
    from lvt_tpu_torch.data import build_train_loader

    loader, n = build_train_loader(cfg)
    it = iter(loader)
    for _ in range(min(8, batches // 4 + 1)):
        next(it)
    t0 = time.perf_counter()
    for _ in range(batches):
        b = next(it)
    dt = time.perf_counter() - t0
    del it
    per = cfg.SOLVER.IMS_PER_BATCH
    key = "video" if which == "vt" else "image"
    return {"dataset_size": n, "workers": cfg.DATALOADER.NUM_WORKERS, "batch": per,
            "batches": batches, "batch_shape": list(np.asarray(b[key]).shape),
            "batches_per_sec": batches / dt, "items_per_sec": batches * per / dt,
            "sec_per_batch": dt / batches}


def measure_e2e(cfg, which, steps, device):
    """``steps`` Trainer.run_step iterations (the loader, the copy to the
    device, the step), synchronized once at the end; then the same trainer's
    train_step alone on one batch on the device, and one batch's copy."""
    from lvt_tpu_torch.data import build_train_loader
    from lvt_tpu_torch.engine.trainer import Trainer

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    loader, _ = build_train_loader(cfg)
    trainer = Trainer(cfg, loader, device=device)
    for _ in range(3):  # warm-up: workers started, first launches
        trainer.run_step()
        trainer.iter += 1
    sync()
    trainer._pending_metrics.clear()
    t0 = time.perf_counter()
    for _ in range(steps):
        trainer.run_step()
        trainer.iter += 1
    sync()
    wall = time.perf_counter() - t0
    data_times = [dt for _, dt, _ in trainer._pending_metrics]
    trainer._pending_metrics.clear()

    raw = next(trainer._data_loader_iter)
    batch = trainer._put_batch(raw)
    for _ in range(3):
        trainer.train_step(batch)
    sync()
    anchor = min(steps, 30)
    t0 = time.perf_counter()
    for _ in range(anchor):
        trainer.train_step(batch)
    sync()
    device_only = (time.perf_counter() - t0) / anchor

    key = "video" if which == "vt" else "image"
    h2d = []
    for _ in range(3):
        t0 = time.perf_counter()
        trainer._put_batch(raw)
        sync()
        h2d.append(time.perf_counter() - t0)
    per = cfg.SOLVER.IMS_PER_BATCH
    return {"batch": per, "workers": cfg.DATALOADER.NUM_WORKERS, "steps": steps,
            "sec_per_iter": wall / steps, "items_per_sec": steps * per / wall,
            "device_only_sec_per_iter": device_only,
            "pipeline_overhead_pct": 100.0 * (wall / steps - device_only) / device_only,
            "data_time_mean_ms": 1e3 * float(np.mean(data_times)),
            "data_time_max_ms": 1e3 * float(np.max(data_times)),
            "h2d_batch_mb": np.asarray(raw[key]).nbytes / 2 ** 20, "h2d_sec": min(h2d)}


def both(fn, *args):
    """fn(*args) with the native reader and with PIL, side by side."""
    out = {}
    for kind in ("native", "pil"):
        with reader(kind):
            out[kind] = fn(*args)
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workdir", default=WORKDIR)
    p.add_argument("--gen", action="store_true", help="write the datasets")
    p.add_argument("--n-videos", type=int, default=1024, help="[--gen] latent videos")
    p.add_argument("--n-frame-videos", type=int, default=256, help="[--gen] PNG videos")
    p.add_argument("--loader-only", action="store_true")
    p.add_argument("--config", choices=["vt", "vqvae"], default="vt")
    p.add_argument("--batch", type=int, default=0,
                   help="SOLVER.IMS_PER_BATCH (0: the config's)")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batches", type=int, default=50, help="[--loader-only] timed batches")
    p.add_argument("--workers", type=int, default=-1,
                   help="DATALOADER.NUM_WORKERS (-1: the config's)")
    p.add_argument("--device", default="cuda", help="the trainer's device")
    args = p.parse_args(argv)

    if args.gen:
        gen_latents(os.path.join(args.workdir, "latents"), n_videos=args.n_videos)
        gen_frames(os.path.join(args.workdir, "frames"), n_videos=args.n_frame_videos)
        return None

    cfg = build_cfg(args.config, args.workdir, args.batch, args.workers)
    if args.loader_only:
        out = {"mode": "loader_only", "config": args.config,
               **both(measure_loader, cfg, args.config, args.batches)}
    else:
        device = torch.device(args.device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise SystemExit("no CUDA device: the trainer's steps run on the card "
                             "(--loader-only needs none)")
        out = {"mode": "pipeline_e2e", "config": args.config, "device": str(device),
               "device_name": torch.cuda.get_device_name(device) if device.type == "cuda"
               else "cpu", **both(measure_e2e, cfg, args.config, args.steps, device)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
