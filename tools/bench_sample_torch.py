#!/usr/bin/env python
"""Per-geometry sampling benchmark (DSFVT / DSSVT / DSTSVT) of the PyTorch
port (lvt_tpu_torch); the counterpart of tools/bench_sample.py.

Measures ``VideoTransformer.sample_video`` alone (the KV-cached rollout, no
VQ-VAE) in generated frames/s on one card: each sampled slice is one replay
of the slice's CUDA graph (lvt_tpu_torch/models/rollout_graph.py). The
weights come from ``init`` with a seeded generator (cast to --dtype), the
video from np.random.default_rng(0), 16x16x16 codes as the reference makes
them. The first call holds the graph's one capture and is timed apart
(``capture_seconds``); each of the next --iters calls is fenced by
torch.cuda.synchronize() and a host read of one code.

  python tools/bench_sample_torch.py --config configs/vt/DSSVT.yaml --batch 8
  python tools/bench_sample_torch.py --config configs/vt/DSTSVT.yaml --batch 8 \\
      --kv int8 --attn pallas-live
  python tools/bench_sample_torch.py --config configs/vt/DSFVT.yaml --batch 8 --kv int4
  python tools/bench_sample_torch.py --config configs/vt/DSFVT.yaml --batch 8 --streams 2

--kv int4 keeps the cache as packed int4 pairs (attention through the
plain PyTorch path, as --attn xla); --streams S splits the batch into S
independent rollouts, on the card S parallel branches of each slice's
graph (greedy codes equal one stream's). --seg is accepted and ignored, as
``sample_video`` ignores kv_seg_size. The output is one JSON line with the
reference's keys and, beside them, capture_seconds, peak_memory_gb and
device, the graph's own capture seconds (its eager warm-up slice included)
and node count.
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

THW = (16, 16, 16)  # the latent video's (T, H, W), as the reference makes it


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="configs/vt/DSSVT.yaml")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--kv", default="native", choices=["native", "int8", "int4"])
    p.add_argument("--weights", default="native", choices=["native", "int8", "int8-pallas"],
                   help="per-pixel decoder weights as int8 with per-column scales; "
                        "'int8-pallas' runs the products through kernel 11")
    p.add_argument("--attn", default="xla", choices=["xla", "pallas", "pallas-live"],
                   help="with --kv int8: 'pallas' = kernel 3, 'pallas-live' = kernel 4, "
                        "'xla' = PyTorch's ops; with --kv native every choice runs kernel 2")
    p.add_argument("--mm", default="native", choices=["native", "int8"],
                   help="attention contractions as exact int8 products (requires --kv int8)")
    p.add_argument("--seg", type=int, default=0,
                   help="accepted and ignored: the port's cache is preallocated")
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--streams", type=int, default=1,
                   help="independent rollouts of batch / streams rows each (must divide the "
                        "batch); on the card the parallel branches of each slice's graph")
    p.add_argument("--class-num", type=int, default=0,
                   help="class-conditional sampling with this many classes (KDSFVT: 600)")
    p.add_argument("--greedy", action="store_true",
                   help="argmax codes instead of draws at temperature 1")
    p.add_argument("--trace", default="",
                   help="write a torch.profiler chrome trace of one timed iteration into "
                        "this directory")
    return p.parse_args(argv)


def load_cfg(args):
    from lvt_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(args.config if os.path.isabs(args.config)
                        else os.path.join(ROOT, args.config))
    if args.class_num > 0:
        cfg.MODEL.AUTOREGRESSIVE.VT.CLASS_NUM = args.class_num
    return cfg


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cfg, args, device):
    """The benchmark on ``device`` (the card; the CPU runs the eager loop).
    Returns (the JSON fields, the model, its params, the input video, the
    last call's codes), the videos (b, nc, T, H, W)."""
    from lvt_tpu_torch.models import cast_floats
    from lvt_tpu_torch.models.vt import VideoTransformer

    device = torch.device(device)
    T, H, W = THW
    model = VideoTransformer(cfg, T=T, H=H, W=W)
    params, _ = model.init(torch.Generator().manual_seed(0), device)
    if args.dtype == "bfloat16":
        params = cast_floats(params, torch.bfloat16)
    n_prime = cfg.TEST.VT_SAMPLER.N_PRIME
    B = args.batch
    rng = np.random.default_rng(0)
    video = torch.from_numpy(rng.integers(0, model.c.nv, size=(B, model.c.nc, T, H, W))).to(device)
    class_idx = (torch.from_numpy(rng.integers(0, args.class_num, size=(B,))).to(device)
                 if args.class_num > 0 else None)
    gen = torch.Generator(device=device).manual_seed(7)

    def call():
        with torch.no_grad():
            out = model.sample_video(params, video, gen, n_prime=n_prime, class_idx=class_idx,
                                     greedy=args.greedy, kv_cache_dtype=args.kv,
                                     kv_seg_size=args.seg, weight_dtype=args.weights,
                                     mm_dtype=args.mm, attn_impl=args.attn,
                                     streams=args.streams)
        _ = int(out[0, 0, -1, 0, 0])  # host read = hard fence
        return out

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _sync(device)
    t0 = time.perf_counter()
    out = call()  # the graph's capture (with its eager warm-up slice) and one rollout
    _sync(device)
    capture_seconds = time.perf_counter() - t0

    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        os.makedirs(args.trace, exist_ok=True)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        with profile(activities=acts) as prof:
            call()
            _sync(device)
        prof.export_chrome_trace(os.path.join(args.trace, "bench_sample_torch_trace.json"))

    times = []
    for _ in range(args.iters):
        _sync(device)
        t0 = time.perf_counter()
        out = call()
        _sync(device)
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    graph = model._slice_graph_slot.graph if model._slice_graph_slot is not None else None
    res = {
        "config": os.path.basename(args.config),
        "batch": B, "kv": args.kv, "seg": args.seg, "mm": args.mm,
        "attn": args.attn, "streams": args.streams,
        "class_num": args.class_num,
        "n_prime": n_prime,
        "seconds_median": round(med, 3),
        "seconds_min": round(min(times), 3),
        "seconds_max": round(max(times), 3),
        "frames_per_sec_per_chip": round(B * (T - n_prime) / med, 1),
        "weights": args.weights, "dtype": args.dtype, "greedy": args.greedy,
        "capture_seconds": round(capture_seconds, 3),
        "graph_capture_seconds": round(graph.capture_seconds, 3) if graph else None,
        "graph_nodes": graph.nodes if graph else None,
        "peak_memory_gb": (round(torch.cuda.max_memory_allocated(device) / 2 ** 30, 3)
                           if device.type == "cuda" else None),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }
    return res, model, params, video, out


def main(argv=None):
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: bench_sample_torch runs on the card")
    res = run(load_cfg(args), args, torch.device("cuda"))[0]
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
