#!/usr/bin/env python
"""Quality accounting of the int8 KV cache at DSFVT's full width, on the
PyTorch port (lvt_tpu_torch); the counterpart of tools/quality_int8.py,
with its options, defaults and JSON keys.

DSFVT (T = H = W = 16, nc = 4, nv = 512) is trained for --iters steps
through the port's ``Trainer`` on structured synthetic latents
(``make_latents``: a gradient background and two moving blocks per video;
random weights would give near-uniform logits and a flatter error than a
trained model), then cast to bf16 (the sampler's regime):

1. **Teacher-forced logit error**: logits through the KV-cached decoder
   (``VideoTransformer.logits_for_entire_video_incremental``) with a native
   and an int8 cache; per-pixel max relative error (mean / p99 / max over
   non-primed positions) and teacher-forced bits/dim under both, beside the
   anchor ``logits_for_entire_video`` (BitsEvaluator's masking: primed
   frames out).
2. **Greedy rollout divergence**: greedy ``sample_video`` from the same
   priming, native against int8 cache: the first differing step in the
   sampling order (slice -> raster -> channel) and the codes' agreement.
3. **Distributional bits/dim**: temperature-1.0 rollouts whose noise comes
   from the same ``torch.Generator`` state, native against int8 cache, each
   scored by the exact teacher-forced model.
4. **FVD_stub**: the native and int8 sample sets (same noise) against a
   held-out native set (other noise), through the stub feature net of
   ``lvt_tpu_torch/evaluation/fvd.py`` (not I3D; not comparable to
   published FVD).

On the card the training runs the fused layer (kernels 7, 8, 9), the
native teacher pass and rollouts kernels 1 and 2, the int8 ones kernel 1
(the int8 cache's attention is PyTorch's ops there, as in lvt_tpu's
default ``attn_impl="xla"``), the anchor and the scoring kernel 7.

--kv int4 measures the int4 cache the same way (packed int4 pairs, its
attention PyTorch's ops as the int8 cache's). --seg is accepted and ignored:
the port's cache is preallocated.
``--device cpu`` runs the whole tool on the CPU at the smoke sizes the
reference's --cpu picks (5 iterations, batches of 8 / 2 / 2).

Usage: python tools/quality_int8_torch.py [--iters 300] [--kv int8] [--device cpu] [KEY VALUE ...]
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

THW = (16, 16, 16)  # the latent video's (T, H, W)
LN2 = float(np.log(2.0))


def make_latents(n, nc, T, H, W, nv, seed=0):
    """Structured synthetic latent-code videos: a coherent gradient
    background plus two moving blocks, per-channel code offsets — enough
    spatio-temporal structure for DSFVT to learn non-trivial CE (the same
    idea as e2e_demo's moving-squares pixels, directly in code space)."""
    rng = np.random.default_rng(seed)
    vids = np.empty((n, nc, T, H, W), np.int32)
    yy, xx = np.mgrid[0:H, 0:W]
    for v in range(n):
        phase = rng.integers(0, nv)
        bg = ((xx * 7 + yy * 13 + phase) % (nv // 2)).astype(np.int64)
        x0, y0 = rng.integers(0, H - 4, 2)
        dx, dy = rng.integers(-2, 3, 2)
        x1, y1 = rng.integers(0, H - 3, 2)
        dx1, dy1 = rng.integers(-2, 3, 2)
        c0, c1 = rng.integers(nv // 2, nv, 2)
        for t in range(T):
            f = bg.copy()
            ax = int(np.clip(x0 + dx * t, 0, H - 4))
            ay = int(np.clip(y0 + dy * t, 0, H - 4))
            bx = int(np.clip(x1 + dx1 * t, 0, H - 3))
            by = int(np.clip(y1 + dy1 * t, 0, H - 3))
            f[ay:ay + 4, ax:ax + 4] = c0
            f[by:by + 3, bx:bx + 3] = c1
            for k in range(nc):
                vids[v, k, t] = (f + k * 37) % nv
    return vids


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=None,
                   help="DSFVT training iters (default 300, 5 with --device cpu)")
    p.add_argument("--kv", default="int8", choices=["int8", "int4"])
    p.add_argument("--seg", type=int, default=16,
                   help="accepted and ignored: the port's cache is preallocated")
    p.add_argument("--eval-batch", type=int, default=None,
                   help="videos for the teacher-forced comparison (default 8, 2 with "
                        "--device cpu)")
    p.add_argument("--sample-batch", type=int, default=None,
                   help="videos for the rollout comparisons (default 64, 2 with --device cpu)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cpu: the whole tool on the CPU at smoke sizes")
    p.add_argument("--fvd-stub", action=argparse.BooleanOptionalAction, default=True,
                   help="FVD_stub of the native and int8 temperature-1.0 sample sets "
                        "(same noise) against a held-out native set")
    p.add_argument("opts", nargs=argparse.REMAINDER,
                   help="KEY VALUE overrides of configs/vt/DSFVT.yaml")
    args = p.parse_args(argv)
    cpu = args.device == "cpu"
    if args.iters is None:
        args.iters = 5 if cpu else 300
    if args.eval_batch is None:
        args.eval_batch = 2 if cpu else 8
    if args.sample_batch is None:
        args.sample_batch = 2 if cpu else 64
    args.train_batch = 8 if cpu else 64
    return args


def load_cfg(opts=()):
    """configs/vt/DSFVT.yaml with KEY VALUE overrides (the tests narrow it)."""
    from lvt_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(ROOT, "configs", "vt", "DSFVT.yaml"))
    cfg.merge_from_list(list(opts))
    return cfg


def bits_per_dim(lg, video, n_prime):
    """Teacher-forced bits/dim of ``video`` (b, nc, T, H, W) under logits
    (b, T, H, W, nc, nv): BitsEvaluator's masking, primed frames out."""
    lg = lg.float()
    target = video.movedim(1, -1).long()  # (b, T, H, W, nc)
    T = video.shape[2]
    keep_b = (torch.arange(T, device=lg.device) >= n_prime).float()[None, :, None, None, None]
    ce = torch.logsumexp(lg, dim=-1) - torch.gather(lg, -1, target[..., None])[..., 0]
    return torch.sum(ce * keep_b) / torch.sum(keep_b.expand(ce.shape)) / LN2


def tf_metrics(ln, lq, lx, video, n_prime):
    """The reference's teacher-forced metrics (tools/quality_int8.py
    ``tf_metrics``): per-pixel max relative logit error of the quantized
    logits ``lq`` against the native ``ln`` over non-primed positions (mean,
    99th percentile, max), and the bits/dim under ``ln``, ``lq`` and the
    anchor ``lx``. Returns floats."""
    T = video.shape[2]
    keep_b = (torch.arange(T, device=ln.device) >= n_prime).float()[None, :, None, None, None]
    err = torch.amax(torch.abs(lq - ln), dim=-1)  # (b, T, H, W, nc)
    den = torch.amax(torch.abs(ln), dim=-1) + 1e-6
    rel = err / den
    w = keep_b.expand(rel.shape)
    rel_mean = torch.sum(rel * w) / torch.sum(w)
    rel_max = torch.amax(rel * w)
    # the -1 sentinel on masked entries sorts below every real value
    rel_p99 = torch.quantile(torch.where(w > 0, rel, -1.0).reshape(-1), 0.99)
    out = {"rel_mean": rel_mean, "rel_p99": rel_p99, "rel_max": rel_max,
           "bpd_native": bits_per_dim(ln, video, n_prime),
           "bpd_quant": bits_per_dim(lq, video, n_prime),
           "bpd_xla": bits_per_dim(lx, video, n_prime)}
    return {k: float(v) for k, v in out.items()}


def greedy_divergence(sn, sq, plan):
    """(steps, first differing step per video, code agreement) of two greedy
    rollouts (b, nc, T, H, W), in the sampling order slice -> raster ->
    channel."""
    sn, sq = np.asarray(sn), np.asarray(sq)
    b, nc = sn.shape[:2]
    order = np.asarray(plan.slice_src).reshape(plan.num_slices, -1)  # THW index
    seq_n = sn.reshape(b, nc, -1)[:, :, order.reshape(-1)]  # (b, nc, S*thw)
    seq_q = sq.reshape(b, nc, -1)[:, :, order.reshape(-1)]
    neq = (seq_n != seq_q).transpose(0, 2, 1).reshape(b, -1)  # (b, steps*nc)
    total = neq.shape[1]
    first = np.where(neq.any(axis=1), neq.argmax(axis=1), total)
    return total, first, float((sn == sq).mean())


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cfg, args, device):
    """The tool on ``device``; returns the JSON fields."""
    from lvt_tpu_torch.engine.trainer import Trainer
    from lvt_tpu_torch.models import cast_floats
    from lvt_tpu_torch.models.vt import VideoTransformer

    device = torch.device(device)
    T, H, W = THW
    vt = VideoTransformer(cfg, T=T, H=H, W=W)
    c = vt.c
    n_prime = cfg.TEST.VT_SAMPLER.N_PRIME
    data = make_latents(128, c.nc, T, H, W, c.nv, seed=0)
    rng = np.random.default_rng(1)

    class Loader:
        def __iter__(self):
            while True:
                yield {"video": data[rng.integers(0, len(data), size=args.train_batch)]}

    # ---- train on structured synthetic latents
    t0 = time.perf_counter()
    trainer = Trainer(cfg, Loader(), model=vt, device=device)
    trainer.train(0, args.iters)
    trainer.flush_metrics()
    ce_final = float(trainer.storage.history("loss_cross_entropy").median(min(20, args.iters)))
    print(f"[train] {args.iters} iters in {time.perf_counter() - t0:.0f}s; "
          f"CE -> {ce_final:.3f} nats (uniform {np.log(c.nv):.3f})", file=sys.stderr)
    with torch.no_grad():  # the sampler's regime: bf16, off the masters' graph
        params = cast_floats(trainer.state.params, torch.bfloat16)
    del trainer
    kv = args.kv

    # ---- 1. teacher-forced logit error and bits/dim
    t0 = time.perf_counter()
    eval_videos = torch.from_numpy(data[:args.eval_batch]).to(device)
    ln = vt.logits_for_entire_video_incremental(params, eval_videos, kv_cache_dtype="native")
    lq = vt.logits_for_entire_video_incremental(params, eval_videos, kv_cache_dtype=kv,
                                                kv_seg_size=args.seg)
    lx = vt.logits_for_entire_video(params, eval_videos)
    tf = tf_metrics(ln, lq, lx, eval_videos, n_prime)
    del ln, lq, lx  # (b, T, H, W, nc, nv) fp32 each
    print(f"[tf] teacher-forced compare in {time.perf_counter() - t0:.0f}s", file=sys.stderr)

    # ---- 2. greedy rollout divergence
    sample_videos = torch.from_numpy(data[:args.sample_batch]).to(device)

    def rollout(kvd, greedy, seed=7):
        gen = torch.Generator(device=device).manual_seed(seed)  # the same noise per seed
        with torch.no_grad():
            out = vt.sample_video(params, sample_videos, gen, n_prime=n_prime, greedy=greedy,
                                  kv_cache_dtype=kvd, kv_seg_size=args.seg)
        _sync(device)
        return out

    t0 = time.perf_counter()
    sn = rollout("native", True).cpu().numpy()
    sq = rollout(kv, True).cpu().numpy()
    print(f"[greedy] rollouts in {time.perf_counter() - t0:.0f}s", file=sys.stderr)
    total_steps, first_div, agree = greedy_divergence(sn, sq, vt._plan_for(T, H, W))

    # ---- 3. distributional bits/dim (temperature 1.0, the same noise)
    def score_chunked(videos, chunk=8):
        # whole-batch logits at b = 64 would be 8.6 GB of fp32: equal-size
        # chunks, whose mean of means is the batch's mean
        n = videos.shape[0]
        chunk = min(chunk, n)
        assert n % chunk == 0
        with torch.no_grad():
            return float(np.mean([
                float(bits_per_dim(vt.logits_for_entire_video(params, videos[i:i + chunk]),
                                   videos[i:i + chunk], n_prime))
                for i in range(0, n, chunk)]))

    t0 = time.perf_counter()
    tn = rollout("native", False)
    tq = rollout(kv, False)
    bpd_sampled_native = score_chunked(tn)
    bpd_sampled_quant = score_chunked(tq)
    print(f"[temp1] rollouts + scoring in {time.perf_counter() - t0:.0f}s", file=sys.stderr)

    # ---- 4. FVD_stub of the two sample sets against a held-out native set
    fvd = {}
    if args.fvd_stub:
        from lvt_tpu_torch.evaluation.fvd import fvd_from_features, make_stub_features

        t0 = time.perf_counter()
        heldout = rollout("native", False, seed=1234)
        feat_fn = make_stub_features(device)

        def codes_feats(codes):
            # (b, nc, T, H, W) codes -> (b, T, H, W, 3) pseudo-RGB in [0, 255]
            # (the first 3 channels; the same transform for every set)
            x = codes.movedim(1, -1).float()[..., :3] * (255.0 / max(c.nv - 1, 1))
            x = x.cpu().numpy()
            return np.concatenate([feat_fn(x[i:i + 8]) for i in range(0, x.shape[0], 8)])

        f_held, f_nat, f_q = codes_feats(heldout), codes_feats(tn), codes_feats(tq)
        fvd = {
            "fvd_stub_native_vs_heldout": round(fvd_from_features(f_held, f_nat), 5),
            "fvd_stub_quant_vs_heldout": round(fvd_from_features(f_held, f_q), 5),
            "fvd_stub_quant_vs_native_samekeys": round(fvd_from_features(f_nat, f_q), 5),
        }
        print(f"[fvd-stub] held-out rollout + features in {time.perf_counter() - t0:.0f}s",
              file=sys.stderr)

    out = {
        "mode": "quality_int8",
        "config": "DSFVT.yaml", "kv": kv, "seg": args.seg,
        "train_iters": args.iters, "train_ce_nats": round(ce_final, 4),
        "eval_batch": args.eval_batch, "sample_batch": args.sample_batch,
        "backend": device.type,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        # teacher-forced: the int8 cache's logit error
        "tf_logit_rel_err_mean": round(tf["rel_mean"], 5),
        "tf_logit_rel_err_p99": round(tf["rel_p99"], 5),
        "tf_logit_rel_err_max": round(tf["rel_max"], 5),
        "tf_bits_per_dim_native": round(tf["bpd_native"], 5),
        "tf_bits_per_dim_quant": round(tf["bpd_quant"], 5),
        "tf_bits_per_dim_xla_anchor": round(tf["bpd_xla"], 5),
        "tf_bits_per_dim_delta": round(tf["bpd_quant"] - tf["bpd_native"], 5),
        # greedy rollout: where the first code flips
        "greedy_total_steps": int(total_steps),
        "greedy_first_divergence_median": int(np.median(first_div)),
        "greedy_first_divergence_min": int(first_div.min()),
        "greedy_code_agreement": round(agree, 4),
        # distributional: bits/dim of sampled codes under the exact model
        "sampled_bits_per_dim_native_kv": round(bpd_sampled_native, 5),
        "sampled_bits_per_dim_quant_kv": round(bpd_sampled_quant, 5),
        "sampled_bits_per_dim_delta": round(bpd_sampled_quant - bpd_sampled_native, 5),
        **fvd,
    }
    return out


def main(argv=None):
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: quality_int8_torch runs on the card "
                         "(--device cpu for the CPU)")
    out = run(load_cfg(args.opts), args, torch.device(args.device))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
