#!/usr/bin/env python
"""Model-FLOPs utilization of the PyTorch port's training step on the card;
the counterpart of tools/mfu.py, with its options, defaults and JSON keys.

Times steady-state ``Trainer.train_step`` calls (forward + backward +
optimizer) on one batch already on the card, fenced by a host read of the
loss, and prints the achieved TFLOP/s and its share of the card's peak for
the compute dtype (lvt_tpu_torch/utils/device_specs.py: 989 TFLOP/s bf16,
67 fp32, 3.35 TB/s; NVIDIA H100 SXM). The port has no compiler cost
analysis: the FLOPs are the analytic matmul count of the VT step
(``_analytic_vt_train_flops``, the reference's function), named in the
output under ``flops_source``; the bytes a step moves are not counted
(``gbytes_per_step`` and the HBM keys are null), and a model other than the
VT gets no FLOPs.

Usage:
  python tools/mfu_torch.py --config configs/vt/DSFVT.yaml --batch 64      # fused (DSFVT's default)
  python tools/mfu_torch.py --remat-policy dots TPU.FUSED_LAYER False     # unfused, remat "dots"
  python tools/mfu_torch.py --trace <dir>                                  # torch.profiler trace
  python tools/mfu_torch.py --sample --kv native --batch 8 --measure       # the sampler's roofline
  python tools/mfu_torch.py SOLVER.OPT_STATE_DTYPE bfloat16                # KEY VALUE config overrides

``--sample`` is the reference's HBM-roofline accounting of the KV-cached
sampler, for the port's cache layout: one preallocated buffer of a block
run's rows, pixel p attending to its run's rows [0, p], so no segment
copies (``cache_concat_copies`` is 0 and --seg is accepted and ignored);
``--measure`` times ``sample_video`` (the rollout's CUDA graph) here.
``--kv int4`` counts the cache at half a byte an element, as the reference
does (the packed int4 pairs), with the int8 cache's per-row scales.
``--probe-dot`` (a probe of the TPU compiler's dot formulation) raises
NotImplementedError. ``--device cpu`` runs on the CPU (the tests; the
percentages mean nothing there).
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

FLOPS_SOURCE = ("analytic: _analytic_vt_train_flops (matmuls 2*M*N*K, forward + 2x "
                "backward; no compiler cost analysis in the port)")


def _analytic_vt_train_flops(model, batch: int, T: int = 16) -> float:
    """Matmul FLOPs (2*M*N*K) of one VT train step: forward + 2x backward.

    Per token per layer: qkv 6*d*nada, proj 2*nada*d, ffn 4*d^2, attention
    4*blk*nada; encoder and decoder each process one slice grid per sample.
    The channel predictor adds per-channel U/P matmuls on decoder tokens.
    """
    c = model.c
    t, h, w = model._plan_for(T, model.H, model.W).slice_shape
    thw = t * h * w
    d = c.d

    def stack_flops(tokens, blocks, heads):
        total = 0.0
        for blk, na in zip(blocks, heads):
            bt, bh, bw = blk
            nada = na * c.da
            per_token = 8 * d * nada + 4 * d * d + 4 * (bt * bh * bw) * nada
            total += tokens * per_token
        return total

    tokens = batch * thw
    fwd = stack_flops(tokens, c.blocks_e, c.n_head_e)
    fwd += stack_flops(tokens, c.blocks_d, c.n_head_d)
    # channel predictor: per channel k, U (d + k*nv, d) then P (d, nv)
    for k in range(c.nc):
        fwd += tokens * 2 * (d + k * c.nv) * d
        fwd += tokens * 2 * d * c.nv
    return 3.0 * fwd  # backward ~ 2x forward


def _device_kind(device):
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu (modeled as NVIDIA H100 SXM)"


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _trace(trace_dir, name, fn, device):
    """``fn()`` once under torch.profiler; its chrome trace into trace_dir."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        fn()
        _sync(device)
    path = os.path.join(trace_dir, name)
    prof.export_chrome_trace(path)
    return path


def sample_roofline(args, device):
    """Analytic HBM roofline of the KV-cached sampler's pixel step (the
    reference's ``_sample_roofline``, for the port's cache layout): every
    mandatory byte a pixel step moves and its GEMM FLOPs against the card's
    peaks, beside a measured rollout (--measure here, or --seconds)."""
    from lvt_tpu_torch.config import get_cfg
    from lvt_tpu_torch.models.vt import VideoTransformer
    from lvt_tpu_torch.models.vt_incremental import conv_tap_table
    from lvt_tpu_torch.utils.device_specs import PEAK_BYTES, PEAK_FLOPS

    if args.probe_dot:
        raise NotImplementedError(
            "--probe-dot times the TPU compiler's formulation of the cache dots: a TPU "
            "probe, not ported (ROADMAP queue 1: the TPU-only probes stay unported)")
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(ROOT, args.config))
    cfg.merge_from_list(list(args.opts))
    T, H, W = args.thw
    model = VideoTransformer(cfg, T=T, H=H, W=W)
    c = model.c
    plan = model._plan_for(T, H, W)
    t, h, w = plan.slice_shape
    thw = t * h * w
    b = args.batch
    L = len(c.blocks_d)
    na, da, d, de = c.n_head_d[0], c.da, c.d, c.de
    nada = na * da
    act = 2 if args.dtype == "bfloat16" else 4
    kv_bytes = {"int8": 1.0, "int4": 0.5, "native": float(act)}[args.kv]

    # --- schedule: one buffer of a block run's R rows, pixel p of a run
    # attends to rows [0, p]
    blocks = [tuple(x) for x in c.blocks_d]
    bt0, bh0, bw0 = blocks[0]
    block_local = len(set(blocks)) == 1 and bh0 == h and bw0 == w and t % bt0 == 0
    blk_run = bt0 * h * w if block_local else thw
    mean_cl = (blk_run + 1) / 2.0

    n_prime = args.n_prime if args.n_prime else cfg.TEST.VT_SAMPLER.N_PRIME
    frames = np.asarray(plan.slice_src).reshape(plan.num_slices, -1) // (H * W)
    sampled_slices = int(np.sum(~(frames < n_prime).all(axis=1)))
    steps = sampled_slices * thw

    nbr_np, _ = conv_tap_table((t, h, w))
    Kp = nbr_np.shape[1]  # unmasked causal-conv taps

    # --- bytes per pixel step (averaged over the rollout)
    row = 2 * L * b * na * da * kv_bytes          # one K+V row, all layers
    scale_row = 2 * L * b * na * act              # per-row absmax scales
    int8 = args.kv in ("int8", "int4")  # a quantized cache: per-row scales
    terms = {}
    terms["kv_cache_reads"] = 2 * L * b * na * mean_cl * da * kv_bytes
    terms["kv_scale_reads"] = 2 * L * b * na * mean_cl * act if int8 else 0.0
    terms["kv_cache_writes"] = row + (scale_row if int8 else 0.0)
    terms["cache_concat_copies"] = 0.0  # preallocated: the cache never grows
    # weight stream: every per-pixel matmul re-reads its weights each step
    wqkv = d * 3 * nada
    per_layer_w = wqkv + nada * d + 2 * d * d + (8 * d)  # + biases/LN rows
    pred_w = sum((d + k * c.nv) * d + d * c.nv for k in range(c.nc)) + 4 * d
    conv_w = Kp * de * d
    terms["weight_stream"] = (L * per_layer_w + pred_w + conv_w) * act
    # per-step row traffic: conv-tap emb gather, emb row write, zlproj row,
    # pos row, channel-embedding rows for the sampled codes
    terms["emb_conv_gather"] = b * Kp * de * act
    terms["emb_row_write"] = b * de * act + b * c.nc * de * act
    terms["zlproj_row"] = b * d * act
    terms["bias_rows"] = L * na * mean_cl * 4.0
    # sampler tail: nc channel logits (fp32) + categorical draw workspace
    terms["pred_logits"] = b * c.nc * c.nv * 4.0
    # per-slice costs amortized over the thw steps of the slice: zl written
    # by the encoder, then zlproj written and read
    terms["zl_zlproj_slice"] = (3 * b * thw * d * act) / thw
    # per-slice context encode: the strided-window index stack and the
    # gathered embedding rows (nc * K rows of de a position)
    kt, kh, kw = c.kernel
    ncK = c.nc * kt * kh * kw
    st_, sh_, sw_ = c.stride
    ctx_vol = ((t - 1) * st_ + kt) * ((h - 1) * sh_ + kh) * ((w - 1) * sw_ + kw)
    terms["ctx_gidx_slice"] = (2 * b * ncK * thw * 4 + b * c.nc * ctx_vol * 4) / thw
    terms["ctx_table_rows_slice"] = (b * thw * ncK * de * act) / thw
    # not in the sum: an unfused accumulation chain's round trips, an upper
    # bound on formulation overhead
    chain_acc_bound = 2 * ncK * b * thw * de * act / thw
    bytes_per_step = float(sum(terms.values()))

    # --- FLOPs per pixel step
    flops = b * L * 2.0 * (wqkv + nada * d + 2 * d * d)        # GEMMs
    flops += b * L * 2 * 2 * na * mean_cl * da                 # QK^T + PV
    flops += b * 2.0 * (sum((d + k * c.nv) * d + d * c.nv for k in range(c.nc)))
    flops += b * 2.0 * Kp * de * d                             # causal conv
    enc = 0.0  # per-slice encoder forward + zlproj GEMM, amortized per step
    for blk, nh in zip(c.blocks_e, c.n_head_e):
        bt, bh, bw = blk
        enc += b * thw * (8 * d * nh * da + 4 * d * d + 4 * (bt * bh * bw) * nh * da)
    enc += b * thw * 2 * d * d  # zlproj
    flops_per_step = flops + enc / thw

    peak, peak_bw = PEAK_FLOPS[args.dtype] / 1e12, PEAK_BYTES / 1e9
    t_bytes = bytes_per_step / (peak_bw * 1e9)
    t_flops = flops_per_step / (peak * 1e12)
    t_sol = max(t_bytes, t_flops)

    measured = None
    if args.seconds:
        measured = args.seconds / steps
    elif args.measure:
        from lvt_tpu_torch.models import cast_floats

        params, _ = model.init(torch.Generator().manual_seed(0), device)
        if args.dtype == "bfloat16":
            params = cast_floats(params, torch.bfloat16)
        rng = np.random.default_rng(0)
        video = torch.from_numpy(rng.integers(0, c.nv, size=(b, c.nc, T, H, W))).to(device)

        def rollout(seed):
            gen = torch.Generator(device=device).manual_seed(seed)
            with torch.no_grad():
                out = model.sample_video(params, video, gen, n_prime=n_prime,
                                         kv_cache_dtype=args.kv, kv_seg_size=args.seg)
            int(out[0, 0, -1, 0, 0])  # host read = fence
            return out

        rollout(7)  # the graph's capture (with its eager warm-up slice) and one rollout
        times = []
        for i in range(args.iters):
            t0 = time.perf_counter()
            rollout(7 + i)
            times.append(time.perf_counter() - t0)
        measured = float(np.median(times)) / steps
        if args.trace:  # one more, untimed, rollout under the profiler
            _trace(args.trace, "mfu_torch_sample_trace.json", lambda: rollout(10_000), device)

    out = {
        "mode": "sample_roofline",
        "config": os.path.basename(args.config),
        "batch": b, "kv": args.kv, "seg": args.seg, "dtype": args.dtype,
        "blk_run": blk_run, "mean_cache_rows": round(mean_cl, 1),
        "pixel_steps": steps, "sampled_slices": sampled_slices,
        "bytes_per_step_mb": {k: round(v / 1e6, 2) for k, v in terms.items()},
        "total_mb_per_step": round(bytes_per_step / 1e6, 1),
        "ctx_chain_acc_unfused_bound_mb": round(chain_acc_bound / 1e6, 2),
        "gflops_per_step": round(flops_per_step / 1e9, 2),
        "sol_step_ms": round(t_sol * 1e3, 3),
        "sol_bytes_ms": round(t_bytes * 1e3, 3),
        "sol_flops_ms": round(t_flops * 1e3, 3),
        "device_kind": _device_kind(device), "peak_gbps": peak_bw,
    }
    if measured is not None:
        out["measured_step_ms"] = round(measured * 1e3, 3)
        out["hbm_gbps"] = round(bytes_per_step / measured / 1e9, 1)
        out["hbm_util_pct"] = round(100.0 * bytes_per_step / measured / (peak_bw * 1e9), 1)
        out["sol_fraction"] = round(t_sol / measured, 3)
        out["fps_per_chip"] = round(b * (T - n_prime) / (measured * steps), 1)
        out["fps_at_sol"] = round(b * (T - n_prime) / (t_sol * steps), 1)
    return out


def train_mfu(args, device):
    """Seconds a train step and the achieved TFLOP/s against the peak of the
    compute dtype; the reference's keys."""
    from lvt_tpu_torch.config import get_cfg
    from lvt_tpu_torch.engine.trainer import Trainer
    from lvt_tpu_torch.utils.device_specs import PEAK_FLOPS

    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(ROOT, args.config))
    cfg.SOLVER.IMS_PER_BATCH = args.batch
    if args.remat or args.remat_policy:
        cfg.TPU.REMAT = True
        cfg.TPU.REMAT_POLICY = args.remat_policy
    if args.no_remat:
        cfg.TPU.REMAT = False
    if args.fused:
        cfg.TPU.FUSED_LAYER = True
    if args.dtype:
        cfg.TPU.COMPUTE_DTYPE = args.dtype
    cfg.VIS_PERIOD = 0
    cfg.merge_from_list(list(args.opts))

    rng = np.random.default_rng(0)
    is_vt = cfg.MODEL.META_ARCHITECTURE == "VideoTransformerModel"
    # the training geometry: the mapper's temporal crop length (DSSVT
    # trains on 4-frame clips, DSFVT on 16)
    vT = cfg.INPUT.N_FRAMES_PER_VIDEO_TRAIN
    v = cfg.MODEL.AUTOREGRESSIVE.VT
    H, W = args.thw[1:]

    class Loader:
        def __iter__(self):
            while True:
                if is_vt:
                    yield {"video": rng.integers(
                        0, v.NV, size=(args.batch, v.NC, vT, H, W)).astype(np.int32)}
                else:
                    yield {"image": rng.random((args.batch, 64, 64, 3)).astype(np.float32)}

    trainer = Trainer(cfg, Loader(), device=device)
    flops_per_step = (_analytic_vt_train_flops(trainer.model, args.batch, T=vT)
                      if is_vt else None)
    # one batch on the card, reused: no host draw or transfer in the timed loop
    batch = trainer._put_batch(next(iter(Loader())))

    def steps(n):
        for _ in range(n):
            metrics = trainer.train_step(batch)
        float(next(iter(metrics.values())))  # host read = hard fence

    if device.type == "cuda":  # this run's own peak, not the process's
        torch.cuda.reset_peak_memory_stats(device)
    steps(3)  # warm-up: first launches, cuBLAS, the kernels' libraries
    t0 = time.perf_counter()
    steps(args.steps)
    dt = (time.perf_counter() - t0) / args.steps
    if args.trace:  # one more step under the profiler, untimed
        _trace(args.trace, "mfu_torch_train_trace.json", lambda: steps(1), device)

    dtype = cfg.TPU.COMPUTE_DTYPE if cfg.TPU.COMPUTE_DTYPE in PEAK_FLOPS else "float32"
    peak = PEAK_FLOPS[dtype] / 1e12
    tflops = flops_per_step / dt / 1e12 if flops_per_step else None
    return {
        "config": os.path.basename(args.config),
        "batch": args.batch,
        "remat": bool(cfg.TPU.REMAT),
        "remat_policy": cfg.TPU.REMAT_POLICY,
        "fused_layer": bool(cfg.TPU.FUSED_LAYER),
        "compute_dtype": cfg.TPU.COMPUTE_DTYPE,
        "opt_state_dtype": cfg.SOLVER.OPT_STATE_DTYPE,
        "device_kind": _device_kind(device),
        "s_per_it": round(dt, 4),
        "gflops_per_step": round(flops_per_step / 1e9, 1) if flops_per_step else None,
        "flops_source": FLOPS_SOURCE if flops_per_step else None,
        "achieved_tflops": round(tflops, 1) if tflops else None,
        "peak_tflops": peak,
        "mfu_pct": round(100.0 * tflops / peak, 1) if tflops else None,
        "gbytes_per_step": None,  # no count of the bytes a step moves
        "hbm_gbps": None,
        "hbm_util_pct": None,
        "samples_per_sec": round(args.batch / dt, 1),
        "peak_memory_gb": (round(torch.cuda.max_memory_allocated(device) / 2 ** 30, 3)
                           if device.type == "cuda" else None),
    }


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="configs/vt/DSFVT.yaml")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--remat", action="store_true")
    p.add_argument("--no-remat", action="store_true")
    p.add_argument("--remat-policy", default="",
                   help="TPU.REMAT_POLICY ('dots' = save the products, 'qkv' = save q/k/v); "
                        "implies --remat")
    p.add_argument("--fused", action="store_true",
                   help="TPU.FUSED_LAYER True: the fused layer, kernels 7-9 (the default)")
    p.add_argument("--dtype", default=None, help="override TPU.COMPUTE_DTYPE")
    p.add_argument("--trace", default="", help="write a torch.profiler chrome trace here")
    p.add_argument("--sample", action="store_true",
                   help="HBM-roofline accounting of the KV-cached sampler instead of the "
                        "train step")
    p.add_argument("--kv", default="int8", choices=["native", "int8", "int4"],
                   help="[--sample] KV-cache storage dtype")
    p.add_argument("--seg", type=int, default=16,
                   help="[--sample] accepted and ignored: the port's cache is preallocated")
    p.add_argument("--n-prime", type=int, default=0,
                   help="[--sample] priming frames (0 = config value)")
    p.add_argument("--seconds", type=float, default=0.0,
                   help="[--sample] measured rollout seconds from a bench capture")
    p.add_argument("--measure", action="store_true",
                   help="[--sample] time sample_video here")
    p.add_argument("--iters", type=int, default=3,
                   help="[--sample --measure] timed iterations")
    p.add_argument("--probe-dot", action="store_true",
                   help="[--sample] a TPU probe: refused")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("opts", nargs=argparse.REMAINDER, help="KEY VALUE config overrides")
    args = p.parse_args(argv)
    args.thw = (16, 16, 16)  # the latent grid of the shipped pipeline
    return args


def run(args):
    device = torch.device(args.device)
    if args.sample:
        if args.dtype is None:
            args.dtype = "bfloat16"
        return sample_roofline(args, device)
    return train_mfu(args, device)


def main(argv=None):
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: mfu_torch runs on the card (--device cpu for the CPU)")
    out = run(args)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
