#!/usr/bin/env python
"""Chip smoke test of the PyTorch port (lvt_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):
  1. device   — a CUDA card must be present; prints nvidia-smi's name and
                power limit.
  2. build    — compiles lvt_tpu_torch/csrc/*.cu with nvcc for sm_90a.
  3. kernels  — each kernel against its plain PyTorch version on the card at
                DSFVT shapes, with the tolerances below; times both.
  4. main     — the generation path (PR-DVQVAE2 encode of example/*.png, DSFVT
                KV-cached rollout, decode) at full width with seeded random
                weights: batch 1 through scripts/generate_videos_torch.py as a
                user runs it, and batch 8 with the VT in bf16. Kernel launch
                counts are read around this phase only.
  5. agree    — fp32, batch 2, full width: teacher-forced vt_logits (kernel 1
                causal and not) and the incremental decoder's teacher logits
                (kernel 2) on the card against the plain path on the CPU,
                and a control run of vt_logits with TF32 on that must
                fall outside the bound.
  6. train kernels — kernel 10 (the attention backward) and kernel 1 against
                their plain versions at DSFVT training shapes (nb=64), fp32
                and bf16, causal and not; device times; kernel 10's outputs
                bit-identical across two calls.
  7. fused kernels — kernels 7, 8 and 9 (the fused layer: forward with and
                without x2, FFN-half backward, attention-half backward)
                against their plain versions at nb=64, n=256, d=512, na=8,
                fp32 and bf16, causal and not; two calls bit-identical;
                device times beside the plain versions' and the unfused
                layer's (kernel 1 + the library's GEMMs; with kernel 10 in
                the backward).
  8. train    — tools/train_net_torch.py's main on configs/vt/DSFVT.yaml at
                batch 64, bf16 compute, RMSprop, on latent videos written
                from a numpy seed, then --resume from its checkpoint, twice:
                with DSFVT's defaults (TPU.FUSED_LAYER True: the fused layer,
                20 + 4 steps, exactly 16 launches each of kernels 7, 8 and 9
                per step and none of kernels 1 and 10), and with
                TPU.FUSED_LAYER False (per-layer remat, 10 + 2 steps, exactly
                32 kernel-1 and 16 kernel-10 launches per step). Finite
                losses; device time by kernel of the last step
                (torch.profiler). The launch counts of kernels 7-10 are read
                around each run only.
  9. train agree — one fp32 loss and backward at batch 2, full width, with
                and without the fused layer: the loss and every gradient leaf
                on the card against the plain path on the CPU, fused against
                unfused on the card, and the unfused step with TF32 on, which
                must fall outside the bound.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# tolerances, |kernel - plain| on the same inputs (kernel 2; kernels 1 and
# 10 take fwd_tol and bwd_tol below):
#   fp32: sums in another order only.
#   bf16: plus one rounding of the output to bf16 and of P to bf16 at a
#   boundary the two versions may cross differently (2^-7 relative).
TOL = {"float32": (1e-4, 0.0), "bfloat16": (1e-3, 2 ** -7)}  # (abs, rel)
# whole path, fp32, card vs CPU: 16 layers of GEMMs summed in other orders
# (sound runs read ~3e-6 at |logits| <= 2.6). Phase 5 also runs vt_logits
# once with TF32 allowed and fails unless that control reads above the bound,
# so a path whose precision drops below fp32 cannot pass.
PATH_TOL = 2e-5
# kernel 10's dbias, |kernel - plain|: fp32 in both dtypes, a sum over nb
# blocks of fp32 terms taken in another order (1e-4 + 1e-5 relative)
DBIAS_TOL = (1e-4, 1e-5)


def fwd_tol(dtype, v):
    """Kernel 1's output, |kernel - plain|: fp32 as TOL; bf16 one rounding
    of the output (2^-7 relative) plus P rounded to bf16 on the other side
    of a boundary: the two versions' fp32 p may differ by an fp32 ulp, and
    where that straddles a bf16 boundary the term p * v moves by
    ulp_bf16(p) * |v| <= 2^-8 * max|v| (p <= 1). At nb=64 (131,072 rows)
    such rows land on small outputs, beyond TOL's relative part."""
    if dtype == "float32":
        return TOL[dtype]
    return (2 ** -8 * float(v.float().abs().max()), 2 ** -7)


def bwd_tol(dtype, ref):
    """Kernel 10's dq, dk, dv, |kernel - plain|: fp32 as TOL; bf16 one
    rounding of the output (2^-7 relative) plus one bf16 rounding at the
    output's largest value (2^-8 of it): where the two versions' fp32 dp
    land on either side of a bf16 boundary, one rounded ds term of
    |ds| up to ~4 moves a dq or dk sum by up to ulp(ds) * |k| / sqrt(da)."""
    if dtype == "float32":
        return TOL[dtype]
    return (2 ** -8 * float(ref.float().abs().max()), 2 ** -7)


# train agree, fp32: per gradient leaf, ||card - cpu|| / ||cpu|| (Frobenius;
# the denominator floored at 1e-2 of the largest leaf norm, for leaves whose
# gradient cancels to float noise). The gradient of the VT is not smooth in
# its inputs: a forward that moves by fp32 rounding flips ReLU gates whose
# input sits near 0, and each flip moves one FFN column by a whole token's
# share. On the CPU, scaling every weight by 1 + 1e-6 N(0, 1) (the size of
# the card's fp32 logits error) moves the worst leaf by 3.5e-3, and by 1e-3
# moves it by 7.6e-2 (TF32's logits error is ~1e-3 relative). The bound
# sits between; the TF32 control must read above it. The whole gradient
# (all leaves as one vector, same relative measure) averages the flips out
# and separates the two further: its bound, GRAD_TOL_WHOLE, holds too.
GRAD_TOL = 2e-2
GRAD_TOL_WHOLE = 5e-3
TRAIN_STEPS, RESUME_STEPS = 20, 4  # the fused run; the unfused run takes half

# NVIDIA H100 SXM peaks (NVIDIA's data sheet, dense): the roofs of bound_ms
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def bound_ms(dtype, nbytes, flops):
    """The least time the card could take: the bytes the function must move
    (each input read once, each output written once) over the memory rate,
    or its operations over the peak rate for their type, whichever is
    larger. Returns (ms, "bytes" or "operations")."""
    tb, tf = 1e3 * nbytes / PEAK_BYTES, 1e3 * flops / PEAK_FLOPS[dtype]
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def fused_tol(dtype, ref, summed=False):
    """Kernels 7, 8 and 9, |kernel - plain| against the output's largest
    value. fp32: sums of up to 3,072 terms in another order (2e-5), and for
    the weight and bias gradients sums over 16,384 rows (1e-4). bf16: one
    rounding of the output (2^-8) plus intermediates (qkv, P, f, ds, dqkv)
    that the two versions' fp32 values put on either side of a bf16
    boundary; each moves an output by a bf16 ulp of one term: 2^-6."""
    rel = 2 ** -6 if dtype == "bfloat16" else (1e-4 if summed else 2e-5)
    return (rel * max(float(ref.float().abs().max()), 1e-3), 0.0)

N_PRIME, T_FRAMES = 5, 16


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def host_ms(calls, iters):
    """Time per call with the host's share: CUDA events around `iters`
    eager calls, cycling through `calls`."""
    import torch

    for f in calls:
        f()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(iters):
        calls[i % len(calls)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(calls, iters):
    """Device time per call: `iters` calls, cycling through `calls`, captured
    in one CUDA graph and replayed between two CUDA events, so the host's
    per-call cost drops out."""
    import torch

    for f in calls:
        f()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for i in range(iters):
            calls[i % len(calls)]()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def time_both(card, kernel_calls, plain_calls, iters, what=""):
    """(kernel device ms, plain device ms) per call, printed beside the
    per-call times with the host's share. The calls cycle through input
    sets that together exceed the 50 MB L2, as the rollout's calls find
    their inputs mostly outside it."""
    kd, pd = device_ms(kernel_calls, iters), device_ms(plain_calls, iters)
    kh, ph = host_ms(kernel_calls, iters), host_ms(plain_calls, iters)
    print(f"  time {what}[{card}]: device kernel {kd:.4f} ms, plain {pd:.4f} ms; "
          f"per call with host kernel {kh:.4f} ms, plain {ph:.4f} ms")
    return kd, pd


def sdpa_mask(bias, dtype, causal):
    """The bias (and a causal -inf) as scaled_dot_product_attention's
    attn_mask, (1, na, n, n) in q's dtype."""
    import torch

    mask = bias.to(dtype)[None]
    if causal:
        n = bias.shape[-1]
        mask = mask.masked_fill(torch.ones((n, n), dtype=torch.bool,
                                           device=bias.device).triu(1), float("-inf"))
    return mask


def library_fwd_ms(sets, causal, iters):
    """Device time of torch.nn.functional.scaled_dot_product_attention on
    kernel 1's inputs: the library's one call for the same function, except
    that it rounds P where its own kernels choose. A yardstick only: the port
    never calls it."""
    import torch.nn.functional as F

    masks = [sdpa_mask(x[3], x[0].dtype, causal) for x in sets]
    return device_ms([lambda x=x, m=m: F.scaled_dot_product_attention(x[0], x[1], x[2],
                                                                      attn_mask=m)
                      for x, m in zip(sets, masks)], iters)


def library_bwd_ms(sets, causal, iters):
    """Time of the autograd backward of scaled_dot_product_attention (dq, dk,
    dv and the mask's gradient) on kernel 10's inputs, by CUDA events around
    eager calls (device-bound at these shapes). A yardstick only."""
    import torch
    import torch.nn.functional as F

    calls = []
    for q, k, v, bias, g in sets:
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v, bias.to(q.dtype))]
        out = F.scaled_dot_product_attention(*leaves[:3],
                                             attn_mask=sdpa_mask(leaves[3], q.dtype, causal))
        calls.append(lambda out=out, leaves=leaves, g=g: torch.autograd.grad(
            out, leaves, g, retain_graph=True))
    return host_ms(calls, iters)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: the port's kernels need a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return card


def phase_build():
    from lvt_tpu_torch.ops._lib import LIBRARY

    t0 = time.perf_counter()
    LIBRARY.get()
    print(f"build: {time.perf_counter() - t0:.2f} s ({LIBRARY.build_seconds:.2f} s nvcc) "
          f"-> {os.path.relpath(LIBRARY.path, ROOT)}")
    for line in LIBRARY.build_log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print("  ptxas: " + line.strip())


def _err(k, p, dtype, tol=None):
    atol, rtol = tol or TOL[dtype]
    diff = (k.float() - p.float()).abs()
    ok = bool(((diff <= atol + rtol * p.float().abs()) & k.float().isfinite()).all())
    return float(diff.max()), ok


def phase_kernels(card):
    import torch

    from lvt_tpu_torch.ops.attention import attention_core_plain, block_attention_fwd_cuda
    from lvt_tpu_torch.ops.cache_attention import decode_attention_cuda, decode_attention_plain

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    res = {}

    nb, na, n, da = 16, 8, 256, 128
    err1, t1 = 0.0, {}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        sets = [[torch.randn((nb, na, n, da), generator=g, device=dev).to(dt) for _ in range(3)]
                + [0.5 * torch.randn((na, n, n), generator=g, device=dev)] for _ in range(3)]
        for causal in (False, True):
            q, k, v, bias = sets[0]
            out = block_attention_fwd_cuda(q, k, v, bias, causal)
            ref = attention_core_plain(q, k, v, bias, causal)
            torch.cuda.synchronize()
            e, ok = _err(out, ref, dtype, fwd_tol(dtype, v))
            print(f"kernel 1 block_attention_fwd {dtype} causal={causal} "
                  f"(nb={nb}, na={na}, n={n}, da={da}): max_abs_err {e:.3g}")
            check(ok, f"block_attention_fwd disagrees with its plain version ({dtype}, "
                      f"causal={causal}): max abs err {e}")
            err1 = max(err1, e)
            t1[(dtype, causal)] = time_both(
                card, [lambda x=x: block_attention_fwd_cuda(*x, causal) for x in sets],
                [lambda x=x: attention_core_plain(*x, causal) for x in sets], 30)
            if dtype == "bfloat16" and not causal:
                lib1 = library_fwd_ms(sets, causal, 30)
    io = nb * na * n * da
    b1, by1 = bound_ms("bfloat16", 4 * io * 2 + na * n * n * 4, 4 * io * n)
    print(f"  kernel 1 bf16 nb={nb}: bound {b1:.4f} ms ({by1}); library call "
          f"(scaled_dot_product_attention, bias as attn_mask) {lib1:.4f} ms [{card}]")
    res["block_attention_fwd"] = dict(zip(("ms", "plain_ms"), t1[("bfloat16", False)]),
                                      err=err1, bound_ms=b1, bound_by=by1, library_ms=lib1)

    b, R = 16, 256
    err2, t2 = 0.0, {}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        q = torch.randn((b, na, da), generator=g, device=dev).to(dt)
        bias = 0.5 * torch.randn((na, R), generator=g, device=dev)
        for live in (1, 17, 255, 256):
            sets = []
            for _ in range(4 if live in (17, 256) else 1):
                kc = torch.randn((b, na, R, da), generator=g, device=dev).to(dt)
                vc = torch.randn((b, na, R, da), generator=g, device=dev).to(dt)
                kc[:, :, live:] = float("nan")  # rows >= live must never be read
                vc[:, :, live:] = float("nan")
                sets.append((kc, vc))
            kc, vc = sets[0]
            out = decode_attention_cuda(q, kc, vc, live, bias, da ** -0.5)
            ref = decode_attention_plain(q, kc, vc, live, bias, da ** -0.5)
            torch.cuda.synchronize()
            e, ok = _err(out, ref, dtype)
            print(f"kernel 2 decode_attention {dtype} live={live} "
                  f"(b={b}, na={na}, R={R}, da={da}): max_abs_err {e:.3g}")
            check(ok, f"decode_attention disagrees with its plain version ({dtype}, "
                      f"live={live}): max abs err {e}")
            err2 = max(err2, e)
            if len(sets) > 1:
                t2[(dtype, live)] = time_both(
                    card,
                    [lambda c=c: decode_attention_cuda(q, *c, live, bias, da ** -0.5) for c in sets],
                    [lambda c=c: decode_attention_plain(q, *c, live, bias, da ** -0.5) for c in sets],
                    200)
    # the library's call on the same inputs (bf16, live = 256)
    import torch.nn.functional as F

    mask = bias.to(dt)[None, :, None, :]
    lib2 = device_ms([lambda c=c: F.scaled_dot_product_attention(
        q[:, :, None], c[0], c[1], attn_mask=mask, scale=da ** -0.5) for c in sets], 200)
    b2, by2 = bound_ms("bfloat16", (2 * b * na * R * da + 2 * b * na * da) * 2 + na * R * 4,
                       4 * b * na * R * da)
    print(f"  kernel 2 bf16 b={b} live={R}: bound {b2:.4f} ms ({by2}); library call "
          f"(scaled_dot_product_attention) {lib2:.4f} ms [{card}]")
    res["decode_attention"] = dict(zip(("ms", "plain_ms"), t2[("bfloat16", 256)]), err=err2,
                                   bound_ms=b2, bound_by=by2, library_ms=lib2)
    return res


def _counts():
    from lvt_tpu_torch.ops.attention import block_attention_fwd_cuda
    from lvt_tpu_torch.ops.cache_attention import decode_attention_cuda

    return block_attention_fwd_cuda.launches, decode_attention_cuda.launches


def _reset_counts():
    from lvt_tpu_torch.ops.attention import block_attention_fwd_cuda
    from lvt_tpu_torch.ops.cache_attention import decode_attention_cuda

    block_attention_fwd_cuda.launches = 0
    decode_attention_cuda.launches = 0


def _check_run(label, video, codes, primed, nv, b):
    import torch

    check(tuple(video.shape) == (b, T_FRAMES, 64, 64, 3), f"{label}: video shape {video.shape}")
    check(bool(torch.isfinite(video).all()), f"{label}: non-finite frames")
    check(float(video.min()) >= 0.0 and float(video.max()) <= 1.0, f"{label}: frames outside [0, 1]")
    check(bool((codes[:, :, :N_PRIME] == primed).all()), f"{label}: primed codes changed")
    check(int(codes.min()) >= 0 and int(codes.max()) < nv, f"{label}: codes outside [0, {nv})")


def phase_main(card):
    import torch

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import generate_videos_torch as gvt

    cfg_file = os.path.join(ROOT, "configs", "vt", "DSFVT.yaml")
    example = os.path.join(ROOT, "example")
    out_dir = os.path.join(ROOT, "output", "chip_smoke")
    n_slices = T_FRAMES - N_PRIME
    per_run = (n_slices * 8, n_slices * 256 * 8)  # encoder layers, pixels x decoder layers

    _reset_counts()  # the counts cover phase 4 only
    video, codes, primed, seconds = gvt.main(
        ["--config-file", cfg_file, "--video-dir", example, "--seed", "0",
         "OUTPUT_DIR", out_dir])
    launches = _counts()
    _check_run("batch 1", video, codes, primed, 512, 1)
    check(launches[0] >= per_run[0] and launches[1] >= per_run[1],
          f"batch 1: kernel launches {launches}, want at least {per_run}")
    print(f"main path batch 1 fp32 [{card}]: rollout {seconds:.3f} s, "
          f"{n_slices / seconds:.3f} generated frames/s; launches {launches}")

    cfg = gvt.load_config(cfg_file)
    dev = torch.device("cuda")
    models = gvt.build_models(cfg, 0, dev, torch.bfloat16)
    frames = torch.from_numpy(gvt.load_priming_frames(example, N_PRIME)).to(dev)
    b = 8
    gen = torch.Generator(device=dev).manual_seed(0)
    before = _counts()
    video, codes, primed, seconds = gvt.generate(
        *models, frames[None].expand(b, *frames.shape).contiguous(), N_PRIME, gen)
    total = _counts()
    launches = (total[0] - before[0], total[1] - before[1])
    _check_run("batch 8", video, codes, primed, 512, b)
    check(launches[0] >= per_run[0] and launches[1] >= per_run[1],
          f"batch 8: kernel launches {launches}, want at least {per_run}")
    print(f"main path batch 8 bf16 [{card}]: rollout {seconds:.3f} s, "
          f"{b * n_slices / seconds:.3f} generated frames/s; launches {launches}")
    return total, models, codes


def phase_profile(card, models, codes):
    """Where the time of one slice of the batch-8 bf16 rollout goes: wall
    time with and without torch.profiler, the device's busy share, and
    device time by kernel."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lvt_tpu_torch.models.vt import vt_encode
    from lvt_tpu_torch.models.vt_incremental import sample_slice_incremental

    *_, vt, params = models
    c, plan, s = vt.c, vt.plan, N_PRIME
    b = codes.shape[0]
    gen = torch.Generator(device=codes.device).manual_seed(0)
    primed = np.zeros(plan.slice_src[s].size, bool)

    def one_slice():
        sidx = torch.full((b,), s, dtype=torch.int64, device=codes.device)
        ctx, sl, _ = vt.prepare_slices(codes, sidx)
        zl = vt_encode(params["netG"], c, ctx, sidx)
        sample_slice_incremental(params["netG"], c, plan.slice_shape, zl, sl, gen, primed, 1.0)
        torch.cuda.synchronize()

    with torch.no_grad():
        t0 = time.perf_counter()
        one_slice()
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            one_slice()
            wall_prof = time.perf_counter() - t0
    kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e6
    by_name = {}
    for e in kern:
        tot, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.elapsed_us() / 1e3, cnt + 1)
    print(f"profile, one slice (256 pixels) of the batch-{b} bf16 rollout [{card}]: "
          f"wall {wall:.3f} s ({wall_prof:.3f} s under the profiler), device busy "
          f"{busy:.3f} s = {100 * busy / wall_prof:.1f}% of the profiled wall time, "
          f"{len(kern)} device activities")
    for name, (tot, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"  {tot:9.2f} ms {cnt:7d}x  {name[:110]}")


def phase_agree(card):
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import generate_videos_torch as gvt
    from lvt_tpu_torch.models import to_device
    from lvt_tpu_torch.models.vt import vt_encode, vt_logits
    from lvt_tpu_torch.models.vt_incremental import sample_slice_incremental

    cfg = gvt.load_config(os.path.join(ROOT, "configs", "vt", "DSFVT.yaml"))
    dev = torch.device("cuda")
    *_, vt, params = gvt.build_models(cfg, 1, dev, torch.float32)
    netg = params["netG"]
    netg_cpu = to_device(netg, "cpu")
    c, plan = vt.c, vt.plan
    video = np.random.default_rng(0).integers(0, c.nv, size=(2, c.nc, T_FRAMES, 16, 16))
    s = N_PRIME
    out = {}
    for name, device, p in (("card", dev, netg), ("cpu", torch.device("cpu"), netg_cpu)):
        sidx = torch.full((2,), s, dtype=torch.int64, device=device)
        ctx, sl, _ = vt.prepare_slices(torch.from_numpy(video).to(device), sidx)
        with torch.no_grad():
            out[name] = vt_logits(p, c, ctx, sl, sidx).reshape(2, -1, c.nc, c.nv).cpu()
            if name == "card":
                zl = vt_encode(p, c, ctx, sidx)
                _, out["teacher"] = sample_slice_incremental(
                    p, c, plan.slice_shape, zl, sl, None, np.ones(256, bool), 1.0,
                    teacher_logits=True)
                out["teacher"] = out["teacher"].cpu()
                # control: the same logits with TF32 GEMMs and convolutions
                torch.backends.cuda.matmul.allow_tf32 = True
                torch.backends.cudnn.allow_tf32 = True
                try:
                    out["tf32"] = vt_logits(p, c, ctx, sl, sidx).reshape(2, -1, c.nc, c.nv).cpu()
                finally:
                    torch.backends.cuda.matmul.allow_tf32 = False
                    torch.backends.cudnn.allow_tf32 = False
    e_logits, e_teacher, e_tf32 = (float((out[k] - out["cpu"]).abs().max())
                                   for k in ("card", "teacher", "tf32"))
    scale = float(out["cpu"].abs().max())
    print(f"agree fp32 b=2 full width: vt_logits card vs cpu plain max_abs_err {e_logits:.3g}, "
          f"incremental teacher logits (card) vs cpu plain {e_teacher:.3g}; control with TF32 "
          f"on {e_tf32:.3g}; bound {PATH_TOL:g} (|logits| <= {scale:.3g})")
    check(e_logits <= PATH_TOL, f"vt_logits on the card disagrees with the plain path: {e_logits}")
    check(e_teacher <= PATH_TOL,
          f"incremental teacher logits disagree with the plain path: {e_teacher}")
    check(e_tf32 > PATH_TOL, f"the TF32 control reads {e_tf32}, within the bound {PATH_TOL}: "
                             "the bound cannot tell a TF32 path from a true-fp32 one")


def phase_train_kernels(card):
    """Kernels 10 and 1 at the training path's shapes (nb=64), each against
    its plain version on the same input sets."""
    import torch

    from lvt_tpu_torch.ops.attention import (attention_core_bwd_plain, attention_core_plain,
                                             block_attention_bwd_cuda, block_attention_fwd_cuda)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(10)
    nb, na, n, da = 64, 8, 256, 128
    shape = f"nb={nb}, na={na}, n={n}, da={da}"
    err, times, err1, times1 = 0.0, {}, 0.0, {}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        sets = [[torch.randn((nb, na, n, da), generator=g, device=dev).to(dt) for _ in range(3)]
                + [0.5 * torch.randn((na, n, n), generator=g, device=dev),
                   torch.randn((nb, na, n, da), generator=g, device=dev).to(dt)]
                for _ in range(3)]
        for causal in (False, True):
            got = block_attention_bwd_cuda(*sets[0], causal)
            again = block_attention_bwd_cuda(*sets[0], causal)
            want = attention_core_bwd_plain(*sets[0], causal)
            torch.cuda.synchronize()
            errs = []
            for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
                e, ok = _err(a, b, dtype, DBIAS_TOL if name == "dbias" else bwd_tol(dtype, b))
                check(ok, f"block_attention_bwd {name} disagrees with its plain version "
                          f"({dtype}, causal={causal}): max abs err {e}")
                errs.append(e)
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"block_attention_bwd ({dtype}, causal={causal}): two calls differ")
            print(f"kernel 10 block_attention_bwd {dtype} causal={causal} ({shape}): "
                  f"max_abs_err dq {errs[0]:.3g}, dk {errs[1]:.3g}, dv {errs[2]:.3g}, dbias "
                  f"{errs[3]:.3g} (|dbias| <= {float(want[3].abs().max()):.3g}); two calls "
                  "bit-identical")
            err = max(err, *errs)
            del got, again, want
            times[(dtype, causal)] = time_both(
                card, [lambda x=x: block_attention_bwd_cuda(*x, causal) for x in sets],
                [lambda x=x: attention_core_bwd_plain(*x, causal) for x in sets], 10)
            if dtype == "bfloat16" and not causal:
                lib10 = library_bwd_ms(sets, causal, 10)
                lib1 = library_fwd_ms(sets, causal, 10)

            fwd = [x[:4] for x in sets]  # q, k, v, bias
            out = block_attention_fwd_cuda(*fwd[0], causal)
            ref = attention_core_plain(*fwd[0], causal)
            torch.cuda.synchronize()
            e, ok = _err(out, ref, dtype, fwd_tol(dtype, fwd[0][2]))
            print(f"kernel 1 block_attention_fwd {dtype} causal={causal} ({shape}): "
                  f"max_abs_err {e:.3g}")
            check(ok, f"block_attention_fwd disagrees with its plain version at the training "
                      f"shape ({dtype}, causal={causal}): max abs err {e}")
            err1 = max(err1, e)
            del out, ref
            times1[(dtype, causal)] = time_both(
                card, [lambda x=x: block_attention_fwd_cuda(*x, causal) for x in fwd],
                [lambda x=x: attention_core_plain(*x, causal) for x in fwd], 10)
    io = nb * na * n * da
    b10, by10 = bound_ms("bfloat16", 7 * io * 2 + 2 * na * n * n * 4, 10 * io * n)
    b1, by1 = bound_ms("bfloat16", 4 * io * 2 + na * n * n * 4, 4 * io * n)
    print(f"  bf16 nb={nb}: kernel 10 bound {b10:.4f} ms ({by10}), library call (autograd "
          f"backward of scaled_dot_product_attention, events) {lib10:.4f} ms; kernel 1 bound "
          f"{b1:.4f} ms ({by1}), library call {lib1:.4f} ms [{card}]")
    k10 = dict(zip(("ms", "plain_ms"), times[("bfloat16", False)]), err=err, bound_ms=b10,
               bound_by=by10, library_ms=lib10)
    return k10, err1, times1


def phase_fused_kernels(card):
    """Kernels 7, 8 and 9 at the DSFVT training shape, each against its plain
    version on the same inputs; two calls bit-identical; device times beside
    the plain versions' and the unfused layer's."""
    import torch

    from lvt_tpu_torch.models.vt import init_block_attn
    from lvt_tpu_torch.ops import fused_layer as fl
    from lvt_tpu_torch.ops.attention import ffn_tokens, mha_tokens, relative_bias

    dev = torch.device("cuda")
    nb, block, na, d, da = 64, (1, 16, 16), 8, 512, 128
    n, rows = 256, 64 * 256
    shape = f"nb={nb}, n={n}, d={d}, na={na}, da={da}"
    gen = torch.Generator().manual_seed(7)
    p32 = init_block_attn(gen, block, na, d, da)
    for key in ("dt_bank", "dh_bank", "dw_bank", "ln_bias", "ffn_ln_bias", "ffn_b1", "ffn_b2"):
        p32[key] = 0.1 * torch.randn(p32[key].shape, generator=gen)
    res = {}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        p = {k: v.to(dev, dt) for k, v in p32.items()}
        bias = relative_bias(p["dt_bank"], p["dh_bank"], p["dw_bank"], block).float().contiguous()
        g = torch.Generator(device=dev).manual_seed(8)
        sets = [[torch.randn((nb, n, d), generator=g, device=dev).to(dt) for _ in range(2)]
                for _ in range(3)]  # (tok, cotangent) x 3: 100 MB in bf16, over the L2
        errs = {7: 0.0, 8: 0.0, 9: 0.0}
        for causal in (False, True):
            tok, go = sets[0]
            # kernel 7, with and without x2
            out, x2 = fl.fused_layer_fwd_cuda(tok, p, bias, causal, True)
            alone = fl.fused_layer_fwd_cuda(tok, p, bias, causal)
            again = fl.fused_layer_fwd_cuda(tok, p, bias, causal, True)
            w_out, w_x2 = fl.fused_layer_tokens_plain(tok, p, bias, causal, True)
            torch.cuda.synchronize()
            e7 = []
            for name, a, b in (("out", out, w_out), ("x2", x2, w_x2), ("out alone", alone, w_out)):
                e, ok = _err(a, b, dtype, fused_tol(dtype, b))
                check(ok, f"fused_layer_fwd {name} disagrees with its plain version ({dtype}, "
                          f"causal={causal}): max abs err {e}")
                e7.append(e)
            check(torch.equal(out, again[0]) and torch.equal(x2, again[1]),
                  f"fused_layer_fwd ({dtype}, causal={causal}): two calls differ")
            # kernel 8 from the plain version's x2, kernel 9 from its dx2
            got8 = fl.ffn_half_bwd_cuda(w_x2, go, p)
            again8 = fl.ffn_half_bwd_cuda(w_x2, go, p)
            want8 = fl.ffn_half_bwd_plain(w_x2, go, p)
            torch.cuda.synchronize()
            e8 = []
            for name, a, b in zip(("dx2", "dw1", "db1", "dw2", "db2", "dls", "dlb"), got8, want8):
                e, ok = _err(a, b, dtype, fused_tol(dtype, b, summed=name != "dx2"))
                check(ok, f"ffn_half_bwd {name} disagrees with its plain version ({dtype}, "
                          f"causal={causal}): max abs err {e}")
                e8.append(e)
            check(all(torch.equal(a, b) for a, b in zip(got8, again8)),
                  f"ffn_half_bwd ({dtype}): two calls differ")
            dx2 = want8[0]
            got9 = fl.attn_half_bwd_cuda(tok, dx2, p, bias, causal, 0, na)
            again9 = fl.attn_half_bwd_cuda(tok, dx2, p, bias, causal, 0, na)
            want9 = fl.attn_half_bwd_plain(tok, dx2, p, bias, causal, 0, na)
            torch.cuda.synchronize()
            e9 = []
            for name, a, b in zip(("dy", "dwqkv", "dproj", "dbias"), got9, want9):
                e, ok = _err(a, b, dtype, fused_tol(dtype, b, summed=name != "dy"))
                check(ok, f"attn_half_bwd {name} disagrees with its plain version ({dtype}, "
                          f"causal={causal}): max abs err {e}")
                e9.append(e)
            check(all(torch.equal(a, b) for a, b in zip(got9, again9)),
                  f"attn_half_bwd ({dtype}, causal={causal}): two calls differ")
            print(f"fused kernels {dtype} causal={causal} ({shape}): max_abs_err kernel 7 out "
                  f"{e7[0]:.3g} x2 {e7[1]:.3g} (|out| <= {float(w_out.float().abs().max()):.3g}); "
                  f"kernel 8 " + " ".join(f"{k} {e:.3g}" for k, e in zip(
                      ("dx2", "dw1", "db1", "dw2", "db2", "dls", "dlb"), e8))
                  + "; kernel 9 " + " ".join(f"{k} {e:.3g}" for k, e in zip(
                      ("dy", "dwqkv", "dproj", "dbias"), e9)) + "; two calls bit-identical")
            for k, e in ((7, e7), (8, e8), (9, e9)):
                errs[k] = max(errs[k], *e)
            del out, x2, alone, again, w_out, got8, again8, want8, got9, again9, want9

            # times: kernel, plain version, unfused layer
            x2s = [fl.fused_layer_tokens_plain(t, p, bias, causal, True)[1] for t, _ in sets]
            with torch.no_grad():
                t7 = time_both(card, [lambda x=x: fl.fused_layer_fwd_cuda(x[0], p, bias, causal, True)
                                      for x in sets],
                               [lambda x=x: fl.fused_layer_tokens_plain(x[0], p, bias, causal, True)
                                for x in sets], 6, "kernel 7 ")
                u7 = device_ms([lambda x=x: ffn_tokens(mha_tokens(x[0], p, bias, causal), p)
                                for x in sets], 6)
                t8 = time_both(card, [lambda x=x, y=y: fl.ffn_half_bwd_cuda(y, x[1], p)
                                      for x, y in zip(sets, x2s)],
                               [lambda x=x, y=y: fl.ffn_half_bwd_plain(y, x[1], p)
                                for x, y in zip(sets, x2s)], 6, "kernel 8 ")
                t9 = time_both(card, [lambda x=x: fl.attn_half_bwd_cuda(x[0], x[1], p, bias, causal,
                                                                         0, na) for x in sets],
                               [lambda x=x: fl.attn_half_bwd_plain(x[0], x[1], p, bias, causal,
                                                                    0, na) for x in sets], 6,
                               "kernel 9 ")
            # a whole layer's forward + backward by CUDA events around eager
            # calls: the fused Function (kernels 7, 8, 9 and the LN tail) and
            # the unfused layer (kernels 1 and 10, the library's GEMMs)
            leaves = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}

            def layer_step(fn, x):
                tk = x[0].detach().requires_grad_(True)
                b_ = relative_bias(leaves["dt_bank"], leaves["dh_bank"], leaves["dw_bank"], block)
                torch.autograd.grad(fn(tk, leaves, b_, causal), [tk, *leaves.values()], x[1])

            unfused = lambda tk, pp, b_, c: ffn_tokens(mha_tokens(tk, pp, b_, c), pp)
            fb_fused = host_ms([lambda x=x: layer_step(fl.fused_block_layer, x) for x in sets], 6)
            fb_unfused = host_ms([lambda x=x: layer_step(unfused, x) for x in sets], 6)
            print(f"  layer times {dtype} causal={causal} [{card}]: forward kernel 7 {t7[0]:.4f} ms, "
                  f"plain {t7[1]:.4f}, unfused layer {u7:.4f}; kernel 8 {t8[0]:.4f}, plain "
                  f"{t8[1]:.4f}; kernel 9 {t9[0]:.4f}, plain {t9[1]:.4f}; forward + backward of "
                  f"one layer by events: fused {fb_fused:.4f} ms, unfused {fb_unfused:.4f} ms")
            res[(dtype, causal)] = {7: t7, 8: t8, 9: t9, "unfused_fwd": u7,
                                    "fb_fused": fb_fused, "fb_unfused": fb_unfused}
            del x2s, leaves
        res[dtype] = errs

    # bounds, bf16, from the shapes: each input read once, each output
    # written once; the products the functions need
    wide, el = 3 * na * da, 2
    w_bytes = (d * wide + na * da * d + 2 * d * d + 6 * d) * el
    bias_b = na * n * n * 4
    attn = nb * na * n * n * da  # multiply-adds of one score-space product
    bounds = {
        7: bound_ms("bfloat16", 3 * rows * d * el + w_bytes + bias_b,
                    2 * rows * d * wide + 4 * attn + 2 * rows * na * da * d + 4 * rows * d * d),
        8: bound_ms("bfloat16", 3 * rows * d * el + 2 * d * d * el + 2 * d * d * 4 + 8 * d * 4,
                    10 * rows * d * d),
        9: bound_ms("bfloat16", 3 * rows * d * el + (d * wide + na * da * d) * el + bias_b
                    + (d * wide + na * da * d) * 4 + bias_b,
                    2 * 3 * rows * d * wide + 2 * 2 * rows * na * da * d + 12 * attn),
    }
    print("  bounds bf16 (NVIDIA H100 SXM peaks: 3.35 TB/s, 989 TFLOP/s dense bf16): "
          + ", ".join(f"kernel {k} {b:.4f} ms ({by})" for k, (b, by) in bounds.items()))
    return res, bounds


def _write_latents(root, n_videos, seed):
    """Latent videos in the CodesExtractor layout, <root>/video_<i>/<f>.npy,
    (nc, 16, 16) codes each, drawn from a numpy seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    for v in range(n_videos):
        d = os.path.join(root, f"video_{v}")
        os.makedirs(d)
        for f, frame in enumerate(rng.integers(0, 512, (T_FRAMES, 4, 16, 16))):
            np.save(os.path.join(d, f"{f}.npy"), frame)


def _train_kernels():
    """The wrappers whose launches a train step is held to: kernels 1, 10, 7, 8, 9."""
    from lvt_tpu_torch.ops.attention import block_attention_bwd_cuda, block_attention_fwd_cuda
    from lvt_tpu_torch.ops.fused_layer import (attn_half_bwd_cuda, ffn_half_bwd_cuda,
                                               fused_layer_fwd_cuda)

    return (block_attention_fwd_cuda, block_attention_bwd_cuda, fused_layer_fwd_cuda,
            ffn_half_bwd_cuda, attn_half_bwd_cuda)


def phase_train(card):
    """DSFVT training through tools/train_net_torch.py's main, then --resume,
    with the fused layer (DSFVT's defaults) and with TPU.FUSED_LAYER False;
    per-step launch counts and times recorded around Trainer.train_step."""
    import shutil
    import tempfile

    from lvt_tpu_torch.data.datasets.latents import register_latents

    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        t0 = time.perf_counter()
        _write_latents(os.path.join(tmp, "latents"), 128, 0)
        register_latents("chip_smoke_latents", os.path.join(tmp, "latents"))
        print(f"train data: 128 latent videos of {T_FRAMES} frames written in "
              f"{time.perf_counter() - t0:.2f} s")
        fused = _train_run(card, os.path.join(tmp, "fused"), True, TRAIN_STEPS, RESUME_STEPS)
        unfused = _train_run(card, os.path.join(tmp, "unfused"), False, TRAIN_STEPS // 2,
                             RESUME_STEPS // 2)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"train DSFVT b=64 bf16 [{card}]: fused {fused['sec']:.4f} s/step, "
          f"{fused['videos_per_s']:.2f} videos/s, device busy {fused['busy_ms']:.2f} ms in "
          f"{fused['activities']} activities; unfused {unfused['sec']:.4f} s/step, "
          f"{unfused['videos_per_s']:.2f} videos/s, device busy {unfused['busy_ms']:.2f} ms in "
          f"{unfused['activities']} activities")
    return fused, unfused


def _train_run(card, out, fused, n_steps, n_resume):
    """One run of the training CLI's main and its --resume. Returns the
    launch counts of the first run by kernel and the step's times."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import train_net_torch
    from lvt_tpu_torch.engine.defaults import default_argument_parser
    from lvt_tpu_torch.engine.trainer import Trainer

    kernels = _train_kernels()
    want = (0, 0, 16, 16, 16) if fused else (32, 16, 0, 0, 0)
    label = "TPU.FUSED_LAYER True (the default)" if fused else "remat FUSED_LAYER False"
    steps, profiled = [], []
    inner = Trainer.train_step

    def recorded(self, batch):
        torch.cuda.synchronize()
        c0 = [k.launches for k in kernels]
        if len(steps) == n_steps + n_resume - 1:  # the last step, outside the medians
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                metrics = inner(self, batch)
                loss = float(metrics["loss_cross_entropy"])
                profiled.append((time.perf_counter() - t0, prof))
        else:
            t0 = time.perf_counter()
            metrics = inner(self, batch)
            loss = float(metrics["loss_cross_entropy"])  # synchronizes
        steps.append((time.perf_counter() - t0, loss,
                      tuple(k.launches - c for k, c in zip(kernels, c0)), t0))
        return metrics

    # DSFVT's defaults when fused: no TPU.FUSED_LAYER override
    opts = ["--config-file", os.path.join(ROOT, "configs", "vt", "DSFVT.yaml"),
            *([] if fused else ["TPU.FUSED_LAYER", "False"]),
            "SOLVER.CHECKPOINT_PERIOD", str(n_steps // 2),
            "DATASETS.TRAIN", "('chip_smoke_latents',)", "DATALOADER.NUM_WORKERS", "8",
            "OUTPUT_DIR", out]
    parse = default_argument_parser().parse_args
    try:
        Trainer.train_step = recorded
        torch.cuda.reset_peak_memory_stats()
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        tr = train_net_torch.main(parse(opts + ["SOLVER.MAX_ITER", str(n_steps)]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = tuple(k.launches for k in kernels)
        peak = torch.cuda.max_memory_allocated()
        check(tr.model.fused == fused, f"train: model.fused is {tr.model.fused}, want {fused}")
        check(tr.state.step == n_steps and len(steps) == n_steps,
              f"train: {tr.state.step} steps taken, want {n_steps}")
        check(sorted(os.listdir(os.path.join(out, "checkpoints"))) ==
              sorted([f"ckpt_{n_steps // 2}.pt", f"ckpt_{n_steps}.pt"]),
              f"train: checkpoints {os.listdir(os.path.join(out, 'checkpoints'))}")
        tr2 = train_net_torch.main(parse(["--resume"] + opts + [
            "SOLVER.MAX_ITER", str(n_steps + n_resume)]))
        check(tr2.start_iter == n_steps and tr2.state.step == n_steps + n_resume,
              f"resume: started at {tr2.start_iter}, ended at {tr2.state.step}")
    finally:
        Trainer.train_step = inner
    losses = [s[1] for s in steps]
    check(all(np.isfinite(losses)), f"train: non-finite losses {losses}")
    per_step = {s[2] for s in steps}
    check(per_step == {want}, f"train ({label}): kernel launches per step (kernels 1, 10, 7, 8, "
                              f"9) {sorted(per_step)}, want exactly {want}")
    sec = float(np.median([s[0] for s in steps[3:n_steps]]))
    # an iteration: from one step's start to the next's (data, step, hooks)
    it_sec = float(np.median([b[3] - a[3] for a, b in zip(steps[3:n_steps - 1],
                                                           steps[4:n_steps])]))
    batch = tr.cfg.SOLVER.IMS_PER_BATCH
    print(f"train DSFVT b={batch} bf16 {label} [{card}]: {n_steps} steps in "
          f"{wall:.2f} s with set-up; median {sec:.4f} s/step over steps 4-{n_steps} "
          f"(train_step, synchronized), {it_sec:.4f} s/iteration (with data and hooks) = "
          f"{batch / it_sec:.2f} videos/s; first step {steps[0][0]:.3f} s; max_memory_allocated "
          f"{peak / 2 ** 30:.2f} GiB; launches per step (kernels 1, 10, 7, 8, 9) {want} (run: "
          f"{launches}); loss {losses[0]:.4f} -> {losses[n_steps - 1]:.4f}; "
          f"resumed at {n_steps}, {n_resume} more steps, loss {losses[-1]:.4f}")
    check(len(profiled) == 1, "train: the last resumed step was not profiled")
    busy, activities = _print_step_profile(card, batch, sec, *profiled[0])
    return {"launches": launches, "sec": sec, "it_sec": it_sec, "videos_per_s": batch / it_sec,
            "peak": peak, "busy_ms": busy, "activities": activities}


def _print_step_profile(card, batch, step_sec, wall, prof):
    """Device time of one train step by kernel, with each __global__
    function of the hand-written kernels on its own. The
    busy share is given against the profiled step's wall time (the
    profiler's own per-launch cost included) and the median unprofiled
    step, ``step_sec``."""
    import torch

    kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    by_name = {}
    for e in kern:
        tot, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.elapsed_us() / 1e3, cnt + 1)
    print(f"profile, one train step DSFVT b={batch} bf16 [{card}]: wall {wall:.4f} s "
          f"under the profiler, device busy {busy:.2f} ms = {100 * busy / (1e3 * wall):.1f}% "
          f"of it, {100 * busy / (1e3 * step_sec):.1f}% of the median step ({step_sec:.4f} s); "
          f"{len(kern)} device activities")
    for name, (tot, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"  {tot:9.3f} ms {cnt:5d}x  {name[:110]}")
    # the hand-written kernels' __global__ functions: the attention device
    # code (shared by kernels 1, 10 and, inside the fused layer, 7 and 9), the
    # fixed-order reduction (kernels 8, 9, 10) and the fused layer's own
    groups = (("attention forward", "block_attention_"), ("query tiles", "::bwd_rows_"),
              ("key tiles", "::bwd_keys_"), ("fixed-order reductions", "dbias_reduce"),
              ("ln_qkv", "ln_qkv"), ("proj_ffn", "proj_ffn"), ("ffn_bwd_rows", "ffn_bwd_rows"),
              ("gemm_nt", "gemm_nt"), ("gemm_tn", "gemm_tn"))
    sums = {label: (sum(t for name, (t, _) in by_name.items() if key in name),
                    sum(c for name, (_, c) in by_name.items() if key in name))
            for label, key in groups}
    print("  hand-written kernels per step: " + ", ".join(
        f"{label} {t:.3f} ms ({c}x)" for label, (t, c) in sums.items() if c)
        + f"; total {sum(t for t, _ in sums.values()):.3f} ms")
    return busy, len(kern)


def phase_train_agree(card):
    import copy

    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import generate_videos_torch as gvt
    from lvt_tpu_torch.checkpoint.convert import flatten
    from lvt_tpu_torch.models import to_device
    from lvt_tpu_torch.models.vt import VideoTransformer

    kernels = _train_kernels()
    cfg = gvt.load_config(os.path.join(ROOT, "configs", "vt", "DSFVT.yaml"))
    vt = VideoTransformer(cfg)
    check(vt.fused, "train agree: DSFVT's default TPU.FUSED_LAYER is not True")
    params, _ = vt.init(torch.Generator().manual_seed(2))
    video = torch.from_numpy(np.random.default_rng(1).integers(0, 512, (2, 4, T_FRAMES, 16, 16)))
    si = torch.tensor([1, 9])
    res = {}
    for name, device, fused, tf32 in (
            ("cpu", "cpu", False, False), ("card", "cuda", False, False),
            ("tf32", "cuda", False, True), ("cpu fused", "cpu", True, False),
            ("card fused", "cuda", True, False), ("tf32 fused", "cuda", True, True)):
        p = copy.deepcopy(to_device(params, device))  # leaves of their own
        for leaf in flatten(p).values():
            leaf.requires_grad_(True)
        vt.fused = fused
        before = [k.launches for k in kernels]
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
        t0 = time.perf_counter()
        try:
            loss, _ = vt.loss(p, {"video": video.to(device)}, slice_idx=si)
            loss.backward()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        res[name] = (float(loss.detach()), {k: v.grad.cpu() for k, v in flatten(p).items()})
        took = tuple(k.launches - b for k, b in zip(kernels, before))
        want = ((0, 0, 16, 16, 16) if fused else (32, 16, 0, 0, 0)) if device == "cuda" \
            else (0, 0, 0, 0, 0)
        check(took == want, f"train agree ({name}): launches of kernels 1, 10, 7, 8, 9 {took}, "
                            f"want {want}")
        print(f"  train agree {name}: loss {res[name][0]:.6f}, "
              f"{time.perf_counter() - t0:.1f} s, launches {took}")

    def worst(grads, ref):
        floor = 1e-2 * max(float(g.norm()) for g in ref.values())
        ref_norm = float(torch.stack([g.norm() for g in ref.values()]).norm())
        rel = {k: float((grads[k] - g).norm()) / max(float(g.norm()), floor)
               for k, g in ref.items()}
        k = max(rel, key=rel.get)
        whole = float(torch.stack([(grads[k] - g).norm() for k, g in ref.items()]).norm())
        return rel[k], k, whole / ref_norm

    pairs = {"card vs cpu plain": ("card", "cpu"), "TF32 control": ("tf32", "cpu"),
             "fused card vs cpu plain": ("card fused", "cpu fused"),
             "fused vs unfused on the card": ("card fused", "card"),
             "fused with TF32 on": ("tf32 fused", "cpu fused")}
    got = {label: worst(res[a][1], res[b][1]) for label, (a, b) in pairs.items()}
    n_leaves = len(res["cpu"][1])
    print(f"train agree fp32 b=2 full width, one loss+backward [{card}], {n_leaves} gradient "
          f"leaves, worst leaf and whole gradient (relative Frobenius): " + "; ".join(
              f"{label} {e:.3g} ({k}), {w:.3g}" for label, (e, k, w) in got.items())
          + f"; bounds {GRAD_TOL:g} per leaf, {GRAD_TOL_WHOLE:g} whole; losses "
          + ", ".join(f"{k} {v[0]:.6f}" for k, v in res.items()))
    for a, b in (("card", "cpu"), ("card fused", "cpu fused"), ("card fused", "card")):
        check(abs(res[a][0] - res[b][0]) <= 1e-5 * abs(res[b][0]),
              f"train agree: loss {res[a][0]} ({a}), {res[b][0]} ({b})")
    for label in ("card vs cpu plain", "fused card vs cpu plain", "fused vs unfused on the card"):
        e, k, w = got[label]
        check(e <= GRAD_TOL, f"train agree, {label}: gradient {k} off by {e} (relative)")
        check(w <= GRAD_TOL_WHOLE, f"train agree, {label}: the whole gradient is off by {w} "
                                   "(relative)")
    # the fused step with TF32 on is printed, not held: its layers' products
    # are the kernels' own fp32 FMAs, which the switch does not reach
    e_tf32, _, w_tf32 = got["TF32 control"]
    check(e_tf32 > GRAD_TOL and w_tf32 > GRAD_TOL_WHOLE,
          f"train agree: the TF32 control reads {e_tf32} per leaf, {w_tf32} whole, within the "
          f"bounds {GRAD_TOL}, {GRAD_TOL_WHOLE}: they cannot tell TF32 from true fp32")
    return got


def main():
    if not os.path.isdir(os.path.join(ROOT, "lvt_tpu_torch")):
        fail(f"no lvt_tpu_torch package beside {__file__}: run from a checkout of the repo")
    sys.path.insert(0, ROOT)
    import torch

    card = phase_device()
    import lvt_tpu_torch  # noqa: F401  (TF32 off)

    phase_build()
    kres = phase_kernels(card)
    launches, models, codes = phase_main(card)
    phase_profile(card, models, codes)
    phase_agree(card)
    del models, codes
    k10, err1_train, _ = phase_train_kernels(card)
    fres, fbounds = phase_fused_kernels(card)
    fused_run, unfused_run = phase_train(card)
    phase_train_agree(card)

    def entry(name, source, replaces, n_launches, r):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": n_launches, "max_abs_err": r["err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"]}

    def fused_entry(name, k, replaces, n_launches):
        # bf16, not causal (the encoder's layers), at nb=64; no single library
        # call computes a fused layer: the unfused layer's times stand beside
        t = fres[("bfloat16", False)]
        e = entry(name, "lvt_tpu_torch/csrc/fused_layer.cu", replaces, n_launches,
                  {"err": max(fres["float32"][k], fres["bfloat16"][k]), "ms": t[k][0],
                   "plain_ms": t[k][1], "bound_ms": fbounds[k][0], "bound_by": fbounds[k][1],
                   "library_ms": None})
        e["unfused_layer_ms"] = t["unfused_fwd"] if k == 7 else t["fb_unfused"]
        return e

    kres["block_attention_fwd"]["err"] = max(kres["block_attention_fwd"]["err"], err1_train)
    kernels = [
        entry("block_attention_fwd", "lvt_tpu_torch/csrc/block_attention.cuh",
              "lvt_tpu/ops/attention.py:127", launches[0], kres["block_attention_fwd"]),
        entry("decode_attention", "lvt_tpu_torch/csrc/decode_attention.cu",
              "lvt_tpu/ops/cache_attention.py:451", launches[1], kres["decode_attention"]),
        entry("block_attention_bwd", "lvt_tpu_torch/csrc/block_attention_bwd.cuh",
              "lvt_tpu/ops/attention.py:186", unfused_run["launches"][1], k10),
        fused_entry("fused_layer_fwd", 7, "lvt_tpu/ops/fused_layer.py:74",
                    fused_run["launches"][2]),
        fused_entry("ffn_half_bwd", 8, "lvt_tpu/ops/fused_layer.py:183",
                    fused_run["launches"][3]),
        fused_entry("attn_half_bwd", 9, "lvt_tpu/ops/fused_layer.py:281",
                    fused_run["launches"][4]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
