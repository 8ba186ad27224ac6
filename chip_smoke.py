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
                user runs it (no VQ-VAE weights configured), and batch 8 with the VT in bf16. Kernel launch
                counts are read around this phase only.
  5. agree    — fp32, batch 2, full width: teacher-forced vt_logits (kernel 1
                causal and not) and the incremental decoder's teacher logits
                (kernel 2) on the card against the plain path on the CPU,
                and a control run of vt_logits with TF32 on that must
                fall outside the bound.
  6. train kernels — kernel 10 (the attention backward) and kernel 1 against
                their plain versions at DSFVT training shapes (nb=64), fp32
                and bf16, causal and not; device times; kernel 10's outputs
                bit-identical across two calls. Then both in bf16 at n in
                (48, 200, 256) x da in (64, 128) x causal, and kernel 10's
                dbias planes at nb in (1, 3, 64); kernel 1 bit-identical
                across two calls.
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

 10. i8 kernels — kernels 3, 4 and 5 (decode attention over an int8 KV cache)
                at b=16 and b=1, na=8, R=256, da=128, live in (1, 64, 200,
                256), bf16 and fp32 scales, and kernel 11 (the int8-weight
                product) at b in (1, 8) for DSFVT's three shapes, each against
                its plain version under the bounds below, with a control that
                must read above them; device times over inputs larger than
                the L2, beside kernel 2's at the same shape and, for kernel 11,
                torch._int_mm plus the scaling (yardsticks, never on a path).
 11. main i8  — the quantized sampler at full width, batch 8, bf16, all 11
                sampled frames, greedy, through generate() with
                TEST.VT_SAMPLER.KV_DTYPE / ATTN_IMPL / WEIGHT_DTYPE set: a
                native rollout for reference, then int8 KV + pallas (kernel 3),
                int8 KV + pallas-live (kernel 4), int8 KV + pallas +
                int8-pallas weights (kernels 3 and 11). Launch counts set to 0
                before each and read after: exactly 22,528 of kernel 3 or 4
                and 90,112 of kernel 11 per rollout. Peak device memory and
                greedy agreement with the native rollout; one profiled slice.
 12. agree i8 — fp32, batch 2, full width: the three modes' teacher-forced
                logits on the card against the plain path on the CPU.

 13. vq kernel — kernel 6 (nearest codebook entry) against its plain version:
                N in (1, 8,192, 8,229), K=512, Dc in (64, 256), fp32 and bf16 z,
                contiguous and strided; exact ties; indices equal except at
                float64-verified near-ties; a control (the plain version on
                bf16-rounded z) that must fail the same check; two calls
                bit-identical; device times beside the plain version,
                torch.cdist + argmin and the bound; the kernel's indices of
                the real z_e of example/*.png beside encode_indices' plain ones.
 14. vqvae train — tools/train_net_torch.py's main on
                configs/vqvae/PR-DVQVAE2.yaml with no model override: batch 32,
                bf16 compute, the config's solver, 512 PNG frames of 64x64
                written from a numpy seed, 8 workers, 20 steps + 4 after
                --resume. Exactly 4 kernel-6 launches per step; finite loss
                terms; the EMA codebook moved, its running_size holds the
                expected mass, and the resumed run starts from the saved one.
 15. vqvae agree — fp32, batch 4, full width: loss terms, every gradient leaf,
                the new EMA state and the indices on the card (kernel 6)
                against the plain path on the CPU; a TF32 control that must
                read above the bounds.
 16. probe kernel — kernel 12 (decode attention with an unquantized q over
                int8 K/V) against its plain version at the probe tool's shape
                and DSFVT's, bf16 and fp32, live in (1, 64, 200, 256), with a
                control (kernel 3's scheme) that must read above the bound;
                tools/probe_decode_kernel_torch.py's timing run, beside
                kernels 2 and 3.

Phases 10 to 13 run right after phase 5, while the generation models are
loaded. The line before the last is {"kernels": [...]}; the last line is
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
# the generation runs sample from random weights: DSFVT.yaml names the
# reference's .pth VQ-VAE files, which the port refuses
NO_VQ_WEIGHTS = ["TEST.VT_SAMPLER.VQ_VAE.ENCODER_WEIGHTS", "",
                 "TEST.VT_SAMPLER.VQ_VAE.GENERATOR_WEIGHTS", "",
                 "TEST.VT_SAMPLER.VQ_VAE.CODEBOOK_WEIGHTS", ""]


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
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}


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

# Kernels 3 and 4, |kernel - plain|. Both integer products are exact, so the
# two differ only where exp or the order of the softmax's fp32 sum leaves a
# weight on the other side of x.5: it rounds one step apart and moves the
# outputs of that (batch row, head) by i8_weight_step * |v8|. Bound per output:
# I8_FLIPS such steps at |v8| = 127, plus 1e-5 of the head's largest output
# (the scale itself differs by ulps), plus for bf16 outputs one bf16 ulp
# (2^-7 relative). And at most I8_ROWS_OFF of the (batch row, head) pairs may
# differ by more than that rounding part. Control: the plain version of the
# other kernel (per-row against per-tile quantization, another rounding of
# the same attention) must break the second bound.
I8_FLIPS, I8_ROWS_OFF = 2, 0.05
# Kernel 5 keeps everything in fp32: sums in another order, 1e-5 of the
# largest output (+ one bf16 ulp on bf16 outputs). Control: its plain version
# with the weights rounded to bf16 before the V product (the sampler's own
# rounding point) must read above it.
K5_TOL = 1e-5
# Kernel 11: the integer sum is exact and the scale arithmetic IEEE on both
# sides: fp32 outputs within 1e-6 of the largest (bit-equal in practice).
# Control: the sampler's other weight mode, (y @ W8) * s with no activation
# rounding, must read above it.
K11_TOL = 1e-6
# Quantized sampler, fp32, card vs the plain path on the CPU, teacher-forced
# logits of one slice. Quantization amplifies fp32 noise: a value within the
# two sides' rounding difference of x.5 rounds one step apart, the step moves
# everything after it by ~1e-3 relative, and later roundings then part at a
# far higher rate. On the CPU (tools/probe_int8_noise_torch.py), scaling every
# weight by 1 + 1e-6 N(0, 1) moves the int8-KV logits by 0.18 of the mode's own gap to the native sampler (root
# mean square; 0.41 at the maximum) and, with the activations quantized for
# kernel 11 as well, by 0.53 (0.73). The card's fp32 noise against the CPU is
# smaller than that: it read 0.12 (int8 KV + pallas) and 0.34 (pallas-live,
# whose own gap is a third of pallas's in root mean square: finer weight
# steps, the same K and V steps). So the bound is a share of the mode's gap
# in root mean square; the control, the native logits on the card against the
# mode's on the CPU, reads the whole gap. The kernels themselves are held to
# their plain versions in phase 10, far tighter.
AGREE_I8 = {"native": 0.6, "int8-pallas": 0.85}  # by WEIGHT_DTYPE
# greedy codes of an int8 rollout against the native one, bf16, random
# weights: the logits are nearly flat, one flipped argmax changes everything
# after it, and chance agreement is 1/512. Measured 0.87 to 0.88 of all
# sampled codes (0.94 to 0.96 of the first sampled frame) in the three modes;
# the floor only says that the rollouts track each other far above chance.
GREEDY_FLOOR = 0.5

# Kernel 6 returns indices: equal to the plain version's, or differing only
# where the float64 distances of the two codes lie within NEAR_TIE_ULPS fp32
# ulps of the sums that form them (||z||^2 + ||c||^2): the two versions sum in
# other orders, which can decide such a choice and no other. At most 1 row per
# 1000 may differ so. Control: the plain version on bf16-rounded z must fail.
NEAR_TIE_ULPS, NEAR_TIE_SHARE = 8, 1e-3
# vqvae agree, fp32, card vs CPU: loss terms 1e-5 relative; gradients by the
# relative-Frobenius measures of the VT's train agree, both held to GRAD_TOL:
# ReLU gates near 0 flip under fp32 noise here too, and 28 leaves average
# fewer flips out than the VT's 300, so the whole gradient reads what the
# worst leaf reads (the card 2.9e-3 per leaf and 2.1e-3 whole; the TF32
# control, which must read above the bound, 0.157 and 0.112). The new EMA
# state within 1e-5 of its largest value on every code no differing index
# touches.
# Indices there: every difference a verified near-tie, and at most 3 per 1000.
# A freshly initialised codebook has entries within 1/512, so the two nearest
# codes of a row lie ~1e-3 apart at distances of ~3: fp32 ulps (2.4e-7) decide
# about 0.5 rows per 1000, where the seeded trained-scale inputs of phase 13
# read none.
VQ_AGREE_SHARE = 3e-3
VQ_TRAIN_STEPS, VQ_RESUME_STEPS, VQ_FRAMES = 20, 4, 512

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
    check(float(video.min()) >= 0.0 and float(video.max()) <= 255.0,
          f"{label}: frames outside [0, 255]")
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
         "OUTPUT_DIR", out_dir] + NO_VQ_WEIGHTS)
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


def phase_profile(card, models, codes, label="native", **knobs):
    """Where the time of one slice of the batch-8 bf16 rollout goes: wall
    time with and without torch.profiler, the device's busy share, device
    activities per pixel (copies and casts among them), and device time by
    kernel. ``knobs`` go to sample_slice_incremental (the quantized modes)."""
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
        sample_slice_incremental(params["netG"], c, plan.slice_shape, zl, sl, gen, primed, 1.0,
                                 **knobs)
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
    copies = sum(cnt for name, (_, cnt) in by_name.items()
                 if "copy" in name.lower() or "memcpy" in name.lower())
    print(f"profile, one slice (256 pixels) of the batch-{b} bf16 rollout, {label} [{card}]: "
          f"wall {wall:.3f} s ({wall_prof:.3f} s under the profiler), device busy "
          f"{busy:.3f} s = {100 * busy / wall_prof:.1f}% of the profiled wall time, "
          f"{100 * busy / wall:.1f}% of the unprofiled; {len(kern)} device activities = "
          f"{len(kern) / 256:.1f} per pixel, copies and casts {copies / 256:.1f} per pixel")
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


def phase_attention_shapes(card):
    """Kernels 1 and 10 in bf16 at the widths the DSFVT shapes leave out: n
    in (48, 200, 256) x da in (64, 128) x causal, nb = 3; kernel 10's dbias
    planes at nb in (1, 3, 64) (runs of one block, and of eight); two calls
    of kernel 1 bit-identical. Tolerances as phases 3 and 6."""
    import torch

    from lvt_tpu_torch.ops.attention import (attention_core_bwd_plain, attention_core_plain,
                                             block_attention_bwd_cuda, block_attention_fwd_cuda)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    worst = {"fwd": 0.0, "bwd": 0.0, "dbias": 0.0}
    cases = [(3, n, da) for n in (48, 200, 256) for da in (64, 128)] + \
        [(nb, 256, 128) for nb in (1, 64)]
    for nb, n, da in cases:
        for causal in (False, True):
            q, k, v, go = (torch.randn((nb, 8, n, da), generator=g, device=dev)
                           .to(torch.bfloat16) for _ in range(4))
            bias = 0.5 * torch.randn((8, n, n), generator=g, device=dev)
            out = block_attention_fwd_cuda(q, k, v, bias, causal)
            again = block_attention_fwd_cuda(q, k, v, bias, causal)
            e, ok = _err(out, attention_core_plain(q, k, v, bias, causal), "bfloat16",
                         fwd_tol("bfloat16", v))
            what = f"(bf16, nb={nb}, n={n}, da={da}, causal={causal})"
            check(ok, f"block_attention_fwd disagrees with its plain version {what}: {e}")
            check(torch.equal(out, again), f"block_attention_fwd {what}: two calls differ")
            worst["fwd"] = max(worst["fwd"], e)
            got = block_attention_bwd_cuda(q, k, v, bias, go, causal)
            want = attention_core_bwd_plain(q, k, v, bias, go, causal)
            for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
                e, ok = _err(a, b, "bfloat16",
                             DBIAS_TOL if name == "dbias" else bwd_tol("bfloat16", b))
                check(ok, f"block_attention_bwd {name} disagrees with its plain version "
                          f"{what}: {e}")
                key = "dbias" if name == "dbias" else "bwd"
                worst[key] = max(worst[key], e)
            del out, again, got, want
    torch.cuda.synchronize()
    print(f"kernels 1 and 10 bf16 at n in (48, 200, 256) x da in (64, 128) x causal (nb=3), "
          f"and nb in (1, 64) at n=256, da=128: max_abs_err fwd {worst['fwd']:.3g}, "
          f"dq/dk/dv {worst['bwd']:.3g}, dbias {worst['dbias']:.3g}; kernel 1 two calls "
          f"bit-identical [{card}]")
    return worst


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


def _print_step_profile(card, batch, step_sec, wall, prof, what="DSFVT"):
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
    print(f"profile, one train step {what} b={batch} bf16 [{card}]: wall {wall:.4f} s "
          f"under the profiler, device busy {busy:.2f} ms = {100 * busy / (1e3 * wall):.1f}% "
          f"of it, {100 * busy / (1e3 * step_sec):.1f}% of the median step ({step_sec:.4f} s); "
          f"{len(kern)} device activities")
    for name, (tot, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"  {tot:9.3f} ms {cnt:5d}x  {name[:110]}")
    # the hand-written kernels' __global__ functions: the attention device
    # code (shared by kernels 1, 10 and, inside the fused layer, 7 and 9), the
    # fixed-order reduction (kernels 8, 9, 10), the fused layer's own, and
    # kernel 6's
    groups = (("attention forward", "block_attention_"), ("query tiles", "::bwd_rows_"),
              ("key tiles", "::bwd_keys_"), ("fixed-order reductions", "dbias_reduce"),
              ("ln_qkv", "ln_qkv"), ("proj_ffn", "proj_ffn"), ("ffn_bwd_rows", "ffn_bwd_rows"),
              ("gemm_nt", "gemm_nt"), ("gemm_tn", "gemm_tn"),
              ("nearest_indices (kernel 6)", "nearest_indices_kernel"))
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


def _i8_kernels():
    """The wrappers of the quantized sampler's kernels: 3, 4, 5, 11."""
    from lvt_tpu_torch.ops.cache_attention import (cache_attention_i8_cuda,
                                                   decode_attention_i8_cuda,
                                                   decode_attention_i8_live_cuda)
    from lvt_tpu_torch.ops.quant import matmul_i8w_cuda

    return (decode_attention_i8_cuda, decode_attention_i8_live_cuda, cache_attention_i8_cuda,
            matmul_i8w_cuda)


def _i8_check(got, want, step, bf16_out):
    """(max abs err, share of (batch row, head) pairs off by more than
    rounding, within the per-output bound?) for kernels 3 and 4."""
    b, na = step.shape
    got, want = got.float().reshape(b, na, -1), want.float().reshape(b, na, -1)
    rounding = 1e-5 * want.abs().amax(dim=-1, keepdim=True)
    if bf16_out:
        rounding = rounding + 2 ** -7 * want.abs()
    diff = (got - want).abs()
    ok = bool(((diff <= I8_FLIPS * 127 * step[:, :, None] + rounding) & got.isfinite()).all())
    return float(diff.max()), float((diff > rounding).any(dim=-1).float().mean()), ok


def phase_i8_kernels(card, kernel2_ms):
    """Kernels 3, 4, 5 and 11 at the quantized sampler's shapes, each against
    its plain version with its control; device times over inputs larger than
    the L2."""
    import torch

    from lvt_tpu_torch.ops import cache_attention as ca
    from lvt_tpu_torch.ops import quant

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(34)
    na, R, da = 8, 256, 128
    scale = da ** -0.5
    res = {}

    def cache_set(b, scale_dtype):
        k8, v8 = (torch.randint(-127, 128, (b, na, R, da), generator=g, device=dev,
                                dtype=torch.int8) for _ in range(2))
        ks, vs = ((0.02 * torch.rand((b, na, R), generator=g, device=dev) + 1e-3).to(scale_dtype)
                  for _ in range(2))
        return k8, ks, v8, vs

    def poison(c, live):  # rows at or past live: what an earlier block run may have left
        k8, ks, v8, vs = (t.clone() for t in c)
        k8[:, :, live:], v8[:, :, live:] = 127, -128
        ks[:, :, live:], vs[:, :, live:] = 1e6, 1e6
        return k8, ks, v8, vs

    # ---- kernels 3 and 4
    pairs = {3: (ca.decode_attention_i8_cuda, ca.decode_attention_i8_plain),
             4: (ca.decode_attention_i8_live_cuda, ca.decode_attention_i8_live_plain)}
    errs, times = {3: 0.0, 4: 0.0}, {}
    for b in (16, 1):
        q8 = torch.randint(-127, 128, (b, na, da), generator=g, device=dev, dtype=torch.int8)
        sq = 0.01 * torch.rand((b, na), generator=g, device=dev) + 1e-3
        bias = 0.5 * torch.randn((na, R), generator=g, device=dev)
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            # 8 sets of 8.5 MB at b=16: 68 MB, over the 50 MB L2
            sets = [cache_set(b, dt) for _ in range(8 if b == 16 else 1)]
            for live in (1, 64, 200, 256):
                c = poison(sets[0], live)
                step = ca.i8_weight_step(q8, sq, c[0], c[1], c[3], live, bias, scale)
                for k, (kernel, plain) in pairs.items():
                    got = kernel(q8, sq, *c, live, bias, scale, dt)
                    want = plain(q8, sq, *c, live, bias, scale, dt)
                    torch.cuda.synchronize()
                    e, off, ok = _i8_check(got, want, step, dtype == "bfloat16")
                    print(f"kernel {k} {kernel.__name__} scales/out {dtype} live={live} (b={b}, "
                          f"na={na}, R={R}, da={da}): max_abs_err {e:.3g}, pairs off by more than "
                          f"rounding {off:.3g} (|out| <= {float(want.float().abs().max()):.3g}, "
                          f"one step * 127 <= {127 * float(step.max()):.3g})")
                    check(ok and off <= I8_ROWS_OFF,
                          f"{kernel.__name__} disagrees with its plain version ({dtype}, b={b}, "
                          f"live={live}): max abs err {e}, pairs off {off}")
                    errs[k] = max(errs[k], e)
                    if live == 256 and b == 16 and dtype == "float32":
                        # control: the other kernel's plain version on the same inputs
                        twin = {3: 4, 4: 3}[k]
                        other = pairs[twin][1](q8, sq, *c, live, bias, scale, dt)
                        ce, coff, _ = _i8_check(got, other, step, False)
                        print(f"  control, kernel {k} against kernel {twin}'s plain version: "
                              f"max_abs_err {ce:.3g}, pairs off {coff:.3g}")
                        check(coff > I8_ROWS_OFF, f"kernel {k}: the control reads {coff} pairs "
                              f"off, within the bound {I8_ROWS_OFF}")
                    if b == 16 and live == 256:
                        times[(k, dtype)] = time_both(
                            card, [lambda s=s: kernel(q8, sq, *s, live, bias, scale, dt)
                                   for s in sets],
                            [lambda s=s: plain(q8, sq, *s, live, bias, scale, dt) for s in sets],
                            200, f"kernel {k} {dtype} b={b} live={live} ")
    el = 2  # bf16 scales and output
    nbytes = (2 * 16 * na * R * da + 2 * 16 * na * R * el + na * R * 4 + 16 * na * (da + 4)
              + 16 * na * da * el)
    b34, by34 = bound_ms("int8", nbytes, 4 * 16 * na * R * da)
    print(f"  kernels 3 and 4 b=16 live={R}: bound {b34:.4f} ms ({by34}: int8 K and V rows, "
          f"scales, bias, q8, output); kernel 2 (bf16 cache) at the same shape "
          f"{kernel2_ms:.4f} ms; no single library call computes them [{card}]")
    for k, name in ((3, "decode_attention_i8"), (4, "decode_attention_i8_live")):
        res[name] = dict(zip(("ms", "plain_ms"), times[(k, "bfloat16")]), err=errs[k],
                         bound_ms=b34, bound_by=by34, library_ms=None, kernel2_ms=kernel2_ms,
                         fp32_scales_ms=times[(k, "float32")][0])

    # ---- kernel 5: q in float, fp32 scales
    err5, t5 = 0.0, {}
    for b in (16, 1):
        extra = 0.5 * torch.randn((1, na, R), generator=g, device=dev)
        sets = [cache_set(b, torch.float32) for _ in range(8 if b == 16 else 1)]
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            q = torch.randn((b, na, da), generator=g, device=dev).to(dt)
            for live in (1, 64, 200, 256):
                k8, ks, v8, vs = sets[0]
                k8, v8 = k8.clone(), v8.clone()
                k8[:, :, live:], v8[:, :, live:] = 127, -128
                got = ca.cache_attention_i8_cuda(q, k8, ks, v8, vs, extra, scale, live)
                want = ca.cache_attention_i8_plain(q, k8, ks, v8, vs, extra, scale, live)
                torch.cuda.synchronize()
                top = float(want.float().abs().max())
                tol = (K5_TOL * top, 2 ** -7 if dtype == "bfloat16" else 0.0)
                e, ok = _err(got, want, dtype, tol)
                print(f"kernel 5 cache_attention_i8 {dtype} live={live} (b={b}, na={na}, R={R}, "
                      f"da={da}): max_abs_err {e:.3g} (|out| <= {top:.3g})")
                check(ok, f"cache_attention_i8 disagrees with its plain version ({dtype}, b={b}, "
                          f"live={live}): max abs err {e}")
                err5 = max(err5, e)
                if live == 256 and b == 16 and dtype == "float32":
                    # control: weights rounded to bf16 before the V product
                    logits = torch.einsum("bad,bajd->baj", q, k8.float()) * scale * ks + extra
                    w = (torch.softmax(logits, -1).bfloat16().float() * vs)
                    ctl = torch.einsum("baj,bajd->bad", w, v8.float())
                    ce, cok = _err(got, ctl, dtype, tol)
                    print(f"  control, weights rounded to bf16 first: max_abs_err {ce:.3g}; "
                          f"bound {tol[0]:.3g}")
                    check(not cok, f"kernel 5: the control reads {ce}, within the bound {tol[0]}")
                if b == 16 and live == 256:
                    t5[dtype] = time_both(
                        card, [lambda s=s: ca.cache_attention_i8_cuda(q, *s, extra, scale, live)
                               for s in sets],
                        [lambda s=s: ca.cache_attention_i8_plain(q, *s, extra, scale, live)
                         for s in sets], 200, f"kernel 5 {dtype} b={b} live={live} ")
    nbytes = 2 * 16 * na * R * da + 2 * 16 * na * R * 4 + na * R * 4 + 2 * 16 * na * da * 2
    b5, by5 = bound_ms("float32", nbytes, 4 * 16 * na * R * da)
    print(f"  kernel 5 b=16 live={R}: bound {b5:.4f} ms ({by5}); kernel 2 at the same shape "
          f"{kernel2_ms:.4f} ms [{card}]")
    res["cache_attention_i8"] = dict(zip(("ms", "plain_ms"), t5["bfloat16"]), err=err5,
                                     bound_ms=b5, bound_by=by5, library_ms=None,
                                     kernel2_ms=kernel2_ms, fp32_ms=t5["float32"][0])

    # ---- kernel 11 at DSFVT's three shapes
    err11, shapes = 0.0, {}
    for K, N in ((512, 3072), (1024, 512), (512, 512)):
        n_sets = min(256, -(-64 * 2 ** 20 // (K * N)))  # weights of 64 MB in all
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            sets = [quant.quantize_cols(torch.randn((K, N), generator=g, device=dev).to(dt), dt)
                    for _ in range(n_sets if dtype == "bfloat16" else 1)]
            sets = [(wi, wi.t().contiguous(), sw) for wi, sw in sets]
            for b in (1, 8):
                y = torch.randn((b, K), generator=g, device=dev).to(dt)
                wi, wt, sw = sets[0]
                got = quant.matmul_i8w_cuda(y, wt, sw, dt)
                want = quant.matmul_i8w_plain(y, wt, sw, dt)
                torch.cuda.synchronize()
                top = float(want.float().abs().max())
                tol = (K11_TOL * top, 2 ** -7 if dtype == "bfloat16" else K11_TOL)
                e, ok = _err(got, want, dtype, tol)
                ce, cok = _err(got, (y @ wi.to(dt)) * sw, dtype, tol)
                print(f"kernel 11 matmul_i8w {dtype} ({b}, {K}) x ({K}, {N}): max_abs_err {e:.3g}"
                      f"{' (bit-equal)' if torch.equal(got, want) else ''} (|out| <= {top:.3g}); "
                      f"control, int8 weights without activation rounding: {ce:.3g}")
                check(ok, f"matmul_i8w disagrees with its plain version ({dtype}, b={b}, K={K}, "
                          f"N={N}): max abs err {e}")
                check(not cok, f"kernel 11: the control reads {ce}, within the bound")
                err11 = max(err11, e)
                if dtype == "bfloat16":
                    kd, pd = time_both(
                        card, [lambda s=s: quant.matmul_i8w_cuda(y, s[1], s[2], dt) for s in sets],
                        [lambda s=s: quant.matmul_i8w_plain(y, s[1], s[2], dt) for s in sets],
                        2 * n_sets, f"kernel 11 ({b}, {K}) x ({K}, {N}) ")
                    # yardsticks: the library's bf16 product on the unquantized
                    # size, and torch._int_mm (which wants more than 16 rows: the
                    # quantized rows padded to 32) plus the scaling
                    dense = device_ms([lambda s=s: y @ s[0].to(dt) for s in sets], 2 * n_sets)
                    y8, sy = quant.quantize_rows_i8(y)
                    y32 = torch.zeros((32, K), dtype=torch.int8, device=dev)
                    y32[:b] = y8
                    try:
                        int_mm = device_ms(
                            [lambda s=s: (torch._int_mm(y32, s[0])[:b].float() * sy
                                          * s[2].float()).to(dt) for s in sets], 2 * n_sets)
                    except RuntimeError as exc:  # a yardstick only: its shape limits vary
                        print(f"  torch._int_mm refused the shape: {exc}")
                        int_mm = None
                    bd, by = bound_ms("int8", K * N + b * K * 2 + N * 2 + b * N * 2, 2 * b * K * N)
                    print(f"  kernel 11 ({b}, {K}) x ({K}, {N}) bf16: bound {bd:.4f} ms ({by}); "
                          f"torch._int_mm on 32 padded rows + scaling "
                          f"{'refused' if int_mm is None else f'{int_mm:.4f} ms'}; bf16 matmul on "
                          f"the cast weight (the int8 mode) {dense:.4f} ms [{card}]")
                    shapes[f"{b}x{K}x{N}"] = {"ms": kd, "plain_ms": pd, "bound_ms": bd,
                                              "bound_by": by, "library_ms": int_mm,
                                              "cast_matmul_ms": dense}
            del sets
    main = shapes["8x512x3072"]
    res["matmul_i8w"] = dict(main, err=err11, shapes=shapes)
    return res


def _quantized_vt(vt, **knobs):
    """The same VideoTransformer with TEST.VT_SAMPLER keys set, as a config
    file or the command line would set them."""
    cfg = vt.cfg.clone()
    cfg.merge_from_list([x for k, v in knobs.items() for x in (f"TEST.VT_SAMPLER.{k}", v)])
    return type(vt)(cfg, T=vt.T, H=vt.H, W=vt.W)


I8_RUNS = (  # label, config keys, expected launches of kernels (2, 3, 4, 11) per rollout
    ("native", {}, (22528, 0, 0, 0)),
    ("int8 KV + pallas", {"KV_DTYPE": "int8", "ATTN_IMPL": "pallas"}, (0, 22528, 0, 0)),
    ("int8 KV + pallas-live", {"KV_DTYPE": "int8", "ATTN_IMPL": "pallas-live"},
     (0, 0, 22528, 0)),
    ("int8 KV + pallas + int8-pallas weights",
     {"KV_DTYPE": "int8", "ATTN_IMPL": "pallas", "WEIGHT_DTYPE": "int8-pallas"},
     (0, 22528, 0, 90112)),
)


def phase_main_i8(card, models):
    """The quantized sampler at full width through generate(): b=8, bf16, all
    11 sampled frames, greedy, each row from differently shifted priming
    frames. Returns the launches of kernels 3, 4 and 11, each from the run
    that was driven with the counts at 0."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import generate_videos_torch as gvt
    from lvt_tpu_torch.ops.attention import block_attention_fwd_cuda
    from lvt_tpu_torch.ops.cache_attention import decode_attention_cuda

    k3, k4, _, k11 = _i8_kernels()
    counted = (decode_attention_cuda, k3, k4, k11)
    vqvae, vq_params, vq_state, vt, vt_params = models
    dev = torch.device("cuda")
    frames = torch.from_numpy(gvt.load_priming_frames(os.path.join(ROOT, "example"), N_PRIME))
    b = 8
    frames = torch.stack([torch.roll(frames, (3 * i, 5 * i), (1, 2)) for i in range(b)]).to(dev)
    n_slices = T_FRAMES - N_PRIME
    out, launches = {}, {}
    for label, knobs, want in I8_RUNS:
        model = _quantized_vt(vt, **knobs) if knobs else vt
        for k in counted + (block_attention_fwd_cuda,):
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        video, codes, primed, seconds = gvt.generate(vqvae, vq_params, vq_state, model, vt_params,
                                                     frames, N_PRIME, None, greedy=True)
        peak = torch.cuda.max_memory_allocated()
        took = tuple(k.launches for k in counted)
        _check_run(label, video, codes, primed, 512, b)
        check(took == want and block_attention_fwd_cuda.launches == n_slices * 8,
              f"{label}: launches of kernels 2, 3, 4, 11 {took}, want exactly {want}; kernel 1 "
              f"{block_attention_fwd_cuda.launches}, want {n_slices * 8}")
        out[label], launches[label] = codes, took
        agree = float((codes[:, :, N_PRIME:] == out["native"][:, :, N_PRIME:]).float().mean())
        first = float((codes[:, :, N_PRIME] == out["native"][:, :, N_PRIME]).float().mean())
        print(f"main path batch {b} bf16 greedy, {label} [{card}]: rollout {seconds:.3f} s, "
              f"{b * n_slices / seconds:.3f} generated frames/s; launches of kernels 2, 3, 4, 11 "
              f"{took}; max_memory_allocated {peak / 2 ** 20:.1f} MiB; greedy codes equal to the "
              f"native rollout's: {agree:.4f} of all sampled, {first:.4f} of the first sampled "
              "frame")
        if knobs:
            check(agree >= GREEDY_FLOOR, f"{label}: greedy agreement with the native rollout "
                                         f"{agree}, under the floor {GREEDY_FLOOR}")
    check(not torch.equal(out["int8 KV + pallas"], out["native"]),
          "the int8 rollout's codes equal the native ones: were the config keys read?")
    return (launches["int8 KV + pallas"][1], launches["int8 KV + pallas-live"][2],
            launches["int8 KV + pallas + int8-pallas weights"][3])


def phase_agree_i8(card):
    """fp32, b=2, full width, one slice teacher-forced: the three kernel modes
    of the quantized sampler on the card against the plain path on the CPU."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import generate_videos_torch as gvt
    from lvt_tpu_torch.models import to_device
    from lvt_tpu_torch.models.vt import vt_encode
    from lvt_tpu_torch.models.vt_incremental import sample_slice_incremental

    cfg = gvt.load_config(os.path.join(ROOT, "configs", "vt", "DSFVT.yaml"))
    dev = torch.device("cuda")
    *_, vt, params = gvt.build_models(cfg, 1, dev, torch.float32)
    video = np.random.default_rng(0).integers(0, vt.c.nv, size=(2, vt.c.nc, T_FRAMES, 16, 16))
    modes = {"native": {}, **{label: {"kv_dtype": k["KV_DTYPE"], "attn_impl": k["ATTN_IMPL"],
                                      "weight_dtype": k.get("WEIGHT_DTYPE", "native")}
                              for label, k, _ in I8_RUNS[1:]}}
    out = {}
    for name, device, p in (("card", dev, params["netG"]),
                            ("cpu", torch.device("cpu"), to_device(params["netG"], "cpu"))):
        sidx = torch.full((2,), N_PRIME, dtype=torch.int64, device=device)
        ctx, sl, _ = vt.prepare_slices(torch.from_numpy(video).to(device), sidx)
        with torch.no_grad():
            zl = vt_encode(p, vt.c, ctx, sidx)
            for label, knobs in modes.items():
                t0 = time.perf_counter()
                out[name, label] = sample_slice_incremental(
                    p, vt.c, vt.plan.slice_shape, zl, sl, None, np.ones(256, bool), 1.0,
                    teacher_logits=True, **knobs)[1].cpu()
                print(f"  agree i8 {name} {label}: {time.perf_counter() - t0:.1f} s")
    def rms(x):
        return float(x.pow(2).mean().sqrt())

    for label in list(modes)[1:]:
        gap = out["cpu", label] - out["cpu", "native"]
        err = out["card", label] - out["cpu", label]
        ctl = out["card", "native"] - out["cpu", label]
        bound = AGREE_I8[modes[label]["weight_dtype"]] * rms(gap)
        print(f"agree i8 fp32 b=2 full width, {label} [{card}]: teacher logits card vs cpu plain "
              f"rms {rms(err):.3g} (max {float(err.abs().max()):.3g}); the mode's gap to the "
              f"native sampler rms {rms(gap):.3g} (max {float(gap.abs().max()):.3g}); bound "
              f"{bound:.3g} rms; control, native logits on the card against this mode's: rms "
              f"{rms(ctl):.3g}")
        check(rms(err) <= bound, f"agree i8, {label}: card vs cpu rms {rms(err)}, bound {bound}")
        check(rms(ctl) > bound, f"agree i8, {label}: the control reads {rms(ctl)}, within the "
                                f"bound {bound}")


def _near_ties(got, want, z, codebook):
    """(rows that differ, rows among them that are no near-tie) of two index
    vectors over z (N, Dc) and codebook (K, Dc), by float64 distances."""
    import torch

    rows = torch.nonzero(got != want).flatten()
    if not len(rows):
        return 0, 0
    z64, c64 = z[rows].double(), codebook.double()
    dg = ((z64 - c64[got[rows].long()]) ** 2).sum(1)
    dw = ((z64 - c64[want[rows].long()]) ** 2).sum(1)
    size = (z64 ** 2).sum(1) + (c64[want[rows].long()] ** 2).sum(1)
    return len(rows), int(((dg - dw).abs() > NEAR_TIE_ULPS * 2 ** -23 * size).sum())


def _indices_ok(got, want, z, codebook):
    n_diff, n_far = _near_ties(got, want, z, codebook)
    return n_diff, n_far, n_far == 0 and n_diff <= max(1, int(NEAR_TIE_SHARE * want.numel()))


def phase_vq_kernel(card, models):
    """Kernel 6 against its plain version at PR-DVQVAE2's training shape and
    Base-VQVAE's, with ties, a control, determinism, times, and the real z_e
    of example/*.png."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import generate_videos_torch as gvt
    from lvt_tpu_torch.ops import vq

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    K, worst = 512, 0
    for Dc in (64, 256):
        codebook = torch.randn((K, Dc), generator=g, device=dev)
        for N in (1, 8192, 8192 + 37):
            for dtype in ("float32", "bfloat16"):
                for strided in (False, True):
                    zz = torch.randn((N, 4, Dc) if strided else (N, Dc), generator=g,
                                     device=dev).to(getattr(torch, dtype))
                    z = zz[:, 2, :] if strided else zz
                    got, again = vq.nearest_indices_cuda(z, codebook), \
                        vq.nearest_indices_cuda(z, codebook)
                    want = vq.nearest_indices_plain(z, codebook)
                    torch.cuda.synchronize()
                    n_diff, n_far, ok = _indices_ok(got, want, z, codebook)
                    worst = max(worst, n_diff)
                    print(f"kernel 6 nearest_indices {dtype} N={N} K={K} Dc={Dc} "
                          f"{'strided' if strided else 'contiguous'}: {n_diff} of {N} indices "
                          f"differ from the plain version's, {n_far} of them no near-tie; two "
                          "calls bit-identical")
                    check(got.dtype == torch.int32 and tuple(got.shape) == (N,),
                          f"nearest_indices: output {got.dtype} {tuple(got.shape)}")
                    check(ok, f"nearest_indices disagrees with its plain version ({dtype}, N={N}, "
                              f"Dc={Dc}, strided={strided}): {n_diff} differ, {n_far} no near-tie")
                    check(torch.equal(got, again), "nearest_indices: two calls differ")
    # exact ties: four copies of every code, and rows of z that equal a code
    base = torch.randn((128, 64), generator=g, device=dev)
    codebook = base.repeat(4, 1)
    z = torch.cat([base[[5, 127, 0]], torch.randn((8192, 64), generator=g, device=dev)])
    got, want = vq.nearest_indices_cuda(z, codebook), vq.nearest_indices_plain(z, codebook)
    check(got[:3].tolist() == [5, 127, 0] and int(got.max()) < 128 and torch.equal(got, want),
          f"nearest_indices: ties do not go to the lowest index (max index {int(got.max())}, "
          f"{int((got != want).sum())} differ from the plain version)")
    print("kernel 6 ties (512 codes = 4 copies of 128; 3 rows of z equal a code): the lowest "
          "index everywhere, equal to the plain version")
    # control: the plain version on bf16-rounded z is another function
    codebook = torch.randn((K, 64), generator=g, device=dev)
    z = torch.randn((8192, 64), generator=g, device=dev)
    got = vq.nearest_indices_cuda(z, codebook)
    n_diff, n_far, ok = _indices_ok(got, vq.nearest_indices_plain(z.bfloat16(), codebook), z,
                                    codebook)
    print(f"  control, the plain version on bf16-rounded z: {n_diff} of 8192 differ, {n_far} no "
          "near-tie")
    check(not ok, "nearest_indices: the control passes the near-tie check")

    # times at the training shape: z_e of one step, (8192, 4, 64), one
    # sub-codebook per call, read in place; 8 sets (64 MB in fp32) cycle
    times = {}
    for dtype in ("bfloat16", "float32"):
        sets = [torch.randn((8192, 4, 64), generator=g, device=dev).to(getattr(torch, dtype))
                for _ in range(8)]
        views = [zs[:, i, :] for zs in sets for i in range(4)]
        kd, pd = time_both(card, [lambda v=v: vq.nearest_indices_cuda(v, codebook) for v in views],
                           [lambda v=v: vq.nearest_indices_plain(v, codebook) for v in views],
                           128, f"kernel 6 {dtype} N=8192 K=512 Dc=64 strided ")
        lib = device_ms([lambda v=v: torch.cdist(v.float(), codebook).argmin(1) for v in views],
                        128)
        times[dtype] = (kd, pd, lib)
        del sets, views
    cb256 = torch.randn((K, 256), generator=g, device=dev)
    sets = [torch.randn((8192, 256), generator=g, device=dev) for _ in range(8)]
    t256 = time_both(card, [lambda v=v: vq.nearest_indices_cuda(v, cb256) for v in sets],
                     [lambda v=v: vq.nearest_indices_plain(v, cb256) for v in sets], 32,
                     "kernel 6 float32 N=8192 K=512 Dc=256 ")
    del sets
    bd, by = bound_ms("float32", 8192 * 64 * 2 + K * 64 * 4 + 8192 * 4, 2 * 8192 * K * 64)
    print(f"  kernel 6 N=8192 K=512 Dc=64: bound {bd:.4f} ms ({by}: 2 N K Dc operations at the "
          f"non-tensor fp32 peak, {PEAK_FLOPS['float32'] / 1e12:.0f} TFLOP/s; z, codebook and "
          f"indices are {(8192 * 64 * 2 + K * 64 * 4 + 8192 * 4) / 1e6:.2f} MB); library "
          f"yardstick torch.cdist(z, c).argmin(1): bf16 z (cast to fp32 first) "
          f"{times['bfloat16'][2]:.4f} ms, fp32 z {times['float32'][2]:.4f} ms [{card}]")

    # the real z_e of example/*.png: a record for encode_indices' default
    vqvae, vq_params, vq_state = models[:3]
    frames = torch.from_numpy(gvt.load_priming_frames(os.path.join(ROOT, "example"), N_PRIME))
    with torch.no_grad():
        z_e, _ = vqvae.encode_features(vq_params, vq_state,
                                       vqvae.normalize(frames.to(dev) / 255.0))
        plain = vq.encode_indices(z_e, vq_state["netC"])
        kernel = vq.encode_indices(z_e, vq_state["netC"], use_kernel=True)
    emb = vq_state["netC"]["embedding"]
    num, _, Dc = emb.shape
    z = z_e.reshape(-1, num, Dc)
    diffs = [_near_ties(kernel.reshape(-1, num)[:, i], plain.reshape(-1, num)[:, i], z[:, i, :],
                        emb[i]) for i in range(num)]
    n_diff, n_far = sum(d[0] for d in diffs), sum(d[1] for d in diffs)
    print(f"kernel 6 on the z_e of example/*.png (seeded random PR-DVQVAE2 weights, "
          f"{plain.numel()} indices): {n_diff} differ from encode_indices' plain ones, {n_far} "
          "of them no near-tie")
    check(n_far == 0, f"nearest_indices on real z_e: {n_far} indices differ at no near-tie")
    return {"err": float(worst), "ms": times["bfloat16"][0], "plain_ms": times["bfloat16"][1],
            "bound_ms": bd, "bound_by": by, "library_ms": times["bfloat16"][2],
            "fp32_ms": times["float32"][0], "fp32_plain_ms": times["float32"][1],
            "fp32_library_ms": times["float32"][2], "dc256_ms": t256[0],
            "dc256_plain_ms": t256[1], "err_is": "indices that differ, all at near-ties"}


def _write_frames(root, n_videos, n_frames, seed):
    """PNG frames of 64x64 in the BAIR layout, <root>/train/video_<v>/<f>.png:
    8x8 colour blocks that drift from frame to frame, plus noise, drawn from a
    numpy seed."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    for v in range(n_videos):
        d = os.path.join(root, "train", f"video_{v}")
        os.makedirs(d)
        blocks = rng.uniform(0, 255, (8, 8, 3))
        for f in range(n_frames):
            blocks = np.clip(blocks + rng.normal(0, 12, blocks.shape), 0, 255)
            frame = np.kron(blocks, np.ones((8, 8, 1))) + rng.normal(0, 6, (64, 64, 3))
            Image.fromarray(np.clip(frame, 0, 255).astype(np.uint8)).save(
                os.path.join(d, f"{f}.png"))


def phase_vqvae_train(card):
    """PR-DVQVAE2 training through tools/train_net_torch.py's main at full
    width, then --resume; per-step launches of kernel 6 and times recorded
    around Trainer.train_step."""
    import shutil
    import tempfile
    from contextlib import nullcontext

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import train_net_torch
    from lvt_tpu_torch.checkpoint.convert import flatten
    from lvt_tpu_torch.data.datasets.bair import register_bair
    from lvt_tpu_torch.engine.defaults import default_argument_parser
    from lvt_tpu_torch.engine.trainer import Trainer
    from lvt_tpu_torch.ops.vq import nearest_indices_cuda

    n_steps, n_resume = VQ_TRAIN_STEPS, VQ_RESUME_STEPS
    tmp = tempfile.mkdtemp(prefix="chip_smoke_vqvae_")
    steps, profiled, resumed_from = [], [], []
    inner = Trainer.train_step

    def recorded(self, batch):
        if len(steps) == n_steps:  # the resumed run's first step: what it starts from
            resumed_from.append({k: v.clone() for k, v in flatten(self.state.model_state).items()})
        torch.cuda.synchronize()
        c0 = nearest_indices_cuda.launches
        last = len(steps) == n_steps + n_resume - 1  # outside the medians
        with profile(activities=[ProfilerActivity.CUDA]) if last else nullcontext() as prof:
            t0 = time.perf_counter()
            metrics = inner(self, batch)
            terms = {k: float(v) for k, v in metrics.items()}  # synchronizes
            took = time.perf_counter() - t0
        if last:
            profiled.append((took, prof))
        steps.append((took, terms, nearest_indices_cuda.launches - c0, t0))
        return metrics

    try:
        t0 = time.perf_counter()
        _write_frames(os.path.join(tmp, "frames"), VQ_FRAMES // T_FRAMES, T_FRAMES, 0)
        register_bair("chip_smoke_frames", os.path.join(tmp, "frames"), "train", True)
        print(f"vqvae train data: {VQ_FRAMES} PNG frames of 64x64 written in "
              f"{time.perf_counter() - t0:.2f} s")
        out = os.path.join(tmp, "out")
        # PR-DVQVAE2 as it stands: no override of the model, batch or solver
        opts = ["--config-file", os.path.join(ROOT, "configs", "vqvae", "PR-DVQVAE2.yaml"),
                "SOLVER.CHECKPOINT_PERIOD", str(n_steps // 2),
                "DATASETS.TRAIN", "('chip_smoke_frames',)", "DATALOADER.NUM_WORKERS", "8",
                "OUTPUT_DIR", out]
        parse = default_argument_parser().parse_args
        Trainer.train_step = recorded
        torch.cuda.reset_peak_memory_stats()
        nearest_indices_cuda.launches = 0
        t0 = time.perf_counter()
        tr = train_net_torch.main(parse(opts + ["SOLVER.MAX_ITER", str(n_steps)]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = nearest_indices_cuda.launches
        peak = torch.cuda.max_memory_allocated()
        cfg = tr.cfg
        check(cfg.MODEL.ENCODER.NF == 256 and cfg.MODEL.CODEBOOK.NUM == 4 and cfg.MODEL.CODEBOOK.EMA
              and cfg.SOLVER.IMS_PER_BATCH == 32 and tr.compute_dtype == torch.bfloat16,
              "vqvae train: not PR-DVQVAE2 at full width, batch 32, bf16 compute")
        check(tr.state.step == n_steps and len(steps) == n_steps,
              f"vqvae train: {tr.state.step} steps taken, want {n_steps}")
        check(sorted(os.listdir(os.path.join(out, "checkpoints"))) ==
              sorted([f"ckpt_{n_steps // 2}.pt", f"ckpt_{n_steps}.pt"]),
              f"vqvae train: checkpoints {os.listdir(os.path.join(out, 'checkpoints'))}")
        data_time = tr.storage.history("data_time").median(n_steps - 3)
        end_state = {k: v.clone() for k, v in flatten(tr.state.model_state).items()}
        fresh = flatten(tr.model.init(torch.Generator().manual_seed(tr.seed))[1])
        tr2 = train_net_torch.main(parse(["--resume"] + opts + [
            "SOLVER.MAX_ITER", str(n_steps + n_resume)]))
        check(tr2.start_iter == n_steps and tr2.state.step == n_steps + n_resume,
              f"vqvae resume: started at {tr2.start_iter}, ended at {tr2.state.step}")
    finally:
        Trainer.train_step = inner
        shutil.rmtree(tmp, ignore_errors=True)

    for name in ("loss_reconstruction", "loss_commitment"):
        vals = [s[1].get(name, float("nan")) for s in steps]
        check(all(np.isfinite(vals)), f"vqvae train: non-finite {name} {vals}")
    per_step = {s[2] for s in steps}
    check(per_step == {4}, f"vqvae train: kernel-6 launches per step {sorted(per_step)}, want "
                           "exactly 4 (one per sub-codebook)")
    # the EMA codebook: moved, holding the mass 8192 (1 - 0.99^n) per sub-codebook
    check(not torch.equal(end_state["netC.embedding"].cpu(), fresh["netC.embedding"]),
          "vqvae train: the EMA embedding did not move")
    rows = cfg.SOLVER.IMS_PER_BATCH * 16 * 16
    mass, want_mass = end_state["netC.running_size"].sum(dim=1), rows * (1 - 0.99 ** n_steps)
    check(bool(((mass - want_mass).abs() <= 1e-4 * want_mass).all()),
          f"vqvae train: running_size sums to {mass.tolist()}, want {want_mass}")
    check(len(resumed_from) == 1 and all(torch.equal(v, end_state[k])
                                         for k, v in resumed_from[0].items()),
          "vqvae resume: the resumed run does not start from the saved model state")
    check(all(v.grad_fn is None and v.dtype == torch.float32 for v in end_state.values()),
          "vqvae train: the model state holds a graph or left fp32")
    used = (end_state["netC.running_size"] > 0).sum(dim=1).tolist()

    sec = float(np.median([s[0] for s in steps[3:n_steps]]))
    it_sec = float(np.median([b[3] - a[3] for a, b in zip(steps[3:n_steps - 1],
                                                           steps[4:n_steps])]))
    batch = cfg.SOLVER.IMS_PER_BATCH
    first, last = steps[0][1], steps[n_steps - 1][1]
    print(f"train PR-DVQVAE2 b={batch} bf16 64x64 [{card}]: {n_steps} steps in {wall:.2f} s with "
          f"set-up; median {sec:.4f} s/step over steps 4-{n_steps} (train_step, synchronized), "
          f"{it_sec:.4f} s/iteration (with data and hooks) = {batch / it_sec:.2f} frames/s; "
          f"data_time median {data_time:.4f} s; first step {steps[0][0]:.3f} s; "
          f"max_memory_allocated {peak / 2 ** 30:.2f} GiB; kernel-6 launches per step 4 (run: "
          f"{launches}); loss_reconstruction {first['loss_reconstruction']:.4f} -> "
          f"{last['loss_reconstruction']:.4f}, loss_commitment {first['loss_commitment']:.5f} -> "
          f"{last['loss_commitment']:.5f}; codes hit per sub-codebook (of 512) {used}; "
          f"running_size mass {float(mass[0]):.2f} (want {want_mass:.2f}); resumed at {n_steps} "
          f"from the saved codebook, {n_resume} more steps")
    check(len(profiled) == 1, "vqvae train: the last resumed step was not profiled")
    busy, activities = _print_step_profile(card, batch, sec, *profiled[0], what="PR-DVQVAE2")
    return {"launches": launches, "sec": sec, "it_sec": it_sec, "frames_per_s": batch / it_sec,
            "peak": peak, "busy_ms": busy, "activities": activities}


def phase_vqvae_agree(card):
    """fp32, batch 4, PR-DVQVAE2 at full width, the same weights: one loss and
    backward on the card (kernel 6) against the plain path on the CPU."""
    import copy

    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import generate_videos_torch as gvt
    from lvt_tpu_torch.checkpoint.convert import flatten
    from lvt_tpu_torch.models import to_device
    from lvt_tpu_torch.models.vqvae import VQVAE
    from lvt_tpu_torch.ops import vq
    from lvt_tpu_torch.ops.vq import nearest_indices_cuda

    model = VQVAE(gvt.load_config(os.path.join(ROOT, "configs", "vqvae", "PR-DVQVAE2.yaml")))
    params, state = model.init(torch.Generator().manual_seed(5))
    frames = torch.from_numpy(np.random.default_rng(5).uniform(0, 1, (4, 64, 64, 3))
                              .astype(np.float32))
    res, taken = {}, []
    inner = vq.quantize_st

    def recording(z_e, *a, **k):
        taken.append((z_e.detach().cpu(), inner(z_e, *a, **k)))
        return taken[-1][1]

    vq.quantize_st = recording
    try:
        for name, device, tf32 in (("cpu", "cpu", False), ("card", "cuda", False),
                                   ("tf32", "cuda", True)):
            p = copy.deepcopy(to_device(params, device))
            for leaf in flatten(p).values():
                leaf.requires_grad_(True)
            before = nearest_indices_cuda.launches
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
            try:
                loss, (terms, new_state) = model.train_loss(
                    p, to_device(state, device), {"image": frames.to(device)})
                loss.backward()
            finally:
                torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
            z_e, idx = taken[-1][0], taken[-1][1][2].cpu()
            res[name] = ({k: float(v.detach()) for k, v in terms.items()},
                         {k: v.grad.cpu() for k, v in flatten(p).items()},
                         {k: v.cpu() for k, v in flatten(new_state["netC"]).items()}, idx)
            took = nearest_indices_cuda.launches - before
            check(took == (4 if device == "cuda" else 0),
                  f"vqvae agree ({name}): {took} kernel-6 launches")
            if name == "cpu":
                z_cpu = z_e
    finally:
        vq.quantize_st = inner
    del z_e

    def worst(grads, ref):
        floor = 1e-2 * max(float(g.norm()) for g in ref.values())
        rel = {k: float((grads[k] - g).norm()) / max(float(g.norm()), floor)
               for k, g in ref.items()}
        k = max(rel, key=rel.get)
        whole = float(torch.stack([(grads[k] - g).norm() for k, g in ref.items()]).norm())
        return rel[k], k, whole / float(torch.stack([g.norm() for g in ref.values()]).norm())

    emb = state["netC"]["embedding"]
    out = {}
    for name in ("card", "tf32"):
        terms, grads, new_cb, idx = res[name]
        e, k, w = worst(grads, res["cpu"][1])
        # indices under the near-tie rule, by float64 distances of the CPU's z_e
        ref_idx = res["cpu"][3]
        diffs = [_near_ties(idx.reshape(-1, 4)[:, i], ref_idx.reshape(-1, 4)[:, i],
                            z_cpu.reshape(-1, 4, 64)[:, i, :], emb[i]) for i in range(4)]
        n_diff, n_far = sum(d[0] for d in diffs), sum(d[1] for d in diffs)
        # the new EMA state on the codes no differing index touches
        touched = torch.zeros((4, 512), dtype=torch.bool)
        for i in range(4):
            a, b = idx.reshape(-1, 4)[:, i].long(), ref_idx.reshape(-1, 4)[:, i].long()
            touched[i, a[a != b]] = True
            touched[i, b[a != b]] = True
        # codes the batch hit hold means of z_e (|.| ~ 1), the others the
        # initial sums over a denominator of ~eps (|.| ~ 1e2): each group of
        # embedding rows is held to its own largest value
        hit = res["cpu"][2]["running_size"] > 0
        state_err = 0.0
        for field, ref in res["cpu"][2].items():
            for rows in ((hit, ~hit) if field == "embedding" else (torch.ones_like(hit),)):
                keep = rows & ~touched
                keep = keep if ref.dim() == 2 else keep[:, :, None].expand_as(ref)
                if bool(keep.any()):
                    state_err = max(state_err, float((new_cb[field] - ref).abs()[keep].max())
                                    / float(ref.abs()[keep].max()))
        term_err = max(abs(terms[t] - v) / abs(v) for t, v in res["cpu"][0].items())
        out[name] = (e, k, w, n_diff, n_far, state_err, term_err)
    n_idx = res["cpu"][3].numel()
    print(f"vqvae agree fp32 b=4 full width, one loss+backward [{card}], "
          f"{len(res['cpu'][1])} gradient leaves: " + "; ".join(
              f"{label}: loss terms off by {o[6]:.3g} (relative), worst leaf {o[0]:.3g} ({o[1]}), "
              f"whole gradient {o[2]:.3g}, {o[3]} of {n_idx} indices differ ({o[4]} no near-tie), "
              f"new EMA state off by {o[5]:.3g} of its largest value"
              for label, o in (("card vs cpu plain", out["card"]),
                               ("TF32 control", out["tf32"])))
          + f"; bound {GRAD_TOL:g} per leaf and whole; losses cpu "
          + ", ".join(f"{k} {v:.6f}" for k, v in res["cpu"][0].items()))
    e, k, w, n_diff, n_far, state_err, term_err = out["card"]
    check(term_err <= 1e-5, f"vqvae agree: loss terms off by {term_err} (relative)")
    check(e <= GRAD_TOL, f"vqvae agree: gradient {k} off by {e} (relative)")
    check(w <= GRAD_TOL, f"vqvae agree: the whole gradient is off by {w} (relative)")
    check(n_far == 0 and n_diff <= max(1, int(VQ_AGREE_SHARE * n_idx)),
          f"vqvae agree: {n_diff} indices differ, {n_far} of them at no near-tie")
    check(state_err <= 1e-5, f"vqvae agree: the new EMA state is off by {state_err}")
    e, _, w = out["tf32"][:3]
    check(e > GRAD_TOL and w > GRAD_TOL,
          f"vqvae agree: the TF32 control reads {e} per leaf, {w} whole, within the bound "
          f"{GRAD_TOL}: it cannot tell TF32 from true fp32")


def phase_probe_kernel(card):
    """Kernel 12 against its plain version at the probe tool's shape and
    DSFVT's; then the tool's own timing run, with the launch count read
    around it."""
    import importlib.util

    import torch

    from lvt_tpu_torch.ops import cache_attention as ca

    spec = importlib.util.spec_from_file_location(
        "probe_decode_kernel_torch", os.path.join(ROOT, "tools", "probe_decode_kernel_torch.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)

    err = 0.0
    for label, (b, na, R, da) in tool.SHAPES.items():
        scale = da ** -0.5
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            q, k8, ks, v8, vs, extra = tool.make_inputs(12, b, na, R, da, dt, "cuda")
            extra = 0.5 * torch.randn_like(extra)  # no mask: `live` bounds the rows
            for live in (1, 64, 200, 256):
                k8p, v8p = k8.clone(), v8.clone()
                k8p[:, :, live:], v8p[:, :, live:] = 127, -128  # rows >= live are never read
                got = ca.decode_attention_i8kv_cuda(q, k8p, ks, v8p, vs, extra, scale, live)
                want = ca.decode_attention_i8kv_plain(q, k8p, ks, v8p, vs, extra, scale, live)
                torch.cuda.synchronize()
                top = float(want.float().abs().max())
                # fp32: sums in another order, 1e-5 of the largest output. bf16:
                # one rounding of the output (2^-7 relative) plus two weights
                # whose fp32 values the two versions put on either side of a
                # bf16 boundary, each moving an output by ulp_bf16(w) * |v|
                logits = torch.einsum("bad,bajd->baj", q.float(), k8p[:, :, :live].float())
                w = torch.softmax(logits * scale * ks[:, :, :live] + extra[:, :, :live], -1) \
                    * vs[:, :, :live]
                tol = (1e-5 * top + (2 * 2 ** -8 * 127 * float(w.max())
                                     if dtype == "bfloat16" else 0.0),
                       2 ** -7 if dtype == "bfloat16" else 0.0)
                e, ok = _err(got, want, dtype, tol)
                print(f"kernel 12 decode_attention_i8kv {dtype} live={live} ({label}: b={b}, "
                      f"na={na}, R={R}, da={da}): max_abs_err {e:.3g} (|out| <= {top:.3g}, "
                      f"bound {tol[0]:.3g} + {tol[1]:.3g} relative)")
                check(ok, f"decode_attention_i8kv disagrees with its plain version ({label}, "
                          f"{dtype}, live={live}): max abs err {e}")
                err = max(err, e)
                if live == 256:
                    # control: kernel 3's scheme (int8 q and weights) on the same inputs
                    q8, sq = tool.quantize_q(q)
                    ctl = ca.decode_attention_i8_plain(q8, sq, k8p, ks, v8p, vs, live, extra[0],
                                                       scale, dt).reshape(want.shape)
                    ce, cok = _err(got, ctl, dtype, tol)
                    print(f"  control, kernel 3's scheme on the same inputs: max_abs_err {ce:.3g}")
                    check(not cok, f"kernel 12 ({label}, {dtype}): the control reads {ce}, within "
                                   "the bound")
    ca.decode_attention_i8kv_cuda.launches = 0
    times = tool.bench(torch.bfloat16)
    launches = ca.decode_attention_i8kv_cuda.launches
    check(launches > 0, "the probe tool launched kernel 12 no time")
    b, na, R, da = tool.SHAPES["probe"]
    bd, by = bound_ms("bfloat16", 2 * b * na * R * da + 2 * b * na * R * 4 + na * R * 4
                      + 2 * b * na * da * 2, 4 * b * na * R * da)
    b2, na2, R2, da2 = tool.SHAPES["dsfvt"]
    bd2, _ = bound_ms("bfloat16", 2 * b2 * na2 * R2 * da2 + 2 * b2 * na2 * R2 * 4 + na2 * R2 * 4
                      + 2 * b2 * na2 * da2 * 2, 4 * b2 * na2 * R2 * da2)
    probe, dsfvt = times["probe"], times["dsfvt"]
    k2 = dsfvt["decode_attention (kernel 2, cache in the io dtype)"]
    k3 = dsfvt["decode_attention_i8 (kernel 3)"]
    print(f"  kernel 12 bf16 [{card}]: the probe's shape (b={b}, da={da}) "
          f"{probe['decode_attention_i8kv']:.4f} ms, plain {probe['plain']:.4f}, bound {bd:.4f} "
          f"({by}); DSFVT's shape (b={b2}, da={da2}) {dsfvt['decode_attention_i8kv']:.4f} ms, "
          f"plain {dsfvt['plain']:.4f}, bound {bd2:.4f}, kernel 2 {k2:.4f}, kernel 3 {k3:.4f}; no "
          f"single library call computes it; launches in the tool's run {launches}")
    return {"err": err, "ms": probe["decode_attention_i8kv"], "plain_ms": probe["plain"],
            "bound_ms": bd, "bound_by": by, "library_ms": None,
            "dsfvt_ms": dsfvt["decode_attention_i8kv"], "dsfvt_plain_ms": dsfvt["plain"],
            "dsfvt_bound_ms": bd2, "kernel2_ms": k2, "kernel3_ms": k3}, launches


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
    i8res = phase_i8_kernels(card, kres["decode_attention"]["ms"])
    i8_launches = phase_main_i8(card, models)
    phase_profile(card, models, codes, "int8 KV + pallas", kv_dtype="int8", attn_impl="pallas")
    phase_profile(card, models, codes, "int8 KV + pallas + int8-pallas weights",
                  kv_dtype="int8", attn_impl="pallas", weight_dtype="int8-pallas")
    phase_agree_i8(card)
    k6 = phase_vq_kernel(card, models)
    del models, codes
    k10, err1_train, _ = phase_train_kernels(card)
    shapes = phase_attention_shapes(card)
    k10["err"] = max(k10["err"], shapes["bwd"], shapes["dbias"])
    fres, fbounds = phase_fused_kernels(card)
    fused_run, unfused_run = phase_train(card)
    phase_train_agree(card)
    vq_run = phase_vqvae_train(card)
    phase_vqvae_agree(card)
    k12, k12_launches = phase_probe_kernel(card)

    def entry(name, source, replaces, n_launches, r):
        keys = ("err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": n_launches, "max_abs_err": r["err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"],
                **{k: v for k, v in r.items() if k not in keys}}

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

    kres["block_attention_fwd"]["err"] = max(kres["block_attention_fwd"]["err"], err1_train,
                                             shapes["fwd"])
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
        entry("decode_attention_i8", "lvt_tpu_torch/csrc/decode_attention_i8.cu",
              "lvt_tpu/ops/cache_attention.py:147", i8_launches[0], i8res["decode_attention_i8"]),
        entry("decode_attention_i8_live", "lvt_tpu_torch/csrc/decode_attention_i8.cu",
              "lvt_tpu/ops/cache_attention.py:278", i8_launches[1],
              i8res["decode_attention_i8_live"]),
        entry("matmul_i8w", "lvt_tpu_torch/csrc/matmul_i8w.cu",
              "lvt_tpu/ops/quant_matmul.py:58", i8_launches[2], i8res["matmul_i8w"]),
        # kernel 5 is on no path of the sampler (in the JAX package only a test
        # calls it): held against its plain version in phase 10, launches 0
        dict(entry("cache_attention_i8", "lvt_tpu_torch/csrc/decode_attention_i8.cu",
                   "lvt_tpu/ops/cache_attention.py:35", 0, i8res["cache_attention_i8"]),
             on_main_path=False),
        # kernel 6: the launches of the VQ-VAE training run (4 per step);
        # max_abs_err counts indices that differ from the plain version's, all
        # of them verified near-ties
        entry("nearest_indices", "lvt_tpu_torch/csrc/nearest_indices.cu",
              "lvt_tpu/ops/vq.py:91", vq_run["launches"], k6),
        # kernel 12 is a tool's kernel, on no path of the sampler: the
        # launches are those of the tool's own timing run
        dict(entry("decode_attention_i8kv", "lvt_tpu_torch/csrc/decode_attention_i8.cu",
                   "tools/probe_decode_kernel.py:49", k12_launches, k12), on_main_path=False),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
