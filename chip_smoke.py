#!/usr/bin/env python
"""Chip smoke test of the PyTorch port (lvt_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):
  1. device   — a CUDA card must be present; prints nvidia-smi's name and
                power limit.
  2. build    — compiles lvt_tpu_torch/csrc/*.cu with nvcc for sm_90a.
  3. kernels  — each kernel against its plain PyTorch version on the card at
                DSFVT shapes, with the tolerances below; times both. Kernel 2
                also at the rollout's batch sizes (b in 1, 8, 16 x live in
                64, 256; bf16, and fp32 at b=1) beside the library call and
                the bound.
  4. main     — the generation path (PR-DVQVAE2 encode of example/*.png, DSFVT
                KV-cached rollout, decode) at full width with seeded random
                weights: batch 1 through scripts/generate_videos_torch.py as a
                user runs it (no VQ-VAE weights configured), and batch 8 with
                the VT in bf16, both sampled at temperature 1. Each slice is
                one replay of its CUDA graph (models/rollout_graph.py),
                captured at the first slice. Exactly 88 launches of kernel 1
                and 22,528 of kernel 2 in each rollout (a replay adds what its
                capture launched; the warm-up and the capture count none);
                rollout seconds, the capture's share of them, frames/s with
                and without it, peak memory. Kernel launch counts are read
                around this phase only.
  5. agree    — fp32, batch 2, full width: teacher-forced vt_logits (kernel 1
                causal and not) and the incremental decoder's teacher logits
                (kernel 2) on the card against the plain path on the CPU,
                and a control run of vt_logits with TF32 on that must
                fall outside the bound.
 5b. pth      — reference-layout .pth files at full width from a numpy seed
                (DSFVT's state dict and PR-DVQVAE2's netE, netG and netC,
                each wrapped as fvcore's {"model": state_dict}): batch 1
                through scripts/generate_videos_torch.py with the four files
                configured, with phase 4's checks and exact launch counts;
                the VT read from the same file on the card and on the CPU,
                its leaves equal and one slice's fp32 logits within PATH_TOL.
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
                the backward); one bf16 call of each under torch.profiler,
                by __global__ function.
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
                at b in (16, 8, 1) (kernel 5: 16, 1, 256), na=8, R=256,
                da=128, live in (1, 64, 200, 256), bf16 and fp32 scales (kernel
                5: fp32 scales, fp32 and bf16 q), and kernel 11 (the int8-weight
                product) at b in (1, 8, 16) for DSFVT's three shapes and at K
                = 1,040, each against its plain version under the bounds
                below (kernel 11 bit-equal; kernels 3 and 4 also two calls
                bit-identical), with a control that must read above them;
                device times over inputs larger than the L2: kernels 3 and 4
                (and their fused entries) swept over b in (1, 8, 16) x live
                in (16, 64, 128, 256), each beside the bound and kernel 2's
                time at that shape; kernel 5 beside kernel 2's and swept over
                b in (1, 16, 256) x live in (1, 64, 200, 256), kernel 11
                beside torch._int_mm plus the scaling (yardsticks, never on a
                path).
 10b. i8 fold — kernels 3 and 4 with the quantization of q and of the new
                cache row folded in (the sampler's call) against the PyTorch
                sequence they replace: q8, sq, the written cache rows and
                scales bit-equal, the outputs within the kernels' bound, at b
                in (1, 8, 16) x live in (1, 64, 65, 256), fp32 and bf16, rows
                at and next to x.5 and tiny rows among them.
 11. main i8  — the quantized sampler at full width, batch 8, bf16, all 11
                sampled frames, greedy, through generate() (the graph) with
                TEST.VT_SAMPLER.KV_DTYPE / ATTN_IMPL / WEIGHT_DTYPE set: a
                native rollout for reference, and the same rollout by the
                eager loop, its codes equal; then int8 KV + xla (PyTorch's
                ops, launches of kernels 2, 3, 4, 11 (0, 0, 0, 0)), int8 KV +
                pallas (kernel 3), int8 KV + pallas-live (kernel 4), int8 KV +
                pallas + int8-pallas weights (kernels 3 and 11). Launch counts
                set to 0 before each and read after: exactly 88 of kernel 1,
                22,528 of kernel 3 or 4 (all through the fused entry: one
                launch per layer and pixel that also quantizes q and writes
                the new cache row) and 90,112 of kernel 11 per rollout.
                Seconds with the capture's share, peak device memory and
                greedy agreement with the native rollout.
 11b. slices  — one slice of the batch-8 bf16 rollout, greedy, in every
                sampler mode (native; int8 KV with xla, xla + int8 mm,
                pallas, pallas-live; int8 and int8-pallas weights; int8 KV +
                pallas with int8-pallas weights), by the eager loop and by
                the slice's graph: codes bit-equal; each under
                torch.profiler (wall time, device busy share, activities per
                pixel, the graph's within a share ACTIVITY_GAP of the eager
                loop's); each hand-written kernel's launches in the graph's
                profile exactly those its capture recorded (kernel 1: the
                encoder's, eager).
 12. agree i8 — fp32, batch 2, full width: every quantized mode's teacher-
                forced logits on the card against the plain path on the CPU.
 12b. bench slice — bench.py's program (b = 1024, bf16, int8 KV, xla),
                one slice through its graph, and the same with mm_dtype
                int8: capture and replay seconds, device busy share, peak
                memory, codes in range.

 13. vq kernel — kernel 6 (nearest codebook entry, all sub-codebooks in one
                launch) against its plain version: N in (1, 8,192, 8,229),
                K=512, G=4 at Dc=64 and G=1 at Dc=256, fp32 and bf16 z,
                contiguous and strided; exact ties; indices equal except at
                float64-verified near-ties; a control (the plain version on
                bf16-rounded z) that must fail the same check; two calls
                bit-identical; device times of the grouped call beside the
                plain version, G calls of torch.cdist + argmin and the bound;
                the kernel's indices of the real z_e of example/*.png beside
                encode_indices' plain ones.
 14. vqvae train — tools/train_net_torch.py's main on
                configs/vqvae/PR-DVQVAE2.yaml with no model override: batch 32,
                bf16 compute, the config's solver, 512 PNG frames of 64x64
                written from a numpy seed, 8 workers, 20 steps + 4 after
                --resume. Exactly 1 kernel-6 launch per step; finite loss
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
                device times swept over da in (16, 128) x b in (1, 16, 256) x
                live in (1, 64, 200, 256); tools/probe_decode_kernel_torch.py's
                timing run, beside kernels 2 and 3.

Phases 10 to 13 run right after phase 5, while the generation models are
loaded (10b right after 10, 11b and 12b after 11 and 12). The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

import json
import os
import re
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
PTH_SEED = 52  # numpy seed of phase 5b's reference .pth files
# the generation runs of phase 4 sample from random weights: DSFVT.yaml names
# the reference's .pth VQ-VAE files, which are not in the repository (phase 5b
# writes its own)
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
# The modes with int8 weights and no activation rounding (weight_dtype
# "int8", native KV) quantize the same weights on both sides (a true division,
# correctly rounded on both) and amplify nothing: the native share holds them.
AGREE_I8 = {"native": 0.6, "int8": 0.6, "int8-pallas": 0.85}  # by WEIGHT_DTYPE
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
BENCH_BATCH = 1024  # bench.py's default batch (its program: int8 KV, attn_impl "xla")
# __global__ templates of csrc/fused_layer.cu that phase 7 reports by their
# template argument (gemm_nt_wgmma's epilogue, ln_rows_bf16's input type)
TEMPLATE_NAMES = ("gemm_nt_wgmma", "ln_rows_bf16")


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
                                   bound_ms=b2, bound_by=by2, library_ms=lib2,
                                   sweep=decode_sweep(card))
    return res


def decode_sweep(card):
    """Kernel 2 at the rollout's batch sizes: b in (1, 8, 16) x live in (64,
    256), bf16, and fp32 at b=1 (the batch-1 rollout runs fp32); na=8,
    R=256, da=128, rows >= live poisoned with NaN. Each case against its
    plain version (TOL), device times of the kernel, the plain version and
    the library call (scaled_dot_product_attention over the live rows, the
    bias as attn_mask) over input sets of >= 64 MB together, and the bound
    from the live rows' bytes. Only the public wrappers are called, so that
    tools/ab_attention_torch.py can run this on another tree's package."""
    import torch
    import torch.nn.functional as F

    from lvt_tpu_torch.ops.cache_attention import decode_attention_cuda, decode_attention_plain

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(20)
    na, R, da, scale = 8, 256, 128, 128 ** -0.5
    rows = []
    for b, dtype in ((1, "float32"), (1, "bfloat16"), (8, "bfloat16"), (16, "bfloat16")):
        dt = getattr(torch, dtype)
        el = torch.finfo(dt).bits // 8
        n_sets = max(4, min(64, -(-64 * 2 ** 20 // (2 * b * na * R * da * el))))
        q = torch.randn((b, na, da), generator=g, device=dev).to(dt)
        bias = 0.5 * torch.randn((na, R), generator=g, device=dev)
        caches = [[torch.randn((b, na, R, da), generator=g, device=dev).to(dt) for _ in range(2)]
                  for _ in range(n_sets)]
        for live in (256, 64):  # poisoning for 64 leaves nothing valid past it
            for c in caches:
                c[0][:, :, live:] = float("nan")
                c[1][:, :, live:] = float("nan")
            e, ok = _err(decode_attention_cuda(q, *caches[0], live, bias, scale),
                         decode_attention_plain(q, *caches[0], live, bias, scale), dtype)
            check(ok, f"decode_attention disagrees with its plain version ({dtype}, b={b}, "
                      f"live={live}): max abs err {e}")
            kd, pd = time_both(card, [lambda c=c: decode_attention_cuda(q, *c, live, bias, scale)
                                      for c in caches],
                               [lambda c=c: decode_attention_plain(q, *c, live, bias, scale)
                                for c in caches], 200, f"kernel 2 {dtype} b={b} live={live} ")
            mask = bias[None, :, None, :live].to(dt)
            lib = device_ms([lambda c=c: F.scaled_dot_product_attention(
                q[:, :, None], c[0][:, :, :live], c[1][:, :, :live], attn_mask=mask, scale=scale)
                for c in caches], 200)
            bd, by = bound_ms(dtype if dtype == "bfloat16" else "float32",
                              (2 * b * na * live * da + 2 * b * na * da) * el + na * live * 4,
                              4 * b * na * live * da)
            print(f"  kernel 2 sweep {dtype} b={b} live={live} [{card}]: kernel {kd:.4f} ms, "
                  f"plain {pd:.4f}, library {lib:.4f}, bound {bd:.4f} ({by}); max_abs_err {e:.3g}")
            rows.append({"dtype": dtype, "b": b, "live": live, "ms": kd, "plain_ms": pd,
                         "library_ms": lib, "bound_ms": bd, "max_abs_err": e})
        del caches
    return rows


def _counts():
    from lvt_tpu_torch.ops.attention import block_attention_fwd_cuda
    from lvt_tpu_torch.ops.cache_attention import decode_attention_cuda

    return block_attention_fwd_cuda.launches, decode_attention_cuda.launches


def _reset_counts():
    from lvt_tpu_torch.ops.attention import block_attention_fwd_cuda
    from lvt_tpu_torch.ops.cache_attention import decode_attention_cuda

    block_attention_fwd_cuda.launches = 0
    decode_attention_cuda.launches = 0


def _captures():
    """(slice graphs captured, their seconds: warm-up, capture and
    instantiation) so far in this process; (0, 0.0) on a tree without the
    graph (tools/ab_attention_torch.py runs phases on a parent tree)."""
    try:
        from lvt_tpu_torch.models.rollout_graph import SliceGraph
    except ImportError:
        return 0, 0.0
    return SliceGraph.captures, SliceGraph.captures_seconds


def _rollout_line(seconds, before, b, n_slices, peak):
    """The rollout's seconds, the captures' share of them, frames/s with and
    without that share, and the peak memory."""
    n, cap = (x - y for x, y in zip(_captures(), before))
    return (f"rollout {seconds:.3f} s, of it {cap:.3f} s capturing {n} graph(s) (warm-up "
            f"included); {b * n_slices / seconds:.3f} generated frames/s, "
            f"{b * n_slices / (seconds - cap):.3f} without the capture; max_memory_allocated "
            f"{peak / 2 ** 20:.1f} MiB")


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
    before = _captures()
    torch.cuda.reset_peak_memory_stats()
    video, codes, primed, seconds = gvt.main(
        ["--config-file", cfg_file, "--video-dir", example, "--seed", "0",
         "OUTPUT_DIR", out_dir] + NO_VQ_WEIGHTS)
    launches = _counts()
    line = _rollout_line(seconds, before, 1, n_slices, torch.cuda.max_memory_allocated())
    _check_run("batch 1", video, codes, primed, 512, 1)
    check(launches == per_run, f"batch 1: kernel launches {launches}, want exactly {per_run}")
    print(f"main path batch 1 fp32 [{card}]: {line}; launches {launches}")

    cfg = gvt.load_config(cfg_file)
    dev = torch.device("cuda")
    models = gvt.build_models(cfg, 0, dev, torch.bfloat16)
    frames = torch.from_numpy(gvt.load_priming_frames(example, N_PRIME)).to(dev)
    b = 8
    gen = torch.Generator(device=dev).manual_seed(0)
    before, caps = _counts(), _captures()
    torch.cuda.reset_peak_memory_stats()
    video, codes, primed, seconds = gvt.generate(
        *models, frames[None].expand(b, *frames.shape).contiguous(), N_PRIME, gen)
    total = _counts()
    launches = (total[0] - before[0], total[1] - before[1])
    line = _rollout_line(seconds, caps, b, n_slices, torch.cuda.max_memory_allocated())
    _check_run("batch 8", video, codes, primed, 512, b)
    check(launches == per_run, f"batch 8: kernel launches {launches}, want exactly {per_run}")
    print(f"main path batch 8 bf16 [{card}]: {line}; launches {launches}")
    return total, models, codes


SLICE_MODES = (  # label, knobs of sample_slice_incremental: every sampler mode
    ("native", {}),
    ("int8 KV + xla", {"kv_dtype": "int8"}),
    ("int8 KV + xla + int8 mm", {"kv_dtype": "int8", "mm_dtype": "int8"}),
    ("int8 KV + pallas", {"kv_dtype": "int8", "attn_impl": "pallas"}),
    ("int8 KV + pallas-live", {"kv_dtype": "int8", "attn_impl": "pallas-live"}),
    ("int8 weights", {"weight_dtype": "int8"}),
    ("int8-pallas weights", {"weight_dtype": "int8-pallas"}),
    ("int8 KV + pallas + int8-pallas weights",
     {"kv_dtype": "int8", "attn_impl": "pallas", "weight_dtype": "int8-pallas"}))
# device activities of a slice under the graph against the eager loop's: the
# same launches, plus the copies of the slice's inputs into the graph's
# buffers and of its codes out (4 a slice), within a share of the eager
# count. torch.profiler drops records of a profile this long now and then:
# the same eager slice has read 185,769 activities in one call and 185,828 in
# another, and in one call both eager profiles of a slice lacked 6 or 7
# launches each of several of PyTorch's kernels that its graph, replaying the
# same launches, showed. A profile may drop records, never add one. So each way is profiled
# at least PROFILES times, and on until a profile records within
# PROFILES_AGREE of the most that each function showed in the profiles so far
# (PROFILES_MAX times at the most); each function's launches are the most any
# of them recorded.
ACTIVITY_GAP = 1e-3
PROFILES = 2
PROFILES_MAX = 4
PROFILES_AGREE = ACTIVITY_GAP / 4


def _profiled(fn, profiles=1, most=1):
    """(result, wall s, wall s under torch.profiler, device events as (name,
    µs) of the profile with the most of them, {device function: launches},
    totals of the profiles) of fn(), run once unprofiled and then profiled
    ``profiles`` times, and on while the last profile records fewer
    activities than the most each function showed in the profiles so far by
    more than a share PROFILES_AGREE of them, ``most`` times at the most; each
    run synchronized. A function's launches are the most any profile
    recorded. The events are the profiler's raw records: turning ~100k of
    them into FunctionEvents took ~15 s a profile."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    best, counts, totals = None, {}, []
    while True:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_prof = time.perf_counter() - t0
        kern = [(e.name(), e.duration_ns() / 1e3) for e in prof.profiler.kineto_results.events()
                if e.device_type() == torch.autograd.DeviceType.CUDA]
        if best is None or len(kern) > len(best[1]):
            best = (wall_prof, kern)
        for name, (_, cnt) in _by_name(kern).items():
            counts[name] = max(counts.get(name, 0), cnt)
        totals.append(len(kern))
        full = sum(counts.values())
        if len(totals) >= most or (len(totals) >= profiles
                                   and full - len(kern) <= PROFILES_AGREE * full):
            return (out, wall) + best + (counts, totals)


def _by_name(kern):
    by_name = {}
    for name, us in kern:
        tot, cnt = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + us / 1e3, cnt + 1)
    return by_name


# the hand-written kernels of the rollout: (label, the device functions' names
# by a part of them, the wrappers that launch them)
HAND_WRITTEN = (
    ("kernel 1", ("block_attention_",), ("block_attention_fwd_cuda",)),
    ("kernel 2", ("decode_attention_kernel",), ("decode_attention_cuda",)),
    ("kernel 3", ("decode_i8_kernel<128, 4, false", "decode_i8_kernel<128, 8, false",
                  "decode_attention_i8_kernel"),
     ("decode_attention_i8_cuda", "decode_attention_i8_step_cuda")),
    ("kernel 4", ("decode_i8_kernel<128, 4, true", "decode_i8_kernel<128, 8, true",
                  "decode_attention_i8_live_kernel"),
     ("decode_attention_i8_live_cuda", "decode_attention_i8_live_step_cuda")),
    ("kernel 11", ("matmul_i8w_kernel",), ("matmul_i8w_cuda",)))


def _label(name):
    """The hand-written kernel a device function belongs to (the first whose
    key its name holds), or None."""
    return next((lb for lb, ks, _ in HAND_WRITTEN if any(k in name for k in ks)), None)


def _hand_sums(by_name):
    """{label: (device ms, launches)} of the hand-written kernels, each summed
    over its templates."""
    sums = {}
    for name, (tot, cnt) in by_name.items():
        label = _label(name)
        if label is not None:
            t0, c0 = sums.get(label, (0.0, 0))
            sums[label] = (t0 + tot, c0 + cnt)
    return sums


def _hand_counts(counts):
    """{label: launches} of the hand-written kernels from {device function:
    launches}."""
    out = {}
    for name, cnt in counts.items():
        label = _label(name)
        if label is not None:
            out[label] = out.get(label, 0) + cnt
    return out


def _hand_written(by_name):
    return ", ".join(f"{label} {t:.2f} ms ({cnt}x, {t / cnt:.4f} ms each)"
                     for label, (t, cnt) in _hand_sums(by_name).items())


def _hand_launches(took):
    """{label: launches} of the hand-written kernels from {wrapper: launches}
    (``SliceGraph.launches``, ``rollout_graph.launches_apart``)."""
    out = {}
    for label, _, wrappers in HAND_WRITTEN:
        n = sum(cnt for fn, cnt in took.items() if fn.__name__ in wrappers)
        if n:
            out[label] = n
    return out


def phase_slices(card, models, codes, modes=SLICE_MODES, vts=None):
    """One slice (256 pixels) of the batch-8 bf16 rollout, greedy, in every
    sampler mode, through the eager loop and through the slice's CUDA graph
    (captured first, outside the timings, unless ``vts``, phase 11's model of
    the mode by label, holds it already): the codes bit-equal; wall time,
    device busy share, device activities per pixel (copies and casts among
    them) of each, under torch.profiler, each device function's launches the
    most that any of its profiles recorded (see PROFILES); the graph's
    activities per pixel within a share ACTIVITY_GAP of the eager loop's, and
    each hand-written kernel's launches in the graph's profiles exactly those
    the capture recorded (kernel 1: the encoder's); device time by kernel and
    of the hand-written kernels in the graph's slice. Each run includes the slice's
    encoder pass (kernel 1), as the rollout runs it."""
    import numpy as np
    import torch

    from lvt_tpu_torch.models.vt import vt_encode
    from lvt_tpu_torch.models.vt_incremental import sample_slice_incremental

    *_, vt, params = models
    c, plan, s = vt.c, vt.plan, N_PRIME
    b = codes.shape[0]
    on_graph = hasattr(vt, "_slice_graph")  # False on a tree before the graph (A/B tool)
    if on_graph:
        from lvt_tpu_torch.models.rollout_graph import launches_apart
    thw = plan.slice_src[s].size
    primed = np.zeros(thw, bool)
    primed_t = torch.zeros(thw, dtype=torch.bool, device=codes.device)

    def encoded():
        sidx = torch.full((b,), s, dtype=torch.int64, device=codes.device)
        ctx, sl, _ = vt.prepare_slices(codes, sidx)
        return vt_encode(params["netG"], c, ctx, sidx), sl

    for label, knobs in modes:
        knobs = {"kv_dtype": "native", "weight_dtype": "native", "mm_dtype": "native",
                 "attn_impl": "xla", **knobs}
        runs = {}
        with torch.no_grad():
            if on_graph:  # the set-up made once, as sample_video makes it
                from lvt_tpu_torch.models.vt_incremental import SliceDecoder

                dec = SliceDecoder(params["netG"], c, plan.slice_shape, b, codes.device, **knobs)

            def eager():
                zl, sl = encoded()
                if on_graph:
                    return dec.run(zl, sl, primed_t, None, 1.0, True)
                return sample_slice_incremental(params["netG"], c, plan.slice_shape, zl, sl,
                                                None, primed, 1.0, greedy=True, **knobs)
            runs["eager"] = _profiled(eager, PROFILES, PROFILES_MAX)
            if on_graph:
                zl, sl = encoded()
                graph = (vts or {}).get(label, vt)._slice_graph(params, zl, sl, primed_t, knobs,
                                                                 1.0, True)

                def replay():
                    zl, sl = encoded()
                    return graph(zl, sl, primed_t)
                runs["graph"] = _profiled(replay, PROFILES, PROFILES_MAX)
                # the launches a replay must show: the capture's, and the
                # encoder's (kernel 1, eager, outside the graph)
                with launches_apart() as took:
                    encoded()
                want_hand = _hand_launches(took)
                for kernel, n in _hand_launches(graph.launches).items():
                    want_hand[kernel] = want_hand.get(kernel, 0) + n
        acts = {}
        for way, (out, wall, wall_prof, kern, counts, totals) in runs.items():
            busy = sum(us for _, us in kern) / 1e6
            by_name = _by_name(kern)
            copies = sum(cnt for name, cnt in counts.items()
                         if "copy" in name.lower() or "memcpy" in name.lower())
            n = sum(counts.values())
            acts[way] = n / thw
            print(f"profile, one slice (256 pixels) of the batch-{b} bf16 rollout, {label}, "
                  f"{way} [{card}]: wall {wall:.3f} s ({wall_prof:.3f} s under the profiler), "
                  f"device busy {busy:.3f} s = {100 * busy / wall_prof:.1f}% of the profiled "
                  f"wall time, {100 * busy / wall:.1f}% of the unprofiled; {n} device "
                  f"activities = {n / thw:.2f} per pixel (each function's most in "
                  f"{len(totals)} profiles of {', '.join(map(str, totals))}), copies and casts "
                  f"{copies / thw:.2f} per pixel"
                  + (f"; captured in {graph.capture_seconds:.3f} s (warm-up "
                     f"{graph.warmup_seconds:.3f} s)" if way == "graph" else ""))
            if way == "graph" or not on_graph:
                for name, (tot, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
                    print(f"  {tot:9.2f} ms {cnt:7d}x  {name[:110]}")
                print(f"  hand-written kernels in the slice: {_hand_written(by_name)}")
        if knobs["kv_dtype"] == "int8" and knobs["attn_impl"] != "xla":
            # kernel 3 or 4 once per layer and pixel, live = p + 1
            na, _, da = params["netG"]["decoder"]["layers"][0]["wq"].shape
            layers = len(params["netG"]["decoder"]["layers"])
            bound = layers * sum(i8_bound_ms(b, na, live, da)[0] for live in range(1, thw + 1))
            print(f"  bound of kernel 3 or 4 over the slice's {layers * thw} calls "
                  f"(live 1 to {thw}): {bound:.2f} ms")
        if on_graph:
            check(torch.equal(runs["graph"][0], runs["eager"][0]),
                  f"{label}: the graph's greedy codes differ from the eager loop's")
            counts = {way: run[4] for way, run in runs.items()}
            differ = {name: (counts["eager"].get(name, 0), counts["graph"].get(name, 0))
                      for name in set(counts["eager"]) | set(counts["graph"])
                      if counts["eager"].get(name, 0) != counts["graph"].get(name, 0)}
            check(abs(acts["graph"] - acts["eager"]) <= ACTIVITY_GAP * acts["eager"],
                  f"{label}: device activities per pixel {acts['graph']:.3f} under the graph, "
                  f"{acts['eager']:.3f} eager; want within {ACTIVITY_GAP:g} of the eager count; "
                  f"counts (eager, graph) that differ: {differ}")
            seen = _hand_counts(counts["graph"])
            check(seen == want_hand,
                  f"{label}: hand-written kernels' launches in the graph's profile {seen}, want "
                  f"exactly the capture's and the encoder's {want_hand}")
            print(f"  hand-written kernels' launches in the graph's profile: {seen}, the "
                  "capture's and the encoder's exactly")
    if on_graph:
        print(f"slices [{card}]: greedy codes of the graph equal the eager loop's in all "
              f"{len(modes)} modes (b = {b}, bf16, full width)")


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


def _reference_vt_state(rng, c):
    """A VideoTransformer state dict in the reference key layout
    (videotransformer.py's module paths, as checkpoint/torch_convert.py reads
    them) for the port's VTConfig ``c``, from a numpy generator: weights
    N(0, 1 / fan-in), embeddings N(0, 1), norms near 1, biases and bias
    banks near 0."""
    import numpy as np

    def w(*shape, fan_in):
        return (rng.standard_normal(shape, dtype=np.float32) / np.sqrt(fan_in)).astype(np.float32)

    def small(*shape):
        return (0.01 * rng.standard_normal(shape, dtype=np.float32)).astype(np.float32)

    kt, kh, kw = c.kernel
    sd = {"encoder.conv.weight": w(c.de, c.nc * c.nv, kt, kh, kw, fan_in=c.nc * kt * kh * kw),
          "encoder.conv.bias": small(c.de),
          "encoder.slice_embedding.weight": rng.standard_normal(
              (c.stride[0] * c.stride[1] * c.stride[2], c.de), dtype=np.float32),
          "encoder.linear_projector.weight": w(c.d, c.de, 1, 1, 1, fan_in=c.de)}
    for pfx, blocks, heads in (("encoder", c.blocks_e, c.n_head_e),
                               ("decoder", c.blocks_d, c.n_head_d)):
        for i, ((t, h, bw), na) in enumerate(zip(blocks, heads)):
            p = f"{pfx}.block_local_attention.{i}"
            sd[f"{p}.mha.layer_norm.weight"], sd[f"{p}.mha.layer_norm.bias"] = \
                1 + small(c.d), small(c.d)
            for m in ("w_q", "w_k", "w_v"):
                sd[f"{p}.mha.{m}"] = w(na, c.d, c.da, fan_in=c.d)
            sd[f"{p}.mha.proj.weight"] = w(c.d, na * c.da, fan_in=na * c.da)
            sd[f"{p}.ffn.0.weight"], sd[f"{p}.ffn.0.bias"] = 1 + small(c.d), small(c.d)
            for j in (1, 3):
                sd[f"{p}.ffn.{j}.weight"], sd[f"{p}.ffn.{j}.bias"] = \
                    w(c.d, c.d, fan_in=c.d), small(c.d)
            for axis, n in (("dt", t), ("dh", h), ("dw", bw)):
                sd[f"{p}.{axis}_bank"] = small(na, 2 * n - 1)
    for k in range(c.nc):
        sd[f"decoder.ch_embedder.{k}.weight"] = rng.standard_normal((c.nv, c.de),
                                                                    dtype=np.float32)
    sd["decoder.conv.conv.weight"] = w(c.d, c.de, 3, 3, 3, fan_in=27 * c.de)
    sd["decoder.conv.conv.bias"] = small(c.d)
    sd["decoder.linear_projector.weight"] = w(c.d, c.d, 1, 1, 1, fan_in=c.d)
    sd["ch_predictor.layer_norm.weight"] = 1 + small(c.d)
    sd["ch_predictor.layer_norm.bias"] = small(c.d)
    for k in range(c.nc):
        sd[f"ch_predictor.U.{k}.weight"] = w(c.d, c.d + k * c.nv, fan_in=c.d + k)
        sd[f"ch_predictor.U.{k}.bias"] = small(c.d)
        sd[f"ch_predictor.P.{k}.weight"] = w(c.nv, c.d, fan_in=c.d)
        sd[f"ch_predictor.P.{k}.bias"] = small(c.nv)
    return sd


def _reference_seqnet_state(rng, spec):
    """A norm-free conv net's state dict in module order (the reference's
    Sequential): ``layers.<i>.{weight,bias}`` for a conv (out, in, k, k) or
    transposed conv (in, out, k, k), ``layers.<i>.block.{1,3}.*`` for a
    residual block (ReLU, conv 3x3, ReLU, conv 1x1); N(0, 1 / fan-in)."""
    import numpy as np

    def w(*shape, fan_in):
        return (rng.standard_normal(shape, dtype=np.float32) / np.sqrt(fan_in)).astype(np.float32)

    sd = {}
    for i, layer in enumerate(spec):
        key = f"layers.{i}"
        if layer[0] in ("conv", "convT"):
            _, cin, cout, k = layer[:4]
            shape = (cout, cin, k, k) if layer[0] == "conv" else (cin, cout, k, k)
            sd[f"{key}.weight"], sd[f"{key}.bias"] = w(*shape, fan_in=cin * k * k), \
                np.zeros(cout, np.float32)
        elif layer[0] == "resblock":
            _, dim, res = layer
            sd[f"{key}.block.1.weight"] = w(res, dim, 3, 3, fan_in=9 * dim)
            sd[f"{key}.block.1.bias"] = np.zeros(res, np.float32)
            sd[f"{key}.block.3.weight"] = w(dim, res, 1, 1, fan_in=res)
            sd[f"{key}.block.3.bias"] = np.zeros(dim, np.float32)
    return sd


def phase_pth(card):
    """Generation from reference .pth files at full width: DSFVT's and
    PR-DVQVAE2's netE, netG and netC state dicts in the reference key layout,
    written from a numpy seed as fvcore's Checkpointer wraps them; the
    generation script as a user runs it with the four files configured;
    then one slice's fp32 logits of the VT loaded on the card against the
    same file loaded on the CPU. Returns the phase's seconds."""
    import tempfile

    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import generate_videos_torch as gvt
    from lvt_tpu_torch.checkpoint.convert import flatten
    from lvt_tpu_torch.evaluation.vt_sampler import load_vt_weights
    from lvt_tpu_torch.models.vqvae import VQVAE
    from lvt_tpu_torch.models.vt import VTConfig, vt_logits

    t0 = time.perf_counter()
    cfg_file = os.path.join(ROOT, "configs", "vt", "DSFVT.yaml")
    cfg = gvt.load_config(cfg_file)
    c = VTConfig.from_cfg(cfg)
    vq = VQVAE(gvt.load_config(os.path.join(ROOT, cfg.TEST.VT_SAMPLER.VQ_VAE.CFG)))
    rng = np.random.default_rng(PTH_SEED)
    cb = vq.cfg.MODEL.CODEBOOK
    dc = cb.DIM // cb.NUM
    states = {"netE": _reference_seqnet_state(rng, vq.encoder.spec),
              "netG": _reference_seqnet_state(rng, vq.generator.spec),
              "netC": {k: v for i in range(cb.NUM) for k, v in (
                  (f"ve.{i}.embedding.weight",
                   rng.standard_normal((cb.SIZE, dc), dtype=np.float32)),
                  (f"ve.{i}.running_size", np.ones(cb.SIZE, np.float32)),
                  (f"ve.{i}.running_sum", rng.standard_normal((cb.SIZE, dc), dtype=np.float32)))},
              "vt": _reference_vt_state(rng, c)}
    n_slices = T_FRAMES - N_PRIME
    per_run = (n_slices * 8, n_slices * 256 * 8)
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for name, sd in states.items():
            os.makedirs(os.path.join(tmp, name))
            paths[name] = os.path.join(tmp, name, "model_final.pth")
            torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()},
                        "iteration": 0}, paths[name])
        del states
        opts = ["TEST.VT_SAMPLER.VQ_VAE.ENCODER_WEIGHTS", paths["netE"],
                "TEST.VT_SAMPLER.VQ_VAE.GENERATOR_WEIGHTS", paths["netG"],
                "TEST.VT_SAMPLER.VQ_VAE.CODEBOOK_WEIGHTS", paths["netC"],
                "MODEL.GENERATOR.WEIGHTS", paths["vt"]]
        written = time.perf_counter() - t0
        _reset_counts()
        before = _captures()
        torch.cuda.reset_peak_memory_stats()
        video, codes, primed, seconds = gvt.main(
            ["--config-file", cfg_file, "--video-dir", os.path.join(ROOT, "example"), "--seed",
             "0", "OUTPUT_DIR", os.path.join(ROOT, "output", "chip_smoke_pth")] + opts)
        launches = _counts()
        line = _rollout_line(seconds, before, 1, n_slices, torch.cuda.max_memory_allocated())
        _check_run("pth batch 1", video, codes, primed, c.nv, 1)
        check(launches == per_run, f"pth batch 1: kernel launches {launches}, want {per_run}")
        print(f"pth main path batch 1 fp32, reference .pth weights [{card}]: {line}; launches "
              f"{launches}; files written in {written:.1f} s")

        # the VT read from the same file on the card and on the CPU: the same
        # leaves, and one slice's teacher-forced fp32 logits within PATH_TOL
        cfgp = gvt.load_config(cfg_file, opts)
        video = np.random.default_rng(1).integers(0, c.nv, size=(2, c.nc, T_FRAMES, 16, 16))
        out, trees = {}, {}
        for device in (torch.device("cuda"), torch.device("cpu")):
            vt, init = gvt.build_vt(cfgp, torch.Generator().manual_seed(0), device, 16, 16)
            params = load_vt_weights(cfgp, init)["netG"]
            trees[device.type] = flatten(params)
            sidx = torch.full((2,), N_PRIME, dtype=torch.int64, device=device)
            ctx, sl, _ = vt.prepare_slices(torch.from_numpy(video).to(device), sidx)
            with torch.no_grad():
                out[device.type] = vt_logits(params, c, ctx, sl, sidx).reshape(
                    2, -1, c.nc, c.nv).cpu()
    same = all(torch.equal(trees["cuda"][k].cpu(), v) for k, v in trees["cpu"].items())
    check(same and trees["cuda"].keys() == trees["cpu"].keys(),
          "pth: the VT's leaves loaded on the card differ from those loaded on the CPU")
    e = float((out["cuda"] - out["cpu"]).abs().max())
    took = time.perf_counter() - t0
    print(f"pth agree fp32 b=2 full width: vt_logits card vs cpu plain on the same .pth "
          f"max_abs_err {e:.3g}; bound {PATH_TOL:g} (|logits| <= "
          f"{float(out['cpu'].abs().max()):.3g}); phase {took:.1f} s [{card}]")
    check(e <= PATH_TOL, f"pth: vt_logits on the card disagree with the plain path: {e}")
    return took


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
    t = res[("bfloat16", False)]
    res["by_function"] = fused_by_function(card, p, bias, sets[0], {k: t[k][0] for k in (7, 8, 9)})
    return res, bounds


def fused_by_function(card, p, bias, inputs, whole):
    """Device time of one call each of kernels 7, 8 and 9 (bf16, not causal,
    after a warm-up call) by __global__ function (gemm_nt_wgmma by epilogue,
    ln_rows_bf16 by input type), from torch.profiler, held
    against `whole`, each call's device ms timed by CUDA-graph replay. Only
    the public wrappers are called (tools/ab_attention_torch.py runs this on
    another tree's package too)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lvt_tpu_torch.ops import fused_layer as fl

    tok, go = inputs
    na = p["wq"].shape[0]
    x2 = fl.fused_layer_tokens_plain(tok, p, bias, False, True)[1]
    dx2 = fl.ffn_half_bwd_plain(x2, go, p)[0]
    calls = {7: lambda: fl.fused_layer_fwd_cuda(tok, p, bias, False, True),
             8: lambda: fl.ffn_half_bwd_cuda(x2, go, p),
             9: lambda: fl.attn_half_bwd_cuda(tok, dx2, p, bias, False, 0, na)}
    out = {}
    for k, call in calls.items():
        call()
        # after many earlier profiler sessions and CUDA graphs in one process,
        # a session now and then records no device activity, or durations that
        # do not add up to the call: try again, and say so if none agrees
        for _ in range(3):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
            by_name = {}
            for e in prof.events():
                if e.device_type != torch.autograd.DeviceType.CUDA:
                    continue
                name = e.name[5:] if e.name.startswith("void ") else e.name
                name = name.replace("(anonymous namespace)::", "")
                short = re.split(r"[<(]", name)[0].split("::")[-1]
                if short in TEMPLATE_NAMES:  # the epilogue or input type of each launch
                    arg = re.match(r"[^<(]*<([^<>]*)>", name)
                    short += f"<{arg.group(1).split('::')[-1]}>" if arg else ""
                tot, cnt = by_name.get(short, (0.0, 0))
                by_name[short] = (tot + e.time_range.elapsed_us() / 1e3, cnt + 1)
            total = sum(t for t, _ in by_name.values())
            agrees = abs(total - whole[k]) <= 0.2 * whole[k]
            if agrees:
                break
        out[k] = {name: t for name, (t, _) in by_name.items()} if agrees else None
        print(f"  kernel {k} bf16 by __global__ function, one call under torch.profiler [{card}]: "
              + ", ".join(f"{name} {t:.4f} ms ({c}x)" for name, (t, c) in
                          sorted(by_name.items(), key=lambda kv: -kv[1][0]))
              + f"; total {total:.4f} ms"
              + ("" if agrees else f", not {whole[k]:.4f} as timed: this reading is not used"))
    return out


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


def phase_train(card, unfused=True):
    """DSFVT training through tools/train_net_torch.py's main, then --resume,
    with the fused layer (DSFVT's defaults) and, unless ``unfused`` is
    False, with TPU.FUSED_LAYER False; per-step launch counts and times
    recorded around Trainer.train_step."""
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
        if not unfused:
            return fused, None
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
    # fixed-order reduction (kernels 8, 9, 10), the fused layer's own (in
    # bf16: the LN passes ln_rows_bf16 and ln_bwd_rows; gemm_nt_wgmma with the
    # FFN epilogues of kernels 7 and 8, and with the plain store for the QKV,
    # do and dy products; proj_ffn and ffn_bwd_rows where a tree still has
    # them), and kernel 6's. A function counts in the first group whose key
    # its name holds.
    groups = (("attention forward", ("block_attention_",)), ("query tiles", ("::bwd_rows_",)),
              ("key tiles", ("::bwd_keys_",)), ("fixed-order reductions", ("dbias_reduce",)),
              ("ln_qkv", ("ln_qkv",)), ("ln_rows_bf16", ("ln_rows_bf16",)),
              ("ln_bwd_rows", ("ln_bwd_rows",)), ("proj_ffn", ("proj_ffn",)),
              ("ffn_bwd_rows", ("ffn_bwd_rows",)),
              ("gemm_nt FFN epilogues", ("::Ffn", "::StoreF32>")), ("gemm_nt", ("gemm_nt",)),
              ("gemm_tn", ("gemm_tn",)), ("nearest_indices (kernel 6)", ("nearest_indices_kernel",)))
    sums = {label: (0.0, 0) for label, _ in groups}
    for name, (t, c) in by_name.items():
        label = next((lb for lb, keys in groups if any(k in name for k in keys)), None)
        if label is not None:
            sums[label] = (sums[label][0] + t, sums[label][1] + c)
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


def i8_sweep(card):
    """Kernels 3 and 4 at the rollout's batch sizes and live lengths: b in
    (1, 8, 16) x live in (16, 64, 128, 256), na=8, R=256, da=128, bf16
    scales and output: device times of each (through its (q8, sq) wrapper),
    of its fused entry (q and the new rows quantized in the launch, the
    sampler's call) and of kernel 2 over a bf16 cache of the same shape,
    over input sets of >= 64 MB together, beside the bound of the int8
    call; at b=8, live=256 (the rollout's shape) also the plain versions and
    fp32 scales. Only public wrappers are called, so that
    tools/ab_attention_torch.py can run this on another tree's package (a
    tree without the fused entries times none)."""
    import torch

    from lvt_tpu_torch.ops import cache_attention as ca

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(35)
    na, R, da, scale = 8, 256, 128, 128 ** -0.5
    fused = hasattr(ca, "decode_attention_i8_step_cuda")
    rows = []
    for b in (1, 8, 16):
        n_sets = max(4, min(64, -(-64 * 2 ** 20 // (2 * b * na * R * da))))
        q8 = torch.randint(-127, 128, (b, na, da), generator=g, device=dev, dtype=torch.int8)
        sq = 0.01 * torch.rand((b, na), generator=g, device=dev) + 1e-3
        qkv = torch.randn((b, 3, na, da), generator=g, device=dev).bfloat16()
        q = qkv[:, 0].contiguous()
        bias = 0.5 * torch.randn((na, R), generator=g, device=dev)

        def scales(dt):
            return (0.02 * torch.rand((b, na, R), generator=g, device=dev) + 1e-3).to(dt)

        sets = [(torch.randint(-127, 128, (b, na, R, da), generator=g, device=dev,
                               dtype=torch.int8), scales(torch.bfloat16),
                 torch.randint(-127, 128, (b, na, R, da), generator=g, device=dev,
                               dtype=torch.int8), scales(torch.bfloat16)) for _ in range(n_sets)]
        bf16 = [(torch.randn((b, na, R, da), generator=g, device=dev).bfloat16(),
                 torch.randn((b, na, R, da), generator=g, device=dev).bfloat16())
                for _ in range(max(4, n_sets // 2))]
        for live in (16, 64, 128, 256):
            r = {"b": b, "live": live}
            for k, fn in ((3, ca.decode_attention_i8_cuda), (4, ca.decode_attention_i8_live_cuda)):
                r[f"k{k}_ms"] = device_ms([lambda s=s: fn(q8, sq, *s, live, bias, scale)
                                           for s in sets], 200)
            for k, name in ((3, "decode_attention_i8_step_cuda"),
                            (4, "decode_attention_i8_live_step_cuda")):
                fn = getattr(ca, name, None)
                r[f"k{k}_step_ms"] = None if fn is None else device_ms(
                    [lambda s=s: fn(qkv[:, 0], qkv[:, 1:], *s, live, bias, scale) for s in sets],
                    200)
            r["k2_ms"] = device_ms([lambda c=c: ca.decode_attention_cuda(q, *c, live, bias, scale)
                                    for c in bf16], 200)
            r["bound_ms"], r["bound_by"] = i8_bound_ms(b, na, live, da)
            if (b, live) == (8, 256):
                for k, plain in ((3, ca.decode_attention_i8_plain),
                                 (4, ca.decode_attention_i8_live_plain)):
                    r[f"k{k}_plain_ms"] = device_ms(
                        [lambda s=s: plain(q8, sq, *s, live, bias, scale) for s in sets[:8]], 20)
                f32 = [(s[0], s[1].float(), s[2], s[3].float()) for s in sets]
                for k, fn in ((3, ca.decode_attention_i8_cuda),
                              (4, ca.decode_attention_i8_live_cuda)):
                    r[f"k{k}_fp32_ms"] = device_ms(
                        [lambda s=s: fn(q8, sq, *s, live, bias, scale, torch.bfloat16)
                         for s in f32], 200)
                del f32
            print(f"  kernels 3 and 4 sweep b={b} live={live} [{card}]: kernel 3 "
                  f"{r['k3_ms']:.4f} ms, kernel 4 {r['k4_ms']:.4f}; fused entries "
                  + (f"{r['k3_step_ms']:.4f} / {r['k4_step_ms']:.4f}" if fused else "none")
                  + f"; kernel 2 (bf16 cache) {r['k2_ms']:.4f}; bound {r['bound_ms']:.4f} "
                  f"({r['bound_by']})" + (f"; plain {r['k3_plain_ms']:.4f} / "
                                          f"{r['k4_plain_ms']:.4f}; fp32 scales "
                                          f"{r['k3_fp32_ms']:.4f} / {r['k4_fp32_ms']:.4f}"
                                          if (b, live) == (8, 256) else ""), flush=True)
            rows.append(r)
        del sets, bf16
    return rows


def i8_bound_ms(b, na, live, da):
    """bound_ms of one call of kernel 3 or 4 with bf16 scales and output: the
    live rows' int8 K and V and their scales, the bias row, q8 and sq (or
    the float q), the output; 4 integer operations per cache byte."""
    return bound_ms("int8", 2 * b * na * live * da + 2 * b * na * live * 2 + na * live * 4
                    + b * na * (da + 4) + b * na * da * 2, 4 * b * na * live * da)


def cache_sweep(card, k, fn, da, g, bs=(1, 16, 256), lives=(1, 64, 200, 256)):
    """Device ms of kernel 5 or 12 (``fn``, its CUDA wrapper) at na=8,
    R=256, fp32 scales, bf16 q and output, over b x live, each beside its
    bound_ms (the live rows' int8 K and V and their scales, the extra row,
    q and the output; 4 fp32 operations a cache byte); the calls cycle
    through input sets of >= 64 MB together."""
    import torch

    dev, na, R, scale = torch.device("cuda"), 8, 256, da ** -0.5
    rows = []
    for b in bs:
        n_sets = max(1, min(128, -(-64 * 2 ** 20 // (2 * b * na * R * da))))
        sets = [(torch.randint(-127, 128, (b, na, R, da), generator=g, device=dev,
                               dtype=torch.int8),
                 0.01 + 0.01 * torch.rand((b, na, R), generator=g, device=dev),
                 torch.randint(-127, 128, (b, na, R, da), generator=g, device=dev,
                               dtype=torch.int8),
                 0.01 + 0.01 * torch.rand((b, na, R), generator=g, device=dev))
                for _ in range(n_sets)]
        q = torch.randn((b, na, da), generator=g, device=dev).bfloat16()
        extra = 0.5 * torch.randn((1, na, R), generator=g, device=dev)
        for live in lives:
            ms = device_ms([lambda s=s: fn(q, *s, extra, scale, live) for s in sets], 200)
            bd, by = bound_ms("float32", 2 * b * na * live * da + 2 * b * na * live * 4
                              + na * live * 4 + 2 * b * na * da * 2, 4 * b * na * live * da)
            rows.append({"b": b, "live": live, "da": da, "ms": ms, "bound_ms": bd,
                         "bound_by": by})
        print(f"kernel {k} sweep da={da} b={b} bf16 [{card}]: " + ", ".join(
            f"live={r['live']} {r['ms']:.4f} ms (bound {r['bound_ms']:.4f})" for r in rows
            if r["b"] == b), flush=True)
        del sets
    return rows


def phase_i8_kernels(card, kernel2_ms=None):
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
    errs = {3: 0.0, 4: 0.0}
    for b in (16, 8, 1):
        q8 = torch.randint(-127, 128, (b, na, da), generator=g, device=dev, dtype=torch.int8)
        sq = 0.01 * torch.rand((b, na), generator=g, device=dev) + 1e-3
        bias = 0.5 * torch.randn((na, R), generator=g, device=dev)
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            c0 = cache_set(b, dt)
            for live in (1, 64, 200, 256):
                c = poison(c0, live)
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
                    check(torch.equal(kernel(q8, sq, *c, live, bias, scale, dt), got),
                          f"{kernel.__name__}: two calls differ ({dtype}, b={b}, live={live})")
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
    sweep = i8_sweep(card)
    for k, name in ((3, "decode_attention_i8"), (4, "decode_attention_i8_live")):
        main = next(r for r in sweep if (r["b"], r["live"]) == (8, 256))  # the rollout's shape
        res[name] = dict(ms=main[f"k{k}_ms"], plain_ms=main[f"k{k}_plain_ms"], err=errs[k],
                         bound_ms=main["bound_ms"], bound_by=main["bound_by"], library_ms=None,
                         kernel2_ms=main["k2_ms"], at="b=8, live=256, bf16 scales",
                         fp32_scales_ms=main[f"k{k}_fp32_ms"], fused_ms=main[f"k{k}_step_ms"],
                         sweep=[{key: r[key] for key in ("b", "live", f"k{k}_ms", f"k{k}_step_ms",
                                                         "k2_ms", "bound_ms")} for r in sweep])

    # ---- kernel 5: q in float, fp32 scales
    err5, t5 = 0.0, {}
    for b in (16, 1, 256):
        extra = 0.5 * torch.randn((1, na, R), generator=g, device=dev)
        sets = [cache_set(b, torch.float32) for _ in range({16: 8, 1: 1, 256: 1}[b])]
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
          f"{kernel2_ms} ms [{card}]")
    sweep5 = cache_sweep(card, 5, ca.cache_attention_i8_cuda, da, g)
    res["cache_attention_i8"] = dict(zip(("ms", "plain_ms"), t5["bfloat16"]), err=err5,
                                     bound_ms=b5, bound_by=by5, library_ms=None,
                                     kernel2_ms=kernel2_ms, fp32_ms=t5["float32"][0],
                                     sweep=sweep5)

    # ---- kernel 11 at DSFVT's three shapes (timed) and at a K that is no
    # power of two and rows past one block's 8 (checked only), bit-equal
    err11, shapes = 0.0, {}
    for K, N, timed in ((512, 3072, True), (1024, 512, True), (512, 512, True),
                        (1040, 512, False)):
        n_sets = min(256, -(-64 * 2 ** 20 // (K * N))) if timed else 1  # weights of 64 MB in all
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            sets = [quant.quantize_cols(torch.randn((K, N), generator=g, device=dev).to(dt), dt)
                    for _ in range(n_sets if dtype == "bfloat16" else 1)]
            sets = [(wi, wi.t().contiguous(), sw) for wi, sw in sets]
            for b in (1, 8, 16):
                y = torch.randn((b, K), generator=g, device=dev).to(dt)
                wi, wt, sw = sets[0]
                got = quant.matmul_i8w_cuda(y, wt, sw, dt)
                want = quant.matmul_i8w_plain(y, wt, sw, dt)
                torch.cuda.synchronize()
                top = float(want.float().abs().max())
                tol = (K11_TOL * top, 2 ** -7 if dtype == "bfloat16" else K11_TOL)
                e, ok = _err(got, want, dtype, tol)
                ce, cok = _err(got, (y @ wi.to(dt)) * sw, dtype, tol)
                equal = torch.equal(got, want)
                print(f"kernel 11 matmul_i8w {dtype} ({b}, {K}) x ({K}, {N}): max_abs_err {e:.3g}"
                      f"{' (bit-equal)' if equal else ''} (|out| <= {top:.3g}); "
                      f"control, int8 weights without activation rounding: {ce:.3g}")
                check(ok and equal, f"matmul_i8w differs from its plain version ({dtype}, b={b}, "
                                    f"K={K}, N={N}): max abs err {e}")
                check(not cok, f"kernel 11: the control reads {ce}, within the bound")
                err11 = max(err11, e)
                if dtype == "bfloat16" and timed:
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


def phase_i8_fold(card):
    """Kernels 3 and 4 with the quantization of q and of the new cache row
    folded in (the sampler's call) against the PyTorch sequence they replace
    (quantize_cache_row, the row writes, quantize_rows_i8, the plain kernel)
    on the card: b in (1, 8, 16), live in (1, 64, 65, 256), na=8, R=256,
    da=128, the io dtype fp32 and bf16, rows from randn, rows of scale 1 at
    and next to x.5, and tiny rows. q8, sq, the cache rows and scales equal
    bit for bit (the rest of the cache untouched), the output within the
    kernel's bound of the sequence's, one launch a call. Returns the largest
    output error of each kernel."""
    import torch

    from lvt_tpu_torch.ops import cache_attention as ca

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(36)
    na, R, da, scale = 8, 256, 128, 128 ** -0.5
    errs = {3: 0.0, 4: 0.0}
    entries = {3: (ca.decode_attention_i8_step_cuda, ca.decode_attention_i8_step_plain),
               4: (ca.decode_attention_i8_live_step_cuda, ca.decode_attention_i8_live_step_plain)}
    checked = 0
    for b in (1, 8, 16):
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            for rows in ("randn", "halves", "tiny"):
                qkv = torch.randn((b, 3, na, da), generator=g, device=dev)
                if rows == "halves":  # absmax 127: scale 1, the quotients the values
                    qkv = torch.randint(-126, 126, qkv.shape, generator=g, device=dev) + 0.5
                    qkv = qkv + torch.tensor([0.0, 2 ** -10, -2 ** -10], device=dev)[
                        torch.randint(0, 3, qkv.shape, generator=g, device=dev)]
                    qkv[..., 0] = 127.0
                elif rows == "tiny":
                    qkv = qkv * 1e-7
                qkv = qkv.to(dt)
                cache = [torch.randint(-127, 128, (b, na, R, da), generator=g, device=dev,
                                       dtype=torch.int8),
                         (0.02 * torch.rand((b, na, R), generator=g, device=dev) + 1e-3).to(dt)]
                cache = [cache[0], cache[1], cache[0].flip(-1).contiguous(), cache[1].flip(-1)
                         .contiguous()]
                bias = 0.5 * torch.randn((na, R), generator=g, device=dev)
                for live in (1, 64, 65, 256):
                    for k, (fused, plain) in entries.items():
                        mine = [t.clone() for t in cache]
                        theirs = [t.clone() for t in cache]
                        before = fused.launches
                        got, q8, sq = fused(qkv[:, 0], qkv[:, 1:], *mine, live, bias, scale, dt,
                                            q_out=True)
                        want, q8w, sqw = plain(qkv[:, 0], qkv[:, 1:], *theirs, live, bias, scale,
                                               dt, q_out=True)
                        torch.cuda.synchronize()
                        what = f"kernel {k} fused, {dtype} {rows} b={b} live={live}"
                        check(fused.launches == before + 1, f"{what}: launches")
                        check(torch.equal(q8, q8w) and torch.equal(sq, sqw),
                              f"{what}: q8 or sq differ from quantize_rows_i8's")
                        check(all(torch.equal(x, y) for x, y in zip(mine, theirs)),
                              f"{what}: the cache (k8, ks, v8, vs) differs from the row writes'")
                        step = ca.i8_weight_step(q8w, sqw, theirs[0], theirs[1], theirs[3], live,
                                                 bias, scale)
                        e, off, ok = _i8_check(got, want, step, dtype == "bfloat16")
                        check(ok and off <= I8_ROWS_OFF, f"{what}: output max abs err {e}, pairs "
                                                         f"off {off}")
                        errs[k] = max(errs[k], e)
                        checked += 1
    print(f"i8 fold [{card}]: {checked} fused calls of kernels 3 and 4: q8, sq, the new cache "
          f"rows and scales bit-equal to the PyTorch sequence's; outputs within the kernels' "
          f"bound, max_abs_err {errs[3]:.3g} / {errs[4]:.3g}")
    return errs


def _quantized_vt(vt, **knobs):
    """The same VideoTransformer with TEST.VT_SAMPLER keys set, as a config
    file or the command line would set them."""
    cfg = vt.cfg.clone()
    cfg.merge_from_list([x for k, v in knobs.items() for x in (f"TEST.VT_SAMPLER.{k}", v)])
    return type(vt)(cfg, T=vt.T, H=vt.H, W=vt.W)


I8_RUNS = (  # label, config keys, expected launches of kernels (2, 3, 4, 11) per rollout
    ("native", {}, (22528, 0, 0, 0)),
    ("int8 KV + xla", {"KV_DTYPE": "int8", "ATTN_IMPL": "xla"}, (0, 0, 0, 0)),
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
    that was driven with the counts at 0, and the model of each run by label
    (its slice graph captured)."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import generate_videos_torch as gvt
    from lvt_tpu_torch.ops.attention import block_attention_fwd_cuda
    from lvt_tpu_torch.ops.cache_attention import decode_attention_cuda

    from lvt_tpu_torch.ops import cache_attention as ca

    k3, k4, _, k11 = _i8_kernels()
    # kernels 2, 3, 4 and 11: each kernel's wrappers (3 and 4 with and
    # without the fold; the sampler calls the fused ones, where the tree has
    # them: tools/ab_attention_torch.py runs this on a parent tree too)
    steps = tuple(getattr(ca, n, None) for n in ("decode_attention_i8_step_cuda",
                                                 "decode_attention_i8_live_step_cuda"))
    counted = ((decode_attention_cuda,), tuple(w for w in (k3, steps[0]) if w),
               tuple(w for w in (k4, steps[1]) if w), (k11,))
    vqvae, vq_params, vq_state, vt, vt_params = models
    dev = torch.device("cuda")
    frames = torch.from_numpy(gvt.load_priming_frames(os.path.join(ROOT, "example"), N_PRIME))
    b = 8
    frames = torch.stack([torch.roll(frames, (3 * i, 5 * i), (1, 2)) for i in range(b)]).to(dev)
    n_slices = T_FRAMES - N_PRIME
    out, launches, used = {}, {}, {}
    for label, knobs, want in I8_RUNS:
        model = _quantized_vt(vt, **knobs) if knobs else vt
        for k in sum(counted, (block_attention_fwd_cuda,)):
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        caps = _captures()
        video, codes, primed, seconds = gvt.generate(vqvae, vq_params, vq_state, model, vt_params,
                                                     frames, N_PRIME, None, greedy=True)
        line = _rollout_line(seconds, caps, b, n_slices, torch.cuda.max_memory_allocated())
        took = tuple(sum(k.launches for k in group) for group in counted)
        _check_run(label, video, codes, primed, 512, b)
        fused = tuple(w.launches if w else want[1 + i] for i, w in enumerate(steps))
        check(took == want and block_attention_fwd_cuda.launches == n_slices * 8
              and fused == want[1:3],
              f"{label}: launches of kernels 2, 3, 4, 11 {took}, want exactly {want}, all of "
              f"kernels 3 and 4 fused (fused: {fused}); kernel 1 "
              f"{block_attention_fwd_cuda.launches}, want {n_slices * 8}")
        out[label], launches[label], used[label] = codes, took, model
        agree = float((codes[:, :, N_PRIME:] == out["native"][:, :, N_PRIME:]).float().mean())
        first = float((codes[:, :, N_PRIME] == out["native"][:, :, N_PRIME]).float().mean())
        print(f"main path batch {b} bf16 greedy, {label} [{card}]: {line}; launches of "
              f"kernels 2, 3, 4, 11 {took}; greedy codes equal to the native rollout's: "
              f"{agree:.4f} of all sampled, {first:.4f} of the first sampled frame")
        if not knobs and hasattr(vt, "_slice_graph"):
            # the same rollout by the eager loop and by a graph captured anew
            # (a model with an empty graph cache), the sampler alone, its
            # memory measured alike: the peak of allocated bytes, and the
            # growth of reserved bytes (the graph's private pool among them)
            start = torch.zeros_like(codes)
            start[:, :, :N_PRIME] = primed
            for way, m in (("eager loop", vt), ("graph, captured anew", _quantized_vt(vt))):
                torch.cuda.empty_cache()
                reserved = torch.cuda.memory_reserved()
                torch.cuda.reset_peak_memory_stats()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = m.sample_video(vt_params, start, n_prime=N_PRIME, greedy=True,
                                     _eager=way == "eager loop")
                torch.cuda.synchronize()
                took_s = time.perf_counter() - t0
                check(torch.equal(got, codes), f"{label}, {way}: greedy codes differ from the "
                                               "graph rollout's through generate()")
                print(f"main path batch {b} bf16 greedy, {label}, sampler alone, {way} "
                      f"[{card}]: rollout {took_s:.3f} s, {b * n_slices / took_s:.3f} generated "
                      f"frames/s; max_memory_allocated "
                      f"{torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB, reserved grew "
                      f"{(torch.cuda.max_memory_reserved() - reserved) / 2 ** 20:.1f} MiB; greedy "
                      "codes equal to the rollout's through generate()")
        if knobs:
            check(agree >= GREEDY_FLOOR, f"{label}: greedy agreement with the native rollout "
                                         f"{agree}, under the floor {GREEDY_FLOOR}")
    check(not torch.equal(out["int8 KV + pallas"], out["native"]),
          "the int8 rollout's codes equal the native ones: were the config keys read?")
    return (launches["int8 KV + pallas"][1], launches["int8 KV + pallas-live"][2],
            launches["int8 KV + pallas + int8-pallas weights"][3]), used


def phase_i8_rollouts(card):
    """Phase 11 and one profiled slice of every sampler mode (eager and, on
    a tree with the graph, as a graph), on models built as phase 4 builds
    them, priming codes from a numpy seed: the int8 rollouts alone, for
    tools/ab_attention_torch.py."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import generate_videos_torch as gvt

    cfg = gvt.load_config(os.path.join(ROOT, "configs", "vt", "DSFVT.yaml"))
    dev = torch.device("cuda")
    models = gvt.build_models(cfg, 0, dev, torch.bfloat16)
    c = models[3].c
    codes = torch.from_numpy(np.random.default_rng(0).integers(
        0, c.nv, size=(8, c.nc, T_FRAMES, 16, 16))).to(dev)
    _, vts = phase_main_i8(card, models)
    phase_slices(card, models, codes, vts=vts)


def phase_bench_slice(card, models):
    """bench.py's own program, one slice: DSFVT at b = 1024, bf16, int8 KV,
    attn_impl "xla", greedy, through the slice's CUDA graph (all 256
    pixels), and the same with mm_dtype "int8" (kernel 3's plain version):
    the capture's and one replay's seconds, the replay's device busy share,
    max_memory_allocated, codes in range."""
    import numpy as np
    import torch

    from lvt_tpu_torch.models.vt import vt_encode

    *_, vt, params = models
    c, plan, s = vt.c, vt.plan, N_PRIME
    b, dev = BENCH_BATCH, torch.device("cuda")
    codes = torch.from_numpy(np.random.default_rng(2).integers(
        0, c.nv, size=(b, c.nc, T_FRAMES, 16, 16))).to(dev)
    thw = plan.slice_src[s].size
    primed = torch.zeros(thw, dtype=torch.bool, device=dev)
    with torch.no_grad():
        sidx = torch.full((b,), s, dtype=torch.int64, device=dev)
        ctx, sl, _ = vt.prepare_slices(codes, sidx)
        zl = vt_encode(params["netG"], c, ctx, sidx)
    for label, mm in (("xla", "native"), ("xla + int8 mm", "int8")):
        knobs = {"kv_dtype": "int8", "weight_dtype": "native", "mm_dtype": mm,
                 "attn_impl": "xla"}
        vt._slice_graph_slot = None  # the graph kept before, freed before the peak is read
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            t0 = time.perf_counter()
            graph = vt._slice_graph(params, zl, sl, primed, knobs, 1.0, True)
            capture = time.perf_counter() - t0
            out, wall, wall_prof, kern, *_ = _profiled(lambda: graph(zl, sl, primed))
        peak = torch.cuda.max_memory_allocated()
        busy = sum(us for _, us in kern) / 1e6
        check(tuple(out.shape) == tuple(sl.shape),
              f"bench slice, {label}: codes of shape {tuple(out.shape)}")
        check(int(out.min()) >= 0 and int(out.max()) < c.nv,
              f"bench slice, {label}: codes outside [0, {c.nv})")
        print(f"bench.py's program, one slice: DSFVT b={b} bf16 int8 KV {label} greedy, {thw} "
              f"pixels, graph [{card}]: captured in {capture:.3f} s (warm-up, one eager slice, "
              f"{graph.warmup_seconds:.3f} s); one replay {wall:.3f} s ({wall_prof:.3f} s under "
              f"the profiler), device busy {busy:.3f} s = {100 * busy / wall_prof:.1f}% of the "
              f"profiled wall time; {len(kern) / thw:.2f} device activities per pixel; "
              f"max_memory_allocated {peak / 2 ** 30:.2f} GiB; codes in [0, {c.nv})")
        for name, (tot, cnt) in sorted(_by_name(kern).items(), key=lambda kv: -kv[1][0])[:6]:
            print(f"  {tot:9.2f} ms {cnt:7d}x  {name[:110]}")
        graph = out = kern = None


def phase_agree_i8(card):
    """fp32, b=2, full width, one slice teacher-forced: every mode of the
    quantized sampler (SLICE_MODES: the kernel modes, and int8 KV with
    `xla`, `xla` + int8 mm and int8 weights, which run PyTorch's CUDA ops)
    on the card against the plain path on the CPU."""
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
    modes = {label: {"kv_dtype": "native", "weight_dtype": "native", "mm_dtype": "native",
                     "attn_impl": "xla", **knobs} for label, knobs in SLICE_MODES}
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


def _grouped_kernel(vq):
    """Kernel 6 over all sub-codebooks and its plain version. A tree from
    before the grouped launch (an A/B turn on a parent commit) has only the
    one-codebook wrapper: there the pair calls it once per sub-codebook."""
    import torch

    if hasattr(vq, "nearest_indices_grouped_cuda"):
        return vq.nearest_indices_grouped_cuda, vq.nearest_indices_grouped_plain

    def per_codebook(fn):
        return lambda z, cbs: torch.stack([fn(z[:, i, :], cbs[i]) for i in range(cbs.shape[0])],
                                          dim=1)
    return per_codebook(vq.nearest_indices_cuda), per_codebook(vq.nearest_indices_plain)


def phase_vq_kernel(card, models=None):
    """Kernel 6 against its plain version at PR-DVQVAE2's training shape (all
    four sub-codebooks in one launch) and Base-VQVAE's (one codebook, Dc =
    256), with ties, a control, determinism, times, and (given the generation
    models) the real z_e of example/*.png."""
    import torch

    from lvt_tpu_torch.ops import vq

    grouped, grouped_plain = _grouped_kernel(vq)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    K, worst = 512, 0
    for G, Dc in ((4, 64), (1, 256)):
        codebooks = torch.randn((G, K, Dc), generator=g, device=dev)
        for N in (1, 8192, 8192 + 37):
            for dtype in ("float32", "bfloat16"):
                for strided in (False, True):
                    # strided: every other sub-codebook of a wider z, read in place
                    zz = torch.randn((N, 2 * G if strided else G, Dc), generator=g,
                                     device=dev).to(getattr(torch, dtype))
                    z = zz[:, 1::2, :] if strided else zz
                    got, again = grouped(z, codebooks), grouped(z, codebooks)
                    want = grouped_plain(z, codebooks)
                    torch.cuda.synchronize()
                    check(got.dtype == torch.int32 and tuple(got.shape) == (N, G),
                          f"nearest_indices: output {got.dtype} {tuple(got.shape)}")
                    res = [_indices_ok(got[:, i], want[:, i], z[:, i, :], codebooks[i])
                           for i in range(G)]
                    n_diff, n_far = sum(r[0] for r in res), sum(r[1] for r in res)
                    worst = max(worst, n_diff)
                    print(f"kernel 6 nearest_indices {dtype} N={N} G={G} K={K} Dc={Dc} "
                          f"{'strided' if strided else 'contiguous'}: {n_diff} of {N * G} indices "
                          f"differ from the plain version's, {n_far} of them no near-tie; two "
                          "calls bit-identical")
                    check(all(r[2] for r in res),
                          f"nearest_indices disagrees with its plain version ({dtype}, N={N}, "
                          f"G={G}, Dc={Dc}, strided={strided}): {n_diff} differ, {n_far} no "
                          "near-tie")
                    check(torch.equal(got, again), "nearest_indices: two calls differ")
                    if G == 1:  # the one-codebook wrapper is the same kernel
                        check(torch.equal(vq.nearest_indices_cuda(z[:, 0, :], codebooks[0]),
                                          got[:, 0]),
                              "nearest_indices: the one-codebook call differs from the grouped one")
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

    # times at the training shapes: z_e of one PR-DVQVAE2 step, (8192, 4,
    # 64), all sub-codebooks in one call, read in place, and Base-VQVAE's
    # (8192, 1, 256); 8 sets (64 MB in fp32) cycle
    times = {}
    for G, Dc, dtypes in ((4, 64, ("bfloat16", "float32")), (1, 256, ("float32", "bfloat16"))):
        codebooks = torch.randn((G, K, Dc), generator=g, device=dev)
        for dtype in dtypes:
            sets = [torch.randn((8192, G, Dc), generator=g, device=dev).to(getattr(torch, dtype))
                    for _ in range(8)]
            kd, pd = time_both(card, [lambda s=s: grouped(s, codebooks) for s in sets],
                               [lambda s=s: grouped_plain(s, codebooks) for s in sets],
                               64, f"kernel 6 {dtype} N=8192 G={G} K={K} Dc={Dc} ")
            lib = device_ms([lambda s=s: [torch.cdist(s[:, i, :].float(), codebooks[i]).argmin(1)
                                          for i in range(G)] for s in sets], 64)
            times[(G, dtype)] = (kd, pd, lib)
            del sets
    bounds = {G: bound_ms("float32", 8192 * G * Dc * 2 + G * K * Dc * 4 + 8192 * G * 4,
                          2 * 8192 * G * K * Dc) for G, Dc in ((4, 64), (1, 256))}
    for G, Dc in ((4, 64), (1, 256)):
        t = {d: times[(G, d)] for d in ("bfloat16", "float32")}
        print(f"  kernel 6 N=8192 G={G} K={K} Dc={Dc}: bound {bounds[G][0]:.4f} ms "
              f"({bounds[G][1]}: "
              f"2 N G K Dc operations at the non-tensor fp32 peak, "
              f"{PEAK_FLOPS['float32'] / 1e12:.0f} TFLOP/s); kernel bf16 z {t['bfloat16'][0]:.4f} "
              f"ms, fp32 z {t['float32'][0]:.4f}; plain {t['bfloat16'][1]:.4f} / "
              f"{t['float32'][1]:.4f}; library yardstick {G} x torch.cdist(z, c).argmin(1) "
              f"{t['bfloat16'][2]:.4f} / {t['float32'][2]:.4f} [{card}]")

    if models is not None:
        _vq_real_z(card, models)
    m, m256 = times[(4, "bfloat16")], times[(1, "float32")]
    return {"err": float(worst), "ms": m[0], "plain_ms": m[1], "bound_ms": bounds[4][0],
            "bound_by": bounds[4][1], "library_ms": m[2],
            "fp32_ms": times[(4, "float32")][0], "fp32_plain_ms": times[(4, "float32")][1],
            "fp32_library_ms": times[(4, "float32")][2], "dc256_ms": m256[0],
            "dc256_plain_ms": m256[1], "dc256_library_ms": m256[2],
            "dc256_bound_ms": bounds[1][0], "dc256_bf16_ms": times[(1, "bfloat16")][0],
            "err_is": "indices that differ, all at near-ties"}


def _vq_real_z(card, models):
    """Kernel 6 on the real z_e of example/*.png, beside encode_indices'
    plain indices: a record for encode_indices' default."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import generate_videos_torch as gvt
    from lvt_tpu_torch.ops import vq

    dev = torch.device("cuda")
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
    from lvt_tpu_torch.ops.vq import nearest_indices_grouped_cuda

    n_steps, n_resume = VQ_TRAIN_STEPS, VQ_RESUME_STEPS
    tmp = tempfile.mkdtemp(prefix="chip_smoke_vqvae_")
    steps, profiled, resumed_from = [], [], []
    inner = Trainer.train_step

    def recorded(self, batch):
        if len(steps) == n_steps:  # the resumed run's first step: what it starts from
            resumed_from.append({k: v.clone() for k, v in flatten(self.state.model_state).items()})
        torch.cuda.synchronize()
        c0 = nearest_indices_grouped_cuda.launches
        last = len(steps) == n_steps + n_resume - 1  # outside the medians
        with profile(activities=[ProfilerActivity.CUDA]) if last else nullcontext() as prof:
            t0 = time.perf_counter()
            metrics = inner(self, batch)
            terms = {k: float(v) for k, v in metrics.items()}  # synchronizes
            took = time.perf_counter() - t0
        if last:
            profiled.append((took, prof))
        steps.append((took, terms, nearest_indices_grouped_cuda.launches - c0, t0))
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
        nearest_indices_grouped_cuda.launches = 0
        t0 = time.perf_counter()
        tr = train_net_torch.main(parse(opts + ["SOLVER.MAX_ITER", str(n_steps)]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = nearest_indices_grouped_cuda.launches
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
    check(per_step == {1}, f"vqvae train: kernel-6 launches per step {sorted(per_step)}, want "
                           "exactly 1 (all sub-codebooks in one launch)")
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
          f"max_memory_allocated {peak / 2 ** 30:.2f} GiB; kernel-6 launches per step 1 (run: "
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
    from lvt_tpu_torch.ops.vq import nearest_indices_grouped_cuda

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
            before = nearest_indices_grouped_cuda.launches
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
            took = nearest_indices_grouped_cuda.launches - before
            check(took == (1 if device == "cuda" else 0),
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
    g = torch.Generator(device="cuda").manual_seed(16)
    sweep = [r for da in (16, 128) for r in cache_sweep(card, 12, ca.decode_attention_i8kv_cuda,
                                                        da, g)]
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
            "dsfvt_bound_ms": bd2, "kernel2_ms": k2, "kernel3_ms": k3, "sweep": sweep}, launches


def main():
    start = time.perf_counter()
    if not os.path.isdir(os.path.join(ROOT, "lvt_tpu_torch")):
        fail(f"no lvt_tpu_torch package beside {__file__}: run from a checkout of the repo")
    sys.path.insert(0, ROOT)
    import torch

    card = phase_device()
    import lvt_tpu_torch  # noqa: F401  (TF32 off)

    laps, last = [], [time.perf_counter()]

    def lap(name):  # host seconds of each phase, printed at the end
        now = time.perf_counter()
        laps.append(f"{name} {now - last[0]:.1f}")
        last[0] = now

    phase_build()
    lap("build")
    kres = phase_kernels(card)
    lap("kernels")
    launches, models, codes = phase_main(card)
    lap("main")
    phase_agree(card)
    lap("agree")
    phase_pth(card)
    lap("pth")
    i8res = phase_i8_kernels(card, kres["decode_attention"]["ms"])
    lap("i8 kernels")
    fold_err = phase_i8_fold(card)
    lap("i8 fold")
    for k, name in ((3, "decode_attention_i8"), (4, "decode_attention_i8_live")):
        i8res[name]["err"] = max(i8res[name]["err"], fold_err[k])
    i8_launches, vts = phase_main_i8(card, models)
    lap("main i8")
    phase_slices(card, models, codes, vts=vts)
    lap("slices")
    phase_agree_i8(card)
    lap("agree i8")
    phase_bench_slice(card, models)
    lap("bench slice")
    k6 = phase_vq_kernel(card, models)
    lap("vq kernel")
    del models, codes
    k10, err1_train, _ = phase_train_kernels(card)
    shapes = phase_attention_shapes(card)
    k10["err"] = max(k10["err"], shapes["bwd"], shapes["dbias"])
    lap("train kernels")
    fres, fbounds = phase_fused_kernels(card)
    lap("fused kernels")
    fused_run, unfused_run = phase_train(card)
    lap("train")
    phase_train_agree(card)
    lap("train agree")
    vq_run = phase_vqvae_train(card)
    lap("vqvae train")
    phase_vqvae_agree(card)
    lap("vqvae agree")
    k12, k12_launches = phase_probe_kernel(card)
    lap("probe kernel")
    print("phase seconds: " + ", ".join(laps) + f"; whole run {time.perf_counter() - start:.1f} s")

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
        e["by_function_ms"] = (fres["by_function"] or {}).get(k)
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
        # kernel 6: the launches of the VQ-VAE training run (1 per step);
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
