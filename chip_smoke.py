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
  7. train    — tools/train_net_torch.py's main: DSFVT with TPU.FUSED_LAYER
                False at batch 64, bf16 compute, per-layer remat, RMSprop,
                20 steps on latent videos written from a numpy seed, then
                --resume to step 24 from its checkpoint. Exactly 16 kernel-10
                and 32 kernel-1 launches per step; finite losses; device time
                by kernel of the last step (torch.profiler). Kernel 10's
                launch count is read around this phase only.
  8. train agree — one fp32 step at batch 2, full width: the loss and every
                gradient leaf on the card against the plain path on the CPU,
                and the same step with TF32 on, which must fall outside the
                bound.

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
TRAIN_STEPS, RESUME_STEPS = 20, 4

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


def time_both(card, kernel_calls, plain_calls, iters):
    """(kernel device ms, plain device ms) per call, printed beside the
    per-call times with the host's share. The calls cycle through input
    sets that together exceed the 50 MB L2, as the rollout's calls find
    their inputs mostly outside it."""
    kd, pd = device_ms(kernel_calls, iters), device_ms(plain_calls, iters)
    kh, ph = host_ms(kernel_calls, iters), host_ms(plain_calls, iters)
    print(f"  time [{card}]: device kernel {kd:.4f} ms, plain {pd:.4f} ms; "
          f"per call with host kernel {kh:.4f} ms, plain {ph:.4f} ms")
    return kd, pd


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
    res["block_attention_fwd"] = (err1, *t1[("bfloat16", False)])

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
    res["decode_attention"] = (err2, *t2[("bfloat16", 256)])
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
    return err, times, err1, times1


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


def phase_train(card):
    """DSFVT training through tools/train_net_torch.py's main, then
    --resume; per-step launch counts and times recorded around
    Trainer.train_step."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import train_net_torch
    from lvt_tpu_torch.data.datasets.latents import register_latents
    from lvt_tpu_torch.engine.defaults import default_argument_parser
    from lvt_tpu_torch.engine.trainer import Trainer
    from lvt_tpu_torch.ops.attention import block_attention_bwd_cuda, block_attention_fwd_cuda

    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    steps, profiled = [], []
    inner = Trainer.train_step

    def recorded(self, batch):
        torch.cuda.synchronize()
        c0 = (block_attention_fwd_cuda.launches, block_attention_bwd_cuda.launches)
        if len(steps) == TRAIN_STEPS + RESUME_STEPS - 1:  # the last step, outside the medians
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
                      block_attention_fwd_cuda.launches - c0[0],
                      block_attention_bwd_cuda.launches - c0[1], t0))
        return metrics

    try:
        t0 = time.perf_counter()
        _write_latents(os.path.join(tmp, "latents"), 128, 0)
        register_latents("chip_smoke_latents", os.path.join(tmp, "latents"))
        print(f"train data: 128 latent videos of {T_FRAMES} frames written in "
              f"{time.perf_counter() - t0:.2f} s")
        out = os.path.join(tmp, "out")
        opts = ["--config-file", os.path.join(ROOT, "configs", "vt", "DSFVT.yaml"),
                "TPU.FUSED_LAYER", "False", "SOLVER.CHECKPOINT_PERIOD", "10",
                "DATASETS.TRAIN", "('chip_smoke_latents',)", "DATALOADER.NUM_WORKERS", "8",
                "OUTPUT_DIR", out]
        parse = default_argument_parser().parse_args
        Trainer.train_step = recorded
        torch.cuda.reset_peak_memory_stats()
        block_attention_fwd_cuda.launches = block_attention_bwd_cuda.launches = 0
        t0 = time.perf_counter()
        tr = train_net_torch.main(parse(opts + ["SOLVER.MAX_ITER", str(TRAIN_STEPS)]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = (block_attention_fwd_cuda.launches, block_attention_bwd_cuda.launches)
        peak = torch.cuda.max_memory_allocated()
        check(tr.state.step == TRAIN_STEPS and len(steps) == TRAIN_STEPS,
              f"train: {tr.state.step} steps taken, want {TRAIN_STEPS}")
        check(sorted(os.listdir(os.path.join(out, "checkpoints"))) ==
              [f"ckpt_{TRAIN_STEPS // 2}.pt", f"ckpt_{TRAIN_STEPS}.pt"],
              f"train: checkpoints {os.listdir(os.path.join(out, 'checkpoints'))}")
        tr2 = train_net_torch.main(parse(["--resume"] + opts + [
            "SOLVER.MAX_ITER", str(TRAIN_STEPS + RESUME_STEPS)]))
        check(tr2.start_iter == TRAIN_STEPS and tr2.state.step == TRAIN_STEPS + RESUME_STEPS,
              f"resume: started at {tr2.start_iter}, ended at {tr2.state.step}")
    finally:
        Trainer.train_step = inner
        shutil.rmtree(tmp, ignore_errors=True)
    losses = [s[1] for s in steps]
    check(all(np.isfinite(losses)), f"train: non-finite losses {losses}")
    per_step = {(s[2], s[3]) for s in steps}
    check(per_step == {(32, 16)}, f"train: kernel launches per step (kernel 1, kernel 10) "
                                  f"{sorted(per_step)}, want exactly (32, 16)")
    sec = float(np.median([s[0] for s in steps[3:TRAIN_STEPS]]))
    # an iteration: from one step's start to the next's (data, step, hooks)
    it_sec = float(np.median([b[4] - a[4] for a, b in zip(steps[3:TRAIN_STEPS - 1],
                                                           steps[4:TRAIN_STEPS])]))
    batch = tr.cfg.SOLVER.IMS_PER_BATCH
    print(f"train DSFVT b={batch} bf16 remat FUSED_LAYER False [{card}]: {TRAIN_STEPS} steps in "
          f"{wall:.2f} s with set-up; median {sec:.4f} s/step over steps 4-{TRAIN_STEPS} "
          f"(train_step, synchronized), {it_sec:.4f} s/iteration (with data and hooks) = "
          f"{batch / it_sec:.2f} videos/s; first step {steps[0][0]:.3f} s; max_memory_allocated "
          f"{peak / 2 ** 30:.2f} GiB; launches per step kernel 1 32, kernel 10 16 (run: "
          f"{launches[0]}, {launches[1]}); loss {losses[0]:.4f} -> {losses[TRAIN_STEPS - 1]:.4f}; "
          f"resumed at {TRAIN_STEPS}, {RESUME_STEPS} more steps, loss "
          f"{losses[-1]:.4f}")
    check(len(profiled) == 1, "train: the last resumed step was not profiled")
    _print_step_profile(card, batch, sec, *profiled[0])
    return launches


def _print_step_profile(card, batch, step_sec, wall, prof):
    """Device time of one train step by kernel, with each of kernel 10's
    three kernels (query tiles, key tiles, dbias reduction) on its own. The
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
    print(f"profile, one train step DSFVT b={batch} bf16 remat [{card}]: wall {wall:.4f} s "
          f"under the profiler, device busy {busy:.2f} ms = {100 * busy / (1e3 * wall):.1f}% "
          f"of it, {100 * busy / (1e3 * step_sec):.1f}% of the median step ({step_sec:.4f} s); "
          f"{len(kern)} device activities")
    for name, (tot, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"  {tot:9.3f} ms {cnt:5d}x  {name[:110]}")
    parts = {label: [(t, c) for name, (t, c) in by_name.items() if key in name]
             for label, key in (("query tiles", "bwd_rows"), ("key tiles", "bwd_keys"),
                                ("dbias reduction", "dbias_reduce"),
                                ("kernel 1", "block_attention_"))}
    sums = {label: (sum(t for t, _ in v), sum(c for _, c in v)) for label, v in parts.items()}
    k10 = sum(sums[k][0] for k in ("query tiles", "key tiles", "dbias reduction"))
    print("  kernel 10 per step: " + ", ".join(
        f"{label} {sums[label][0]:.3f} ms ({sums[label][1]}x)"
        for label in ("query tiles", "key tiles", "dbias reduction"))
        + f"; total {k10:.3f} ms; kernel 1 {sums['kernel 1'][0]:.3f} ms "
          f"({sums['kernel 1'][1]}x)")


def phase_train_agree(card):
    import copy

    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import generate_videos_torch as gvt
    from lvt_tpu_torch.checkpoint.convert import flatten
    from lvt_tpu_torch.models import to_device
    from lvt_tpu_torch.models.vt import VideoTransformer

    cfg = gvt.load_config(os.path.join(ROOT, "configs", "vt", "DSFVT.yaml"),
                          ["TPU.FUSED_LAYER", "False"])
    vt = VideoTransformer(cfg)
    params, _ = vt.init(torch.Generator().manual_seed(2))
    video = torch.from_numpy(np.random.default_rng(1).integers(0, 512, (2, 4, T_FRAMES, 16, 16)))
    si = torch.tensor([1, 9])
    res = {}
    for name, device, tf32 in (("cpu", "cpu", False), ("card", "cuda", False),
                               ("tf32", "cuda", True)):
        p = copy.deepcopy(to_device(params, device))  # leaves of their own
        for leaf in flatten(p).values():
            leaf.requires_grad_(True)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
        try:
            loss, _ = vt.loss(p, {"video": video.to(device)}, slice_idx=si)
            loss.backward()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        res[name] = (float(loss.detach()), {k: v.grad.cpu() for k, v in flatten(p).items()})
    ref = res["cpu"][1]
    floor = 1e-2 * max(float(g.norm()) for g in ref.values())
    ref_norm = float(torch.stack([g.norm() for g in ref.values()]).norm())

    def worst(grads):
        rel = {k: float((grads[k] - g).norm()) / max(float(g.norm()), floor)
               for k, g in ref.items()}
        k = max(rel, key=rel.get)
        whole = float(torch.stack([(grads[k] - g).norm() for k, g in ref.items()]).norm())
        return rel[k], k, whole / ref_norm

    (e_card, k_card, w_card), (e_tf32, k_tf32, w_tf32) = worst(res["card"][1]), \
        worst(res["tf32"][1])
    print(f"train agree fp32 b=2 full width, one loss+backward [{card}]: loss card "
          f"{res['card'][0]:.6f} cpu {res['cpu'][0]:.6f}; {len(ref)} gradient leaves, worst "
          f"relative error (Frobenius) card vs cpu plain {e_card:.3g} ({k_card}), whole "
          f"gradient {w_card:.3g}; control with TF32 on {e_tf32:.3g} ({k_tf32}), whole "
          f"gradient {w_tf32:.3g}; bounds {GRAD_TOL:g} per leaf, {GRAD_TOL_WHOLE:g} whole")
    check(abs(res["card"][0] - res["cpu"][0]) <= 1e-5 * abs(res["cpu"][0]),
          f"train agree: loss {res['card'][0]} on the card, {res['cpu'][0]} on the CPU")
    check(e_card <= GRAD_TOL, f"train agree: gradient {k_card} off by {e_card} (relative)")
    check(w_card <= GRAD_TOL_WHOLE, f"train agree: the whole gradient is off by {w_card} "
                                    "(relative)")
    check(e_tf32 > GRAD_TOL and w_tf32 > GRAD_TOL_WHOLE,
          f"train agree: the TF32 control reads {e_tf32} per leaf, {w_tf32} whole, within the "
          f"bounds {GRAD_TOL}, {GRAD_TOL_WHOLE}: they cannot tell TF32 from true fp32")


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
    err10, t10, err1_train, _ = phase_train_kernels(card)
    train_launches = phase_train(card)
    phase_train_agree(card)

    kernels = [
        {"name": "block_attention_fwd", "route": "cuda",
         "source": "lvt_tpu_torch/csrc/block_attention.cu",
         "replaces": "lvt_tpu/ops/attention.py:127", "launches": launches[0],
         "max_abs_err": max(kres["block_attention_fwd"][0], err1_train),
         "ms": kres["block_attention_fwd"][1], "plain_ms": kres["block_attention_fwd"][2]},
        {"name": "decode_attention", "route": "cuda",
         "source": "lvt_tpu_torch/csrc/decode_attention.cu",
         "replaces": "lvt_tpu/ops/cache_attention.py:451", "launches": launches[1],
         "max_abs_err": kres["decode_attention"][0],
         "ms": kres["decode_attention"][1], "plain_ms": kres["decode_attention"][2]},
        {"name": "block_attention_bwd", "route": "cuda",
         "source": "lvt_tpu_torch/csrc/block_attention_bwd.cu",
         "replaces": "lvt_tpu/ops/attention.py:186", "launches": train_launches[1],
         "max_abs_err": err10, "ms": t10[("bfloat16", False)][0],
         "plain_ms": t10[("bfloat16", False)][1]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
