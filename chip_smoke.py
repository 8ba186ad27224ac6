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

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# tolerances, |kernel - plain| on the same inputs:
#   fp32: sums in another order only.
#   bf16: plus one rounding of the output to bf16 and of P to bf16 at a
#   boundary the two versions may cross differently (2^-7 relative).
TOL = {"float32": (1e-4, 0.0), "bfloat16": (1e-3, 2 ** -7)}  # (abs, rel)
# whole path, fp32, card vs CPU: 16 layers of GEMMs summed in other orders
# (sound runs read ~3e-6 at |logits| <= 2.6). Phase 5 also runs vt_logits
# once with TF32 allowed and fails unless that control reads above the bound,
# so a path whose precision drops below fp32 cannot pass.
PATH_TOL = 2e-5

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


def _err(k, p, dtype):
    atol, rtol = TOL[dtype]
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
            e, ok = _err(out, ref, dtype)
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
    from lvt_tpu_torch.ops import subscale as ss

    *_, vt, params = models
    c, plan, s = vt.c, vt.plan, N_PRIME
    b = codes.shape[0]
    vflat = codes.reshape(b, c.nc, -1)
    gen = torch.Generator(device=codes.device).manual_seed(0)
    primed = np.zeros(plan.slice_src[s].size, bool)

    def one_slice():
        ctx = vt._gather_ctx(plan, vflat, s)
        sl = ss.gather_slice(vflat, plan.slice_src[s])
        sidx = torch.full((b,), s, dtype=torch.int64, device=codes.device)
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
    from lvt_tpu_torch.ops import subscale as ss

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
        vflat = torch.from_numpy(video).to(device).reshape(2, c.nc, -1)
        ctx = vt._gather_ctx(plan, vflat, s)
        sl = ss.gather_slice(vflat, plan.slice_src[s])
        sidx = torch.full((2,), s, dtype=torch.int64, device=device)
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

    kernels = [
        {"name": "block_attention_fwd", "route": "cuda",
         "source": "lvt_tpu_torch/csrc/block_attention.cu",
         "replaces": "lvt_tpu/ops/attention.py:127", "launches": launches[0],
         "max_abs_err": kres["block_attention_fwd"][0],
         "ms": kres["block_attention_fwd"][1], "plain_ms": kres["block_attention_fwd"][2]},
        {"name": "decode_attention", "route": "cuda",
         "source": "lvt_tpu_torch/csrc/decode_attention.cu",
         "replaces": "lvt_tpu/ops/cache_attention.py:451", "launches": launches[1],
         "max_abs_err": kres["decode_attention"][0],
         "ms": kres["decode_attention"][1], "plain_ms": kres["decode_attention"][2]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
