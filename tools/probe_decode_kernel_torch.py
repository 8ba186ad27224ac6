#!/usr/bin/env python
"""Probe of the decode-attention kernel with an unquantized q over int8 K/V
caches (kernel 12 of lvt_tpu_torch/ops/cache_attention.py,
``decode_attention_i8kv``); the counterpart of tools/probe_decode_kernel.py.

  logits = (q . K) * scale * ks + extra      q in bf16/fp32, K int8 -> io exactly
  w      = softmax(logits) * vs              rounded once to the io dtype
  out    = w . V                             fp32 sums, rounded to io

The cache keeps the port's heads-apart layout, (b, na, cl, da) int8 with
scales (b, na, cl); the JAX probe's fused-lane layout and block-diagonal q
are not carried over (per head the function is the same).

Correctness of the plain version against a float64 reference, on the CPU
(the bounds of tools/probe_decode_kernel.py):
  python tools/probe_decode_kernel_torch.py --check
Device times on a CUDA card, kernel 12 beside its plain version at the probe's
own shape (b 256, na 8, cl 256, da 16), and beside kernels 2 and 3 at a shape
they take (DSFVT's: b 16, na 8, cl 256, da 128):
  python tools/probe_decode_kernel_torch.py
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

B, NA, CL, DA = 256, 8, 256, 16          # the probe's own shape
SHAPES = {"probe": (B, NA, CL, DA), "dsfvt": (16, 8, 256, 128)}


def make_inputs(seed, b=B, na=NA, cl=CL, da=DA, dtype=torch.bfloat16, device="cpu"):
    """q (b, na, da) in ``dtype``; k8, v8 (b, na, cl, da) int8; ks, vs
    (b, na, cl) fp32 in [0.01, 0.02); extra (1, na, cl) fp32, a small bias
    with the rows past cl // 2 masked by -1e9. Drawn from a numpy seed."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((b, na, da)).astype(np.float32)).to(dtype)
    k8, v8 = (torch.from_numpy(rng.integers(-127, 128, (b, na, cl, da), dtype=np.int8))
              for _ in range(2))
    ks, vs = (torch.from_numpy(rng.uniform(0.01, 0.02, (b, na, cl)).astype(np.float32))
              for _ in range(2))
    extra = (0.1 * rng.standard_normal((1, na, cl))).astype(np.float32)
    extra[:, :, cl // 2 + 1:] = -1e9
    return tuple(t.to(device) for t in (q, k8, ks, v8, vs, torch.from_numpy(extra)))


def reference(q, k8, ks, v8, vs, extra, scale):
    """The function in float64 with no rounding point: (b, na, da)."""
    logits = torch.einsum("bad,bajd->baj", q.double(), k8.double()) * scale
    w = torch.softmax(logits * ks.double() + extra.double(), dim=-1) * vs.double()
    return torch.einsum("baj,bajd->bad", w, v8.double())


def quantize_q(q):
    """(b, na, da) q -> int8 rows + (b, na) fp32 scales, for kernel 3."""
    from lvt_tpu_torch.ops.quant import absmax_scale

    q32 = q.float()
    sq = absmax_scale(q32.abs().amax(dim=-1))
    q8 = torch.clamp(torch.round(q32 / (sq[..., None] + 1e-8)), -127.0, 127.0).to(torch.int8)
    return q8, sq


def check():
    """The plain versions on the CPU against the float64 reference."""
    from lvt_tpu_torch.ops import cache_attention as ca

    q, k8, ks, v8, vs, extra = make_inputs(0, b=16, cl=128)
    scale = DA ** -0.5
    ref = reference(q, k8, ks, v8, vs, extra, scale)
    got = ca.decode_attention_i8kv(q, k8, ks, v8, vs, extra, scale)
    err = float((got.double() - ref).abs().max())
    print("max abs err i8kv (plain) vs float64:", err)
    assert err < 0.05, err
    q8, sq = quantize_q(q)
    got8 = ca.decode_attention_i8_plain(q8, sq, k8, ks, v8, vs, k8.shape[2], extra[0], scale,
                                        torch.bfloat16).reshape(ref.shape)
    err8 = float((got8.double() - ref).abs().max())
    print("max abs err i8 (plain, int8 q and weights) vs float64:", err8)
    assert err8 < 0.1, err8  # extra q/w int8 rounding
    print("OK")
    return err, err8


def device_ms(calls, iters):
    """Device time per call: ``iters`` calls, cycling through ``calls``,
    captured in one CUDA graph and replayed between two CUDA events."""
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
    return start.elapsed_time(end) / iters


def bench(dtype=torch.bfloat16, iters=200):
    """Device ms per call on the current CUDA card, over input sets that
    together exceed a 50 MB L2. Returns {shape: {name: ms}}."""
    from lvt_tpu_torch.ops import cache_attention as ca

    if not torch.cuda.is_available():
        raise SystemExit("probe_decode_kernel_torch.py times on a CUDA card "
                         "(torch.cuda.is_available() is false); --check runs on the CPU")
    out = {}
    for name, (b, na, cl, da) in SHAPES.items():
        scale = da ** -0.5
        n_sets = -(-64 * 2 ** 20 // (2 * b * na * cl * da))
        sets = [make_inputs(s, b, na, cl, da, dtype, "cuda") for s in range(n_sets)]
        t = {"decode_attention_i8kv": device_ms(
                 [lambda x=x: ca.decode_attention_i8kv_cuda(*x, scale) for x in sets], iters),
             "plain": device_ms(
                 [lambda x=x: ca.decode_attention_i8kv_plain(*x, scale) for x in sets], iters)}
        if da in (64, 128):  # the shapes kernels 2 and 3 take
            extra = sets[0][5]
            q8s = [quantize_q(x[0]) for x in sets]
            t["decode_attention_i8 (kernel 3)"] = device_ms(
                [lambda x=x, s=s: ca.decode_attention_i8_cuda(
                    *s, x[1], x[2], x[3], x[4], cl, extra[0], scale, dtype)
                 for x, s in zip(sets, q8s)], iters)
            caches = [(x[1].to(dtype), x[3].to(dtype)) for x in sets]
            t["decode_attention (kernel 2, cache in the io dtype)"] = device_ms(
                [lambda x=x, c=c: ca.decode_attention_cuda(x[0], *c, cl, extra[0], scale)
                 for x, c in zip(sets, caches)], iters)
        logical = 2 * b * na * cl * da  # int8 K and V bytes of one call
        for k, ms in t.items():
            print(f"{name} (b={b}, na={na}, cl={cl}, da={da}) {k}: {1e3 * ms:7.1f} us/call, "
                  f"{logical / ms / 1e6:7.1f} GB/s of int8 cache bytes")
        out[name] = t
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="hold the plain version to a float64 reference on the CPU")
    ap.add_argument("--fp32", action="store_true", help="time with fp32 io (default bf16)")
    args = ap.parse_args()
    if args.check:
        check()
    else:
        print(torch.cuda.get_device_name(0) if torch.cuda.is_available() else "no CUDA card")
        bench(torch.float32 if args.fp32 else torch.bfloat16)
