#!/usr/bin/env python
"""Time kernels 3 and 4 (csrc/decode_attention_i8.cu) at every cluster size,
to choose their launch plans (ops/cache_attention.py ``decode_i8_plan`` and
``decode_i8_live_plan``): at na=8, R=256, da=128, bf16 scales and output,
b in (1, 8, 16) x live in (16, 64, 128, 256), each kernel at C in (1, 2, 4,
8, 16) blocks per (batch row, head) (kernel 4: C no more than its live tiles
of 64 rows), its rows read through the ring of bulk copies and directly,
beside the plan's choice, the fused entries (q and the new
rows quantized in the launch) at the plan's C, and kernel 2 over a bf16
cache of the same shape. Device times by chip_smoke.py's device_ms
(CUDA-graph replay over input sets of >= 64 MB together). Needs a CUDA
card.

    python tools/time_decode_i8_torch.py
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLUSTERS = (1, 2, 4, 8, 16)


def main():
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke
    from lvt_tpu_torch.ops import cache_attention as ca
    from lvt_tpu_torch.ops._lib import LIBRARY

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = chip_smoke.phase_device()
    lib = LIBRARY.get()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    na, R, da, rtile, scale = 8, 256, 128, 64, 128 ** -0.5
    for b in (1, 8, 16):
        n_sets = max(4, min(64, -(-64 * 2 ** 20 // (2 * b * na * R * da))))
        q8 = torch.randint(-127, 128, (b, na, da), generator=g, device=dev, dtype=torch.int8)
        sq = 0.01 * torch.rand((b, na), generator=g, device=dev) + 1e-3
        qkv = torch.randn((b, 3, na, da), generator=g, device=dev).to(torch.bfloat16)
        bias = 0.5 * torch.randn((na, R), generator=g, device=dev)
        sets = [(torch.randint(-127, 128, (b, na, R, da), generator=g, device=dev,
                               dtype=torch.int8),
                 (0.02 * torch.rand((b, na, R), generator=g, device=dev) + 1e-3).bfloat16(),
                 torch.randint(-127, 128, (b, na, R, da), generator=g, device=dev,
                               dtype=torch.int8),
                 (0.02 * torch.rand((b, na, R), generator=g, device=dev) + 1e-3).bfloat16())
                for _ in range(n_sets)]
        bf16 = [(torch.randn((b, na, R, da), generator=g, device=dev).bfloat16(),
                 torch.randn((b, na, R, da), generator=g, device=dev).bfloat16())
                for _ in range(max(4, n_sets // 2))]
        q = qkv[:, 0].contiguous()
        out = torch.empty((b, na * da), dtype=torch.bfloat16, device=dev)
        for live in (16, 64, 128, 256):
            tiles = -(-live // rtile)
            ring = ca.i8_ring_rows(rtile, da)

            def k3(s, c, direct):
                chunk = ca._i8_chunk(live, c)
                err = lib.lvt_decode_attention_i8(
                    q8.data_ptr(), sq.data_ptr(), s[0].data_ptr(), s[1].data_ptr(),
                    s[2].data_ptr(), s[3].data_ptr(), bias.data_ptr(), out.data_ptr(), b, na, R,
                    da, live, c, chunk, direct, 1, 1, scale,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"kernel 3, C={c}: cudaError_t {err}")

            def k4(s, c, direct):
                chunk = -(-tiles // c) * rtile
                err = lib.lvt_decode_attention_i8_live(
                    q8.data_ptr(), sq.data_ptr(), s[0].data_ptr(), s[1].data_ptr(),
                    s[2].data_ptr(), s[3].data_ptr(), bias.data_ptr(), out.data_ptr(), b, na, R,
                    da, live, rtile, c, chunk, ring, direct, 1, 1, scale,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"kernel 4, C={c}: cudaError_t {err}")

            for k, fn, plan, most in ((3, k3, ca.decode_i8_plan(live, da), 16),
                                      (4, k4, ca.decode_i8_live_plan(live, rtile, da),
                                       tiles)):
                times = {(c, d): chip_smoke.device_ms([lambda s=s, c=c, d=d: fn(s, c, d)
                                                       for s in sets], 200)
                         for c in CLUSTERS if c <= most for d in (0, 1)
                         if not d or -(-live // c) * da <= 8 * ca.I8_WARP_BYTES}
                best = min(times, key=times.get)
                print(f"kernel {k} clusters b={b} live={live} [{card}]: " + ", ".join(
                    f"C={c}{' direct' if d else ''} {t:.4f}" for (c, d), t in times.items())
                    + f" ms; fastest C={best[0]}{' direct' if best[1] else ''}, plan C={plan[0]}"
                    + (" direct" if plan[-1] else ""), flush=True)
            step3 = chip_smoke.device_ms(
                [lambda s=s: ca.decode_attention_i8_step_cuda(qkv[:, 0], qkv[:, 1:], *s, live,
                                                             bias, scale) for s in sets], 200)
            step4 = chip_smoke.device_ms(
                [lambda s=s: ca.decode_attention_i8_live_step_cuda(qkv[:, 0], qkv[:, 1:], *s, live,
                                                                  bias, scale) for s in sets], 200)
            k2 = chip_smoke.device_ms([lambda c=c: ca.decode_attention_cuda(q, *c, live, bias,
                                                                             scale)
                                       for c in bf16], 200)
            print(f"kernels 3 and 4 fused b={b} live={live} [{card}]: kernel 3 step {step3:.4f} "
                  f"ms, kernel 4 step {step4:.4f} ms; kernel 2 (bf16 cache) {k2:.4f} ms",
                  flush=True)
        del sets, bf16


if __name__ == "__main__":
    main()
