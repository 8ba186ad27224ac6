#!/usr/bin/env python
"""Time kernels 5 and 12 (csrc/decode_attention_i8.cu) at every launch plan,
to choose ops/cache_attention.py ``cache_attention_plan``: na=8, R=256, fp32
scales, bf16 q and output, b in (1, 16, 256) x live in (1, 64, 200, 256);
kernel 5 at da=128, kernel 12 at da=16 (the probe tool's width) and 128;
each at C in (1, 2, 4, 8, 16) ranks per (batch row, head) of 4 warps of 4
row loads a thread or of 8 warps of 4 or 8, and at da=16 also one warp a
head, beside the plan's choice and the bound (chip_smoke.py bound_ms). Device times by chip_smoke.py's device_ms
(CUDA-graph replay over input sets of >= 64 MB together). Needs a CUDA card.

    python tools/time_cache_attention_torch.py
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLUSTERS = (1, 2, 4, 8, 16)


def plans(live, da):
    """Every plan the launch takes at `live` rows: (C, chunk, warps)."""
    from lvt_tpu_torch.ops import cache_attention as ca

    out = [(c, -(-live // c), w, u) for c in CLUSTERS for w, u in ((4, 4), (8, 4), (8, 8))]
    if da == 16 and live <= ca.CACHE_WARP_ROWS:
        out.append((1, live, 1, 8))  # one warp a head
    return out


def main():
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke
    from lvt_tpu_torch.ops import cache_attention as ca

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = chip_smoke.phase_device()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    na, R = 8, 256
    for k, entry, da in ((5, "lvt_cache_attention_i8", 128),
                         (12, "lvt_decode_attention_i8kv", 16),
                         (12, "lvt_decode_attention_i8kv", 128)):
        name = {5: "cache_attention_i8_cuda", 12: "decode_attention_i8kv_cuda"}[k]
        scale = da ** -0.5
        for b in (1, 16, 256):
            n_sets = max(4, min(64, -(-64 * 2 ** 20 // (2 * b * na * R * da))))
            sets = [(torch.randint(-127, 128, (b, na, R, da), generator=g, device=dev,
                                   dtype=torch.int8),
                     0.01 + 0.01 * torch.rand((b, na, R), generator=g, device=dev),
                     torch.randint(-127, 128, (b, na, R, da), generator=g, device=dev,
                                   dtype=torch.int8),
                     0.01 + 0.01 * torch.rand((b, na, R), generator=g, device=dev))
                    for _ in range(n_sets)]
            q = torch.randn((b, na, da), generator=g, device=dev).bfloat16()
            extra = 0.5 * torch.randn((1, na, R), generator=g, device=dev)
            for live in (1, 64, 200, 256):
                def call(s, plan):
                    return ca._float_query_cuda(name, entry, (16, 64, 128), q, *s, extra, scale,
                                                live, plan)

                times = {p: chip_smoke.device_ms([lambda s=s, p=p: call(s, p) for s in sets], 200)
                         for p in plans(live, da)}
                best = min(times, key=times.get)
                plan = ca.cache_attention_plan(b, na, live, da)
                bd, by = chip_smoke.bound_ms(
                    "float32", 2 * b * na * live * da + 3 * b * na * live * 4
                    + 2 * b * na * da * 2, 4 * b * na * live * da)
                print(f"kernel {k} plans da={da} b={b} live={live} [{card}]: " + ", ".join(
                    f"C={c}x{w}wx{u} {t:.4f}" for (c, _, w, u), t in times.items())
                    + f" ms; fastest C={best[0]}x{best[2]}wx{best[3]} {times[best]:.4f}, plan "
                    f"C={plan[0]}x{plan[2]}wx{plan[3]} {times[plan]:.4f}; bound {bd:.4f} ({by})",
                    flush=True)
            del sets


if __name__ == "__main__":
    main()
