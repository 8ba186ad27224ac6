#!/usr/bin/env python
"""How far fp32 noise moves the quantized sampler's logits (PyTorch port).

Two runs of one full-width DSFVT slice (batch 2, fp32, teacher-forced, random
seeded weights) on the CPU: one with the weights as they are, one with every
float weight scaled by 1 + NOISE * N(0, 1), NOISE = 1e-6 (the size of fp32
rounding differences between two devices). For the native sampler and for two
quantized modes it prints the difference of the two runs' logits beside the
mode's own gap to the native sampler. int8 rounding turns a value within the
noise of x.5 into a whole step, and later roundings then part at a far higher
rate, so the quantized modes' difference is a sizeable share of their gap
where the native one stays at the noise. That share is what an agreement
bound between two devices (chip_smoke.py, phase "agree i8") has to allow.

    python tools/probe_int8_noise_torch.py        # ~1 minute on 4 CPU threads
"""

import copy
import os
import sys

import numpy as np
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

NOISE = 1e-6
MODES = {"native": {},
         "int8 KV + pallas": dict(kv_dtype="int8", attn_impl="pallas"),
         "int8 KV + pallas + int8-pallas weights": dict(kv_dtype="int8", attn_impl="pallas",
                                                        weight_dtype="int8-pallas")}


def main():
    import generate_videos_torch as gvt
    from lvt_tpu_torch.checkpoint.convert import flatten
    from lvt_tpu_torch.models.vt import vt_encode
    from lvt_tpu_torch.models.vt_incremental import sample_slice_incremental

    torch.set_num_threads(4)
    cfg = gvt.load_config(os.path.join(ROOT, "configs", "vt", "DSFVT.yaml"))
    *_, vt, params = gvt.build_models(cfg, 1, "cpu", torch.float32)
    noisy = copy.deepcopy(params["netG"])
    gen = torch.Generator().manual_seed(5)
    for leaf in flatten(noisy).values():
        if leaf.is_floating_point():
            leaf.mul_(1 + NOISE * torch.randn(leaf.shape, generator=gen))
    video = np.random.default_rng(0).integers(0, vt.c.nv, size=(2, vt.c.nc, 16, 16, 16))
    sidx = torch.full((2,), 5, dtype=torch.int64)
    ctx, sl, _ = vt.prepare_slices(torch.from_numpy(video), sidx)
    logits = {}
    with torch.no_grad():
        for name, p in (("clean", params["netG"]), ("noisy", noisy)):
            zl = vt_encode(p, vt.c, ctx, sidx)
            for mode, knobs in MODES.items():
                logits[name, mode] = sample_slice_incremental(
                    p, vt.c, vt.plan.slice_shape, zl, sl, None, np.ones(256, bool), 1.0,
                    teacher_logits=True, **knobs)[1]

    def stats(x):
        return f"max {float(x.abs().max()):.3g}, rms {float(x.pow(2).mean().sqrt()):.3g}"

    for mode in MODES:
        moved = logits["noisy", mode] - logits["clean", mode]
        gap = logits["clean", mode] - logits["clean", "native"]
        print(f"{mode}: weights scaled by 1 + {NOISE:g} N(0, 1) move the logits by "
              f"{stats(moved)}; the mode's gap to the native sampler: {stats(gap)}")


if __name__ == "__main__":
    main()
