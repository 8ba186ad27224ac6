#!/usr/bin/env python
"""Time kernel 1's bf16 kernel (csrc/block_attention.cuh) with one part left
out at a time, to see which part holds it back: the bias step, the softmax,
q k^T, P.V, and everything but the loads.

Each variant is compiled with nvcc from a copy of csrc/ whose kernel has a
preprocessor switch around each part, into build/attention_parts/, and is
timed at DSFVT's shape (na=8, n=256, da=128; nb 16 and 64) by chip_smoke.py's
device_ms (CUDA-graph replay over input sets larger than the L2). A variant
that leaves a part out computes a wrong output: only its time means anything.
Also prints how many blocks share an SM at either end of the shared-memory
carveout. Needs a CUDA card and nvcc.

    python tools/time_attention_parts_torch.py
"""

import ctypes
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "lvt_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "build", "attention_parts")

# (text of csrc/block_attention.cuh, the same text with a switch around it)
SWITCHES = [
    ("  const bool bias_tma = n % 4 == 0;\n",
     "#ifdef NO_BIAS\n  const bool bias_tma = false;\n#else\n  const bool bias_tma = n % 4 == 0;\n"
     "#endif\n"),
    ("          const float2 b = bias_tma ?",
     "#ifdef NO_BIAS\n          const float2 b = make_float2(0.f, 0.f);\n#else\n"
     "          const float2 b = bias_tma ?"),
    ("gr < n && gc + 1 < n ? bh[(size_t)gr * n + gc + 1] : 0.f);\n",
     "gr < n && gc + 1 < n ? bh[(size_t)gr * n + gc + 1] : 0.f);\n#endif\n"),
    ("        wgmma_ss(s[c], desc(Qs + off), desc(KV + c * S::TILE + off));\n",
     "#ifndef NO_S\n        wgmma_ss(s[c], desc(Qs + off), desc(KV + c * S::TILE + off));\n#endif\n"),
    ("        wgmma_rs_t(o[h], pa[c][kk], desc(KV + c * S::TILE + h * HALF + kk * 16 * "
     "TILE_ROW_BYTES));\n",
     "      {\n#ifndef NO_PV\n        wgmma_rs_t(o[h], pa[c][kk], desc(KV + c * S::TILE + h * HALF + "
     "kk * 16 * TILE_ROW_BYTES));\n#endif\n      }\n"),
    ("      s[c][4 * j] = expf(s[c][4 * j] - m_lo);\n",
     "#ifndef NO_SOFTMAX\n      s[c][4 * j] = expf(s[c][4 * j] - m_lo);\n"),
    ("      s[c][4 * j + 3] = expf(s[c][4 * j + 3] - m_hi);\n",
     "      s[c][4 * j + 3] = expf(s[c][4 * j + 3] - m_hi);\n#endif\n"),
    ("    for (int i = 0; i < 32; ++i) s[c][i] /= (i & 2) ? sum_hi : sum_lo;\n",
     "    for (int i = 0; i < 32; ++i) {\n#ifndef NO_SOFTMAX\n"
     "      s[c][i] /= (i & 2) ? sum_hi : sum_lo;\n#endif\n    }\n"),
]
OCCUPANCY = '''
extern "C" int lvt_blocks_per_sm(int max_shared) {
  int blocks = -1;
  auto k = lvt_fwd::block_attention_wgmma_kernel<128>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, lvt_fwd::WgSmem<128>::BYTES);
  cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout, max_shared ? 100 : 0);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, 128, lvt_fwd::WgSmem<128>::BYTES);
  return blocks;
}
'''
VARIANTS = {
    "whole kernel": [],
    "no bias step": ["NO_BIAS"],
    "no softmax": ["NO_SOFTMAX"],
    "no P.V": ["NO_PV"],
    "no q k^T": ["NO_S"],
    "no products": ["NO_S", "NO_PV"],
    "loads only": ["NO_S", "NO_PV", "NO_SOFTMAX", "NO_BIAS"],
}


def build():
    """Compile every variant at once; returns {name: library path}."""
    shutil.rmtree(OUT, ignore_errors=True)
    csrc = os.path.join(OUT, "csrc")
    shutil.copytree(SRC, csrc)
    with open(os.path.join(SRC, "block_attention.cuh")) as f:
        text = f.read()
    for old, new in SWITCHES:
        if old not in text:
            raise SystemExit(f"block_attention.cuh changed; update SWITCHES: {old.strip()[:60]}")
        text = text.replace(old, new)
    with open(os.path.join(csrc, "block_attention.cuh"), "w") as f:
        f.write(text + OCCUPANCY)
    from lvt_tpu_torch.ops._lib import NVCC_FLAGS, _nvcc

    procs = {}
    for i, (name, defines) in enumerate(VARIANTS.items()):
        path = os.path.join(OUT, f"variant_{i}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", path,
               os.path.join(csrc, "block_attention.cu")]
        procs[name] = (path, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True))
    paths = {}
    for name, (path, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log[-3000:]}")
        paths[name] = path
    return paths


def main():
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    paths = build()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    libs = {name: ctypes.CDLL(path) for name, path in paths.items()}
    for nb in (16, 64):
        sets = [[torch.randn((nb, 8, 256, 128), generator=g, device=dev).to(torch.bfloat16)
                 for _ in range(3)] + [0.5 * torch.randn((8, 256, 256), generator=g, device=dev)]
                for _ in range(3)]
        outs = [torch.empty_like(x[0]) for x in sets]
        for name, lib in libs.items():
            fn = lib.lvt_block_attention_fwd
            fn.argtypes = [P, P, P, P, P, I, I, I, I, I, I, F, P]

            def call(x, o, fn=fn):
                err = fn(*(t.data_ptr() for t in x), o.data_ptr(), nb, 8, 256, 128, 0, 1,
                         128 ** -0.5, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: cudaError_t {err}")

            ms = chip_smoke.device_ms([lambda x=x, o=o: call(x, o) for x, o in zip(sets, outs)],
                                      30)
            print(f"nb={nb} {name:14s} {ms:.4f} ms", flush=True)
    blocks = libs["whole kernel"].lvt_blocks_per_sm
    blocks.argtypes = [I]
    print(f"blocks an SM at da=128: carveout largest L1 {blocks(0)}, largest shared "
          f"{blocks(1)}")


if __name__ == "__main__":
    main()
