#!/usr/bin/env python
"""Time kernel 2 (csrc/decode_attention.cu) part by part, to see what holds
it back at the rollout's shapes: the whole kernel at the cluster size its
wrapper plans, at one block per (batch row, head) and at twice the planned
cluster, its loads alone, and an empty kernel of the same launch (a cluster
launch's own cost).

Each variant is compiled with nvcc from a copy of csrc/ whose kernel has a
preprocessor switch around each part, into build/decode_parts/, and is
timed by chip_smoke.py's device_ms (CUDA-graph replay over input sets of
>= 64 MB together) at na=8, R=256, da=128: bf16 at b in (1, 8, 16) x live in
(32, 64, 96, 128, 256), and fp32 at b=1. A variant that leaves a part out computes a
wrong output: only its time means anything. Needs a CUDA card and nvcc.

    python tools/time_decode_parts_torch.py
"""

import ctypes
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "lvt_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "build", "decode_parts")

# (text of csrc/decode_attention.cu, the same text with a switch around it)
SWITCHES = [
    ("  const int chunk = (live + C - 1) / C;\n\n",
     "  const int chunk = (live + C - 1) / C;\n#ifdef EMPTY_KERNEL\n  return;\n#endif\n\n"),
    ("  // ---- logits of this rank's rows: LPR lanes per row\n",
     "#ifdef LOADS_ONLY\n  for (int t = 0; t < ntiles && t < stages; ++t) {\n"
     "    mbar_wait(&kbar[t], 0);\n    mbar_wait(&vbar[t], 0);\n  }\n  cluster_wait();\n"
     "  if (tid < DA && rank == 0) out[head * DA + tid] = from_float<T>(0.f);\n"
     "  return;\n#endif\n"),
]
VARIANTS = {  # name: (defines, cluster size: None = the wrapper's plan, "2x" twice it)
    "whole kernel": ([], None),
    "whole, 1 block": ([], 1),
    "whole, 2x cluster": ([], "2x"),
    "loads only": (["LOADS_ONLY"], None),
    "empty kernel": (["EMPTY_KERNEL"], None),
}


def build():
    """Compile every variant at once; returns {defines tuple: library path}."""
    shutil.rmtree(OUT, ignore_errors=True)
    csrc = os.path.join(OUT, "csrc")
    shutil.copytree(SRC, csrc)
    with open(os.path.join(SRC, "decode_attention.cu")) as f:
        text = f.read()
    for old, new in SWITCHES:
        if old not in text:
            raise SystemExit(f"decode_attention.cu changed; update SWITCHES: {old.strip()[:60]}")
        text = text.replace(old, new)
    with open(os.path.join(csrc, "decode_attention.cu"), "w") as f:
        f.write(text)
    from lvt_tpu_torch.ops._lib import NVCC_FLAGS, _nvcc

    procs = {}
    for defines in {tuple(d) for d, _ in VARIANTS.values()}:
        path = os.path.join(OUT, f"variant_{'_'.join(defines).replace('=', '') or 'whole'}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", path,
               os.path.join(csrc, "decode_attention.cu")]
        procs[defines] = (path, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True))
    paths = {}
    for defines, (path, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{defines}: nvcc failed\n{log[-3000:]}")
        paths[defines] = path
    return paths


def main():
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke
    from lvt_tpu_torch.ops.cache_attention import decode_plan

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = chip_smoke.phase_device()
    libs = {d: ctypes.CDLL(p) for d, p in build().items()}
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    na, R, da = 8, 256, 128
    for b, dtype in ((1, torch.float32), (1, torch.bfloat16), (8, torch.bfloat16),
                     (16, torch.bfloat16)):
        el = torch.finfo(dtype).bits // 8
        n_sets = max(4, min(64, -(-64 * 2 ** 20 // (2 * b * na * R * da * el))))
        q = torch.randn((b, na, da), generator=g, device=dev).to(dtype)
        bias = 0.5 * torch.randn((na, R), generator=g, device=dev)
        caches = [[torch.randn((b, na, R, da), generator=g, device=dev).to(dtype)
                   for _ in range(2)] for _ in range(n_sets)]
        out = torch.empty((b, na * da), dtype=dtype, device=dev)
        for live in (256, 128, 96, 64, 32):
            line = []
            for name, (defines, cluster) in VARIANTS.items():
                c = decode_plan(b, na, live)[0]
                if cluster == "2x":
                    c = min(16, 2 * c)
                elif cluster is not None:
                    c = cluster
                fn = libs[tuple(defines)].lvt_decode_attention
                fn.argtypes = [P] * 5 + [I] * 7 + [F, P]

                def call(kv, fn=fn, c=c, name=name):
                    err = fn(q.data_ptr(), kv[0].data_ptr(), kv[1].data_ptr(), bias.data_ptr(),
                             out.data_ptr(), b, na, R, da, live, c,
                             0 if dtype == torch.float32 else 1, da ** -0.5,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{name}: cudaError_t {err}")

                ms = chip_smoke.device_ms([lambda kv=kv: call(kv) for kv in caches], 200)
                line.append(f"{name} (C={c}) {ms:.4f}")
            print(f"kernel 2 parts {str(dtype)[6:]} b={b} live={live} [{card}]: "
                  + ", ".join(line) + " ms", flush=True)
        del caches


if __name__ == "__main__":
    main()
