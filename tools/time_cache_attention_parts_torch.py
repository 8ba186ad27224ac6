#!/usr/bin/env python
"""Time kernel 5 (csrc/decode_attention_i8.cu cache_i8_kernel) with one part
left out at a time, beside a kernel that only loads the same K and V rows,
to see what holds it above its bound: the exchange of the ranks' (m, l),
the push of the column sums, the logits, the weights, the V product, the
scalar loads of the scales and the extra row.

Each variant is compiled with nvcc from a copy of csrc/ whose kernel has one
part cut out (a text edit), into build/cache_attention_parts/; the "loads
only" kernel (each thread's K and V rows of the same plan into registers,
xor-folded, one store a block if the fold hits a fixed word) is appended to
the unedited copy. A variant that leaves a part out computes a wrong output:
only its time means anything. Timed by chip_smoke.py's device_ms (CUDA-graph
replay over input sets of >= 64 MB together) at na=8, R=256, da=128, bf16 q,
each shape at the plan of ops/cache_attention.py cache_attention_plan and at
the cluster of four ranks. Needs a CUDA card and nvcc.

    python tools/time_cache_attention_parts_torch.py
"""

import ctypes
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "lvt_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "build", "cache_attention_parts")

# variant: [(text of csrc/decode_attention_i8.cu, its replacement)]
EDITS = {
    "whole": [],
    "no (m, l) exchange": [
        ("    if (tid < C) push2(map_rank(x1 + 2 * rank, tid), m, sum, map_rank(&bars[0], tid));\n"
         "    mbar_wait(&bars[0], 0);\n",
         "    x1[2 * rank] = m, x1[2 * rank + 1] = sum;\n")],
    "no column push": [
        ("    mbar_wait(&bars[1], 0);  // every rank's sums of this rank's columns have landed\n", ""),
        ("    else push(map_rank(x3 + rank * per + tid % per, tid / per), o, map_rank(&bars[1], "
         "tid / per));", "    else x3[rank * per + tid % per] = o;")],
    "no V product": [
        ("    axpy16f(w, vreg[u], acc);\n  }\n  for (int base = PASS;",
         "    acc[u] += w * __uint_as_float(vreg[u].x & 0x3f000000u);\n  }\n  for (int base = PASS;")],
    "no logits": [
        ("    float dot = dot16f(qv, kreg[u]);\n#pragma unroll\n    for (int o = M::LPR / 2; o > 0; "
         "o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);\n    const bool in = u * M::STEP",
         "    float dot = __uint_as_float(kreg[u].x & 0x3f000000u) + qv[u];\n"
         "    const bool in = u * M::STEP")],
    "no weights": [
        ("    wk[k] = x > -INFINITY ? cache_weight<ROUND_W>(expf(x - m), sum, pick(vsv, u), "
         "p.io_bf16)\n                          : 0.f;",
         "    wk[k] = x * sum;")],
    "no scalar loads": [
        ("    ksv[u] = in ? ksr[jt] : 0.f;\n    vsv[u] = in ? vsr[jt] : 0.f;\n"
         "    ev[u] = in ? er[jt] : 0.f;\n",
         "    ksv[u] = in ? 0.01f : 0.f;\n    vsv[u] = in ? 0.015f : 0.f;\n"
         "    ev[u] = in ? 0.1f * u : 0.f;\n")],
}
LOADS_ONLY = '''
namespace {
template <int CW, int U>
__global__ void __launch_bounds__(CW * 32) loads_only_kernel(const int8_t* k8, const int8_t* v8,
                                                             int R, int live, int chunk, int C,
                                                             int* out) {
  using M = RowMap<128, CW>;
  const int rank = blockIdx.x % C, a = blockIdx.x / C, na = gridDim.x / C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane / M::LPR, col = (lane % M::LPR) * VEC;
  const int j0 = min(rank * chunk, live), rows = min(j0 + chunk, live) - j0;
  const size_t row0 = ((size_t)blockIdx.y * na + a) * R + j0;
  unsigned acc = 0;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int jt = u * M::STEP + warp * M::RPW + sub;
    if (jt < rows) {
      const uint4 k = load_row16(k8 + (row0 + jt) * 128 + col);
      const uint4 v = load_row16(v8 + (row0 + jt) * 128 + col);
      acc ^= k.x ^ k.y ^ k.z ^ k.w ^ v.x ^ v.y ^ v.z ^ v.w;
    }
  }
  if (acc == 0x12345678u) out[0] = (int)acc;
}
}  // namespace

extern "C" int lvt_cache_loads_only(const void* k8, const void* v8, int b, int na, int R, int live,
                                    int C, int chunk, int warps, int loads, void* out,
                                    cudaStream_t stream) {
  const dim3 grid(na * C, b);
  const int8_t* k = static_cast<const int8_t*>(k8);
  const int8_t* v = static_cast<const int8_t*>(v8);
  if (warps == 4) loads_only_kernel<4, 4><<<grid, 128, 0, stream>>>(k, v, R, live, chunk, C, (int*)out);
  else if (loads == 4) loads_only_kernel<8, 4><<<grid, 256, 0, stream>>>(k, v, R, live, chunk, C, (int*)out);
  else loads_only_kernel<8, 8><<<grid, 256, 0, stream>>>(k, v, R, live, chunk, C, (int*)out);
  return (int)cudaGetLastError();
}
'''
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC"]


def build():
    """{variant: its lvt_cache_attention_i8}, and the loads-only entry."""
    sys.path.insert(0, ROOT)
    from lvt_tpu_torch.ops._lib import _SIGNATURES, _nvcc

    with open(os.path.join(SRC, "decode_attention_i8.cu")) as f:
        base = f.read()
    procs = {}
    for i, (name, edits) in enumerate(EDITS.items()):
        d = os.path.join(OUT, f"v{i}")
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(SRC, d)
        text = base
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"{name}: csrc/decode_attention_i8.cu no longer holds {old[:60]!r}")
            text = text.replace(old, new)
        if not edits:
            text += LOADS_ONLY
        with open(os.path.join(d, "decode_attention_i8.cu"), "w") as f:
            f.write(text)
        so = os.path.join(OUT, f"v{i}.so")
        procs[name] = (so, subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", so,
                                             os.path.join(d, "decode_attention_i8.cu")]))
    fns = {}
    for name, (so, proc) in procs.items():
        if proc.wait() != 0:
            raise SystemExit(f"nvcc failed for {name}")
        lib = ctypes.CDLL(so)
        fns[name] = lib.lvt_cache_attention_i8
        fns[name].argtypes = _SIGNATURES["lvt_cache_attention_i8"]
        if name == "whole":
            loads = lib.lvt_cache_loads_only
            loads.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 2
    return fns, loads


def main():
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke
    from lvt_tpu_torch.ops import cache_attention as ca

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = chip_smoke.phase_device()
    fns, loads_only = build()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    na, R, da = 8, 256, 128
    out = torch.zeros(4, dtype=torch.int32, device=dev)
    for b, live in ((16, 256), (16, 64), (1, 256), (256, 256), (256, 64)):
        n_sets = max(1, min(64, -(-64 * 2 ** 20 // (2 * b * na * R * da))))
        sets = [(torch.randint(-127, 128, (b, na, R, da), generator=g, device=dev,
                               dtype=torch.int8),
                 0.01 + 0.01 * torch.rand((b, na, R), generator=g, device=dev),
                 torch.randint(-127, 128, (b, na, R, da), generator=g, device=dev,
                               dtype=torch.int8),
                 0.01 + 0.01 * torch.rand((b, na, R), generator=g, device=dev))
                for _ in range(n_sets)]
        q = torch.randn((b, na, da), generator=g, device=dev).bfloat16()
        extra = 0.5 * torch.randn((1, na, R), generator=g, device=dev)
        res = torch.empty((b, na, da), dtype=torch.bfloat16, device=dev)
        plans = [ca.cache_attention_plan(b, na, live, da)]
        if plans[0][0] != 4 and live > 64:
            plans.append((4, -(-live // 4), 4, 4))
        for c, chunk, warps, loads in plans:
            stream = lambda: torch.cuda.current_stream().cuda_stream
            times = {name: chip_smoke.device_ms(
                [lambda s=s, f=f: f(q.data_ptr(), s[0].data_ptr(), s[1].data_ptr(),
                                    s[2].data_ptr(), s[3].data_ptr(), extra.data_ptr(),
                                    res.data_ptr(), b, na, R, da, live, 1, c, chunk, warps, loads,
                                    1, da ** -0.5, stream()) for s in sets], 200)
                for name, f in fns.items()}
            times["loads only"] = chip_smoke.device_ms(
                [lambda s=s: loads_only(s[0].data_ptr(), s[2].data_ptr(), b, na, R, live, c, chunk,
                                        warps, loads, out.data_ptr(), stream()) for s in sets], 200)
            print(f"kernel 5 parts b={b} live={live} C={c} x {warps} warps x {loads} loads "
                  f"[{card}]: " + ", ".join(f"{k} {t:.4f}" for k, t in times.items()) + " ms",
                  flush=True)
        del sets


if __name__ == "__main__":
    main()
