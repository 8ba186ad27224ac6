#!/usr/bin/env python
"""Time kernels 6 (csrc/nearest_indices.cu) and 11 (csrc/matmul_i8w.cu) part
by part and beside the alternatives their designs were chosen over.

Each variant is compiled with nvcc from an edited copy of the kernel's
source into build/i8w_vq_parts/ and called through its C entry point on the
same inputs; device times come from chip_smoke.py's device_ms (CUDA-graph
replay over input sets larger than the L2). A variant that leaves a part out
computes a wrong output: only its time means anything. Needs a CUDA card and
nvcc.

Kernel 11, at DSFVT's three products x b in (1, 8, 16): the kernel as the
plan launches it; with each column count a block (2, 4, 8, 16); with 128
threads a block; with the first design's tie test (one branch per value);
and left without its parts: empty (the launch alone), no quantization (the
weight words and the products), the loads and absmax only (no rounding, no
store of y8), the rounding without the loads of y, no products.

Kernel 6, at PR-DVQVAE2's step (N = 8,192, G = 4, Dc = 64) and Base-VQVAE's
(G = 1, Dc = 256): the grouped launch as planned, the same kernel launched
once per sub-codebook, each split of the codes over a cluster (1, 2, 4),
and two blocks an SM (128 registers a thread, with spills).

    python tools/time_i8w_vq_parts_torch.py
"""

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "lvt_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "build", "i8w_vq_parts")
sys.path.insert(0, ROOT)

TIE_PER_VALUE = '''__device__ __forceinline__ uint2 pack8(const float (&v)[8], float q, float r) {
  uint32_t w[2] = {0, 0};
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float t = __fmul_rn(v[e], r);
    float k = rint_fma(t);
    if (fabsf(fabsf(__fsub_rn(t, k)) - 0.5f) < 1e-4f) k = rint_fma(__fdiv_rn(v[e], q));
    const float kc = __fadd_rn(fminf(fmaxf(k, -127.f), 127.f), MAGIC);
    w[e / 4] |= ((uint32_t)__float_as_int(kc) & 0xffu) << (8 * (e % 4));
  }
  return make_uint2(w[0], w[1]);
}
'''
Y8_STORE = ("          if (i < K) *reinterpret_cast<uint2*>(y8 + r * K + i) = "
            "pack8(v[h][c], q, rq);")
# name: (source file, [(text, replacement)]); every text must occur once
VARIANTS = {
    "i8w": ("matmul_i8w.cu", []),
    "i8w_128_threads": ("matmul_i8w.cu", [("constexpr int NTHREADS = 256;",
                                           "constexpr int NTHREADS = 128;")]),
    "i8w_tie_per_value": ("matmul_i8w.cu", [("PACK8", TIE_PER_VALUE)]),
    "i8w_empty": ("matmul_i8w.cu", [("  // 1. the first batch", "  if (b > 0) return;\n  // 1.")]),
    "i8w_no_quantization": ("matmul_i8w.cu", [
        ("  // 2. the block's rows of y", "  if (b > 0) goto products;\n  // 2."),
        ("  __syncthreads();\n\n  // 3.", "products:\n  __syncthreads();\n\n  // 3.")]),
    "i8w_loads_absmax_only": ("matmul_i8w.cu", [
        (Y8_STORE, Y8_STORE.replace("if (i < K)", "if (i < K && s == 12345.f)"))]),
    "i8w_no_y_loads": ("matmul_i8w.cu", [
        ("          load8(y, (size_t)(row0 + r) * K + i, y_bf16, v[h][c]);",
         "          for (int e = 0; e < 8; ++e) v[h][c][e] = (float)(i + e + r);")]),
    "i8w_no_products": ("matmul_i8w.cu", [("for (int base = 0; base < words;",
                                           "for (int base = 0; b < 0 && base < words;")]),
    "ni": ("nearest_indices.cu", []),
    "ni_two_blocks_an_sm": ("nearest_indices.cu", [("__launch_bounds__(NTHREADS, 1)",
                                                    "__launch_bounds__(NTHREADS, 2)")]),
}


def build():
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, (src, subs) in VARIANTS.items():
        text = open(os.path.join(SRC, src)).read()
        for a, b in subs:
            if a == "PACK8":  # the whole function
                start = text.index("__device__ __forceinline__ uint2 pack8(")
                end = text.index("\n}\n", start) + 3
                text = text[:start] + b + text[end:]
                continue
            if text.count(a) != 1:
                raise RuntimeError(f"{name}: {a!r} occurs {text.count(a)} times in {src}")
            text = text.replace(a, b)
        path = os.path.join(OUT, name + ".cu")
        with open(path, "w") as f:
            f.write(text)
        from lvt_tpu_torch.ops._lib import NVCC_FLAGS, _nvcc
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", SRC, "-o", os.path.join(OUT, f"lib{name}.so"), path]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        for line in log.splitlines():
            if name in ("i8w", "ni", "ni_two_blocks_an_sm") and ("registers" in line
                                                                 or "spill" in line):
                print(f"  ptxas {name}: {line.strip()}")
        lib = ctypes.CDLL(os.path.join(OUT, f"lib{name}.so"))
        if name.startswith("i8w"):
            lib.lvt_matmul_i8w.argtypes = [P] * 5 + [I] * 7 + [P]
        else:
            lib.lvt_nearest_indices_grouped.argtypes = [P, P, P, I, I, I, I, L, L, I, I, P]
        libs[name] = lib
    return libs


def main():
    import torch

    import chip_smoke as c
    from lvt_tpu_torch.ops import quant, vq

    card = c.phase_device()
    libs = build()
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    g = torch.Generator(device="cuda").manual_seed(0)

    # ---- kernel 11
    dt = torch.bfloat16
    for K, N in ((512, 3072), (1024, 512), (512, 512)):
        n_sets = min(256, -(-64 * 2 ** 20 // (K * N)))  # weights of 64 MB in all
        sets = [quant.quantize_cols(torch.randn((K, N), generator=g, device="cuda").to(dt), dt)
                for _ in range(n_sets)]
        sets = [(wi.t().contiguous(), sw) for wi, sw in sets]
        for b in (1, 8, 16):
            y = torch.randn((b, K), generator=g, device="cuda").to(dt)
            plan = quant.matmul_i8w_plan(b, K, N)[0]

            def run(name, wt, sw, cpb=plan):
                out = torch.empty((b, N), dtype=dt, device="cuda")
                err = libs[name].lvt_matmul_i8w(y.data_ptr(), wt.data_ptr(), sw.data_ptr(), None,
                                                out.data_ptr(), b, K, N, 1, 1, 1, cpb, stream())
                if err:
                    raise RuntimeError(f"{name}: cudaError_t {err}")
                return out

            def ms(name, cpb=plan):
                return c.device_ms([lambda s=s: run(name, *s, cpb) for s in sets], 2 * n_sets)

            want = quant.matmul_i8w_plain(y, *sets[0], dt)
            for name in ("i8w", "i8w_128_threads", "i8w_tie_per_value"):
                if not torch.equal(run(name, *sets[0]), want):
                    raise RuntimeError(f"{name} differs from the plain version")
            cols = " ".join(f"{cpb} {ms('i8w', cpb):.4f}" for cpb in quant.I8W_CPB)
            parts = " ".join(f"{name[4:]} {ms(name):.4f}" for name in VARIANTS
                             if name.startswith("i8w_"))
            print(f"kernel 11 ({b}, {K}) x ({K}, {N}) bf16 [{card}]: as planned ({plan} columns "
                  f"a block) {ms('i8w'):.4f} ms; by columns a block: {cols}; {parts}")
        del sets

    # ---- kernel 6
    K = 512
    for G, Dc, dtype in ((4, 64, torch.bfloat16), (4, 64, torch.float32),
                         (1, 256, torch.float32), (1, 256, torch.bfloat16)):
        cbs = torch.randn((G, K, Dc), generator=g, device="cuda")
        sets = [torch.randn((8192, G, Dc), generator=g, device="cuda").to(dtype)
                for _ in range(8)]
        plan = vq.nearest_plan(8192, G, K)[0]

        def grouped(name, z, ksplit=plan):
            out = torch.empty((z.shape[0], z.shape[1]), dtype=torch.int32, device="cuda")
            err = libs[name].lvt_nearest_indices_grouped(
                z.data_ptr(), cbs.data_ptr(), out.data_ptr(), z.shape[0], z.shape[1], K, Dc,
                z.stride(0), z.stride(1) if z.shape[1] > 1 else 0,
                int(z.dtype == torch.bfloat16), ksplit, stream())
            if err:
                raise RuntimeError(f"{name}: cudaError_t {err}")
            return out

        def single(z):  # one launch per sub-codebook, each planned as G = 1
            outs = []
            for i in range(G):
                out = torch.empty((z.shape[0], 1), dtype=torch.int32, device="cuda")
                err = libs["ni"].lvt_nearest_indices_grouped(
                    z[:, i].data_ptr(), cbs[i].data_ptr(), out.data_ptr(), z.shape[0], 1, K, Dc,
                    z.stride(0), 0, int(z.dtype == torch.bfloat16),
                    vq.nearest_plan(z.shape[0], 1, K)[0], stream())
                if err:
                    raise RuntimeError(f"single: cudaError_t {err}")
                outs.append(out)
            return outs

        def ms(fn):
            return c.device_ms([lambda s=s: fn(s) for s in sets], 64)

        want = vq.nearest_indices_grouped_plain(sets[0], cbs)
        for name in ("ni", "ni_two_blocks_an_sm"):
            got = grouped(name, sets[0])
            print(f"  {name}: {int((got != want).sum())} of {got.numel()} indices differ from "
                  "the plain version's")
        splits = " ".join(f"{s} {ms(lambda z, s=s: grouped('ni', z, s)):.4f}" for s in (1, 2, 4))
        print(f"kernel 6 N=8192 G={G} K={K} Dc={Dc} {str(dtype)[6:]} [{card}]: as planned "
              f"(split {plan}) {ms(lambda z: grouped('ni', z)):.4f} ms; {G} launches of one "
              f"sub-codebook {ms(single):.4f}; by split of the codes: {splits}; two blocks an "
              f"SM {ms(lambda z: grouped('ni_two_blocks_an_sm', z)):.4f}")
        del sets


if __name__ == "__main__":
    main()
