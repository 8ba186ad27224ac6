#pragma once
// bf16 tensor-core primitives of the fused layer (fused_layer.cu): one
// mma.sync m16n8k16 tile and its fragment loads from shared memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace lvt_mma {

// D += A B for one m16n8k16 tile: A 16x16 bf16 row-major in 4 registers,
// B 16x8 bf16 in 2, D 16x8 fp32 in 4 (PTX ISA, "mma.m16n8k16" fragments:
// lane = 4 g + t holds A rows g and g+8, B column g, D rows g and g+8 at
// columns 2t and 2t+1).
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two consecutive bf16 of shared memory as one fragment register
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment (16 rows x 16 of k) at kk-th k-step of a row-major bf16 tile
// whose 16 rows start at `base` with row stride ld
__device__ __forceinline__ void load_a(uint32_t fa[4], const __nv_bfloat16* base, int ld,
                                       int kk, int g, int t) {
  const __nv_bfloat16* p = base + 2 * t + kk * 16;
  fa[0] = ld32(p + g * ld);
  fa[1] = ld32(p + (g + 8) * ld);
  fa[2] = ld32(p + g * ld + 8);
  fa[3] = ld32(p + (g + 8) * ld + 8);
}

}  // namespace lvt_mma
