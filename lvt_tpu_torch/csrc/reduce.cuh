// Warp and block reductions shared by the int8 decode kernels
// (decode_attention_i8.cu, matmul_i8w.cu).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace lvt {

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// block-wide reduction through `red` (NWARPS floats); every thread of the
// block must call it, and every thread gets the result
template <bool IS_MAX, int NWARPS>
__device__ __forceinline__ float block_reduce(float x, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  x = IS_MAX ? warp_max(x) : warp_sum(x);
  __syncthreads();  // red may still be read from a previous reduction
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < NWARPS; ++w) r = IS_MAX ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

// one element of a float32 or bfloat16 array, chosen at run time
__device__ __forceinline__ float load_scalar(const void* p, size_t i, int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}
__device__ __forceinline__ void store_scalar(void* p, size_t i, float x, int is_bf16) {
  if (is_bf16) static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(x);
  else static_cast<float*>(p)[i] = x;
}

// absmax quantization of one value: clip(round_half_even(x / (s + 1e-8)), +-127)
__device__ __forceinline__ float quantize_i8(float x, float s) {
  return fminf(fmaxf(rintf(x / (s + 1e-8f)), -127.f), 127.f);
}

}  // namespace lvt
