// Per-pixel decode attention over one layer's preallocated KV cache:
// out[b, a*da:(a+1)*da] = softmax(q[b,a] . K[b,a,:live]^T * scale
//                                 + bias[a,:live]) . V[b,a,:live]
//
// Replaces the TPU kernel lvt_tpu/ops/cache_attention.py:
// decode_attention_pallas (its pl.pallas_call at :499), the native-dtype
// decode kernel over fused-lane (b, cl, na*da) caches with a block-diagonal
// q. Here the cache keeps heads apart, (b, na, R, da), so no block-diagonal
// expansion is needed: each head reads only its own rows.
//
// Numerics (same as the plain version in lvt_tpu_torch/ops/cache_attention.py
// and the sampler's einsum path, lvt_tpu/models/vt_incremental.py:510-546):
// q.k summed in fp32, times scale, plus the fp32 bias row; softmax in fp32 as
// exp(s - max) / sum; the weights rounded to the cache dtype before the V
// product; that product summed in fp32 and rounded to the cache dtype.
// Rows >= live are never read (the sampler's causal mask, -1e9, gives them
// exactly zero weight in the reference).
//
// What bounds it on the H100: memory. One call reads 2 * b * na * live * da
// cache elements (8.4 M elements, 16.8 MB in bf16, at b = 16, na = 8,
// live = 256, da = 128: 5 us at 3.35 TB/s) and does 4 flops per element
// read, far under the 295 flops per byte where the card stops waiting on
// memory; at small batch it is bound by latency (one call is one dependent
// step of the autoregressive rollout, and b * na blocks do not fill 132 SMs).
// To keep the card's memory busy an SM needs some 16 KB of loads in flight.
// The design answers that: one block of 8 warps per (batch row, head); each
// lane loads 16 bytes (8 bf16 or 4 fp32) so a warp covers one fp32 row or
// two bf16 rows of 128 per load, and each warp issues the loads of 4 row
// groups before it reduces any, so a block keeps 16 KB in flight. Every
// cache row is read once; the (live,) logits stay in shared memory between
// the two passes. Splitting long caches across blocks (flash-decode), which
// small batches need to fill the card, is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int NTHREADS = 256;  // 8 warps
constexpr int NWARPS = NTHREADS / 32;
constexpr int UNROLL = 4;      // row groups a warp loads before it reduces

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// one 16-byte load: 4 fp32 or 8 bf16, as floats
__device__ __forceinline__ void load16(const float* p, float out[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float out[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

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

// block-wide reduction through `red` (NWARPS floats); every thread gets it
template <bool IS_MAX>
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

template <typename T, int DA>
__global__ void __launch_bounds__(NTHREADS)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc, const float* __restrict__ bias,
                        T* __restrict__ out, int na, int R, int live, float scale) {
  constexpr int VEC = 16 / sizeof(T);  // elements per lane load
  constexpr int LPR = DA / VEC;        // lanes per cache row
  constexpr int RPW = 32 / LPR;        // rows per warp load
  constexpr int STEP = NWARPS * RPW;   // rows per block load
  static_assert(DA % VEC == 0 && 32 % LPR == 0, "DA must be 64 or 128");

  extern __shared__ __align__(16) float smem[];
  float* s = smem;                    // [R] logits, then weights
  float* partial = s + R;             // [NWARPS][DA] P.V partial sums
  float* red = partial + NWARPS * DA; // [NWARPS] reduction scratch

  const int a = blockIdx.x;
  const int bi = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane / LPR;          // which row of the warp's load
  const int col = (lane % LPR) * VEC;  // first element of this lane
  const size_t head = (size_t)bi * na + a;
  const T* kh = kc + head * (size_t)R * DA + col;
  const T* vh = vc + head * (size_t)R * DA + col;
  const float* brow = bias + (size_t)a * R;
  const int base0 = warp * RPW;  // the warp's first row: loop bounds stay warp-uniform

  float qv[VEC];
  load16(q + head * DA + col, qv);

  // ---- logits: LPR lanes per row, UNROLL row groups in flight per warp
  for (int j0 = base0; j0 < live; j0 += UNROLL * STEP) {
    float dot[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + sub + u * STEP;
      dot[u] = 0.f;
      if (j < live) {
        float kv[VEC];
        load16(kh + (size_t)j * DA, kv);
#pragma unroll
        for (int e = 0; e < VEC; ++e) dot[u] = fmaf(qv[e], kv[e], dot[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int o = LPR / 2; o > 0; o >>= 1) dot[u] += __shfl_xor_sync(0xffffffffu, dot[u], o);
      const int j = j0 + sub + u * STEP;
      if (lane % LPR == 0 && j < live) s[j] = dot[u] * scale + brow[j];
    }
  }
  __syncthreads();

  // ---- softmax over the live rows in fp32; weights rounded to T
  float m = -INFINITY;
  for (int j = threadIdx.x; j < live; j += NTHREADS) m = fmaxf(m, s[j]);
  m = block_reduce<true>(m, red);
  float sum = 0.f;
  for (int j = threadIdx.x; j < live; j += NTHREADS) {
    const float e = expf(s[j] - m);
    s[j] = e;
    sum += e;
  }
  sum = block_reduce<false>(sum, red);
  for (int j = threadIdx.x; j < live; j += NTHREADS)
    s[j] = to_float(from_float<T>(s[j] / sum));
  __syncthreads();

  // ---- P.V in fp32, the same lanes-to-rows map as the logits
  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
  for (int j0 = base0; j0 < live; j0 += UNROLL * STEP) {
    float vv[UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + sub + u * STEP;
      if (j < live) {
        load16(vh + (size_t)j * DA, vv[u]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) vv[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + sub + u * STEP;
      const float p = j < live ? s[j] : 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = fmaf(p, vv[u][e], acc[e]);
    }
  }
  // lanes of one warp that hold the same columns, then the warps
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  }
  if (sub == 0) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) partial[warp * DA + col + e] = acc[e];
  }
  __syncthreads();
  for (int d = threadIdx.x; d < DA; d += NTHREADS) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) o += partial[w * DA + d];
    out[head * DA + d] = from_float<T>(o);
  }
}

template <typename T, int DA>
cudaError_t launch(const void* q, const void* kc, const void* vc, const float* bias,
                   void* out, int b, int na, int R, int live, float scale,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)R + NWARPS * DA + NWARPS);
  auto kernel = decode_attention_kernel<T, DA>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(na, b);
  kernel<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc), bias,
      static_cast<T*>(out), na, R, live, scale);
  return cudaGetLastError();
}

}  // namespace

// q (b, na, da); kc, vc (b, na, R, da); bias (na, R) fp32; out (b, na*da).
// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int lvt_decode_attention(const void* q, const void* kc, const void* vc,
                                    const float* bias, void* out, int b, int na, int R,
                                    int da, int live, int dtype, float scale,
                                    cudaStream_t stream) {
  if (b < 1 || na < 1 || b > 65535 || na > 65535 || live < 1 || live > R || R > 32768)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && da == 128)
    return (int)launch<float, 128>(q, kc, vc, bias, out, b, na, R, live, scale, stream);
  if (dtype == 0 && da == 64)
    return (int)launch<float, 64>(q, kc, vc, bias, out, b, na, R, live, scale, stream);
  if (dtype == 1 && da == 128)
    return (int)launch<__nv_bfloat16, 128>(q, kc, vc, bias, out, b, na, R, live, scale, stream);
  if (dtype == 1 && da == 64)
    return (int)launch<__nv_bfloat16, 64>(q, kc, vc, bias, out, b, na, R, live, scale, stream);
  return (int)cudaErrorInvalidValue;
}
