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
// What bounds it on the H100: memory, and at small batch latency. One call
// reads 2 * b * na * live * da cache elements (16.8 MB in bf16 at b = 16,
// na = 8, live = 256, da = 128: 5 us at 3.35 TB/s) and does 4 flops per
// element, far under the 295 flops per byte where the card stops waiting on
// memory. One call is one dependent step of the autoregressive rollout, and
// one block per (batch row, head) leaves most of the 132 SMs idle at b = 1
// and b = 8 and reads K before V.
//
// The design: one launch of thread-block clusters, C blocks per (batch row,
// head), C chosen by the caller from b * na and live (ops/cache_attention.py
// decode_plan: the least power of two up to 16 that puts at least 132 blocks
// on the card, 264 once live exceeds 128 rows). Rank r of a cluster owns the
// live rows [r * chunk, (r + 1) * chunk), chunk = ceil(live / C); a head's
// rows are contiguous in the cache, so its thread 0 lands them with bulk
// copies (cp.async.bulk on mbarriers) in 8 KB tiles, all of K and V issued
// at once (a ring of up to 4 tiles each, refilled as tiles are used, for
// longer ranges): V is in flight while the logits and the softmax run. The softmax's maximum and sum meet across
// the cluster through distributed shared memory: each rank pushes its local
// maximum m_r and sum l_r = sum exp(s - m_r) into every rank's shared memory
// with st.async, which completes on the receiver's mbarrier, and every rank
// forms the same m = max m_r and sum = sum_r l_r exp(m_r - m) in rank order,
// then normalises and rounds its own weights, exp(s - m) / sum, as a single
// block would. Each rank forms its partial P.V in fp32 and pushes each
// column's partial to the rank that owns that column, which adds the C
// partials in rank order and rounds once on store. One cluster barrier,
// arrived at entry and waited on only before the first push, so that every
// receiver's mbarriers exist; no other. No atomics: two calls are
// bit-identical. A rank with no live rows (live < C * chunk) contributes a
// maximum of -inf, a sum of 0 and a zero partial.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NTHREADS = 128;  // 4 warps a block (a rank)
constexpr int NWARPS = NTHREADS / 32;
constexpr int TILE_BYTES = 8192;  // one bulk copy of K or V rows
constexpr int NSTAGES = 4;        // tiles of K and of V in flight
constexpr int MAX_CLUSTER = 16;   // the non-portable cluster size limit

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

// Shared memory: K ring [stages][TILE_BYTES] | V ring [stages][TILE_BYTES] |
// stats[MAX_CLUSTER][2] (every rank's maximum and sum, pushed by that rank)
// | comb[C][per] (every rank's P.V of this rank's `per` output columns,
// pushed by that rank) | partial[NWARPS][DA] | red[NWARPS] | s[chunk]
// logits, then weights | mbarriers: K [stages], V [stages], stats, comb
template <int DA>
constexpr int fixed_floats() {
  return NWARPS * DA + NWARPS + 2 * MAX_CLUSTER + DA + MAX_CLUSTER;
}

template <typename T, int DA>
__global__ void __launch_bounds__(NTHREADS)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc, const float* __restrict__ bias,
                        T* __restrict__ out, int na, int R, int live, int stages,
                        float scale) {
  using namespace lvt_hopper;
  constexpr int VEC = 16 / sizeof(T);   // elements per lane load
  constexpr int LPR = DA / VEC;         // lanes per cache row
  constexpr int RPW = 32 / LPR;         // rows per warp load
  constexpr int STEP = NWARPS * RPW;    // rows per block load
  constexpr int ROW_BYTES = DA * (int)sizeof(T);
  constexpr int TR = TILE_BYTES / ROW_BYTES;  // rows per tile
  static_assert(DA % VEC == 0 && 32 % LPR == 0 && TR % STEP == 0, "DA must be 64 or 128");

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int chunk = (live + C - 1) / C;

  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* kring = smem;
  unsigned char* vring = smem + stages * TILE_BYTES;
  float* stats = reinterpret_cast<float*>(smem + 2 * stages * TILE_BYTES);  // 8-byte aligned
  float* comb = stats + 2 * MAX_CLUSTER;
  float* partial = comb + DA + MAX_CLUSTER;
  float* red = partial + NWARPS * DA;
  float* s = red + NWARPS;
  uint64_t* kbar = reinterpret_cast<uint64_t*>(
      (reinterpret_cast<uintptr_t>(s + chunk) + 7) & ~static_cast<uintptr_t>(7));
  uint64_t* vbar = kbar + stages;
  uint64_t* stat_bar = vbar + stages;
  uint64_t* comb_bar = stat_bar + 1;

  const int a = blockIdx.x / C;
  const int bi = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int sub = lane / LPR;          // which row of the warp's load
  const int col = (lane % LPR) * VEC;  // first element of this lane
  const size_t head = (size_t)bi * na + a;
  const int j0 = min(rank * chunk, live);            // this rank's rows [j0, j1)
  const int rows = min(j0 + chunk, live) - j0;
  const int ntiles = (rows + TR - 1) / TR;
  const T* kh = kc + (head * (size_t)R + j0) * DA;
  const T* vh = vc + (head * (size_t)R + j0) * DA;
  const float* brow = bias + (size_t)a * R + j0;

  // tile t of K (or V) into its ring stage
  auto issue = [&](const T* src, unsigned char* ring, uint64_t* bars, int t) {
    const int nr = min(TR, rows - t * TR);
    uint64_t* bar = &bars[t % stages];
    mbar_expect_tx(bar, nr * ROW_BYTES);
    bulk_load(ring + (t % stages) * TILE_BYTES, src + (size_t)t * TR * DA, nr * ROW_BYTES, bar);
  };
  const int per = (DA + C - 1) / C;  // output columns of each rank
  if (tid == 0) {
    for (int i = 0; i < 2 * stages + 2; ++i) mbar_init(&kbar[i], 1);
    fence_barrier_init();
    for (int t = 0; t < ntiles && t < stages; ++t) issue(kh, kring, kbar, t);
    for (int t = 0; t < ntiles && t < stages; ++t) issue(vh, vring, vbar, t);
    // what the other ranks will push: a (max, sum) pair each, and each
    // one's partials of this rank's columns
    mbar_expect_tx(stat_bar, C * 8);
    mbar_expect_tx(comb_bar, C * 4 * max(0, min(DA, (rank + 1) * per) - rank * per));
  }
  cluster_arrive();
  // q and this rank's bias row while the copies are in flight
  float qv[VEC];
  load16(q + head * DA + col, qv);
  for (int j = tid; j < rows; j += NTHREADS) s[j] = brow[j];
  __syncthreads();

  // ---- logits of this rank's rows: LPR lanes per row
  for (int t = 0; t < ntiles; ++t) {
    mbar_wait(&kbar[t % stages], (t / stages) & 1);
    const T* kt = reinterpret_cast<const T*>(kring + (t % stages) * TILE_BYTES) + col;
    const int nr = min(TR, rows - t * TR);
#pragma unroll
    for (int u = 0; u < TR / STEP; ++u) {
      const int jt = warp * RPW + sub + u * STEP;
      float dot = 0.f;
      if (jt < nr) {
        float kv[VEC];
        load16(kt + jt * DA, kv);
#pragma unroll
        for (int e = 0; e < VEC; ++e) dot = fmaf(qv[e], kv[e], dot);
      }
#pragma unroll
      for (int o = LPR / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      const int j = t * TR + jt;
      if (lane % LPR == 0 && jt < nr) s[j] = dot * scale + s[j];
    }
    if (t + stages < ntiles) {
      __syncthreads();  // every warp is done with this stage
      if (tid == 0) {
        fence_proxy_async();  // generic reads before the copy's writes
        issue(kh, kring, kbar, t + stages);
      }
    }
  }
  __syncthreads();

  // ---- softmax over the live rows in fp32. Each rank pushes its maximum m_r
  // and l_r = sum exp(s - m_r) into every rank's `stats`; each rank waits for
  // the C pairs and forms m = max m_r and sum = sum_r l_r exp(m_r - m) in rank
  // order from its own copy. Weights exp(s - m) / sum rounded to T.
  float mr = -INFINITY;
  for (int j = tid; j < rows; j += NTHREADS) mr = fmaxf(mr, s[j]);
  mr = block_reduce<true>(mr, red);
  float lr = 0.f;
  for (int j = tid; j < rows; j += NTHREADS) lr += expf(s[j] - mr);
  lr = block_reduce<false>(lr, red);
  cluster_wait();  // every rank's mbarriers are initialised
  if (tid < C) push2(map_rank(stats + 2 * rank, tid), mr, lr, map_rank(stat_bar, tid));
  mbar_wait(stat_bar, 0);
  float m = -INFINITY;
  for (int r = 0; r < C; ++r) m = fmaxf(m, stats[2 * r]);
  float sum = 0.f;
  for (int r = 0; r < C; ++r) sum += stats[2 * r + 1] * expf(stats[2 * r] - m);  // 0 if empty
  for (int j = tid; j < rows; j += NTHREADS)
    s[j] = to_float(from_float<T>(expf(s[j] - m) / sum));
  __syncthreads();

  // ---- this rank's P.V in fp32, the same lanes-to-rows map as the logits
  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
  for (int t = 0; t < ntiles; ++t) {
    mbar_wait(&vbar[t % stages], (t / stages) & 1);
    const T* vt = reinterpret_cast<const T*>(vring + (t % stages) * TILE_BYTES) + col;
    const int nr = min(TR, rows - t * TR);
#pragma unroll
    for (int u = 0; u < TR / STEP; ++u) {
      const int jt = warp * RPW + sub + u * STEP;
      if (jt < nr) {
        float vv[VEC];
        load16(vt + jt * DA, vv);
        const float p = s[t * TR + jt];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = fmaf(p, vv[e], acc[e]);
      }
    }
    if (t + stages < ntiles) {
      __syncthreads();
      if (tid == 0) {
        fence_proxy_async();
        issue(vh, vring, vbar, t + stages);
      }
    }
  }
  // lanes of one warp that hold the same columns, then the warps in order
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  }
  if (sub == 0) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) partial[warp * DA + col + e] = acc[e];
  }
  // ---- each column's partial to the rank that owns it, which adds the C
  // partials in rank order and rounds once on store
  __syncthreads();
  for (int d = tid; d < DA; d += NTHREADS) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) o += partial[w * DA + d];
    push(map_rank(comb + rank * per + d % per, d / per), o, map_rank(comb_bar, d / per));
  }
  mbar_wait(comb_bar, 0);  // every push into this block has landed
  for (int i = tid; i < per; i += NTHREADS) {
    const int d = rank * per + i;
    if (d < DA) {
      float o = 0.f;
      for (int r = 0; r < C; ++r) o += comb[r * per + i];
      out[head * DA + d] = from_float<T>(o);
    }
  }
}

template <typename T, int DA>
cudaError_t launch(const void* q, const void* kc, const void* vc, const float* bias,
                   void* out, int b, int na, int R, int live, int C, float scale,
                   cudaStream_t stream) {
  constexpr int TR = TILE_BYTES / (DA * (int)sizeof(T));
  const int chunk = (live + C - 1) / C;
  const int stages = max(1, min(NSTAGES, (chunk + TR - 1) / TR));
  const size_t smem = (size_t)2 * stages * TILE_BYTES +
                      sizeof(float) * ((size_t)chunk + fixed_floats<DA>()) + 8 +
                      (2 * stages + 2) * sizeof(uint64_t);
  auto kernel = decode_attention_kernel<T, DA>;
  static size_t smem_set = 0;  // the largest dynamic shared memory granted so far
  static bool wide_ok = false;
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  if (C > 8 && !wide_ok) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    wide_ok = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(na * C, b);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), bias, static_cast<T*>(out), na, R, live, stages, scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// q (b, na, da); kc, vc (b, na, R, da); bias (na, R) fp32; out (b, na*da);
// cluster: blocks per (batch row, head), 1 to 16. dtype: 0 = float32, 1 =
// bfloat16. Returns the cudaError_t of the launch: a cluster the card cannot
// place fails the launch (there is no single-block fallback).
extern "C" int lvt_decode_attention(const void* q, const void* kc, const void* vc,
                                    const float* bias, void* out, int b, int na, int R,
                                    int da, int live, int cluster, int dtype, float scale,
                                    cudaStream_t stream) {
  if (b < 1 || na < 1 || b > 65535 || na > 65535 || live < 1 || live > R || R > 32768 ||
      cluster < 1 || cluster > MAX_CLUSTER)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && da == 128)
    return (int)launch<float, 128>(q, kc, vc, bias, out, b, na, R, live, cluster, scale, stream);
  if (dtype == 0 && da == 64)
    return (int)launch<float, 64>(q, kc, vc, bias, out, b, na, R, live, cluster, scale, stream);
  if (dtype == 1 && da == 128)
    return (int)launch<__nv_bfloat16, 128>(q, kc, vc, bias, out, b, na, R, live, cluster, scale,
                                           stream);
  if (dtype == 1 && da == 64)
    return (int)launch<__nv_bfloat16, 64>(q, kc, vc, bias, out, b, na, R, live, cluster, scale,
                                          stream);
  return (int)cudaErrorInvalidValue;
}
