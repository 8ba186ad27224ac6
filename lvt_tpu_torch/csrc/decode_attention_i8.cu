// Per-pixel decode attention over one layer's int8 KV cache: four kernels,
// each one block per (batch row, head) over the cache's live rows.
//
// They replace the TPU kernels of lvt_tpu/ops/cache_attention.py:
//   lvt_decode_attention_i8       decode_attention_i8_pallas (pallas_call at :202)
//   lvt_decode_attention_i8_live  decode_attention_i8_live_pallas (:409)
//   lvt_cache_attention_i8        cache_attention_pallas (:58)
// and the probe kernel of tools/probe_decode_kernel.py:
//   lvt_decode_attention_i8kv     decode_attn_pallas (pallas_call at :80)
// Those work on fused-lane (b, cl, na*da) caches with a block-diagonal q, a
// head mask and row-major scales, which the TPU's matrix unit and tiling ask
// for. Here the cache keeps heads apart, (b, na, R, da) int8 with scales
// (b, na, R), each head reads only its own rows, and rows at or past `live`
// are never read (in the reference they carry a -1e9 or -1e30 logit, whose
// exp is exactly 0, so they add nothing to a maximum, a sum or a scale).
//
// Numerics, as the TPU kernels and the plain versions in
// lvt_tpu_torch/ops/cache_attention.py:
//   i8:      logit_j = float(int32 q8.k8_j) * (sq * scale) * ks_j + bias_j;
//            w = softmax(logit) * vs (fp32); sw = max|w| / 127;
//            w8 = clip(rint(w / (sw + 1e-8)), +-127);
//            out = float(int32 sum_j w8_j v8_j) * sw, rounded once.
//   i8_live: the same logits, walked in tiles of `rtile` rows in order with
//            the online-softmax recurrence: p = exp(logit - running max),
//            p * vs quantized per tile (unnormalised), acc = acc * alpha +
//            float(int32 sum) * sw, l = l * alpha + sum p, and
//            out = acc / (l + 1e-30) after the last live tile. The tile is the
//            quantization group and the step of the recurrence, so it is part
//            of the function; tiles are walked in order inside one block.
//   cache:   q in float; logit_j = (q . float(k8_j)) * scale * ks_j + extra_j;
//            w = softmax(logit) * vs, kept fp32; out = sum_j w_j float(v8_j).
//   i8kv:    the probe kernel: q in the io dtype (not quantized), K and V
//            converted from int8 exactly, products summed in fp32; the same
//            logits as `cache`; the softmax normalised by a division; the
//            weight row w = softmax * vs rounded once to the io dtype before
//            the V product; the output rounded to io. In fp32 io that is
//            `cache`'s function; in bf16 it differs by the weights' rounding.
//            Its TPU form (fused lanes, block-diagonal q, head mask) is not
//            kept: per head the function is the same. da 16 (the probe's own
//            shape), 64 or 128.
// Both integer products are exact, so only exp and the order of the fp32
// sums (the softmax denominator) separate a kernel from its plain version:
// a weight that sits within an ulp of x.5 may round one step apart.
// Multiplies and adds whose pairing would let the compiler form an FMA are
// written with __fmul_rn / __fadd_rn, to round where the plain versions do.
//
// What bounds them on the H100: memory, then latency. One call reads
// 2 * b * na * live * da bytes of cache (4.2 MB at b = 16, na = 8, live =
// 256, da = 128: 1.3 us at 3.35 TB/s), half of kernel 2's bf16 traffic, and
// does 4 integer operations per byte. One call is one dependent step of the
// rollout, and b * na blocks do not fill 132 SMs at small batch. The design
// follows kernel 2 (decode_attention.cu): 8 warps per block, each lane loads
// 16 bytes (16 int8), a warp covers 4 rows of 128 per load and loads 4 row
// groups before it reduces any. q8 . k8 runs on __dp4a (four int8 products
// per instruction); the V product multiplies one weight into four different
// columns per word, so it uses __dp4a with the weight placed in one byte
// lane. A tensor-core mma.sync m16n8k32 would idle 15 of its 16 rows at one
// query row per head. A split over row tiles with a combine pass is later
// work (for the live kernel it would also change sw by rounding).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "reduce.cuh"

namespace {

using namespace lvt;

constexpr int NTHREADS = 256;  // 8 warps
constexpr int NWARPS = NTHREADS / 32;
constexpr int UNROLL = 4;      // row groups a warp loads before it reduces
constexpr int VEC = 16;        // int8 per lane load

// how the lanes of a block map onto cache rows of DA int8
template <int DA>
struct RowMap {
  static constexpr int LPR = DA / VEC;       // lanes per cache row
  static constexpr int RPW = 32 / LPR;       // rows per warp load
  static constexpr int STEP = NWARPS * RPW;  // rows per block load
  static_assert(DA % VEC == 0 && 32 % LPR == 0, "DA must be 16, 64 or 128");
};

__device__ __forceinline__ uint4 load_row16(const int8_t* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ int dot16(const uint4& a, const uint4& b) {
  int d = __dp4a((int)a.x, (int)b.x, 0);
  d = __dp4a((int)a.y, (int)b.y, d);
  d = __dp4a((int)a.z, (int)b.z, d);
  return __dp4a((int)a.w, (int)b.w, d);
}

// acc[4 * word + i] += w * byte i of the word, for the 16 int8 of v
__device__ __forceinline__ void axpy16(int w, const uint4& v, int acc[VEC]) {
  const unsigned wb = (unsigned)w & 0xffu;
  const int words[4] = {(int)v.x, (int)v.y, (int)v.z, (int)v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      acc[4 * k + i] = __dp4a(words[k], (int)(wb << (8 * i)), acc[4 * k + i]);
  }
}

__device__ __forceinline__ float byte_to_float(unsigned word, int i) {
  return (float)(int)(int8_t)((word >> (8 * i)) & 0xffu);
}

// int32 q8 . k8_j for rows [0, n) of `kh` (already offset to this lane's
// columns), scaled and biased into s[0, n):
//   s[j] = float(dot) * qs * ks[j] + brow[j]
template <int DA>
__device__ __forceinline__ void logits_i8(const uint4& qv, const int8_t* kh, int n, float qs,
                                          const void* ks, size_t ks_off, int scale_bf16,
                                          const float* brow, float* s) {
  using M = RowMap<DA>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane / M::LPR;
  for (int j0 = warp * M::RPW; j0 < n; j0 += UNROLL * M::STEP) {  // warp-uniform bounds
    uint4 kv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + sub + u * M::STEP;
      kv[u] = j < n ? load_row16(kh + (size_t)j * DA) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      int dot = dot16(kv[u], qv);
#pragma unroll
      for (int o = M::LPR / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      const int j = j0 + sub + u * M::STEP;
      if (lane % M::LPR == 0 && j < n) {
        const float kscale = load_scalar(ks, ks_off + j, scale_bf16);
        s[j] = __fadd_rn(__fmul_rn(__fmul_rn((float)dot, qs), kscale), brow[j]);
      }
    }
  }
}

// int32 sum_j w8[j] * v8_j over rows [0, n) of `vh`, for all DA columns, into
// partial[0, DA) summed over the block's warps; w8 holds integers as floats.
// Returns after a __syncthreads(): total[d] = sum_w partial[w * DA + d].
template <int DA>
__device__ __forceinline__ void weighted_rows_i8(const float* w8, const int8_t* vh, int n,
                                                 int* partial) {
  using M = RowMap<DA>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane / M::LPR, col = (lane % M::LPR) * VEC;
  int acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0;
  for (int j0 = warp * M::RPW; j0 < n; j0 += UNROLL * M::STEP) {
    uint4 vv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + sub + u * M::STEP;
      vv[u] = j < n ? load_row16(vh + (size_t)j * DA) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + sub + u * M::STEP;
      axpy16(j < n ? (int)w8[j] : 0, vv[u], acc);
    }
  }
  // lanes of one warp that hold the same columns, then the warps
#pragma unroll
  for (int o = M::LPR; o < 32; o <<= 1) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  }
  if (sub == 0) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) partial[warp * DA + col + e] = acc[e];
  }
  __syncthreads();
}

__device__ __forceinline__ int sum_warps(const int* partial, int d, int DA) {
  int t = 0;
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) t += partial[w * DA + d];
  return t;
}

// ---------------------------------------------------------------- kernel 3
template <int DA>
__global__ void __launch_bounds__(NTHREADS)
decode_attention_i8_kernel(const int8_t* __restrict__ q8, const float* __restrict__ sq,
                           const int8_t* __restrict__ k8, const void* __restrict__ ks,
                           const int8_t* __restrict__ v8, const void* __restrict__ vs,
                           const float* __restrict__ bias, void* __restrict__ out,
                           int na, int R, int live, float scale, int scale_bf16, int out_bf16) {
  using M = RowMap<DA>;
  extern __shared__ __align__(16) float smem[];
  float* s = smem;                                          // [R] logits, then weights
  int* partial = reinterpret_cast<int*>(s + R);             // [NWARPS][DA]
  float* red = reinterpret_cast<float*>(partial + NWARPS * DA);  // [NWARPS]

  const int a = blockIdx.x, bi = blockIdx.y;
  const int col = (threadIdx.x % 32 % M::LPR) * VEC;
  const size_t head = (size_t)bi * na + a;
  const size_t rows = head * (size_t)R;

  const uint4 qv = load_row16(q8 + head * DA + col);
  const float qs = __fmul_rn(sq[head], scale);
  logits_i8<DA>(qv, k8 + rows * DA + col, live, qs, ks, rows, scale_bf16,
                bias + (size_t)a * R, s);
  __syncthreads();

  // softmax in fp32, times the V scales, then one absmax scale for the row
  float m = -INFINITY;
  for (int j = threadIdx.x; j < live; j += NTHREADS) m = fmaxf(m, s[j]);
  m = block_reduce<true, NWARPS>(m, red);
  float sum = 0.f;
  for (int j = threadIdx.x; j < live; j += NTHREADS) {
    const float e = expf(s[j] - m);
    s[j] = e;
    sum += e;
  }
  sum = block_reduce<false, NWARPS>(sum, red);
  float amax = 0.f;
  for (int j = threadIdx.x; j < live; j += NTHREADS) {
    const float w = __fmul_rn(s[j] / sum, load_scalar(vs, rows + j, scale_bf16));
    s[j] = w;
    amax = fmaxf(amax, fabsf(w));
  }
  const float sw = block_reduce<true, NWARPS>(amax, red) / 127.f;
  for (int j = threadIdx.x; j < live; j += NTHREADS) s[j] = quantize_i8(s[j], sw);
  __syncthreads();

  weighted_rows_i8<DA>(s, v8 + rows * DA + col, live, partial);
  for (int d = threadIdx.x; d < DA; d += NTHREADS)
    store_scalar(out, head * DA + d, __fmul_rn((float)sum_warps(partial, d, DA), sw), out_bf16);
}

// ---------------------------------------------------------------- kernel 4
template <int DA>
__global__ void __launch_bounds__(NTHREADS)
decode_attention_i8_live_kernel(const int8_t* __restrict__ q8, const float* __restrict__ sq,
                                const int8_t* __restrict__ k8, const void* __restrict__ ks,
                                const int8_t* __restrict__ v8, const void* __restrict__ vs,
                                const float* __restrict__ bias, void* __restrict__ out,
                                int na, int R, int live, int rtile, float scale,
                                int scale_bf16, int out_bf16) {
  using M = RowMap<DA>;
  static_assert(DA <= NTHREADS, "one thread per output column");
  extern __shared__ __align__(16) float smem[];
  float* s = smem;                                          // [rtile] one tile's logits, weights
  int* partial = reinterpret_cast<int*>(s + rtile);         // [NWARPS][DA]
  float* red = reinterpret_cast<float*>(partial + NWARPS * DA);  // [NWARPS]

  const int a = blockIdx.x, bi = blockIdx.y;
  const int col = (threadIdx.x % 32 % M::LPR) * VEC;
  const size_t head = (size_t)bi * na + a;
  const size_t rows = head * (size_t)R;

  const uint4 qv = load_row16(q8 + head * DA + col);
  const float qs = __fmul_rn(sq[head], scale);
  float m_run = -1e30f, l_run = 0.f;
  float acc = 0.f;  // thread d < DA owns output column d

  for (int j0 = 0; j0 < live; j0 += rtile) {  // the live tiles, in order
    const int n = min(rtile, live - j0);
    logits_i8<DA>(qv, k8 + (rows + j0) * DA + col, n, qs, ks, rows + j0, scale_bf16,
                  bias + (size_t)a * R + j0, s);
    __syncthreads();
    float tmax = -1e30f;  // rows past `live` of this tile carry -1e30 in the reference
    for (int j = threadIdx.x; j < n; j += NTHREADS) tmax = fmaxf(tmax, s[j]);
    const float m_new = fmaxf(m_run, block_reduce<true, NWARPS>(tmax, red));
    const float alpha = expf(m_run - m_new);
    float psum = 0.f, amax = 0.f;
    for (int j = threadIdx.x; j < n; j += NTHREADS) {
      const float p = expf(s[j] - m_new);
      psum += p;
      const float pw = __fmul_rn(p, load_scalar(vs, rows + j0 + j, scale_bf16));
      s[j] = pw;
      amax = fmaxf(amax, fabsf(pw));
    }
    psum = block_reduce<false, NWARPS>(psum, red);
    const float sw = block_reduce<true, NWARPS>(amax, red) / 127.f;
    l_run = __fadd_rn(__fmul_rn(l_run, alpha), psum);
    for (int j = threadIdx.x; j < n; j += NTHREADS) s[j] = quantize_i8(s[j], sw);
    __syncthreads();

    weighted_rows_i8<DA>(s, v8 + (rows + j0) * DA + col, n, partial);
    if (threadIdx.x < DA)
      acc = __fadd_rn(__fmul_rn(acc, alpha),
                      __fmul_rn((float)sum_warps(partial, threadIdx.x, DA), sw));
    m_run = m_new;
    __syncthreads();  // s and partial are rewritten by the next tile
  }
  if (threadIdx.x < DA)
    store_scalar(out, head * DA + threadIdx.x, acc / __fadd_rn(l_run, 1e-30f), out_bf16);
}

// ------------------------------------------------------- kernels 5 and 12
// ROUND_W: round the weight row to the io dtype before the V product (the
// probe kernel, 12); kernel 5 keeps it fp32.
template <int DA, bool ROUND_W>
__global__ void __launch_bounds__(NTHREADS)
cache_attention_i8_kernel(const void* __restrict__ q, const int8_t* __restrict__ k8,
                          const float* __restrict__ ks, const int8_t* __restrict__ v8,
                          const float* __restrict__ vs, const float* __restrict__ extra,
                          void* __restrict__ out, int na, int R, int live, size_t extra_stride,
                          float scale, int io_bf16) {
  using M = RowMap<DA>;
  extern __shared__ __align__(16) float smem[];
  float* s = smem;                      // [R] logits, then weights
  float* partial = s + R;               // [NWARPS][DA]
  float* qf = partial + NWARPS * DA;    // [DA]
  float* red = qf + DA;                 // [NWARPS]

  const int a = blockIdx.x, bi = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane / M::LPR, col = (lane % M::LPR) * VEC;
  const size_t head = (size_t)bi * na + a;
  const size_t rows = head * (size_t)R;
  const int8_t* kh = k8 + rows * DA + col;
  const int8_t* vh = v8 + rows * DA + col;
  const float* erow = extra + (size_t)bi * extra_stride + (size_t)a * R;

  for (int d = threadIdx.x; d < DA; d += NTHREADS) qf[d] = load_scalar(q, head * DA + d, io_bf16);
  __syncthreads();
  float qv[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) qv[e] = qf[col + e];

  // logits: q . float(k8_j) in fp32
  for (int j0 = warp * M::RPW; j0 < live; j0 += UNROLL * M::STEP) {
    uint4 kv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + sub + u * M::STEP;
      kv[u] = j < live ? load_row16(kh + (size_t)j * DA) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const unsigned words[4] = {kv[u].x, kv[u].y, kv[u].z, kv[u].w};
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) dot = fmaf(qv[e], byte_to_float(words[e / 4], e % 4), dot);
#pragma unroll
      for (int o = M::LPR / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      const int j = j0 + sub + u * M::STEP;
      if (lane % M::LPR == 0 && j < live)
        s[j] = __fadd_rn(__fmul_rn(__fmul_rn(dot, scale), ks[rows + j]), erow[j]);
    }
  }
  __syncthreads();

  float m = -INFINITY;
  for (int j = threadIdx.x; j < live; j += NTHREADS) m = fmaxf(m, s[j]);
  m = block_reduce<true, NWARPS>(m, red);
  float sum = 0.f;
  for (int j = threadIdx.x; j < live; j += NTHREADS) {
    const float e = expf(s[j] - m);
    s[j] = e;
    sum += e;
  }
  sum = block_reduce<false, NWARPS>(sum, red);
  for (int j = threadIdx.x; j < live; j += NTHREADS) {
    float w = __fmul_rn(s[j] / sum, vs[rows + j]);
    if (ROUND_W && io_bf16) w = __bfloat162float(__float2bfloat16(w));
    s[j] = w;
  }
  __syncthreads();

  // sum_j w_j float(v8_j) in fp32
  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
  for (int j0 = warp * M::RPW; j0 < live; j0 += UNROLL * M::STEP) {
    uint4 vv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + sub + u * M::STEP;
      vv[u] = j < live ? load_row16(vh + (size_t)j * DA) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + sub + u * M::STEP;
      const float w = j < live ? s[j] : 0.f;
      const unsigned words[4] = {vv[u].x, vv[u].y, vv[u].z, vv[u].w};
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = fmaf(w, byte_to_float(words[e / 4], e % 4), acc[e]);
    }
  }
#pragma unroll
  for (int o = M::LPR; o < 32; o <<= 1) {
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
    store_scalar(out, head * DA + d, o, io_bf16);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

bool bad_shape(int b, int na, int R, int da, int live) {
  return b < 1 || na < 1 || b > 65535 || na > 65535 || live < 1 || live > R || R > 32768 ||
         (da != 64 && da != 128);
}

template <bool ROUND_W>
int launch_cache_attention(const void* q, const void* k8, const float* ks, const void* v8,
                           const float* vs, const float* extra, void* out, int b, int na, int R,
                           int da, int live, int eb, int io_bf16, float scale,
                           cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)R + NWARPS * da + da + NWARPS);
  auto kernel = da == 128  ? cache_attention_i8_kernel<128, ROUND_W>
                : da == 64 ? cache_attention_i8_kernel<64, ROUND_W>
                           : cache_attention_i8_kernel<16, ROUND_W>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(na, b), NTHREADS, smem, stream>>>(
      q, static_cast<const int8_t*>(k8), ks, static_cast<const int8_t*>(v8), vs, extra, out, na,
      R, live, eb == 1 ? (size_t)0 : (size_t)na * R, scale, io_bf16);
  return (int)cudaGetLastError();
}

}  // namespace

// Kernel 3. q8 (b, na, da) int8; sq (b, na) fp32; k8, v8 (b, na, R, da) int8;
// ks, vs (b, na, R) fp32 or bf16 (scale_bf16); bias (na, R) fp32; out
// (b, na*da) fp32 or bf16 (out_bf16). Returns the cudaError_t of the launch.
extern "C" int lvt_decode_attention_i8(const void* q8, const float* sq, const void* k8,
                                       const void* ks, const void* v8, const void* vs,
                                       const float* bias, void* out, int b, int na, int R,
                                       int da, int live, int scale_bf16, int out_bf16,
                                       float scale, cudaStream_t stream) {
  if (bad_shape(b, na, R, da, live)) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)R + NWARPS * da + NWARPS);
  auto kernel = da == 128 ? decode_attention_i8_kernel<128> : decode_attention_i8_kernel<64>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(na, b), NTHREADS, smem, stream>>>(
      static_cast<const int8_t*>(q8), sq, static_cast<const int8_t*>(k8), ks,
      static_cast<const int8_t*>(v8), vs, bias, out, na, R, live, scale, scale_bf16, out_bf16);
  return (int)cudaGetLastError();
}

// Kernel 4: kernel 3's operands plus the row tile; bias without a causal mask.
extern "C" int lvt_decode_attention_i8_live(const void* q8, const float* sq, const void* k8,
                                            const void* ks, const void* v8, const void* vs,
                                            const float* bias, void* out, int b, int na, int R,
                                            int da, int live, int rtile, int scale_bf16,
                                            int out_bf16, float scale, cudaStream_t stream) {
  if (bad_shape(b, na, R, da, live) || rtile < 1 || rtile > R || R % rtile != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)rtile + NWARPS * da + NWARPS);
  auto kernel =
      da == 128 ? decode_attention_i8_live_kernel<128> : decode_attention_i8_live_kernel<64>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(na, b), NTHREADS, smem, stream>>>(
      static_cast<const int8_t*>(q8), sq, static_cast<const int8_t*>(k8), ks,
      static_cast<const int8_t*>(v8), vs, bias, out, na, R, live, rtile, scale, scale_bf16,
      out_bf16);
  return (int)cudaGetLastError();
}

// Kernel 5. q, out (b, na, da) fp32 or bf16 (io_bf16); k8, v8 (b, na, R, da)
// int8; ks, vs (b, na, R) fp32; extra (eb, na, R) fp32 with eb = b or 1.
extern "C" int lvt_cache_attention_i8(const void* q, const void* k8, const float* ks,
                                      const void* v8, const float* vs, const float* extra,
                                      void* out, int b, int na, int R, int da, int live, int eb,
                                      int io_bf16, float scale, cudaStream_t stream) {
  if (bad_shape(b, na, R, da, live) || (eb != 1 && eb != b)) return (int)cudaErrorInvalidValue;
  return launch_cache_attention<false>(q, k8, ks, v8, vs, extra, out, b, na, R, da, live, eb,
                                       io_bf16, scale, stream);
}

// Kernel 12, the probe kernel: kernel 5's operands and layouts, da also 16;
// the weight row is rounded to the io dtype before the V product.
extern "C" int lvt_decode_attention_i8kv(const void* q, const void* k8, const float* ks,
                                         const void* v8, const float* vs, const float* extra,
                                         void* out, int b, int na, int R, int da, int live,
                                         int eb, int io_bf16, float scale, cudaStream_t stream) {
  if (bad_shape(b, na, R, da == 16 ? 64 : da, live) || (eb != 1 && eb != b))
    return (int)cudaErrorInvalidValue;
  return launch_cache_attention<true>(q, k8, ks, v8, vs, extra, out, b, na, R, da, live, eb,
                                      io_bf16, scale, stream);
}
