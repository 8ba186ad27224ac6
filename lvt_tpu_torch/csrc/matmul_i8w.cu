// y (b, K) float  x  W8 (K, N) int8 with per-column scales sw (N,):
//   sy_r  = max_k |y_rk| / 127                      (fp32, per activation row)
//   y8_rk = clip(rint(y_rk / (sy_r + 1e-8)), +-127)
//   out_rn = float(int32 sum_k y8_rk W8_kn) * sy_r * sw_n, rounded once.
// Given row_amax (b,) fp32, sy_r = row_amax_r / 127 instead: under tensor
// parallelism y holds one rank's part of each row of a row-split product
// (proj, FFN 2), row_amax is the whole row's absmax over the model group,
// and the rank's int8 values are its part of the whole row's
// (lvt_tpu_torch/ops/quant.py matmul_i8w_split). The kernel then skips its
// own absmax of each row. With an int32 output it stores the integer sums
// unscaled: the group adds the ranks' exact sums, and the epilogue's two
// products, applied after that, give the whole row's output bit for bit.
//
// Replaces the TPU kernel lvt_tpu/ops/quant_matmul.py: matmul_i8w_pallas (its
// pl.pallas_call at :99), which quantizes the activation tile in the kernel's
// body and feeds one int8 x int8 product to the matrix unit. The weight
// arrives transposed here, (N, K) row-major, so that the K values of one
// output column are contiguous and four of them lie in one 32-bit word for
// __dp4a. The integer sum is exact (any grouping of it gives the same bits)
// and the three fp32 operations of the epilogue round as IEEE on both sides,
// so the kernel equals its plain version (lvt_tpu_torch/ops/quant.py:
// matmul_i8w_plain) bit for bit.
//
// What bounds it on the H100: the weight's bytes, then latency. The sampler
// calls it with b = 1 to 16 rows: (b, 512) x (512, 3072), (b, 512) x (512,
// 512) twice and (b, 1024) x (1024, 512) per layer and pixel, 0.25 to 1.5 MB
// of int8 weight per call (0.08 to 0.47 us at 3.35 TB/s), 2 b operations per
// weight byte. At these sizes the time is launch plus a chain of dependent
// memory round trips, so the design shortens the chain and spreads the weight
// over every SM:
// * A block of 256 threads takes CPB output columns (16, 8, 4 or 2) and 8
//   activation rows; every block quantizes its rows itself, so the host
//   picks the most blocks that one wave of one block an SM holds (ops/quant.py
//   matmul_i8w_plan): 128 for N = 512 (CPB 4; CPB 8 at b = 16), 192 for N =
//   3,072 (CPB 16; 384 at b = 16). On the H100 256 blocks (two an SM) read
//   0.0045-0.0050 ms where 128 read 0.0041-0.0046 (b = 8, N = 512), and 128
//   threads a block 1.1-1.3x slower (tools/time_i8w_vq_parts_torch.py). The
//   256 / CPB threads of a column split its K in 16-byte words.
// * Each thread asks for its weight words first (up to 4 words held in
//   registers), then reads its row of y once: a warp takes one row, its lanes
//   8 values each per 256 columns, held in registers (K <= 1,024; longer rows
//   are read twice, the second time from the L1), takes the row's absmax with
//   a warp reduction, quantizes and stores the int8 row in shared memory. The
//   weight lands meanwhile.
// * After one __syncthreads each thread multiplies its words into all 8
//   rows with __dp4a. The 8 row sums of a column, spread over its lanes, are
//   combined by one transposing butterfly (reduce-scatter: 4 + 2 + 1
//   shuffles, then one per remaining lane bit), after which each lane holds
//   one row's sum; columns of more than 32 threads add their warps' parts in
//   shared memory. The stores run along rows: consecutive threads write
//   consecutive columns of one row.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "reduce.cuh"

namespace {

using namespace lvt;

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int BT = 8;      // activation rows per block
constexpr int WPT = 4;     // 16-byte weight words a thread holds per batch
constexpr int YCH = 4;     // 8-value pieces of a row per lane held in registers
constexpr int KREG = 32 * 8 * YCH;  // rows up to this long are read once
constexpr int RPW = BT / NWARPS;  // rows a warp quantizes
static_assert(RPW * NWARPS == BT, "the warps share the rows evenly");
constexpr int OUT_F32 = 0, OUT_BF16 = 1, OUT_I32 = 2;  // out_type

__device__ __forceinline__ uint4 ld_weight(const int8_t* p) {
  uint4 v;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// eight consecutive values of y at element i (a multiple of 8), as fp32
__device__ __forceinline__ void load8(const void* y, size_t i, int y_bf16, float (&v)[8]) {
  if (y_bf16) {
    const uint4 u = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(y) + i);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[h]));
      v[2 * h] = f.x;
      v[2 * h + 1] = f.y;
    }
  } else {
    const float4 a = *reinterpret_cast<const float4*>(static_cast<const float*>(y) + i);
    const float4 b = *reinterpret_cast<const float4*>(static_cast<const float*>(y) + i + 4);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  }
}

// rint for |x| < 2^22, round half to even, on the FMA pipe: adding 1.5 2^23
// leaves the integer in the low mantissa bits (the conversion instructions,
// FRND and F2I, run at an eighth of the FMA rate or less)
constexpr float MAGIC = 12582912.f;
__device__ __forceinline__ float rint_fma(float x) {
  return __fsub_rn(__fadd_rn(x, MAGIC), MAGIC);
}

// Eight values quantized with scale s, clip(rint(x / q), +-127) with q = s
// + 1e-8 bit for bit, packed into two words; r = 1 / q. A multiplication by
// r takes the place of each division: x r lies within 2 fp32 ulps of x / q
// (1.6e-5 for |x / q| <= 128), so the two round to the same integer unless
// x / q lies that close to a half-integer; where one of the eight does (1e-4
// of one), all eight take the true quotient: one branch per eight values
// (tools/time_i8w_vq_parts_torch.py times a branch per value beside it).
// Clipping before the rounding gives the same integer, whose byte is that of
// k in k + 1.5 2^23.
__device__ __forceinline__ uint2 pack8(const float (&v)[8], float q, float r) {
  float k[8];
  bool near_half = false;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float t = __fmul_rn(v[e], r);
    k[e] = rint_fma(t);
    near_half |= fabsf(fabsf(__fsub_rn(t, k[e])) - 0.5f) < 1e-4f;
  }
  if (near_half) {
#pragma unroll
    for (int e = 0; e < 8; ++e) k[e] = rint_fma(__fdiv_rn(v[e], q));
  }
  uint32_t w[2] = {0, 0};
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float kc = __fadd_rn(fminf(fmaxf(k[e], -127.f), 127.f), MAGIC);
    w[e / 4] |= ((uint32_t)__float_as_int(kc) & 0xffu) << (8 * (e % 4));
  }
  return make_uint2(w[0], w[1]);
}

// Transposing butterfly over the G lanes of one column (G a power of two,
// V <= G): V values a lane in, the total over the G lanes of one of them
// out, value (lane % G) / (G / V). While a lane holds more than one value it
// sends the half it gives away and adds the partner's copy of the half it
// keeps; then each remaining lane bit is one plain exchange.
template <int G, int V>
__device__ __forceinline__ int reduce_scatter(int (&v)[V], int lane) {
#pragma unroll
  for (int s = 0; (G >> (s + 1)) >= 1; ++s) {
    const int m = G >> (s + 1);
    const int n = V >> s;  // values held before this step
    if (n > 1) {
      const bool upper = lane & m;
#pragma unroll
      for (int i = 0; i < n / 2; ++i) {
        const int give = upper ? v[i] : v[i + n / 2];
        const int keep = upper ? v[i + n / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, give, m);
      }
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], m);
    }
  }
  return v[0];
}

template <int CPB, bool YREG>
__global__ void __launch_bounds__(NTHREADS)
matmul_i8w_kernel(const void* __restrict__ y, const int8_t* __restrict__ wt,
                  const void* __restrict__ sw, const float* __restrict__ row_amax,
                  void* __restrict__ out, int b, int K, int N, int y_bf16, int sw_bf16,
                  int out_type) {
  constexpr int TPC = NTHREADS / CPB;      // threads of one column: 8 to 64
  constexpr int G = TPC < 32 ? TPC : 32;   // its lanes within one warp
  constexpr int WPC = TPC / G;             // its warps
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* y8 = reinterpret_cast<int8_t*>(smem_raw);          // [BT][K]
  float* sy = reinterpret_cast<float*>(smem_raw + BT * K);    // [BT]
  int* part = reinterpret_cast<int*>(sy + BT);               // [CPB][BT][WPC]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int col = tid / TPC, j0 = tid % TPC;
  const int n = blockIdx.x * CPB + col;
  const int row0 = blockIdx.y * BT;
  const int rows = min(BT, b - row0);
  const int words = K / 16;
  const int8_t* wcol = wt + (size_t)(n < N ? n : 0) * K;

  // 1. the first batch of this thread's weight words, before anything else
  uint4 w[WPT];
#pragma unroll
  for (int u = 0; u < WPT; ++u) {
    const int j = j0 + u * TPC;
    w[u] = n < N && j < words ? ld_weight(wcol + (size_t)j * 16) : make_uint4(0, 0, 0, 0);
  }

  // 2. the block's rows of y, quantized into shared memory: warp w takes
  // rows w, w + NWARPS, ..., lane l the values 8 (32 c + l) .. + 7 of each
  if (YREG) {
    float v[RPW][YCH][8];
#pragma unroll
    for (int h = 0; h < RPW; ++h) {
      const int r = warp + NWARPS * h;
#pragma unroll
      for (int c = 0; c < YCH; ++c) {
        const int i = (32 * c + lane) * 8;
        if (r < rows && i < K) {
          load8(y, (size_t)(row0 + r) * K + i, y_bf16, v[h][c]);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[h][c][e] = 0.f;
        }
      }
    }
#pragma unroll
    for (int h = 0; h < RPW; ++h) {
      const int r = warp + NWARPS * h;
      float s;
      if (row_amax != nullptr) {  // kernel-uniform
        s = (r < rows ? row_amax[row0 + r] : 0.f) / 127.f;
      } else {
        float amax = 0.f;
#pragma unroll
        for (int c = 0; c < YCH; ++c)
#pragma unroll
          for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[h][c][e]));
        s = warp_max(amax) / 127.f;
      }
      const float q = __fadd_rn(s, 1e-8f), rq = 1.f / q;
      if (r < rows) {
#pragma unroll
        for (int c = 0; c < YCH; ++c) {
          const int i = (32 * c + lane) * 8;
          if (i < K) *reinterpret_cast<uint2*>(y8 + r * K + i) = pack8(v[h][c], q, rq);
        }
        if (lane == 0) sy[r] = s;
      }
    }
  } else {
    for (int h = 0; h < RPW; ++h) {
      const int r = warp + NWARPS * h;
      if (r >= rows) continue;  // warp-uniform
      const size_t base = (size_t)(row0 + r) * K;
      float v[8], s;
      if (row_amax != nullptr) {  // kernel-uniform: no pass over the row for its absmax
        s = row_amax[row0 + r] / 127.f;
      } else {
        float amax = 0.f;
        for (int i = lane * 8; i < K; i += 256) {
          load8(y, base + i, y_bf16, v);
#pragma unroll
          for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[e]));
        }
        s = warp_max(amax) / 127.f;
      }
      const float q = __fadd_rn(s, 1e-8f), rq = 1.f / q;
      for (int i = lane * 8; i < K; i += 256) {
        load8(y, base + i, y_bf16, v);
        *reinterpret_cast<uint2*>(y8 + r * K + i) = pack8(v, q, rq);
      }
      if (lane == 0) sy[r] = s;
    }
  }
  __syncthreads();

  // 3. the products: every word of this thread into each of the rows
  int acc[BT];
#pragma unroll
  for (int r = 0; r < BT; ++r) acc[r] = 0;
  for (int base = 0; base < words; base += WPT * TPC) {
    if (base > 0) {
#pragma unroll
      for (int u = 0; u < WPT; ++u) {
        const int j = j0 + base + u * TPC;
        w[u] = n < N && j < words ? ld_weight(wcol + (size_t)j * 16) : make_uint4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int u = 0; u < WPT; ++u) {
      const int j = j0 + base + u * TPC;
      if (j < words) {
#pragma unroll
        for (int r = 0; r < BT; ++r) {
          if (r < rows) {
            const uint4 yv = *reinterpret_cast<const uint4*>(y8 + r * K + j * 16);
            int d = __dp4a((int)w[u].x, (int)yv.x, acc[r]);
            d = __dp4a((int)w[u].y, (int)yv.y, d);
            d = __dp4a((int)w[u].z, (int)yv.z, d);
            acc[r] = __dp4a((int)w[u].w, (int)yv.w, d);
          }
        }
      }
    }
  }

  // 4. the column's sums: a butterfly over its lanes, then its warps
  const int total = reduce_scatter<G, BT>(acc, lane);
  if (lane % (G / BT) == 0)
    part[(col * BT + (lane % G) / (G / BT)) * WPC + warp % WPC] = total;
  __syncthreads();

  // 5. scale and store, consecutive threads on consecutive columns of a row
  if (tid < CPB * BT) {
    const int r = tid / CPB, c = tid % CPB, nn = blockIdx.x * CPB + c;
    if (r < rows && nn < N) {
      int sum = 0;
#pragma unroll
      for (int s = 0; s < WPC; ++s) sum += part[(c * BT + r) * WPC + s];
      const size_t at = (size_t)(row0 + r) * N + nn;
      if (out_type == OUT_I32) {
        static_cast<int*>(out)[at] = sum;
      } else {
        const float o = __fmul_rn(__fmul_rn((float)sum, sy[r]), load_scalar(sw, nn, sw_bf16));
        store_scalar(out, at, o, out_type == OUT_BF16);
      }
    }
  }
}

template <int CPB, bool YREG>
cudaError_t launch(const void* y, const void* wt, const void* sw, const float* row_amax,
                   void* out, int b, int K, int N, int y_bf16, int sw_bf16, int out_type,
                   cudaStream_t stream) {
  auto kernel = matmul_i8w_kernel<CPB, YREG>;
  constexpr int WPC = NTHREADS / CPB > 32 ? NTHREADS / CPB / 32 : 1;
  const size_t smem = (size_t)BT * K + BT * sizeof(float) + CPB * BT * WPC * sizeof(int);
  static size_t smem_set = 48 * 1024;
  if (smem > smem_set) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  const dim3 grid((N + CPB - 1) / CPB, (b + BT - 1) / BT);
  kernel<<<grid, NTHREADS, smem, stream>>>(y, static_cast<const int8_t*>(wt), sw, row_amax,
                                           out, b, K, N, y_bf16, sw_bf16, out_type);
  return cudaGetLastError();
}

template <int CPB>
cudaError_t launch_rows(const void* y, const void* wt, const void* sw, const float* row_amax,
                        void* out, int b, int K, int N, int y_bf16, int sw_bf16, int out_type,
                        cudaStream_t stream) {
  if (K <= KREG)
    return launch<CPB, true>(y, wt, sw, row_amax, out, b, K, N, y_bf16, sw_bf16, out_type,
                             stream);
  return launch<CPB, false>(y, wt, sw, row_amax, out, b, K, N, y_bf16, sw_bf16, out_type,
                            stream);
}

}  // namespace

// y (b, K) fp32 or bf16 (y_bf16), 16-byte aligned; wt (N, K) int8, the
// (K, N) weight transposed, 16-byte aligned; sw (N,) fp32 or bf16 (sw_bf16);
// row_amax (b,) fp32, or null (each row's own absmax); out (b, N) fp32,
// bf16 or int32 (out_type 0, 1, 2; int32: the integer sums, unscaled). K a
// multiple of 16 up to 16,384. cpb: output columns per block, 2, 4, 8 or 16
// (ops/quant.py matmul_i8w_plan). Returns the cudaError_t of the launch.
extern "C" int lvt_matmul_i8w(const void* y, const void* wt, const void* sw,
                              const float* row_amax, void* out, int b, int K, int N, int y_bf16,
                              int sw_bf16, int out_type, int cpb, cudaStream_t stream) {
  if (b < 1 || K < 16 || K % 16 != 0 || N < 1 || K > 16384 || (b + BT - 1) / BT > 65535 ||
      out_type < OUT_F32 || out_type > OUT_I32)
    return (int)cudaErrorInvalidValue;
  cudaError_t (*run)(const void*, const void*, const void*, const float*, void*, int, int, int,
                     int, int, int, cudaStream_t) = nullptr;
  if (cpb == 16) run = launch_rows<16>;
  if (cpb == 8) run = launch_rows<8>;
  if (cpb == 4) run = launch_rows<4>;
  if (cpb == 2) run = launch_rows<2>;
  if (run == nullptr) return (int)cudaErrorInvalidValue;
  return (int)run(y, wt, sw, row_amax, out, b, K, N, y_bf16, sw_bf16, out_type, stream);
}
