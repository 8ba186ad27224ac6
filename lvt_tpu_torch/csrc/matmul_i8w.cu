// y (b, K) float  x  W8 (K, N) int8 with per-column scales sw (N,):
//   sy_r  = max_k |y_rk| / 127                      (fp32, per activation row)
//   y8_rk = clip(rint(y_rk / (sy_r + 1e-8)), +-127)
//   out_rn = float(int32 sum_k y8_rk W8_kn) * sy_r * sw_n, rounded once.
//
// Replaces the TPU kernel lvt_tpu/ops/quant_matmul.py: matmul_i8w_pallas (its
// pl.pallas_call at :99), which quantizes the activation tile in the kernel's
// body and feeds one int8 x int8 product to the matrix unit. The weight
// arrives transposed here, (N, K) row-major, so that the K values of one
// output column are contiguous and four of them lie in one 32-bit word for
// __dp4a. The integer sum is exact and the three fp32 operations of the
// epilogue round as IEEE on both sides, so the kernel equals its plain version
// (lvt_tpu_torch/ops/quant.py: matmul_i8w_plain) bit for bit.
//
// What bounds it on the H100: the weight's bytes, then latency. The sampler
// calls it with b = 1 to 8 rows: (b, 512) x (512, 3072), (b, 512) x (512, 512)
// twice and (b, 1024) x (1024, 512) per layer and pixel, 0.25 to 1.5 MB of
// int8 weight per call (0.08 to 0.47 us at 3.35 TB/s), 2 * b operations per
// weight byte. So it streams the weight once and keeps all rows of a row
// group (up to 8) on chip: a block quantizes its rows into shared memory (one
// warp per row: absmax by a warp reduction), then each warp takes columns,
// its lanes read 16 bytes of a column's K each, multiply them into every row
// with __dp4a and reduce over the lanes. A tiled tensor-core GEMM would idle
// at these row counts; row groups beyond the first re-read the weight from
// the L2.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "reduce.cuh"

namespace {

using namespace lvt;

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int BT = 8;    // activation rows per block (one warp quantizes one row)
constexpr int CPW = 4;   // columns a warp loads before it reduces
constexpr int CPB = NWARPS * CPW;  // columns per block
static_assert(BT <= NWARPS, "one warp per activation row");

__global__ void __launch_bounds__(NTHREADS)
matmul_i8w_kernel(const void* __restrict__ y, const int8_t* __restrict__ wt,
                  const void* __restrict__ sw, void* __restrict__ out, int b, int K, int N,
                  int y_bf16, int sw_bf16, int out_bf16) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* y8 = reinterpret_cast<int8_t*>(smem_raw);        // [BT][K]
  float* sy = reinterpret_cast<float*>(smem_raw + BT * K);  // [BT]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.y * BT;
  const int rows = min(BT, b - row0);

  // quantize the block's activation rows: warp r takes row r
  if (warp < rows) {
    const size_t base = (size_t)(row0 + warp) * K;
    float amax = 0.f;
    for (int k = lane; k < K; k += 32) amax = fmaxf(amax, fabsf(load_scalar(y, base + k, y_bf16)));
    const float s = warp_max(amax) / 127.f;
    for (int k = lane; k < K; k += 32)
      y8[warp * K + k] = (int8_t)quantize_i8(load_scalar(y, base + k, y_bf16), s);
    if (lane == 0) sy[warp] = s;
  }
  __syncthreads();

  const int n0 = blockIdx.x * CPB + warp * CPW;
  int acc[CPW][BT];
#pragma unroll
  for (int c = 0; c < CPW; ++c) {
#pragma unroll
    for (int r = 0; r < BT; ++r) acc[c][r] = 0;
  }
  for (int k = lane * 16; k < K; k += 32 * 16) {
    uint4 w[CPW];
#pragma unroll
    for (int c = 0; c < CPW; ++c)
      w[c] = n0 + c < N ? *reinterpret_cast<const uint4*>(wt + (size_t)(n0 + c) * K + k)
                        : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      if (r < rows) {
        const uint4 yv = *reinterpret_cast<const uint4*>(y8 + r * K + k);
#pragma unroll
        for (int c = 0; c < CPW; ++c) {
          int d = __dp4a((int)w[c].x, (int)yv.x, acc[c][r]);
          d = __dp4a((int)w[c].y, (int)yv.y, d);
          d = __dp4a((int)w[c].z, (int)yv.z, d);
          acc[c][r] = __dp4a((int)w[c].w, (int)yv.w, d);
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < CPW; ++c) {
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      const int total = warp_sum(acc[c][r]);
      if (lane == r && r < rows && n0 + c < N) {
        const float o = __fmul_rn(__fmul_rn((float)total, sy[r]),
                                  load_scalar(sw, n0 + c, sw_bf16));
        store_scalar(out, (size_t)(row0 + r) * N + n0 + c, o, out_bf16);
      }
    }
  }
}

}  // namespace

// y (b, K) fp32 or bf16 (y_bf16); wt (N, K) int8, the (K, N) weight
// transposed; sw (N,) fp32 or bf16 (sw_bf16); out (b, N) fp32 or bf16
// (out_bf16). K a multiple of 16. Returns the cudaError_t of the launch.
extern "C" int lvt_matmul_i8w(const void* y, const void* wt, const void* sw, void* out, int b,
                              int K, int N, int y_bf16, int sw_bf16, int out_bf16,
                              cudaStream_t stream) {
  if (b < 1 || K < 16 || K % 16 != 0 || N < 1 || K > 16384) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)BT * K + BT * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        matmul_i8w_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((N + CPB - 1) / CPB, (b + BT - 1) / BT);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  matmul_i8w_kernel<<<grid, NTHREADS, smem, stream>>>(
      y, static_cast<const int8_t*>(wt), sw, out, b, K, N, y_bf16, sw_bf16, out_bf16);
  return (int)cudaGetLastError();
}
