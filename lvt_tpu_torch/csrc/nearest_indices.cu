// Nearest codebook entry of every row of z: the fp32 distance surrogate fused
// with the arg-reduction, so no (N, K) distance matrix reaches device memory.
//
// It replaces the TPU kernel nearest_indices_pallas of lvt_tpu/ops/vq.py
// (pallas_call at :125). That kernel pads N to 256-row tiles, keeps every
// intermediate 2-D, takes the argmin as min + masked-iota-min and writes a
// lane-broadcast (N, 128) int32 output: all of that answers the TPU's
// compiler. What is kept is the function:
//   d_k = (||c_k||^2 + ||z||^2) - 2 (z . c_k)        all in fp32
//   out = the lowest k among the minima of d_k
// with z cast to fp32 first (it may arrive as bf16) and the codebook fp32.
//
// Numerics. The product runs on fp32 FMAs, one accumulator per (row, code)
// summed over Dc in order: no TF32, no bf16 tensor cores, since an index is
// discrete and the port's fp32 paths stay true fp32. Against the plain
// PyTorch version (lvt_tpu_torch/ops/vq.py nearest_indices_plain) only the
// order of the fp32 sums differs, which can decide between two codes whose
// distances lie within rounding of each other and nothing else. Ties are
// exact: each thread walks its codes upward with a strict <, and the
// reductions across threads prefer the lower index on equal distances. A NaN
// distance never compares below the running minimum: a row of NaNs returns 0
// (as argmin does), a NaN codebook row is skipped.
//
// Design, for the H100. One block of 256 threads per 64 rows of z. The z
// tile (all Dc columns, transposed to [d][row]) stays in shared memory; the
// codebook walks through shared memory in chunks of 64 codes ([d][code]), so
// Dc = 256 fits (2 x 68 KB) as well as Dc = 64. Each thread holds a 4 x 4
// tile of (row, code) accumulators: per d it reads one float4 of rows and one
// of codes and issues 16 FMAs. ||c_k||^2 of a chunk is summed by all threads
// in four column ranges and combined in a fixed order. Any N (rows past N
// load zeros and are not written), any K (codes past K are not compared), Dc
// a multiple of 4 up to 256; z is read in place through its row stride.
// What bounds it: operations, 2 N K Dc flops at the non-tensor fp32 rate
// (537 MFLOP per PR-DVQVAE2 sub-codebook call against 67 TFLOP/s: 8 us); z
// and the indices are 2 MB. 128 blocks at N = 8,192 fill 132 SMs once, at 8
// warps per SM: a smaller row tile or a pipelined codebook load is later
// work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;          // rows of z per block
constexpr int BN = 64;          // codes per chunk
constexpr int TM = 4, TN = 4;   // (row, code) tile of one thread
constexpr int TX = BN / TN;     // 16 threads across the codes
constexpr int NTHREADS = (BM / TM) * TX;  // 256
constexpr int LDZ = BM + 4;     // padded leading dimensions, 16-byte rows
constexpr int LDC = BN + 4;
constexpr int CPARTS = NTHREADS / BN;  // column ranges of the ||c||^2 sums

__host__ __device__ constexpr size_t smem_floats(int Dc) {
  return (size_t)Dc * (LDZ + LDC) + BM + BN + CPARTS * BN + 2 * BM * TX;
}

template <bool Z_BF16>
__device__ __forceinline__ float load_z(const void* z, size_t i) {
  if (Z_BF16) return __bfloat162float(static_cast<const __nv_bfloat16*>(z)[i]);
  return static_cast<const float*>(z)[i];
}

template <bool Z_BF16>
__global__ void __launch_bounds__(NTHREADS)
nearest_indices_kernel(const void* __restrict__ z, const float* __restrict__ cb,
                       int* __restrict__ out, int N, int K, int Dc, long long z_stride) {
  extern __shared__ __align__(16) float smem[];
  float* zs = smem;                      // [Dc][LDZ]
  float* cs = zs + (size_t)Dc * LDZ;     // [Dc][LDC]
  float* zsq = cs + (size_t)Dc * LDC;    // [BM]
  float* csq = zsq + BM;                 // [BN]
  float* cpart = csq + BN;               // [CPARTS][BN]
  float* red_d = cpart + CPARTS * BN;    // [BM][TX]
  int* red_k = reinterpret_cast<int*>(red_d + BM * TX);  // [BM][TX]

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const long long r0 = (long long)blockIdx.x * BM;

  // the z tile, cast to fp32, transposed: consecutive threads read
  // consecutive columns of one row
  for (int i = tid; i < BM * Dc; i += NTHREADS) {
    const int r = i / Dc, d = i % Dc;
    zs[d * LDZ + r] =
        r0 + r < N ? load_z<Z_BF16>(z, (size_t)(r0 + r) * (size_t)z_stride + d) : 0.f;
  }
  __syncthreads();
  if (tid < BM) {
    float s = 0.f;
    for (int d = 0; d < Dc; ++d) s = fmaf(zs[d * LDZ + tid], zs[d * LDZ + tid], s);
    zsq[tid] = s;
  }

  float best_d[TM];
  int best_k[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    best_d[i] = INFINITY;
    best_k[i] = 0;
  }

  for (int k0 = 0; k0 < K; k0 += BN) {
    __syncthreads();  // the previous chunk is consumed (and zsq is written)
    for (int i = tid; i < BN * Dc; i += NTHREADS) {
      const int k = i / Dc, d = i % Dc;
      cs[d * LDC + k] = k0 + k < K ? cb[(size_t)(k0 + k) * Dc + d] : 0.f;
    }
    __syncthreads();
    {  // ||c_k||^2: CPARTS column ranges per code, combined in a fixed order
      const int k = tid % BN, part = tid / BN;
      const int per = (Dc + CPARTS - 1) / CPARTS;
      const int d1 = min(Dc, (part + 1) * per);
      float s = 0.f;
      for (int d = part * per; d < d1; ++d) s = fmaf(cs[d * LDC + k], cs[d * LDC + k], s);
      cpart[part * BN + k] = s;
    }
    __syncthreads();
    if (tid < BN) {
      float s = cpart[tid];
#pragma unroll
      for (int p = 1; p < CPARTS; ++p) s += cpart[p * BN + tid];
      csq[tid] = s;
    }

    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < Dc; ++d) {
      const float4 a4 = *reinterpret_cast<const float4*>(zs + d * LDZ + ty * TM);
      const float4 b4 = *reinterpret_cast<const float4*>(cs + d * LDC + tx * TN);
      const float a[TM] = {a4.x, a4.y, a4.z, a4.w};
      const float b[TN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // csq is written

    // this thread's codes of the chunk, upward: a strict < keeps the lowest
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int k = k0 + tx * TN + j;
      if (k < K) {
        const float c2 = csq[tx * TN + j];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float dist =
              __fsub_rn(__fadd_rn(c2, zsq[ty * TM + i]), __fmul_rn(2.f, acc[i][j]));
          if (dist < best_d[i]) {
            best_d[i] = dist;
            best_k[i] = k;
          }
        }
      }
    }
  }

  // across the TX threads of a row: the lower distance, then the lower index
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    red_d[(ty * TM + i) * TX + tx] = best_d[i];
    red_k[(ty * TM + i) * TX + tx] = best_k[i];
  }
  __syncthreads();
  if (tid < BM && r0 + tid < N) {
    float bd = red_d[tid * TX];
    int bk = red_k[tid * TX];
    for (int t = 1; t < TX; ++t) {
      const float d = red_d[tid * TX + t];
      const int k = red_k[tid * TX + t];
      if (d < bd || (d == bd && k < bk)) {
        bd = d;
        bk = k;
      }
    }
    out[r0 + tid] = bk;
  }
}

}  // namespace

// Kernel 6. z (N, Dc) fp32 or bf16 (z_bf16) with row stride z_stride
// (elements) and unit column stride; cb (K, Dc) fp32 contiguous; out (N,)
// int32. Returns the cudaError_t of the launch.
extern "C" int lvt_nearest_indices(const void* z, const float* cb, int* out, int N, int K,
                                   int Dc, long long z_stride, int z_bf16,
                                   cudaStream_t stream) {
  if (N < 1 || K < 1 || Dc < 4 || Dc > 256 || Dc % 4 != 0 || z_stride < Dc)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * smem_floats(Dc);
  auto kernel = z_bf16 ? nearest_indices_kernel<true> : nearest_indices_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned blocks = (unsigned)(((long long)N + BM - 1) / BM);
  kernel<<<blocks, NTHREADS, smem, stream>>>(z, cb, out, N, K, Dc, z_stride);
  return (int)cudaGetLastError();
}
