// Nearest codebook entry of every row of z, for all G sub-codebooks in one
// launch: the fp32 distance surrogate fused with the arg-reduction, so no
// (N, K) distance matrix reaches device memory.
//
// It replaces the TPU kernel nearest_indices_pallas of lvt_tpu/ops/vq.py
// (pallas_call at :125). That kernel pads N to 256-row tiles, keeps every
// intermediate 2-D, takes the argmin as min + masked-iota-min and writes a
// lane-broadcast (N, 128) int32 output: all of that answers the TPU's
// compiler. What is kept is the function, per sub-codebook g:
//   d_k = (||c_gk||^2 + ||z_g||^2) - 2 (z_g . c_gk)     all in fp32
//   out = the lowest k among the minima of d_k
// with z cast to fp32 first (it may arrive as bf16) and the codebooks fp32.
// VQ-VAE training asks for all G sub-codebooks of one z_e at once (their
// indices depend only on the embedding before the EMA update), so one launch
// covers them: z (N, G, Dc) is read in place through its two strides.
//
// Numerics. The product runs on fp32 FMAs, one accumulator per (row, code)
// summed over Dc in order: no TF32, no bf16 tensor cores, since an index is
// discrete and the port's fp32 paths stay true fp32. Against the plain
// PyTorch version (lvt_tpu_torch/ops/vq.py nearest_indices_plain) only the
// order of the fp32 sums differs, which can decide between two codes whose
// distances lie within rounding of each other and nothing else. Ties are
// exact: each thread walks its codes upward with a strict <, and every
// reduction across threads and blocks takes the lower (distance, index) pair,
// a total order, so the result does not depend on the order of the
// reductions and two calls give the same bits. A NaN distance never compares
// below the running minimum: a row of NaNs returns 0 (as argmin does), a NaN
// codebook row is skipped.
//
// What bounds it on the H100: operations, 2 N G K Dc flops at the non-tensor
// fp32 rate (67 TFLOP/s): 2.15 GFLOP, 32 us, for PR-DVQVAE2's step (N =
// 8,192, G = 4, K = 512, Dc = 64) and for Base-VQVAE's (G = 1, Dc = 256); z,
// the codebooks and the indices are a few MB. So the design keeps the FMA
// pipes fed:
// * A block of 256 threads takes 128 rows of one sub-codebook against 128
//   codes at a time; each thread holds an 8 x 8 tile of (row, code)
//   accumulators, rows ty + 16 i and codes tx + 16 j. Per 4 columns of Dc it
//   reads 8 + 8 16-byte words of shared memory for 256 FMAs (the 4 x 4 tile
//   of the first port read 2 words for 16). The tile and the unrolled loop
//   take 168-254 registers, so one block runs on an SM: at two (128
//   registers) the spills cost more than the second block gained (on the
//   H100 0.086 against 0.079 ms for the PR-DVQVAE2 step with bf16 z, 0.083
//   against 0.063 at Base-VQVAE's; tools/time_i8w_vq_parts_torch.py).
// * The codebook and z both stream through shared memory as a GEMM's K loop,
//   32 columns of Dc a stage, three stages deep, by cp.async (16-byte copies;
//   8-byte ones for bf16 z): stage t + 2 lands while stage t is multiplied,
//   with one __syncthreads per stage and no store through registers. Rows sit
//   in their natural layout, [row][d] and [code][d], padded to 144 bytes (80
//   for bf16 z): the 8 threads of a quarter warp read 8 consecutive codes
//   (banks 4 apart: conflict-free) and one row of z (a broadcast). Nothing
//   is resident, so every Dc up to 256 takes the same 111 KB (87 KB with
//   bf16 z).
// * ||c_k||^2 and ||z||^2 ride on the staging: as each stage lands, threads
//   0-127 add the squares of their code's 32 columns to a register, threads
//   128-255 (on the first chunk only) those of their row, in order of d; both
//   reach shared memory at the end of the chunk. That is 1/64 of the block's
//   FMAs. Summing the codebook once in a separate pass would put a dependent
//   launch (a few us) before this one to save them.
// * At the end of each chunk a thread takes its rows' minima over its 8
//   codes, the 8 lanes of a row's quarter warp exchange theirs by shuffles,
//   and the row's owner (thread row) folds the two warps' into its running
//   minimum: no per-row state stays in the product loop's registers.
// * The grid is (split, row tile, sub-codebook). Where the row tiles of all
//   sub-codebooks fill few SMs (Base-VQVAE: 64), the K codes are split over
//   the blocks of a cluster (2 or 4), each walks its share of the chunks, and
//   rank 0 takes the lower (distance, index) pair of each row from the
//   others' shared memory. The host picks the split with the fewest waves x
//   chunks a block (ops/vq.py nearest_plan): PR-DVQVAE2's step runs 256
//   blocks unsplit, Base-VQVAE's 128 blocks of two.
// Any N (rows past N load zeros and are not written), any K (codes past K
// are not compared), Dc a multiple of 4 up to 256; z's rows start on 16-byte
// boundaries (8-byte for bf16).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;          // rows of z per block
constexpr int BN = 128;          // codes per chunk
constexpr int DK = 32;           // columns of Dc per stage
constexpr int STAGES = 3;
constexpr int TM = 8, TN = 8;    // (row, code) tile of one thread
constexpr int NTHREADS = 256;
constexpr int MAX_SPLIT = 4;
constexpr int LDC = DK + 4;      // floats per staged code row (144 bytes)
constexpr int ZROW_F32 = (DK + 4) * 4;  // bytes per staged row of z
constexpr int ZROW_BF16 = (DK + 8) * 2;
static_assert(BM == NTHREADS / 2 && BN == NTHREADS / 2, "one thread per code and per row norm");
static_assert(BM / TM == 16 && BN / TN == 16, "16 x 16 threads");

__host__ __device__ constexpr int zrow_bytes(bool bf16) { return bf16 ? ZROW_BF16 : ZROW_F32; }
__host__ __device__ constexpr int stage_bytes(bool bf16) {
  return BM * zrow_bytes(bf16) + BN * LDC * 4;
}
// the stages, ||c||^2 of the chunk's codes, ||z||^2 of the rows, and each
// row's two half-row minima of the chunk (distance and index)
__host__ __device__ constexpr int smem_bytes(bool bf16) {
  return STAGES * stage_bytes(bf16) + (BN + BM) * 4 + BM * 2 * 8;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// cp.async of 16 (or 8) bytes; src_bytes 0 fills the destination with zeros
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp8(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 8 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four consecutive columns of a staged row of z, as fp32
template <bool Z_BF16>
__device__ __forceinline__ float4 z4(const unsigned char* zs, int row, int d) {
  if (Z_BF16) {
    const uint2 u = *reinterpret_cast<const uint2*>(zs + row * ZROW_BF16 + d * 2);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  return *reinterpret_cast<const float4*>(zs + row * ZROW_F32 + d * 4);
}

// the lower (distance, index) pair: a total order on non-NaN distances
__device__ __forceinline__ bool lower(float d, int k, float bd, int bk) {
  return d < bd || (d == bd && k < bk);
}

__device__ __forceinline__ uint32_t map_rank(const void* p, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(smem_u32(p)), "r"(rank));
  return out;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\nbarrier.cluster.wait.aligned;\n" ::: "memory");
}

template <bool Z_BF16>
__global__ void __launch_bounds__(NTHREADS, 1)
nearest_indices_kernel(const void* __restrict__ z, const float* __restrict__ cb,
                       int* __restrict__ out, int N, int G, int K, int Dc, long long sn,
                       long long sg, int ksplit) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* csq = reinterpret_cast<float*>(smem + STAGES * stage_bytes(Z_BF16));  // [BN]
  float* zsq = csq + BN;                                                        // [BM]
  float* red_d = zsq + BM;                                    // [BM][2]
  int* red_k = reinterpret_cast<int*>(red_d + 2 * BM);        // [BM][2]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // warp w holds 4 x 8 threads of the 16 x 16: a quarter warp is one ty and
  // 8 consecutive tx, so it reads one row of z and 8 consecutive codes
  const int ty = (warp / 2) * 4 + lane / 8, tx = (warp % 2) * 8 + lane % 8;
  const int rank = blockIdx.x, g = blockIdx.z;
  const long long r0 = (long long)blockIdx.y * BM;

  // this block's codes: whole chunks, split evenly over the cluster's ranks
  const int chunks = (K + BN - 1) / BN, per = (chunks + ksplit - 1) / ksplit;
  const int kbeg = min(K, rank * per * BN), kend = min(K, kbeg + per * BN);
  const int nchunk = (kend - kbeg + BN - 1) / BN, nslice = (Dc + DK - 1) / DK;
  const int T = nchunk * nslice;

  const unsigned char* zb = static_cast<const unsigned char*>(z);
  const int esz = Z_BF16 ? 2 : 4;
  const float* cbg = cb + (size_t)g * K * Dc;

  // stage t: columns [32 s, 32 s + 32) of the block's rows and of chunk c's
  // codes; 4 copies of each per thread
  auto issue = [&](int t) {
    unsigned char* st = smem + (t % STAGES) * stage_bytes(Z_BF16);
    float* cs = reinterpret_cast<float*>(st + BM * zrow_bytes(Z_BF16));
    const int d0 = (t % nslice) * DK, k0 = kbeg + (t / nslice) * BN;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = tid + u * NTHREADS, row = i / 8, part = i % 8, d = d0 + part * 4;
      const bool zok = r0 + row < N && d < Dc;
      const unsigned char* zsrc =
          zok ? zb + ((size_t)(r0 + row) * sn + (size_t)g * sg + d) * esz : zb;
      if (Z_BF16)
        cp8(st + row * ZROW_BF16 + part * 8, zsrc, zok);
      else
        cp16(st + row * ZROW_F32 + part * 16, zsrc, zok);
      const bool cok = k0 + row < kend && d < Dc;
      cp16(cs + row * LDC + part * 4, cok ? cbg + (size_t)(k0 + row) * Dc + d : cb, cok);
    }
  };

  // the running minimum of row tid (tid < 128) over the chunks so far
  float bd = INFINITY;
  int bk = 0;
  float acc[TM][TN];
  float norm = 0.f;  // ||c||^2 of code tid (tid < 128) or ||z||^2 of row tid - 128

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < T) issue(s);
    cp_commit();
  }
  for (int t = 0; t < T; ++t) {
    cp_wait<STAGES - 2>();
    __syncthreads();  // stage t has landed for all; stage t - 1 is consumed
    if (t + STAGES - 1 < T) issue(t + STAGES - 1);
    cp_commit();

    const int slice = t % nslice, chunk = t / nslice;
    const unsigned char* zs = smem + (t % STAGES) * stage_bytes(Z_BF16);
    const float* cs = reinterpret_cast<const float*>(zs + BM * zrow_bytes(Z_BF16));
    if (slice == 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
      if (tid < BN || chunk == 0) norm = 0.f;
    }
    // the norms, in order of d (zero-filled columns add nothing)
    if (tid < BN) {
#pragma unroll
      for (int d = 0; d < DK; d += 4) {
        const float4 c = *reinterpret_cast<const float4*>(cs + tid * LDC + d);
        norm = fmaf(c.x, c.x, norm);
        norm = fmaf(c.y, c.y, norm);
        norm = fmaf(c.z, c.z, norm);
        norm = fmaf(c.w, c.w, norm);
      }
    } else if (chunk == 0) {
#pragma unroll
      for (int d = 0; d < DK; d += 4) {
        const float4 v = z4<Z_BF16>(zs, tid - BN, d);
        norm = fmaf(v.x, v.x, norm);
        norm = fmaf(v.y, v.y, norm);
        norm = fmaf(v.z, v.z, norm);
        norm = fmaf(v.w, v.w, norm);
      }
    }
    // the products, in order of d
#pragma unroll
    for (int d = 0; d < DK; d += 4) {
      float4 c[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j)
        c[j] = *reinterpret_cast<const float4*>(cs + (tx + 16 * j) * LDC + d);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 a = z4<Z_BF16>(zs, ty + 16 * i, d);
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc[i][j] = fmaf(a.x, c[j].x, acc[i][j]);
          acc[i][j] = fmaf(a.y, c[j].y, acc[i][j]);
          acc[i][j] = fmaf(a.z, c[j].z, acc[i][j]);
          acc[i][j] = fmaf(a.w, c[j].w, acc[i][j]);
        }
      }
    }

    if (slice == nslice - 1) {  // the chunk is summed: its distances
      if (tid < BN)
        csq[tid] = norm;
      else if (chunk == 0)
        zsq[tid - BN] = norm;
      __syncthreads();
      // each thread's codes upward: a strict < keeps the lowest; then the
      // lower (distance, index) pair over the 8 lanes of a row's quarter
      // warp, and over the warp pair by the row's owner
      float c2[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) c2[j] = csq[tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float z2 = zsq[ty + 16 * i];
        float d = INFINITY;
        int k = 0;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int kk = kbeg + chunk * BN + tx + 16 * j;
          const float dist = __fsub_rn(__fadd_rn(c2[j], z2), __fmul_rn(2.f, acc[i][j]));
          if (kk < kend && dist < d) {
            d = dist;
            k = kk;
          }
        }
#pragma unroll
        for (int o = 1; o < 8; o <<= 1) {
          const float od = __shfl_xor_sync(0xffffffffu, d, o);
          const int ok = __shfl_xor_sync(0xffffffffu, k, o);
          if (lower(od, ok, d, k)) {
            d = od;
            k = ok;
          }
        }
        if (lane % 8 == 0) {
          red_d[(ty + 16 * i) * 2 + warp % 2] = d;
          red_k[(ty + 16 * i) * 2 + warp % 2] = k;
        }
      }
      __syncthreads();
      if (tid < BM) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (lower(red_d[2 * tid + h], red_k[2 * tid + h], bd, bk)) {
            bd = red_d[2 * tid + h];
            bk = red_k[2 * tid + h];
          }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();  // the stages are free: they hold the candidates now

  float* cand_d = reinterpret_cast<float*>(smem);  // [BM], read by rank 0
  int* cand_k = reinterpret_cast<int*>(cand_d + BM);
  if (tid < BM) {
    cand_d[tid] = bd;
    cand_k[tid] = bk;
  }
  if (ksplit > 1) {
    cluster_sync();  // every rank's candidates are in its shared memory
    if (rank == 0 && tid < BM) {
      for (int r = 1; r < ksplit; ++r) {
        float od;
        int ok;
        const uint32_t pd = map_rank(cand_d + tid, r), pk = map_rank(cand_k + tid, r);
        asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(od) : "r"(pd));
        asm volatile("ld.shared::cluster.s32 %0, [%1];\n" : "=r"(ok) : "r"(pk));
        if (lower(od, ok, bd, bk)) {
          bd = od;
          bk = ok;
        }
      }
    }
    cluster_sync();  // no rank leaves while rank 0 reads its shared memory
  }
  if (rank == 0 && tid < BM && r0 + tid < N) out[(size_t)(r0 + tid) * G + g] = bk;
}

template <bool Z_BF16>
cudaError_t launch(const void* z, const float* cb, int* out, int N, int G, int K, int Dc,
                   long long sn, long long sg, int ksplit, cudaStream_t stream) {
  auto kernel = nearest_indices_kernel<Z_BF16>;
  static bool configured = false;
  const int smem = smem_bytes(Z_BF16);
  if (!configured) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ksplit, (unsigned)((N + BM - 1) / BM), G);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ksplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = ksplit > 1 ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, z, cb, out, N, G, K, Dc, sn, sg, ksplit);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Kernel 6. z (N, G, Dc) fp32 or bf16 (z_bf16): element (n, g, d) at
// n * sn + g * sg + d, rows starting on 16-byte (bf16: 8-byte) boundaries; cb
// (G, K, Dc) fp32 contiguous; out (N, G) int32 contiguous. ksplit: blocks of
// a cluster that share one row tile's codes, 1, 2 or 4 (ops/vq.py
// nearest_plan). Returns the cudaError_t of the launch.
extern "C" int lvt_nearest_indices_grouped(const void* z, const float* cb, int* out, int N, int G,
                                           int K, int Dc, long long sn, long long sg, int z_bf16,
                                           int ksplit, cudaStream_t stream) {
  if (N < 1 || G < 1 || G > 65535 || K < 1 || Dc < 4 || Dc > 256 || Dc % 4 != 0 ||
      (N + BM - 1) / BM > 65535 || sn < 0 || sg < 0 || sn % 4 != 0 || sg % 4 != 0 ||
      ksplit < 1 || ksplit > MAX_SPLIT || (ksplit & (ksplit - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  if (z_bf16) return (int)launch<true>(z, cb, out, N, G, K, Dc, sn, sg, ksplit, stream);
  return (int)launch<false>(z, cb, out, N, G, K, Dc, sn, sg, ksplit, stream);
}
