#pragma once
// Block-local attention forward (device code and launcher; the C entry point is
// in block_attention.cu, and fused_layer.cu launches the same kernels): out = softmax(q k^T * scale + bias [causal
// -1e4 fill after the bias]) v, per (attention block, head).
//
// Replaces the TPU kernel lvt_tpu/ops/attention.py:attention_core_pallas
// (its pl.pallas_call at :176), which keeps one block's whole (n, n) score
// matrix in VMEM and runs QK^T and PV on the MXU.
//
// Numerics (same as the TPU kernel and the plain version in
// lvt_tpu_torch/ops/attention.py): q.k products and sums in fp32, the bias
// read as fp32, masked entries set to -1e4 after the bias is added, softmax
// in fp32 as exp(s - max) / sum, the probabilities rounded to v's dtype
// before P.V, P.V summed in fp32, the output rounded to q's dtype. The
// softmax is exact, not online: the TPU kernel normalises first and then
// rounds P, and a flash-style running rescale would round other numbers.
//
// What bounds it on the H100: at DSFVT shapes (n = 256, da = 128) one call
// does 4 * nb * na * n^2 * da flops (4.3 GFLOP at nb = 16, na = 8) over
// 4 * nb * na * n * da inputs/outputs (33.5 MB in bf16) plus the bias:
// 128 flops per byte, under the 295 at which bf16 tensor cores stop waiting
// on memory, so a tensor-core version is bound by memory and latency, an
// FMA version by the FMA pipes (67 TFLOP/s fp32).
//
// Two kernels, picked by dtype:
// * bf16, n <= 256 (DSFVT; bf16 at wider blocks is refused until a geometry
//   that needs it is ported):
//   tensor cores through mma.sync m16n8k16 (bf16 in, fp32 accumulate). One
//   block of 4 warps per (64 query rows, head, attention block); each warp
//   owns 16 query rows and keeps their whole score row block (up to 256
//   keys) in registers, so the softmax is exact and S never reaches shared
//   or device memory. The C fragments of S are, after the softmax and the
//   rounding to bf16, the A fragments of P.V as they stand (no shuffle).
//   K and V go through shared memory one 64-key tile at a time, V
//   transposed so that each B fragment is one 32-bit read; rows are padded
//   by 16 bytes so the fragment reads of a warp hit 32 distinct banks.
// * fp32, n <= 1024 (true fp32: no TF32 tensor-core path exists for it):
//   FMA register micro-tiles over shared-memory tiles (each
//   thread keeps a 4x4 block of S and a 4x8 block of O), with the whole
//   (QT, n) score row block in shared memory, so the softmax is exact there
//   too and nothing of S reaches device memory.
// In both, key tiles that the causal mask covers entirely for the block are
// filled with -1e4 without computing q.k. wgmma/TMA is later work.
//
// Shapes: q, k, v, out (nb, na, n, DA) contiguous; bias (na, n, n) fp32
// contiguous; n <= 1024 in fp32, n <= 256 in bf16; DA in {64, 128}.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace lvt_fwd {
namespace {

using lvt_mma::CH;
using lvt_mma::ld32;
using lvt_mma::mma_bf16;
using lvt_mma::pack_bf16;

constexpr int KT = 64;        // key rows per tile
constexpr int NTHREADS = 256; // 16 x 16 thread grid

// ---------------------------------------------------------------------------
// fp32: FMA
// ---------------------------------------------------------------------------

// Shared-memory layout (floats): Qs[DA][QT+4] | KV[DA][KT+4] | S[QT][np+4]
// (the +4 pads keep float4 rows aligned and spread the transposed stores
// over more banks)
template <int QT, int DA>
__global__ void __launch_bounds__(NTHREADS)
block_attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ bias,
                           float* __restrict__ out, int na, int n, int np, int causal,
                           float scale) {
  constexpr int RM = QT / 16;   // query rows per thread
  constexpr int CPT = DA / 16;  // output columns per thread in P.V
  constexpr int LDQ = QT + 4;
  constexpr int LDK = KT + 4;
  const int lds = np + 4;

  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                 // [DA][LDQ], Q transposed
  float* KV = Qs + DA * LDQ;        // [DA][LDK] K^T, or [KT][DA] V
  float* S = KV + DA * LDK;         // [QT][lds] scores, then P

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * QT;
  const int a = blockIdx.y;
  const int blk = blockIdx.z;
  const size_t head = ((size_t)blk * na + a) * (size_t)n * DA;
  const float* qh = q + head;
  const float* kh = k + head;
  const float* vh = v + head;
  const float* bh = bias + (size_t)a * n * n;

  // ---- Q tile, transposed into shared memory (rows past n read as 0)
  for (int i = tid; i < QT * DA; i += NTHREADS) {
    const int r = i / DA, d = i % DA;
    const int gr = q0 + r;
    Qs[d * LDQ + r] = gr < n ? qh[(size_t)gr * DA + d] : 0.f;
  }

  // ---- S = q k^T * scale + bias, causal fill, one key tile at a time
  for (int kt0 = 0; kt0 < np; kt0 += KT) {
    const bool all_masked = causal && kt0 > q0 + QT - 1;
    if (all_masked) {
      for (int i = tid; i < QT * KT; i += NTHREADS) {
        const int r = i / KT, c = i % KT;
        S[r * lds + kt0 + c] = kt0 + c < n ? -1e4f : 0.f;
      }
      continue;  // no shared K tile was touched: no barrier needed
    }
    __syncthreads();  // previous readers of KV are done
    for (int i = tid; i < KT * DA; i += NTHREADS) {
      const int c = i / DA, d = i % DA;
      const int gc = kt0 + c;
      KV[d * LDK + c] = gc < n ? kh[(size_t)gc * DA + d] : 0.f;
    }
    __syncthreads();

    float acc[RM][4];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

#pragma unroll 4
    for (int d = 0; d < DA; ++d) {
      float qa[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) qa[i] = Qs[d * LDQ + ty * RM + i];
      const float4 kb = *reinterpret_cast<const float4*>(&KV[d * LDK + tx * 4]);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        acc[i][0] = fmaf(qa[i], kb.x, acc[i][0]);
        acc[i][1] = fmaf(qa[i], kb.y, acc[i][1]);
        acc[i][2] = fmaf(qa[i], kb.z, acc[i][2]);
        acc[i][3] = fmaf(qa[i], kb.w, acc[i][3]);
      }
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ty * RM + i;
      const int gr = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gc = kt0 + tx * 4 + j;
        float s = 0.f;
        if (gr < n && gc < n) {
          s = acc[i][j] * scale + bh[(size_t)gr * n + gc];
          if (causal && gc > gr) s = -1e4f;
        }
        S[r * lds + gc] = s;
      }
    }
  }
  __syncthreads();

  // ---- softmax per row in fp32, P kept in fp32 = v's dtype (one warp per row)
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < QT; r += NTHREADS / 32) {
    float* row = S + r * lds;
    if (q0 + r >= n) {
      for (int c = lane; c < np; c += 32) row[c] = 0.f;
      continue;
    }
    float m = -INFINITY;
    for (int c = lane; c < n; c += 32) m = fmaxf(m, row[c]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.f;
    for (int c = lane; c < n; c += 32) {
      const float e = expf(row[c] - m);
      row[c] = e;
      sum += e;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    for (int c = lane; c < np; c += 32)
      row[c] = c < n ? row[c] / sum : 0.f;
  }

  // ---- O = P v, summed in fp32
  float o[RM][CPT];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) o[i][j] = 0.f;

  for (int kt0 = 0; kt0 < np; kt0 += KT) {
    __syncthreads();  // softmax done / previous V tile consumed
    for (int i = tid; i < KT * DA; i += NTHREADS) {
      const int c = i / DA, d = i % DA;
      const int gc = kt0 + c;
      KV[c * DA + d] = gc < n ? vh[(size_t)gc * DA + d] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < KT; ++c) {
      float p[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) p[i] = S[(ty * RM + i) * lds + kt0 + c];
      float vv[CPT];
#pragma unroll
      for (int j = 0; j < CPT; j += 4) {
        const float4 t4 = *reinterpret_cast<const float4*>(&KV[c * DA + tx * CPT + j]);
        vv[j] = t4.x; vv[j + 1] = t4.y; vv[j + 2] = t4.z; vv[j + 3] = t4.w;
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) o[i][j] = fmaf(p[i], vv[j], o[i][j]);
    }
  }

  float* oh = out + head;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int gr = q0 + ty * RM + i;
    if (gr >= n) continue;
#pragma unroll
    for (int j = 0; j < CPT; ++j) oh[(size_t)gr * DA + tx * CPT + j] = o[i][j];
  }
}

template <int QT, int DA>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias,
                   void* out, int nb, int na, int n, int causal, float scale,
                   cudaStream_t stream) {
  const int np = (n + KT - 1) / KT * KT;
  const size_t smem =
      sizeof(float) * ((size_t)DA * (QT + 4) + (size_t)DA * (KT + 4) + (size_t)QT * (np + 4));
  auto kernel = block_attention_fwd_kernel<QT, DA>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((n + QT - 1) / QT, na, nb);
  kernel<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      bias, static_cast<float*>(out), na, n, np, causal, scale);
  return cudaGetLastError();
}

template <int DA>
cudaError_t dispatch_qt(const void* q, const void* k, const void* v, const float* bias,
                        void* out, int nb, int na, int n, int causal, float scale,
                        cudaStream_t stream) {
  // QT * n fp32 scores must fit next to the Q and KV tiles: 64 rows up to
  // n = 256, 16 rows up to n = 1024 (both about 66 KB of scores)
  if (n <= 256) return launch<64, DA>(q, k, v, bias, out, nb, na, n, causal, scale, stream);
  return launch<16, DA>(q, k, v, bias, out, nb, na, n, causal, scale, stream);
}

// ---------------------------------------------------------------------------
// bf16, n <= 256: tensor cores
// ---------------------------------------------------------------------------

constexpr int MMA_QT = 64;        // query rows per block, 16 per warp
constexpr int MMA_THREADS = 128;  // 4 warps
constexpr int MMA_KT = 64;        // keys per shared-memory tile
constexpr int MMA_MAXN = 256;     // keys a warp's score registers hold

// Shared-memory layout (bf16): Qs[QT][DA+8] | Ks[KT][DA+8] | Vt[DA][KT+8].
// A row stride of 4 words more than a multiple of 32 puts the 8 rows x 4
// words of one fragment read on 32 distinct banks.
template <int DA>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) *
         ((size_t)MMA_QT * (DA + 8) + (size_t)MMA_KT * (DA + 8) + (size_t)DA * (MMA_KT + 8));
}

template <int DA>
__global__ void __launch_bounds__(MMA_THREADS)
block_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                           int na, int n, int causal, float scale) {
  constexpr int LDA = DA + 8;         // row stride of Qs and Ks
  constexpr int LDV = MMA_KT + 8;     // row stride of Vt
  constexpr int KSTEPS = DA / 16;     // k-steps of q.k^T
  constexpr int DTILES = DA / 8;      // 8-column tiles of the output
  constexpr int STILES = MMA_MAXN / 8;  // 8-key tiles of a score row block
  constexpr int CPR = DA / CH;        // 16-byte chunks per row

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + MMA_QT * LDA;
  __nv_bfloat16* Vt = Ks + MMA_KT * LDA;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * MMA_QT;
  const int a = blockIdx.y;
  const size_t head = ((size_t)blockIdx.z * na + a) * (size_t)n * DA;
  const float* bh = bias + (size_t)a * n * n;
  const int nkt = (n + MMA_KT - 1) / MMA_KT;
  const int r_lo = q0 + warp * 16 + g;  // the query rows of this lane's fragments
  const int r_hi = r_lo + 8;

  // ---- Q tile (rows past n are zero), then this warp's A fragments
  for (int i = tid; i < MMA_QT * CPR; i += MMA_THREADS) {
    const int r = i / CPR, c = (i % CPR) * CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < n) val = *reinterpret_cast<const uint4*>(q + head + (size_t)(q0 + r) * DA + c);
    *reinterpret_cast<uint4*>(Qs + r * LDA + c) = val;
  }
  __syncthreads();
  uint32_t qa[KSTEPS][4];
  const __nv_bfloat16* qw = Qs + warp * 16 * LDA + 2 * t;
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    qa[kk][0] = ld32(qw + g * LDA + kk * 16);
    qa[kk][1] = ld32(qw + (g + 8) * LDA + kk * 16);
    qa[kk][2] = ld32(qw + g * LDA + kk * 16 + 8);
    qa[kk][3] = ld32(qw + (g + 8) * LDA + kk * 16 + 8);
  }

  // ---- S = q k^T * scale + bias, causal fill, one 64-key tile at a time.
  // s[j] is the D fragment of keys 8j..8j+7; keys past n are -inf (not
  // keys at all), padding rows past n are 0 (never stored).
  float s[STILES][4];
#pragma unroll
  for (int kt = 0; kt < MMA_MAXN / MMA_KT; ++kt) {
    if (kt >= nkt) break;
    const int k0 = kt * MMA_KT;
    if (causal && k0 >= q0 + MMA_QT) {  // above the diagonal for every row of the block
#pragma unroll
      for (int j = 0; j < MMA_KT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[kt * 8 + j][e] = k0 + j * 8 + 2 * t + (e & 1) < n ? -1e4f : -INFINITY;
      }
      continue;  // block-uniform: every thread skips the barriers below alike
    }
    __syncthreads();  // previous readers of Ks are done
    for (int i = tid; i < MMA_KT * CPR; i += MMA_THREADS) {
      const int r = i / CPR, c = (i % CPR) * CH;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < n) val = *reinterpret_cast<const uint4*>(k + head + (size_t)(k0 + r) * DA + c);
      *reinterpret_cast<uint4*>(Ks + r * LDA + c) = val;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < MMA_KT / 8; ++j) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      const __nv_bfloat16* kr = Ks + (j * 8 + g) * LDA + 2 * t;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) mma_bf16(acc, qa[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e < 2 ? r_lo : r_hi;
        const int c = k0 + j * 8 + 2 * t + (e & 1);
        float x = -INFINITY;
        if (c < n) {
          x = 0.f;
          if (r < n) {
            x = acc[e] * scale + bh[(size_t)r * n + c];
            if (causal && c > r) x = -1e4f;
          }
        }
        s[kt * 8 + j][e] = x;
      }
    }
  }

  // ---- softmax of rows r_lo (e = 0, 1) and r_hi (e = 2, 3) in fp32: a row
  // lies across the 4 lanes of one quad
  float m_lo = -INFINITY, m_hi = -INFINITY;
#pragma unroll
  for (int j = 0; j < STILES; ++j) {
    if (j < nkt * 8) {
      m_lo = fmaxf(m_lo, fmaxf(s[j][0], s[j][1]));
      m_hi = fmaxf(m_hi, fmaxf(s[j][2], s[j][3]));
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    m_lo = fmaxf(m_lo, __shfl_xor_sync(0xffffffffu, m_lo, o));
    m_hi = fmaxf(m_hi, __shfl_xor_sync(0xffffffffu, m_hi, o));
  }
  float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
  for (int j = 0; j < STILES; ++j) {
    if (j < nkt * 8) {
      s[j][0] = expf(s[j][0] - m_lo);
      s[j][1] = expf(s[j][1] - m_lo);
      s[j][2] = expf(s[j][2] - m_hi);
      s[j][3] = expf(s[j][3] - m_hi);
      sum_lo += s[j][0] + s[j][1];
      sum_hi += s[j][2] + s[j][3];
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, o);
    sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, o);
  }
  // P rounded to bf16; p[j] = (row r_lo, row r_hi) halves of key tile j
  uint32_t p[STILES][2];
#pragma unroll
  for (int j = 0; j < STILES; ++j) {
    if (j < nkt * 8) {
      p[j][0] = pack_bf16(s[j][0] / sum_lo, s[j][1] / sum_lo);
      p[j][1] = pack_bf16(s[j][2] / sum_hi, s[j][3] / sum_hi);
    }
  }

  // ---- O = P v in fp32; V through shared memory transposed, one tile at a time
  float o[DTILES][4];
#pragma unroll
  for (int d = 0; d < DTILES; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
#pragma unroll
  for (int kt = 0; kt < MMA_MAXN / MMA_KT; ++kt) {
    if (kt >= nkt) break;
    const int k0 = kt * MMA_KT;
    __syncthreads();  // previous readers of Vt are done
    // neighbouring lanes take neighbouring keys: their 2-byte stores into a
    // Vt row then fall on distinct banks
    for (int i = tid; i < MMA_KT * CPR; i += MMA_THREADS) {
      const int r = i % MMA_KT, c = (i / MMA_KT) * CH;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < n) val = *reinterpret_cast<const uint4*>(v + head + (size_t)(k0 + r) * DA + c);
      const uint32_t w[4] = {val.x, val.y, val.z, val.w};
#pragma unroll
      for (int e = 0; e < CH; ++e)
        Vt[(c + e) * LDV + r] = __ushort_as_bfloat16((unsigned short)(w[e / 2] >> (16 * (e % 2))));
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < MMA_KT / 16; ++j) {
      const int i0 = kt * 8 + 2 * j;  // key tiles 16j.. and 16j+8.. of this tile
      const uint32_t pa[4] = {p[i0][0], p[i0][1], p[i0 + 1][0], p[i0 + 1][1]};
#pragma unroll
      for (int d = 0; d < DTILES; ++d) {
        const __nv_bfloat16* vr = Vt + (d * 8 + g) * LDV + j * 16 + 2 * t;
        mma_bf16(o[d], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

  __nv_bfloat16* oh = out + head;
#pragma unroll
  for (int d = 0; d < DTILES; ++d) {
    const int c = d * 8 + 2 * t;
    if (r_lo < n)
      *reinterpret_cast<__nv_bfloat162*>(oh + (size_t)r_lo * DA + c) =
          __floats2bfloat162_rn(o[d][0], o[d][1]);
    if (r_hi < n)
      *reinterpret_cast<__nv_bfloat162*>(oh + (size_t)r_hi * DA + c) =
          __floats2bfloat162_rn(o[d][2], o[d][3]);
  }
}

template <int DA>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const float* bias,
                       void* out, int nb, int na, int n, int causal, float scale,
                       cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<DA>();
  auto kernel = block_attention_mma_kernel<DA>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((n + MMA_QT - 1) / MMA_QT, na, nb);
  kernel<<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), bias, static_cast<__nv_bfloat16*>(out), na, n,
      causal, scale);
  return cudaGetLastError();
}


// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
inline int block_attention_fwd(const void* q, const void* k, const void* v,
                                       const float* bias, void* out, int nb, int na,
                                       int n, int da, int causal, int dtype, float scale,
                                       cudaStream_t stream) {
  if (n < 1 || n > 1024 || nb < 1 || na < 1 || nb > 65535 || na > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && n <= MMA_MAXN && da == 128)
    return (int)launch_mma<128>(q, k, v, bias, out, nb, na, n, causal, scale, stream);
  if (dtype == 1 && n <= MMA_MAXN && da == 64)
    return (int)launch_mma<64>(q, k, v, bias, out, nb, na, n, causal, scale, stream);
  if (dtype == 0 && da == 128)
    return (int)dispatch_qt<128>(q, k, v, bias, out, nb, na, n, causal, scale, stream);
  if (dtype == 0 && da == 64)
    return (int)dispatch_qt<64>(q, k, v, bias, out, nb, na, n, causal, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace lvt_fwd
