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
// on memory, so the bf16 kernel is bound by bytes (and by the L2 traffic of
// K, V and the bias, which each of a head's query tiles reads again); the
// fp32 kernel by the FMA pipes (67 TFLOP/s fp32).
//
// Two kernels, picked by dtype:
// * bf16, n <= 256 (DSFVT): one warpgroup per
//   (64 query rows, head, attention block), two blocks an SM. Thread 0 loads
//   every tile by TMA into 128-byte-swizzled shared memory, completing on
//   mbarriers: Q and the K chunks together, then each chunk's V into its K
//   buffer as soon as that chunk's q k^T is done, so V lands during the
//   later chunks' products and the softmax; the fp32 bias
//   (64 rows x 64 keys a tile) through a ring beside them (where n % 4 is
//   not 0, TMA cannot take the bias rows, and the bias is read from device
//   memory at the fragments' positions instead). q k^T is wgmma
//   m64n64k16 from shared memory, one 64 x 64 fp32 accumulator per 64-key
//   chunk: the whole 64 x 256 score block stays in registers (128 a
//   thread), so the softmax is exact. P, rounded to bf16, is the register A
//   operand of P.V as it stands (the accumulator and A layouts match), and
//   V is read as wgmma's transposed B from its row-major tile: nothing is
//   transposed by hand. Building blocks in hopper.cuh.
// * fp32, n <= 1024 (true fp32: no TF32 tensor-core path exists for it):
//   FMA register micro-tiles over shared-memory tiles (each
//   thread keeps a 4x4 block of S and a 4x8 block of O), with the whole
//   (QT, n) score row block in shared memory, so the softmax is exact there
//   too and nothing of S reaches device memory.
// In both, key tiles that the causal mask covers entirely for the block are
// filled with -1e4 without computing q.k (and, in bf16, without loading K).
//
// Shapes: q, k, v, out (nb, na, n, DA) contiguous; bias (na, n, n) fp32
// contiguous; n <= 1024 in fp32, n <= 256 in bf16; DA in {64, 128};
// q, k, v 16-byte aligned.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace lvt_fwd {
namespace {

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
// bf16, n <= 256: wgmma, tiles by TMA
// ---------------------------------------------------------------------------

constexpr int WG_THREADS = 128;  // one warpgroup: 64 query rows
constexpr int WG_MAXN = 256;     // keys the score accumulators hold (4 chunks of 64)
constexpr int BIAS_CHUNK = 64 * 64 * 4;  // one (64 rows, 64 keys) fp32 bias tile

template <int DA>
struct WgSmem {
  static constexpr int TILE = DA * 128;  // 64 rows x DA bf16
  static constexpr int NBIAS = DA == 64 ? 4 : 2;  // bias tiles in flight
  // Q | K or V chunks 0..3 | bias ring | mbarriers: 112 KB at DA = 128 (two
  // blocks an SM). No static shared memory: the dynamic block starts the
  // block's window, on the 1024-byte boundary the swizzle atoms need.
  static constexpr int BARS = 5 * TILE + NBIAS * BIAS_CHUNK;
  static constexpr int BYTES = BARS + 8 * (5 + NBIAS);
};

// fp32 bias element (r, c) of a (64, 64) tile loaded as two 32-column boxes
// with the 128-byte swizzle (16-byte chunks of a row XORed with r % 8)
__device__ __forceinline__ int bias_at(int r, int c) {
  const int cc = c & 31;
  return (c >> 5) * 64 * 32 + r * 32 + ((((cc >> 2) ^ (r & 7)) << 2) | (cc & 3));
}

// One warpgroup per (64 query rows, head, attention block). Thread 0 issues
// every load: Q, the K chunks the mask leaves and the first bias tiles at
// once; a chunk's V into its K buffer once that chunk's q k^T is done;
// later bias tiles into the ring as earlier ones are used. Each chunk's
// products are one wgmma stage (fence, products, commit, wait) under a
// block-uniform condition, so that no stage is cut by divergent code.
template <int DA>
__global__ void __launch_bounds__(WG_THREADS)
block_attention_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap,
                             const __grid_constant__ CUtensorMap bmap,
                             const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                             int na, int n, int causal, float scale) {
  using namespace lvt_hopper;
  using S = WgSmem<DA>;
  constexpr int KSTEPS = DA / 16;
  constexpr int HALVES = DA / 64;
  constexpr int HALF = 64 * TILE_ROW_BYTES;  // bytes of one 64-column half

  extern __shared__ __align__(1024) unsigned char tile_smem[];
  unsigned char* smem = tile_smem;
  if (smem_u32(smem) & 1023) __trap();  // the swizzle atoms need 1024-byte alignment
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t& bar_q = bars[0];
  uint64_t* bar_kv = bars + 1;
  uint64_t* bar_b = bars + 5;
  unsigned char* Qs = smem;
  unsigned char* KV = smem + S::TILE;
  float* Bs = reinterpret_cast<float*>(smem + 5 * S::TILE);

  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int qt = blockIdx.x, q0 = qt * 64, a = blockIdx.y;
  const int plane = blockIdx.z * na + a;
  const int nkt = (n + 63) / 64;
  const int kend = causal ? min(nkt, qt + 1) : nkt;  // chunks not wholly masked
  // TMA needs a bias row stride of a multiple of 16 bytes; other widths read
  // the bias from device memory at the fragments' positions
  const bool bias_tma = n % 4 == 0;
  const float* bh = bias + (size_t)a * n * n;

  auto load_bias = [&](int c) {
    float* dst = Bs + (c % S::NBIAS) * (BIAS_CHUNK / 4);
    uint64_t* bar = &bar_b[c % S::NBIAS];
    mbar_expect_tx(bar, BIAS_CHUNK);
    tma_load(dst, &bmap, bar, 64 * c, q0, a);
    tma_load(dst + 64 * 32, &bmap, bar, 64 * c + 32, q0, a);
  };
  if (tid == 0) {
    mbar_init(&bar_q, 1);
    for (int c = 0; c < 4; ++c) mbar_init(&bar_kv[c], 1);
    for (int c = 0; c < S::NBIAS; ++c) mbar_init(&bar_b[c], 1);
    fence_barrier_init();
    mbar_expect_tx(&bar_q, S::TILE);
    tma_tile<DA>(Qs, &qmap, &bar_q, q0, plane);
    for (int c = 0; c < kend; ++c) {
      mbar_expect_tx(&bar_kv[c], S::TILE);
      tma_tile<DA>(KV + c * S::TILE, &kmap, &bar_kv[c], 64 * c, plane);
    }
    for (int c = 0; bias_tma && c < kend && c < S::NBIAS; ++c) load_bias(c);
  }
  __syncthreads();

  // ---- per 64-key chunk: S = q k^T into its own 64 x 64 accumulator (a
  // wgmma stage of its own: fence, products, commit, wait), then scale,
  // bias and causal fill; the chunk's K buffer then takes its V and its bias
  // ring slot a later chunk's bias. Keys past n are -inf (not keys at all),
  // query rows past n are 0 (never stored).
  float s[4][32];
  mbar_wait(&bar_q, 0);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (c >= nkt) break;
    if (c < kend) {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[c][i] = 0.f;
      mbar_wait(&bar_kv[c], 0);
      fence_regs(s[c]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const int off = (kk / 4) * HALF + (kk % 4) * 32;
        wgmma_ss(s[c], desc(Qs + off), desc(KV + c * S::TILE + off));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s[c]);
      if (bias_tma) mbar_wait(&bar_b[c % S::NBIAS], (c / S::NBIAS) & 1);
      const float* B = Bs + (c % S::NBIAS) * (BIAS_CHUNK / 4);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int r = acc_row(2 * hi, w, g), cl = acc_col(j, 0, t);
          const int gr = q0 + r, gc = 64 * c + cl;
          const float2 b = bias_tma ? *reinterpret_cast<const float2*>(B + bias_at(r, cl))
                           : make_float2(gr < n && gc < n ? bh[(size_t)gr * n + gc] : 0.f,
                                         gr < n && gc + 1 < n ? bh[(size_t)gr * n + gc + 1] : 0.f);
#pragma unroll
          for (int e1 = 0; e1 < 2; ++e1) {
            const int col = gc + e1;
            float x = -INFINITY;
            if (col < n) {
              x = 0.f;
              if (gr < n) {
                x = s[c][4 * j + 2 * hi + e1] * scale + (e1 ? b.y : b.x);
                if (causal && col > gr) x = -1e4f;
              }
            }
            s[c][4 * j + 2 * hi + e1] = x;
          }
        }
      }
    } else {  // above the diagonal for every row of the tile
#pragma unroll
      for (int i = 0; i < 32; ++i)
        s[c][i] = 64 * c + acc_col(i / 4, i % 4, t) < n ? -1e4f : -INFINITY;
    }
    __syncthreads();  // every warp is done with chunk c's K and bias slot
    if (tid == 0) {
      fence_proxy_async();  // the bias slot was read by generic loads
      mbar_expect_tx(&bar_kv[c], S::TILE);
      tma_tile<DA>(KV + c * S::TILE, &vmap, &bar_kv[c], 64 * c, plane);
      if (bias_tma && c + S::NBIAS < kend) load_bias(c + S::NBIAS);
    }
  }

  // ---- softmax of rows lo (e = 0, 1) and hi (e = 2, 3) in fp32: a row lies
  // across the 4 lanes of one quad
  float m_lo = -INFINITY, m_hi = -INFINITY;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (c >= nkt) break;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      m_lo = fmaxf(m_lo, fmaxf(s[c][4 * j], s[c][4 * j + 1]));
      m_hi = fmaxf(m_hi, fmaxf(s[c][4 * j + 2], s[c][4 * j + 3]));
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    m_lo = fmaxf(m_lo, __shfl_xor_sync(0xffffffffu, m_lo, o));
    m_hi = fmaxf(m_hi, __shfl_xor_sync(0xffffffffu, m_hi, o));
  }
  float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (c >= nkt) break;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[c][4 * j] = expf(s[c][4 * j] - m_lo);
      s[c][4 * j + 1] = expf(s[c][4 * j + 1] - m_lo);
      s[c][4 * j + 2] = expf(s[c][4 * j + 2] - m_hi);
      s[c][4 * j + 3] = expf(s[c][4 * j + 3] - m_hi);
      sum_lo += s[c][4 * j] + s[c][4 * j + 1];
      sum_hi += s[c][4 * j + 2] + s[c][4 * j + 3];
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, o);
    sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, o);
  }
  // P rounded to bf16, straight into the A operand of P v
  uint32_t pa[4][4][4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (c >= nkt) break;
#pragma unroll
    for (int i = 0; i < 32; ++i) s[c][i] /= (i & 2) ? sum_hi : sum_lo;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a(pa[c][kk], s[c], kk);
  }

  // ---- O = P v in fp32; V is the transposed (MN-major) B operand
  float o[HALVES][32];
#pragma unroll
  for (int h = 0; h < HALVES; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[h][i] = 0.f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {  // one wgmma stage per chunk, as its V lands
    if (c >= nkt) break;
    mbar_wait(&bar_kv[c], c < kend ? 1 : 0);
#pragma unroll
    for (int h = 0; h < HALVES; ++h) fence_regs(o[h]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(pa[c][kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < HALVES; ++h)
        wgmma_rs_t(o[h], pa[c][kk], desc(KV + c * S::TILE + h * HALF + kk * 16 * TILE_ROW_BYTES));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < HALVES; ++h) fence_regs(o[h]);
  }

  __nv_bfloat16* oh = out + (size_t)plane * n * DA;
#pragma unroll
  for (int h = 0; h < HALVES; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int gr = q0 + acc_row(2 * hi, w, g);
        if (gr < n)
          *reinterpret_cast<__nv_bfloat162*>(oh + (size_t)gr * DA + 64 * h + acc_col(j, 0, t)) =
              __floats2bfloat162_rn(o[h][4 * j + 2 * hi], o[h][4 * j + 2 * hi + 1]);
      }
}

template <int DA>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, const float* bias,
                         void* out, int nb, int na, int n, int causal, float scale,
                         cudaStream_t stream) {
  using namespace lvt_hopper;
  CUtensorMap mq, mk, mv, mb;
  const uint64_t planes = (uint64_t)nb * na;
  if (!make_bf16_map(&mq, q, planes, n, DA) || !make_bf16_map(&mk, k, planes, n, DA) ||
      !make_bf16_map(&mv, v, planes, n, DA))
    return cudaErrorInvalidValue;
  mb = mq;  // unused where n % 4 != 0: the kernel then reads the bias without TMA
  if (n % 4 == 0 && !make_map(&mb, bias, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, na, n, n, 64, 32))
    return cudaErrorInvalidValue;
  constexpr int smem = WgSmem<DA>::BYTES;
  auto kernel = block_attention_wgmma_kernel<DA>;
  cudaError_t err = set_smem_max(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((n + 63) / 64, na, nb), WG_THREADS, smem, stream>>>(
      mq, mk, mv, mb, bias, static_cast<__nv_bfloat16*>(out), na, n, causal, scale);
  return cudaGetLastError();
}


// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
inline int block_attention_fwd(const void* q, const void* k, const void* v,
                                       const float* bias, void* out, int nb, int na,
                                       int n, int da, int causal, int dtype, float scale,
                                       cudaStream_t stream) {
  if (n < 1 || n > 1024 || nb < 1 || na < 1 || nb > 65535 || na > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && n > WG_MAXN) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && da == 128)
    return (int)launch_wgmma<128>(q, k, v, bias, out, nb, na, n, causal, scale, stream);
  if (dtype == 1 && da == 64)
    return (int)launch_wgmma<64>(q, k, v, bias, out, nb, na, n, causal, scale, stream);
  if (dtype == 0 && da == 128)
    return (int)dispatch_qt<128>(q, k, v, bias, out, nb, na, n, causal, scale, stream);
  if (dtype == 0 && da == 64)
    return (int)dispatch_qt<64>(q, k, v, bias, out, nb, na, n, causal, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace lvt_fwd
