#pragma once
// Block-local attention backward (recompute; device code and launcher: the C
// entry point is in block_attention_bwd.cu, and fused_layer.cu launches the same
// kernels): from q, k, v, bias and the
// output cotangent g, per (attention block, head)
//   s  = q k^T * scale + bias, -1e4 where causal-masked (after the bias)
//   p  = softmax(s) in fp32
//   dv = p_io^T g            (p rounded to the io dtype first)
//   dp = g v^T
//   ds = p * (dp - rowsum(dp * p)) in fp32, 0 where masked
//   dq = ds_io k * scale,  dk = ds_io^T q * scale   (ds rounded to io dtype)
//   dbias = sum over the nb blocks of ds, in fp32, unrounded.
//
// Replaces the TPU kernel lvt_tpu/ops/attention.py:attention_core_pallas_bwd
// (its pl.pallas_call at :263), which holds one block's whole (n, n) problem
// in VMEM and accumulates dbias by revisiting one output block along its
// sequential grid.
//
// What bounds it on the H100: at DSFVT training shapes (nb = 64, na = 8,
// n = 256, da = 128) one call is ~43 GFLOP of products (q k^T twice, g v^T
// three times, p^T g, ds k, ds^T q) over ~67 MB of bf16 inputs and outputs,
// plus a 134 MB fp32 scratch of per-block dbias terms written once and read
// once. Both are far from the roofs: the simple design below is bound by
// latency (barriers around each shared-memory tile, no copy overlap).
//
// Design (three kernels, no atomics, so every output is bit-identical from
// call to call):
// 1. Query-tile kernel, one block per (query tile, head, attention block).
//    It needs whole rows: rowsum(dp * p) must use the fp32 p of the full
//    256-key row, as the TPU kernel does (flash attention's shortcut
//    rowsum(dO * O) reads the output, which was rounded through p_io, and is
//    a different number in bf16). The tile's (rows, n) score block lives in
//    shared memory in fp32: scores, then the softmax in place. A first pass
//    over the key tiles sums dp * p per row; a second recomputes dp, forms
//    ds, writes it to the per-block dbias scratch and accumulates dq. The
//    row statistics (max, sum, rowsum(dp * p)) go to device memory.
// 2. Key-tile kernel, one block per (key tile, head, attention block). dk
//    and dv sum over all query rows, so they stay in registers while the
//    block walks the query tiles, recomputing p and ds for its keys from
//    the row statistics (the (n, n) block, 256 KB in fp32, never exists).
// 3. dbias: a reduction over the nb per-block terms in a fixed order (an
//    fp32 atomicAdd would change dbias from run to run).
// In bf16 (n <= 256) the products run on tensor cores (mma.sync m16n8k16,
// bf16 in, fp32 accumulate), with the fragment layout of block_attention.cu;
// in fp32 (n <= 1024) on FMAs, since TF32 would round the inputs to 10 bits.
// Key tiles that the causal mask covers entirely are skipped: their p is
// exp(-1e4 - rowmax) / rowsum, exactly 0 in fp32 unless a row's largest
// score is below -9,896, and their ds is 0 by definition.
//
// Shapes: q, k, v, g, dq, dk, dv (nb, na, n, DA) contiguous in the io dtype;
// bias and dbias (na, n, n) fp32; stats (3, nb, na, n) fp32 and part
// (nb, na, n, n) fp32 scratch; DA in {64, 128}; n <= 1024 in fp32, n <= 256
// in bf16.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace lvt_bwd {
namespace {

using lvt_mma::CH;
using lvt_mma::ld32;
using lvt_mma::load_a;
using lvt_mma::mma_bf16;
using lvt_mma::pack_bf16;

constexpr int NTHREADS = 256;  // fp32 kernels
constexpr int QT = 16;         // fp32 query-tile kernel: rows per block
constexpr int KT = 64;         // fp32 query-tile kernel: keys per shared tile
constexpr int KB = 16;         // fp32 key-tile kernel: keys per block
constexpr int RT = 64;         // fp32 key-tile kernel: query rows per shared tile

__device__ __forceinline__ size_t stat_index(int s, int blk, int nb, int na, int a, int n,
                                             int row) {
  return (((size_t)s * nb + blk) * na + a) * (size_t)n + row;
}

// ---------------------------------------------------------------------------
// fp32: FMA
// ---------------------------------------------------------------------------

// Shared memory (floats): Qs[QT][DA] | Gs[QT][DA] | KV[KT][DA+1] | S[QT][lds] | DP[QT][lds]
template <int DA>
__global__ void __launch_bounds__(NTHREADS)
bwd_rows_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ bias,
             const float* __restrict__ g, float* __restrict__ dq,
             float* __restrict__ stats, float* __restrict__ part, int nb, int na, int n,
             int np, int causal, float scale) {
  constexpr int LDK = DA + 1;
  const int lds = np + 1;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Gs = Qs + QT * DA;
  float* KV = Gs + QT * DA;
  float* S = KV + KT * LDK;
  float* DP = S + QT * lds;

  const int tid = threadIdx.x, tx = tid % 16, r = tid / 16;  // r: this thread's row
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * QT, a = blockIdx.y, blk = blockIdx.z;
  const size_t head = ((size_t)blk * na + a) * (size_t)n * DA;
  const float* bh = bias + (size_t)a * n * n;
  const int gr = q0 + r;

  for (int i = tid; i < QT * DA; i += NTHREADS) {
    const int rr = i / DA, d = i % DA;
    const bool in = q0 + rr < n;
    Qs[i] = in ? q[head + (size_t)(q0 + rr) * DA + d] : 0.f;
    Gs[i] = in ? g[head + (size_t)(q0 + rr) * DA + d] : 0.f;
  }

  // ---- S = q k^T * scale + bias (causal fill), and DP = g v^T, tile by tile
  for (int pass = 0; pass < 2; ++pass) {
    const float* src = pass == 0 ? k : v;
    const float* A = pass == 0 ? Qs : Gs;
    float* out = pass == 0 ? S : DP;
    for (int kt0 = 0; kt0 < np; kt0 += KT) {
      __syncthreads();  // previous readers of KV are done
      for (int i = tid; i < KT * DA; i += NTHREADS) {
        const int c = i / DA, d = i % DA;
        KV[c * LDK + d] = kt0 + c < n ? src[head + (size_t)(kt0 + c) * DA + d] : 0.f;
      }
      __syncthreads();
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int d = 0; d < DA; ++d) {
        const float x = A[r * DA + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j] = fmaf(x, KV[(tx + 16 * j) * LDK + d], acc[j]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = kt0 + tx + 16 * j;
        float x = 0.f;
        if (gr < n && c < n) {
          if (pass == 0) {
            x = acc[j] * scale + bh[(size_t)gr * n + c];
            if (causal && c > gr) x = -1e4f;
          } else {
            x = acc[j];
          }
        }
        out[r * lds + c] = x;
      }
    }
  }
  __syncthreads();

  // ---- per row (one warp per row): softmax in place, then D = rowsum(dp * p)
  //      and ds = p * (dp - D), 0 where masked; ds goes to S and to the scratch
  for (int rr = warp; rr < QT; rr += NTHREADS / 32) {
    float* row = S + rr * lds;
    const float* dpr = DP + rr * lds;
    const int grr = q0 + rr;
    if (grr >= n) {
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
    float dsum = 0.f;
    for (int c = lane; c < n; c += 32) {
      const float p = row[c] / sum;
      row[c] = p;
      dsum += dpr[c] * p;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) dsum += __shfl_xor_sync(0xffffffffu, dsum, o);
    float* ph = part + (((size_t)blk * na + a) * n + grr) * (size_t)n;
    for (int c = lane; c < np; c += 32) {
      float ds = 0.f;
      if (c < n && !(causal && c > grr)) ds = row[c] * (dpr[c] - dsum);
      row[c] = ds;
      if (c < n) ph[c] = ds;
    }
    if (lane == 0) {
      stats[stat_index(0, blk, nb, na, a, n, grr)] = m;
      stats[stat_index(1, blk, nb, na, a, n, grr)] = sum;
      stats[stat_index(2, blk, nb, na, a, n, grr)] = dsum;
    }
  }

  // ---- dq = ds k * scale; each thread owns row r, columns tx + 16 j
  constexpr int CPT = DA / 16;
  float acc[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) acc[j] = 0.f;
  for (int kt0 = 0; kt0 < np; kt0 += KT) {
    __syncthreads();
    for (int i = tid; i < KT * DA; i += NTHREADS) {
      const int c = i / DA, d = i % DA;
      KV[c * LDK + d] = kt0 + c < n ? k[head + (size_t)(kt0 + c) * DA + d] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < KT; ++c) {
      const float ds = S[r * lds + kt0 + c];
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[j] = fmaf(ds, KV[c * LDK + tx + 16 * j], acc[j]);
    }
  }
  if (gr < n) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) dq[head + (size_t)gr * DA + tx + 16 * j] = acc[j] * scale;
  }
}

// Shared memory (floats): Ks[KB][DA] | Vs[KB][DA] | Qt[RT][DA+1] | Gt[RT][DA+1]
//                         | PT[KB][RT] | DT[KB][RT] | Ms[RT] | Ls[RT] | Ds[RT]
template <int DA>
__global__ void __launch_bounds__(NTHREADS)
bwd_keys_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ bias,
             const float* __restrict__ g, float* __restrict__ dk, float* __restrict__ dv,
             const float* __restrict__ stats, int nb, int na, int n, int causal,
             float scale) {
  constexpr int LDQ = DA + 1;
  constexpr int CPT = DA / 16;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + KB * DA;
  float* Qt = Vs + KB * DA;
  float* Gt = Qt + RT * LDQ;
  float* PT = Gt + RT * LDQ;
  float* DT = PT + KB * RT;
  float* Ms = DT + KB * RT;
  float* Ls = Ms + RT;
  float* Ds = Ls + RT;

  const int tid = threadIdx.x, tx = tid % 16, i = tid / 16;  // i: this thread's key
  const int k0 = blockIdx.x * KB, a = blockIdx.y, blk = blockIdx.z;
  const size_t head = ((size_t)blk * na + a) * (size_t)n * DA;
  const float* bh = bias + (size_t)a * n * n;
  const int key = k0 + i;

  for (int e = tid; e < KB * DA; e += NTHREADS) {
    const int c = e / DA, d = e % DA;
    const bool in = k0 + c < n;
    Ks[e] = in ? k[head + (size_t)(k0 + c) * DA + d] : 0.f;
    Vs[e] = in ? v[head + (size_t)(k0 + c) * DA + d] : 0.f;
  }

  float ak[CPT], av[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) ak[j] = av[j] = 0.f;

  for (int r0 = 0; r0 < n; r0 += RT) {
    if (causal && r0 + RT <= k0) continue;  // every row precedes every key: masked
    __syncthreads();  // previous readers of Qt, Gt, PT, DT are done
    for (int e = tid; e < RT * DA; e += NTHREADS) {
      const int rr = e / DA, d = e % DA;
      const bool in = r0 + rr < n;
      Qt[rr * LDQ + d] = in ? q[head + (size_t)(r0 + rr) * DA + d] : 0.f;
      Gt[rr * LDQ + d] = in ? g[head + (size_t)(r0 + rr) * DA + d] : 0.f;
    }
    for (int e = tid; e < RT; e += NTHREADS) {
      const bool in = r0 + e < n;
      Ms[e] = in ? stats[stat_index(0, blk, nb, na, a, n, r0 + e)] : 0.f;
      Ls[e] = in ? stats[stat_index(1, blk, nb, na, a, n, r0 + e)] : 1.f;
      Ds[e] = in ? stats[stat_index(2, blk, nb, na, a, n, r0 + e)] : 0.f;
    }
    __syncthreads();

    // p and ds for key i and rows tx + 16 j of the tile
    float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int d = 0; d < DA; ++d) {
      const float kk = Ks[i * DA + d], vv = Vs[i * DA + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[j] = fmaf(kk, Qt[(tx + 16 * j) * LDQ + d], s[j]);
        dp[j] = fmaf(vv, Gt[(tx + 16 * j) * LDQ + d], dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int rl = tx + 16 * j, row = r0 + rl;
      float p = 0.f, ds = 0.f;
      if (row < n && key < n) {
        const bool masked = causal && key > row;
        const float x = masked ? -1e4f : s[j] * scale + bh[(size_t)row * n + key];
        p = expf(x - Ms[rl]) / Ls[rl];
        if (!masked) ds = p * (dp[j] - Ds[rl]);
      }
      PT[i * RT + rl] = p;
      DT[i * RT + rl] = ds;
    }
    __syncthreads();

    // dv += p^T g, dk += ds^T q over the tile's rows
#pragma unroll 4
    for (int rl = 0; rl < RT; ++rl) {
      const float p = PT[i * RT + rl], ds = DT[i * RT + rl];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        av[j] = fmaf(p, Gt[rl * LDQ + tx + 16 * j], av[j]);
        ak[j] = fmaf(ds, Qt[rl * LDQ + tx + 16 * j], ak[j]);
      }
    }
  }
  if (key < n) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      dv[head + (size_t)key * DA + tx + 16 * j] = av[j];
      dk[head + (size_t)key * DA + tx + 16 * j] = ak[j] * scale;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16, n <= 256: tensor cores
// ---------------------------------------------------------------------------

constexpr int MT = 64;        // rows (query-tile kernel) or keys (key-tile kernel) per block
constexpr int MTHREADS = 128; // 4 warps, 16 rows or keys each
constexpr int MKT = 64;       // keys or query rows per shared-memory tile

// rows [r0, r0 + MKT) of a (n, DA) bf16 matrix into a row-major tile
// (rows past n are zero)
template <int DA>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, int ld,
                                          const __nv_bfloat16* src, int r0, int n) {
  constexpr int CPR = DA / CH;
  for (int i = threadIdx.x; i < MKT * CPR; i += MTHREADS) {
    const int r = i / CPR, c = (i % CPR) * CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n) val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * DA + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// the same rows transposed: dst[d][r]; neighbouring lanes take neighbouring
// rows, so their 2-byte stores into one dst row fall on distinct banks
template <int DA>
__device__ __forceinline__ void load_rows_t(__nv_bfloat16* dst, int ld,
                                            const __nv_bfloat16* src, int r0, int n) {
  constexpr int CPR = DA / CH;
  for (int i = threadIdx.x; i < MKT * CPR; i += MTHREADS) {
    const int r = i % MKT, c = (i / MKT) * CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n) val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * DA + c);
    const uint32_t w[4] = {val.x, val.y, val.z, val.w};
#pragma unroll
    for (int e = 0; e < CH; ++e)
      dst[(c + e) * ld + r] = __ushort_as_bfloat16((unsigned short)(w[e / 2] >> (16 * (e % 2))));
  }
}

template <int DA>
constexpr size_t rows_mma_smem_bytes(int np) {
  return sizeof(__nv_bfloat16) * (3 * (size_t)MT * (DA + 8) + (size_t)DA * (MKT + 8)) +
         sizeof(float) * (size_t)MT * (np + 4);
}

// Query-tile kernel. Shared memory: Qs, Gs, KV [64][DA+8] bf16 | Kt [DA][72]
// bf16 | S [64][np+4] fp32 (scores, then p).
template <int DA>
__global__ void __launch_bounds__(MTHREADS)
bwd_rows_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
             const __nv_bfloat16* __restrict__ g, __nv_bfloat16* __restrict__ dq,
             float* __restrict__ stats, float* __restrict__ part, int nb, int na, int n,
             int causal, float scale) {
  constexpr int LDA = DA + 8;
  constexpr int LDT = MKT + 8;
  constexpr int KSTEPS = DA / 16;
  constexpr int DTILES = DA / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Gs = Qs + MT * LDA;
  __nv_bfloat16* KV = Gs + MT * LDA;
  __nv_bfloat16* Kt = KV + MT * LDA;
  float* S = reinterpret_cast<float*>(Kt + DA * LDT);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * MT, a = blockIdx.y, blk = blockIdx.z;
  const size_t head = ((size_t)blk * na + a) * (size_t)n * DA;
  const float* bh = bias + (size_t)a * n * n;
  const int nkt = (n + MKT - 1) / MKT;
  const int np = nkt * MKT;
  const int lds = np + 4;
  const int wr = warp * 16;                // this warp's first row in the tile
  const int r_lo = q0 + wr + g8, r_hi = r_lo + 8;
  float* part_h = part + ((size_t)blk * na + a) * (size_t)n * n;

  load_rows<DA>(Qs, LDA, q + head, q0, n);
  load_rows<DA>(Gs, LDA, g + head, q0, n);

  // ---- S = q k^T * scale + bias, causal fill; keys past n are -inf
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * MKT;
    if (causal && k0 >= q0 + MT) {
      for (int i = tid; i < MT * MKT; i += MTHREADS) {
        const int r = i / MKT, c = k0 + i % MKT;
        S[r * lds + c] = c < n ? -1e4f : -INFINITY;
      }
      continue;  // block-uniform
    }
    __syncthreads();  // previous readers of KV are done
    load_rows<DA>(KV, LDA, k + head, k0, n);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < MKT / 8; ++j) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      const __nv_bfloat16* kr = KV + (j * 8 + g8) * LDA + 2 * t;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t fa[4];
        load_a(fa, Qs + wr * LDA, LDA, kk, g8, t);
        mma_bf16(acc, fa, ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
      }
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
        S[(r - q0) * lds + c] = x;
      }
    }
  }
  __syncthreads();

  // ---- softmax in place, one warp per row (each warp takes its own 16 rows)
  for (int rr = wr; rr < wr + 16; ++rr) {
    float* row = S + rr * lds;
    const int gr = q0 + rr;
    if (gr >= n) {
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
    for (int c = lane; c < np; c += 32) row[c] = c < n ? row[c] / sum : 0.f;
    if (lane == 0) {
      stats[stat_index(0, blk, nb, na, a, n, gr)] = m;
      stats[stat_index(1, blk, nb, na, a, n, gr)] = sum;
    }
  }
  __syncwarp();

  // ---- D = rowsum(dp * p) for rows r_lo, r_hi (dp = g v^T, not stored)
  float d_lo = 0.f, d_hi = 0.f;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * MKT;
    if (causal && k0 >= q0 + MT) continue;
    __syncthreads();
    load_rows<DA>(KV, LDA, v + head, k0, n);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < MKT / 8; ++j) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      const __nv_bfloat16* vr = KV + (j * 8 + g8) * LDA + 2 * t;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t fa[4];
        load_a(fa, Gs + wr * LDA, LDA, kk, g8, t);
        mma_bf16(acc, fa, ld32(vr + kk * 16), ld32(vr + kk * 16 + 8));
      }
      const int c = k0 + j * 8 + 2 * t;
      d_lo += acc[0] * S[(wr + g8) * lds + c] + acc[1] * S[(wr + g8) * lds + c + 1];
      d_hi += acc[2] * S[(wr + g8 + 8) * lds + c] + acc[3] * S[(wr + g8 + 8) * lds + c + 1];
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {  // a row lies across the 4 lanes of a quad
    d_lo += __shfl_xor_sync(0xffffffffu, d_lo, o);
    d_hi += __shfl_xor_sync(0xffffffffu, d_hi, o);
  }
  if (t == 0) {
    if (r_lo < n) stats[stat_index(2, blk, nb, na, a, n, r_lo)] = d_lo;
    if (r_hi < n) stats[stat_index(2, blk, nb, na, a, n, r_hi)] = d_hi;
  }

  // ---- ds = p (dp - D), 0 where masked; to the dbias scratch; dq += ds_io k
  float o[DTILES][4];
#pragma unroll
  for (int d = 0; d < DTILES; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * MKT;
    if (causal && k0 >= q0 + MT) {  // masked tile: ds = 0
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e < 2 ? r_lo : r_hi;
        if (r >= n) continue;
        for (int c = k0 + 2 * t + (e & 1); c < k0 + MKT && c < n; c += 8)
          part_h[(size_t)r * n + c] = 0.f;
      }
      continue;
    }
    __syncthreads();
    load_rows<DA>(KV, LDA, v + head, k0, n);
    load_rows_t<DA>(Kt, LDT, k + head, k0, n);
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < MKT / 16; ++jj) {
      uint32_t fds[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 2 * jj + h;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        const __nv_bfloat16* vr = KV + (j * 8 + g8) * LDA + 2 * t;
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
          uint32_t fa[4];
          load_a(fa, Gs + wr * LDA, LDA, kk, g8, t);
          mma_bf16(acc, fa, ld32(vr + kk * 16), ld32(vr + kk * 16 + 8));
        }
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e < 2 ? r_lo : r_hi;
          const int c = k0 + j * 8 + 2 * t + (e & 1);
          const float p = S[(r - q0) * lds + c];
          ds[e] = 0.f;
          if (r < n && c < n && !(causal && c > r)) ds[e] = p * (acc[e] - (e < 2 ? d_lo : d_hi));
          if (r < n && c < n) part_h[(size_t)r * n + c] = ds[e];
        }
        fds[2 * h] = pack_bf16(ds[0], ds[1]);
        fds[2 * h + 1] = pack_bf16(ds[2], ds[3]);
      }
      // A fragment of ds (16 rows x keys 16jj..16jj+15): tiles 2jj and 2jj+1
      const uint32_t fa[4] = {fds[0], fds[1], fds[2], fds[3]};
#pragma unroll
      for (int d = 0; d < DTILES; ++d) {
        const __nv_bfloat16* kr = Kt + (d * 8 + g8) * LDT + jj * 16 + 2 * t;
        mma_bf16(o[d], fa, ld32(kr), ld32(kr + 8));
      }
    }
  }

  __nv_bfloat16* dqh = dq + head;
#pragma unroll
  for (int d = 0; d < DTILES; ++d) {
    const int c = d * 8 + 2 * t;
    if (r_lo < n)
      *reinterpret_cast<__nv_bfloat162*>(dqh + (size_t)r_lo * DA + c) =
          __floats2bfloat162_rn(o[d][0] * scale, o[d][1] * scale);
    if (r_hi < n)
      *reinterpret_cast<__nv_bfloat162*>(dqh + (size_t)r_hi * DA + c) =
          __floats2bfloat162_rn(o[d][2] * scale, o[d][3] * scale);
  }
}

template <int DA>
constexpr size_t keys_mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (4 * (size_t)MT * (DA + 8) + 2 * (size_t)DA * (MKT + 8)) +
         sizeof(float) * 3 * MKT;
}

// Key-tile kernel. Shared memory: Ks, Vs, Qs, Gs [64][DA+8] bf16 | Qt, Gt
// [DA][72] bf16 | Ms, Ls, Ds [64] fp32. Each warp owns 16 keys; their dk and
// dv sit in registers while the block walks the query tiles.
template <int DA>
__global__ void __launch_bounds__(MTHREADS)
bwd_keys_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
             const __nv_bfloat16* __restrict__ g, __nv_bfloat16* __restrict__ dk,
             __nv_bfloat16* __restrict__ dv, const float* __restrict__ stats, int nb, int na,
             int n, int causal, float scale) {
  constexpr int LDA = DA + 8;
  constexpr int LDT = MKT + 8;
  constexpr int KSTEPS = DA / 16;
  constexpr int DTILES = DA / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + MT * LDA;
  __nv_bfloat16* Qs = Vs + MT * LDA;
  __nv_bfloat16* Gs = Qs + MKT * LDA;
  __nv_bfloat16* Qt = Gs + MKT * LDA;
  __nv_bfloat16* Gt = Qt + DA * LDT;
  float* Ms = reinterpret_cast<float*>(Gt + DA * LDT);
  float* Ls = Ms + MKT;
  float* Ds = Ls + MKT;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, t = lane % 4;
  const int k0 = blockIdx.x * MT, a = blockIdx.y, blk = blockIdx.z;
  const size_t head = ((size_t)blk * na + a) * (size_t)n * DA;
  const float* bh = bias + (size_t)a * n * n;
  const int wk = warp * 16;  // this warp's first key in the tile
  const int c_lo = k0 + wk + g8, c_hi = c_lo + 8;

  load_rows<DA>(Ks, LDA, k + head, k0, n);
  load_rows<DA>(Vs, LDA, v + head, k0, n);

  float ak[DTILES][4], av[DTILES][4];
#pragma unroll
  for (int d = 0; d < DTILES; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) ak[d][e] = av[d][e] = 0.f;

  for (int r0 = 0; r0 < n; r0 += MKT) {
    if (causal && r0 + MKT <= k0) continue;  // block-uniform: all masked
    __syncthreads();  // previous readers of the row tiles are done
    load_rows<DA>(Qs, LDA, q + head, r0, n);
    load_rows<DA>(Gs, LDA, g + head, r0, n);
    load_rows_t<DA>(Qt, LDT, q + head, r0, n);
    load_rows_t<DA>(Gt, LDT, g + head, r0, n);
    for (int e = tid; e < MKT; e += MTHREADS) {
      const bool in = r0 + e < n;
      Ms[e] = in ? stats[stat_index(0, blk, nb, na, a, n, r0 + e)] : 0.f;
      Ls[e] = in ? stats[stat_index(1, blk, nb, na, a, n, r0 + e)] : 1.f;
      Ds[e] = in ? stats[stat_index(2, blk, nb, na, a, n, r0 + e)] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int ch = 0; ch < MKT / 16; ++ch) {  // 16 query rows per step
      uint32_t fp[4], fds[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rt = ch * 16 + h * 8;  // first row (in the tile) of this 8-row tile
        float sacc[4] = {0.f, 0.f, 0.f, 0.f}, dacc[4] = {0.f, 0.f, 0.f, 0.f};
        const __nv_bfloat16* qr = Qs + (rt + g8) * LDA + 2 * t;
        const __nv_bfloat16* gr = Gs + (rt + g8) * LDA + 2 * t;
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
          uint32_t fa[4];
          load_a(fa, Ks + wk * LDA, LDA, kk, g8, t);
          mma_bf16(sacc, fa, ld32(qr + kk * 16), ld32(qr + kk * 16 + 8));
          load_a(fa, Vs + wk * LDA, LDA, kk, g8, t);
          mma_bf16(dacc, fa, ld32(gr + kk * 16), ld32(gr + kk * 16 + 8));
        }
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = e < 2 ? c_lo : c_hi;           // key
          const int rl = rt + 2 * t + (e & 1), r = r0 + rl;  // query row
          p[e] = 0.f;
          ds[e] = 0.f;
          if (r < n && c < n) {
            const bool masked = causal && c > r;
            const float x = masked ? -1e4f : sacc[e] * scale + bh[(size_t)r * n + c];
            p[e] = expf(x - Ms[rl]) / Ls[rl];
            if (!masked) ds[e] = p[e] * (dacc[e] - Ds[rl]);
          }
        }
        fp[2 * h] = pack_bf16(p[0], p[1]);
        fp[2 * h + 1] = pack_bf16(p[2], p[3]);
        fds[2 * h] = pack_bf16(ds[0], ds[1]);
        fds[2 * h + 1] = pack_bf16(ds[2], ds[3]);
      }
#pragma unroll
      for (int d = 0; d < DTILES; ++d) {
        const __nv_bfloat16* gtr = Gt + (d * 8 + g8) * LDT + ch * 16 + 2 * t;
        const __nv_bfloat16* qtr = Qt + (d * 8 + g8) * LDT + ch * 16 + 2 * t;
        mma_bf16(av[d], fp, ld32(gtr), ld32(gtr + 8));
        mma_bf16(ak[d], fds, ld32(qtr), ld32(qtr + 8));
      }
    }
  }

#pragma unroll
  for (int d = 0; d < DTILES; ++d) {
    const int c = d * 8 + 2 * t;
    if (c_lo < n) {
      *reinterpret_cast<__nv_bfloat162*>(dv + head + (size_t)c_lo * DA + c) =
          __floats2bfloat162_rn(av[d][0], av[d][1]);
      *reinterpret_cast<__nv_bfloat162*>(dk + head + (size_t)c_lo * DA + c) =
          __floats2bfloat162_rn(ak[d][0] * scale, ak[d][1] * scale);
    }
    if (c_hi < n) {
      *reinterpret_cast<__nv_bfloat162*>(dv + head + (size_t)c_hi * DA + c) =
          __floats2bfloat162_rn(av[d][2], av[d][3]);
      *reinterpret_cast<__nv_bfloat162*>(dk + head + (size_t)c_hi * DA + c) =
          __floats2bfloat162_rn(ak[d][2] * scale, ak[d][3] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// dbias = sum over blocks of part, in block order
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256)
dbias_reduce(const float* __restrict__ part, float* __restrict__ dbias, int nb, size_t per) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < per;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int b = 0; b < nb; ++b) s += part[(size_t)b * per + i];
    dbias[i] = s;
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int DA>
cudaError_t launch_f32(const float* q, const float* k, const float* v, const float* bias,
                       const float* g, float* dq, float* dk, float* dv, float* stats,
                       float* part, int nb, int na, int n, int causal, float scale,
                       cudaStream_t stream) {
  const int np = (n + KT - 1) / KT * KT;
  const size_t rows_smem =
      sizeof(float) * (2 * (size_t)QT * DA + (size_t)KT * (DA + 1) + 2 * (size_t)QT * (np + 1));
  cudaError_t err = set_smem(bwd_rows_f32<DA>, rows_smem);
  if (err != cudaSuccess) return err;
  bwd_rows_f32<DA><<<dim3((n + QT - 1) / QT, na, nb), NTHREADS, rows_smem, stream>>>(
      q, k, v, bias, g, dq, stats, part, nb, na, n, np, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t keys_smem = sizeof(float) * (2 * (size_t)KB * DA + 2 * (size_t)RT * (DA + 1) +
                                            2 * (size_t)KB * RT + 3 * (size_t)RT);
  err = set_smem(bwd_keys_f32<DA>, keys_smem);
  if (err != cudaSuccess) return err;
  bwd_keys_f32<DA><<<dim3((n + KB - 1) / KB, na, nb), NTHREADS, keys_smem, stream>>>(
      q, k, v, bias, g, dk, dv, stats, nb, na, n, causal, scale);
  return cudaGetLastError();
}

template <int DA>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const float* bias,
                       const void* g, void* dq, void* dk, void* dv, float* stats,
                       float* part, int nb, int na, int n, int causal, float scale,
                       cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const int np = (n + MKT - 1) / MKT * MKT;
  const size_t rows_smem = rows_mma_smem_bytes<DA>(np);
  cudaError_t err = set_smem(bwd_rows_mma<DA>, rows_smem);
  if (err != cudaSuccess) return err;
  bwd_rows_mma<DA><<<dim3((n + MT - 1) / MT, na, nb), MTHREADS, rows_smem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v), bias,
      static_cast<const bf*>(g), static_cast<bf*>(dq), stats, part, nb, na, n, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr size_t keys_smem = keys_mma_smem_bytes<DA>();
  err = set_smem(bwd_keys_mma<DA>, keys_smem);
  if (err != cudaSuccess) return err;
  bwd_keys_mma<DA><<<dim3((n + MT - 1) / MT, na, nb), MTHREADS, keys_smem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v), bias,
      static_cast<const bf*>(g), static_cast<bf*>(dk), static_cast<bf*>(dv), stats, nb, na, n,
      causal, scale);
  return cudaGetLastError();
}


// dtype: 0 = float32, 1 = bfloat16. Launches the query-tile, key-tile and
// dbias kernels on `stream`; returns the first failing cudaError_t, or 0.
// stats (3 * nb * na * n floats) and part (nb * na * n * n floats) are
// scratch the caller allocates.
inline int block_attention_bwd(const void* q, const void* k, const void* v,
                                       const float* bias, const void* g, void* dq, void* dk,
                                       void* dv, float* dbias, float* stats, float* part,
                                       int nb, int na, int n, int da, int causal, int dtype,
                                       float scale, cudaStream_t stream) {
  if (n < 1 || n > 1024 || nb < 1 || na < 1 || nb > 65535 || na > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (dtype == 1 && n <= 256 && da == 128)
    err = launch_mma<128>(q, k, v, bias, g, dq, dk, dv, stats, part, nb, na, n, causal, scale,
                          stream);
  else if (dtype == 1 && n <= 256 && da == 64)
    err = launch_mma<64>(q, k, v, bias, g, dq, dk, dv, stats, part, nb, na, n, causal, scale,
                         stream);
  else if (dtype == 0 && (da == 128 || da == 64)) {
    const float* fq = static_cast<const float*>(q);
    const float* fk = static_cast<const float*>(k);
    const float* fv = static_cast<const float*>(v);
    const float* fg = static_cast<const float*>(g);
    float* fdq = static_cast<float*>(dq);
    float* fdk = static_cast<float*>(dk);
    float* fdv = static_cast<float*>(dv);
    err = da == 128 ? launch_f32<128>(fq, fk, fv, bias, fg, fdq, fdk, fdv, stats, part, nb, na,
                                      n, causal, scale, stream)
                    : launch_f32<64>(fq, fk, fv, bias, fg, fdq, fdk, fdv, stats, part, nb, na,
                                     n, causal, scale, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  const size_t per = (size_t)na * n * n;
  const int blocks = (int)((per + 255) / 256 < 4096 ? (per + 255) / 256 : 4096);
  dbias_reduce<<<blocks, 256, 0, stream>>>(part, dbias, nb, per);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace lvt_bwd
