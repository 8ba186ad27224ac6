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
// twice, p^T g, ds k, ds^T q) over ~67 MB of bf16 inputs and outputs: the
// bound is the 43 GFLOP at the bf16 tensor-core rate (0.044 ms at 989
// TFLOP/s) against 0.020 ms of bytes. The dbias terms go through a scratch
// of at most 8 fp32 planes (16.8 MB at na = 8, n = 256, so it stays in L2).
//
// Design (three kernels, no atomics, so every output is bit-identical from
// call to call):
// 1. Query-tile kernel. It needs whole rows: rowsum(dp * p) must use the
//    fp32 p of the full key row, as the TPU kernel does (flash attention's
//    shortcut rowsum(dO * O) reads the output, which was rounded through
//    p_io, and is a different number in bf16). It computes the softmax,
//    rowsum(dp * p), ds and dq, writes the row statistics (max, sum,
//    rowsum(dp * p)) to device memory and adds ds to a dbias plane.
// 2. Key-tile kernel, one block per (key tile, head, attention block). dk
//    and dv sum over all query rows, so they stay in registers while the
//    block walks the query tiles, recomputing p and ds for its keys from
//    the row statistics (the (n, n) block never exists).
// 3. dbias: a reduction over the planes in a fixed order (an fp32
//    atomicAdd would change dbias from run to run).
// In bf16 (n <= 256) the products run on wgmma (bf16 in, fp32 accumulate)
// over tiles that TMA loads into 128-byte-swizzled shared memory
// (hopper.cuh). The query-tile kernel has two warpgroups, one per half of
// the keys: 64 scores and 64 of dp a thread, which with the 64 of the dq
// accumulator is as much as the registers hold at n = 256; dp is computed
// once. Each of its blocks walks a fixed run of nb / 8 attention blocks and
// sums their ds into the run's plane in block order. Every A operand that
// was an accumulator (p, ds, p^T, ds^T) stays in registers, and every B
// operand that the product reads transposed (k, g, q) goes through wgmma's
// transposed mode: nothing is transposed by hand. In fp32 (n <= 1024) the
// products run on FMAs, since TF32 would round the inputs to 10 bits, and
// the dbias scratch has one plane per attention block.
// Key tiles that the causal mask covers entirely are skipped: their p is
// exp(-1e4 - rowmax) / rowsum, exactly 0 in fp32 unless a row's largest
// score is below -9,896, and their ds is 0 by definition.
//
// Shapes: q, k, v, g, dq, dk, dv (nb, na, n, DA) contiguous in the io dtype,
// 16-byte aligned; bias and dbias (na, n, n) fp32; stats (3, nb, na, np)
// fp32 with np = n rounded up to 64 (fp32 uses the first (3, nb, na, n) of
// it); part (planes, na, n, n) fp32 scratch, planes = min(nb, 8) in bf16 and
// nb in fp32; DA in {64, 128}; n <= 1024 in fp32, n <= 256 in bf16.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace lvt_bwd {
namespace {


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
// bf16, n <= 256: wgmma, tiles by TMA
// ---------------------------------------------------------------------------

constexpr int DBIAS_PLANES = 8;  // bf16: dbias partial planes, each a run of blocks

template <int DA>
struct RowsSmem {
  static constexpr int TILE = DA * 128;  // 64 rows x DA bf16
  // Q | G | K chunks 0..3 | V chunks 0..3 | row reductions (3 x 2 x 64 fp32)
  // | mbarriers (Q, G, K 0..3, V 0..3). Q and G take the second warpgroup's
  // dq partial (64 x DA fp32) once both products that read them are done.
  static constexpr int RED = 10 * TILE;
  static constexpr int BARS = RED + 3 * 2 * 64 * 4;
  static constexpr int BYTES = BARS + 8 * 10;
};

template <int DA>
struct KeysSmem {
  static constexpr int TILE = DA * 128;
  // K | V | Q ring (2) | G ring (2) | stats ring (2 x 3 x 64 fp32) | mbarriers
  static constexpr int STATS = 6 * TILE;
  static constexpr int BARS = STATS + 2 * 3 * 64 * 4;
  static constexpr int BYTES = BARS + 8 * 3;
};

// Query-tile kernel: two warpgroups per (64 query rows, head, run of
// attention blocks); warpgroup w owns key chunks 2w and 2w + 1, so each
// thread holds 64 scores (then p) and 64 of dp = g v^T in registers, and the
// row reductions (max, sum, rowsum(dp p)) meet in shared memory. dp is
// computed once. ds goes to the run's dbias plane (written by the run's
// first block, added to by the others, in block order) and, rounded, into
// the register A operand of dq = ds k; the two warpgroups' dq partials are
// added through shared memory. Each block of the run loads its tiles anew:
// the 160 KB of Q, G, K, V (at DA = 128) leave no room for a second set.
template <int DA>
__global__ void __launch_bounds__(256, 1)
bwd_rows_wgmma(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap gmap,
               const float* __restrict__ bias, __nv_bfloat16* __restrict__ dq,
               float* __restrict__ stats, float* __restrict__ part, int nb, int na, int n,
               int causal, float scale) {
  using namespace lvt_hopper;
  using S = RowsSmem<DA>;
  constexpr int KSTEPS = DA / 16;
  constexpr int HALVES = DA / 64;
  constexpr int HALF = 64 * TILE_ROW_BYTES;

  extern __shared__ __align__(1024) unsigned char tile_smem[];
  unsigned char* smem = tile_smem;
  if (smem_u32(smem) & 1023) __trap();
  unsigned char* Qs = smem;
  unsigned char* Gs = smem + S::TILE;
  unsigned char* Ks = smem + 2 * S::TILE;
  unsigned char* Vs = smem + 6 * S::TILE;
  float* red = reinterpret_cast<float*>(smem + S::RED);  // [3][2][64]
  float* xq = reinterpret_cast<float*>(smem);            // dq partial, over Q and G
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::BARS);  // Q, G, K 0..3, V 0..3

  const int tid = threadIdx.x, wg = tid / 128, wt = tid % 128;
  const int w = wt / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int qt = blockIdx.x, q0 = qt * 64, a = blockIdx.y;
  const int planes = min(nb, DBIAS_PLANES);
  const int b0 = (int)((long)blockIdx.z * nb / planes), b1 = (int)((long)(blockIdx.z + 1) * nb / planes);
  const int nkt = (n + 63) / 64, np = nkt * 64;
  const int kend = causal ? min(nkt, qt + 1) : nkt;
  const float* bh = bias + (size_t)a * n * n;
  float* ph = part + ((size_t)blockIdx.z * na + a) * n * n;

  if (tid == 0) {
    for (int i = 0; i < 10; ++i) mbar_init(&bars[i], 1);
    fence_barrier_init();
  }
  __syncthreads();

  for (int blk = b0; blk < b1; ++blk) {
    const uint32_t par = (blk - b0) & 1;
    const int plane = blk * na + a;
    if (tid == 0) {
      fence_proxy_async();  // the dq partial was written over Q and G
      mbar_expect_tx(&bars[0], S::TILE);
      tma_tile<DA>(Qs, &qmap, &bars[0], q0, plane);
      for (int c = 0; c < kend; ++c) {
        mbar_expect_tx(&bars[2 + c], S::TILE);
        tma_tile<DA>(Ks + c * S::TILE, &kmap, &bars[2 + c], 64 * c, plane);
      }
      mbar_expect_tx(&bars[1], S::TILE);
      tma_tile<DA>(Gs, &gmap, &bars[1], q0, plane);
      for (int c = 0; c < kend; ++c) {
        mbar_expect_tx(&bars[6 + c], S::TILE);
        tma_tile<DA>(Vs + c * S::TILE, &vmap, &bars[6 + c], 64 * c, plane);
      }
    }

    // ---- S = q k^T and dp = g v^T for this warpgroup's two key chunks,
    // one wgmma stage per chunk
    float s[2][32], dp[2][32];
    mbar_wait(&bars[0], par);
    mbar_wait(&bars[1], par);
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int c = 2 * wg + cc;
#pragma unroll
      for (int i = 0; i < 32; ++i) s[cc][i] = dp[cc][i] = 0.f;
      if (c < kend) {
        mbar_wait(&bars[2 + c], par);
        mbar_wait(&bars[6 + c], par);
        fence_regs(s[cc]);
        fence_regs(dp[cc]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
          const int off = (kk / 4) * HALF + (kk % 4) * 32;
          wgmma_ss(s[cc], desc(Qs + off), desc(Ks + c * S::TILE + off));
          wgmma_ss(dp[cc], desc(Gs + off), desc(Vs + c * S::TILE + off));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s[cc]);
        fence_regs(dp[cc]);
      }
    }

    // ---- scale, bias, causal fill (-1e4 after the bias); keys past n -inf,
    // rows past n 0
    const int r_lo = acc_row(0, w, g), r_hi = r_lo + 8;  // rows of the tile
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int c = 2 * wg + cc;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i & 2) ? r_hi : r_lo, gr = q0 + r;
        const int col = 64 * c + acc_col(i / 4, i % 4, t);
        float x = -INFINITY;
        if (col < n) {
          x = 0.f;
          if (gr < n) {
            x = c < kend ? s[cc][i] * scale + bh[(size_t)gr * n + col] : -1e4f;
            if (causal && col > gr) x = -1e4f;
          }
        }
        s[cc][i] = x;
      }
    }

    // ---- row reductions across the quad, then across the two warpgroups
    auto reduce2 = [&](float lo, float hi, int which, bool is_max) {
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        const float l2 = __shfl_xor_sync(0xffffffffu, lo, o);
        const float h2 = __shfl_xor_sync(0xffffffffu, hi, o);
        lo = is_max ? fmaxf(lo, l2) : lo + l2;
        hi = is_max ? fmaxf(hi, h2) : hi + h2;
      }
      float* rd = red + which * 128;
      if (t == 0) {
        rd[wg * 64 + r_lo] = lo;
        rd[wg * 64 + r_hi] = hi;
      }
      __syncthreads();
      const float2 out = is_max ? make_float2(fmaxf(rd[r_lo], rd[64 + r_lo]),
                                              fmaxf(rd[r_hi], rd[64 + r_hi]))
                                : make_float2(rd[r_lo] + rd[64 + r_lo], rd[r_hi] + rd[64 + r_hi]);
      return out;
    };
    float m_lo = -INFINITY, m_hi = -INFINITY;
#pragma unroll
    for (int cc = 0; cc < 2; ++cc)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (i & 2) m_hi = fmaxf(m_hi, s[cc][i]);
        else m_lo = fmaxf(m_lo, s[cc][i]);
      }
    const float2 m = reduce2(m_lo, m_hi, 0, true);
    float l_lo = 0.f, l_hi = 0.f;
#pragma unroll
    for (int cc = 0; cc < 2; ++cc)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[cc][i] = expf(s[cc][i] - ((i & 2) ? m.y : m.x));
        if (i & 2) l_hi += s[cc][i];
        else l_lo += s[cc][i];
      }
    const float2 l = reduce2(l_lo, l_hi, 1, false);
    float d_lo = 0.f, d_hi = 0.f;
#pragma unroll
    for (int cc = 0; cc < 2; ++cc)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[cc][i] /= (i & 2) ? l.y : l.x;  // p in fp32
        if (i & 2) d_hi += dp[cc][i] * s[cc][i];
        else d_lo += dp[cc][i] * s[cc][i];
      }
    const float2 d = reduce2(d_lo, d_hi, 2, false);
    if (wg == 0 && t == 0) {
      const size_t st = (size_t)blk * na + a;
      const size_t per = (size_t)nb * na * np;
      if (q0 + r_lo < n) {
        stats[st * np + q0 + r_lo] = m.x;
        stats[per + st * np + q0 + r_lo] = l.x;
        stats[2 * per + st * np + q0 + r_lo] = d.x;
      }
      if (q0 + r_hi < n) {
        stats[st * np + q0 + r_hi] = m.y;
        stats[per + st * np + q0 + r_hi] = l.y;
        stats[2 * per + st * np + q0 + r_hi] = d.y;
      }
    }

    // ---- ds = p (dp - D), 0 where masked; into the dbias plane; rounded,
    // the A operand of dq = ds k
    uint32_t fa[2][4][4];
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int c = 2 * wg + cc;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i & 2) ? r_hi : r_lo, gr = q0 + r;
        const int col = 64 * c + acc_col(i / 4, i % 4, t);
        float ds = 0.f;
        if (gr < n && col < n && c < kend && !(causal && col > gr))
          ds = s[cc][i] * (dp[cc][i] - ((i & 2) ? d.y : d.x));
        if (gr < n && col < n) {
          float* dst = ph + (size_t)gr * n + col;
          *dst = blk == b0 ? ds : *dst + ds;
        }
        dp[cc][i] = ds;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc_to_a(fa[cc][kk], dp[cc], kk);
    }
    float o[HALVES][32];
#pragma unroll
    for (int h = 0; h < HALVES; ++h)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[h][i] = 0.f;
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {  // one wgmma stage per chunk
      const int c = 2 * wg + cc;
      if (c < kend) {
#pragma unroll
        for (int h = 0; h < HALVES; ++h) fence_regs(o[h]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) fence_regs(fa[cc][kk]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int h = 0; h < HALVES; ++h)
            wgmma_rs_t(o[h], fa[cc][kk],
                       desc(Ks + c * S::TILE + h * HALF + kk * 16 * TILE_ROW_BYTES));
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int h = 0; h < HALVES; ++h) fence_regs(o[h]);
      }
    }

    // ---- dq = (partial of chunks 0, 1) + (partial of chunks 2, 3)
    __syncthreads();  // both warpgroups are done with Q and G
    if (wg == 1) {
#pragma unroll
      for (int h = 0; h < HALVES; ++h)
#pragma unroll
        for (int i = 0; i < 32; ++i) xq[(h * 32 + i) * 128 + wt] = o[h][i];
    }
    __syncthreads();
    if (wg == 0) {
      __nv_bfloat16* dqh = dq + (size_t)plane * n * DA;
#pragma unroll
      for (int h = 0; h < HALVES; ++h)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            const int i = 4 * j + 2 * hi, gr = q0 + (hi ? r_hi : r_lo);
            const float x0 = o[h][i] + xq[(h * 32 + i) * 128 + wt];
            const float x1 = o[h][i + 1] + xq[(h * 32 + i + 1) * 128 + wt];
            if (gr < n)
              *reinterpret_cast<__nv_bfloat162*>(dqh + (size_t)gr * DA + 64 * h +
                                                 acc_col(j, 0, t)) =
                  __floats2bfloat162_rn(x0 * scale, x1 * scale);
          }
    }
    __syncthreads();  // every buffer is free for the next block's loads
  }
}

// Key-tile kernel: one warpgroup per (64 keys, head, attention block). dk
// and dv (64 x DA fp32 each) stay in registers while the block walks the
// query tiles the mask leaves, two in flight (Q, G and the row statistics
// by TMA into a ring). Per tile it recomputes s^T = k q^T and dp^T = v g^T,
// forms p and ds from the statistics, and feeds their bf16 roundings as
// register A operands to dv += p^T g and dk += ds^T q (g and q read as
// wgmma's transposed B).
template <int DA>
__global__ void __launch_bounds__(128)
bwd_keys_wgmma(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap gmap,
               const float* __restrict__ bias, __nv_bfloat16* __restrict__ dk,
               __nv_bfloat16* __restrict__ dv, const float* __restrict__ stats, int nb, int na,
               int n, int causal, float scale) {
  using namespace lvt_hopper;
  using S = KeysSmem<DA>;
  constexpr int KSTEPS = DA / 16;
  constexpr int HALVES = DA / 64;
  constexpr int HALF = 64 * TILE_ROW_BYTES;

  extern __shared__ __align__(1024) unsigned char tile_smem[];
  unsigned char* smem = tile_smem;
  if (smem_u32(smem) & 1023) __trap();
  unsigned char* Ks = smem;
  unsigned char* Vs = smem + S::TILE;
  unsigned char* Qs = smem + 2 * S::TILE;  // [2] tiles
  unsigned char* Gs = smem + 4 * S::TILE;  // [2] tiles
  float* St = reinterpret_cast<float*>(smem + S::STATS);  // [2][3][64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::BARS);  // K+V, row slot 0, 1

  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int kt = blockIdx.x, k0 = kt * 64, a = blockIdx.y;
  const int plane = blockIdx.z * na + a;
  const int nrt = (n + 63) / 64, np = nrt * 64;
  const int rt0 = causal ? kt : 0;  // earlier query tiles precede every key: masked
  const float* bh = bias + (size_t)a * n * n;
  const size_t per = (size_t)nb * na * np;
  const float* sh = stats + (size_t)plane * np;

  auto load_rows = [&](int rt, int slot) {
    uint64_t* bar = &bars[1 + slot];
    mbar_expect_tx(bar, 2 * S::TILE + 3 * 64 * 4);
    tma_tile<DA>(Qs + slot * S::TILE, &qmap, bar, 64 * rt, plane);
    tma_tile<DA>(Gs + slot * S::TILE, &gmap, bar, 64 * rt, plane);
    for (int k = 0; k < 3; ++k) bulk_load(St + (slot * 3 + k) * 64, sh + k * per + 64 * rt, 256, bar);
  };
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i], 1);
    fence_barrier_init();
    mbar_expect_tx(&bars[0], 2 * S::TILE);
    tma_tile<DA>(Ks, &kmap, &bars[0], k0, plane);
    tma_tile<DA>(Vs, &vmap, &bars[0], k0, plane);
    for (int i = 0; i < 2 && rt0 + i < nrt; ++i) load_rows(rt0 + i, i);
  }
  __syncthreads();

  float ak[HALVES][32], av[HALVES][32];
#pragma unroll
  for (int h = 0; h < HALVES; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) ak[h][i] = av[h][i] = 0.f;
  const int c_lo = k0 + acc_row(0, w, g), c_hi = c_lo + 8;  // this thread's keys
  mbar_wait(&bars[0], 0);

  for (int rt = rt0, it = 0; rt < nrt; ++rt, ++it) {
    const int slot = it & 1, r0 = 64 * rt;
    mbar_wait(&bars[1 + slot], (it >> 1) & 1);
    const unsigned char* Qt = Qs + slot * S::TILE;
    const unsigned char* Gt = Gs + slot * S::TILE;
    const float* Ms = St + slot * 3 * 64;

    float st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const int off = (kk / 4) * HALF + (kk % 4) * 32;
      wgmma_ss(st, desc(Ks + off), desc(Qt + off));
      wgmma_ss(dpt, desc(Vs + off), desc(Gt + off));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // p and ds of (key, query row): keys are the accumulator's rows, query
    // rows its columns
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = (i & 2) ? c_hi : c_lo;
      const int rl = acc_col(i / 4, i % 4, t), r = r0 + rl;
      float p = 0.f, ds = 0.f;
      if (r < n && c < n) {
        const bool masked = causal && c > r;
        const float x = masked ? -1e4f : st[i] * scale + bh[(size_t)r * n + c];
        p = expf(x - Ms[rl]) / Ms[64 + rl];
        if (!masked) ds = p * (dpt[i] - Ms[128 + rl]);
      }
      st[i] = p;
      dpt[i] = ds;
    }
    uint32_t fp[4][4], fds[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      acc_to_a(fp[kk], st, kk);
      acc_to_a(fds[kk], dpt, kk);
    }
#pragma unroll
    for (int h = 0; h < HALVES; ++h) {
      fence_regs(av[h]);
      fence_regs(ak[h]);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      fence_regs(fp[kk]);
      fence_regs(fds[kk]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < HALVES; ++h) {
        const int off = h * HALF + kk * 16 * TILE_ROW_BYTES;
        wgmma_rs_t(av[h], fp[kk], desc(Gt + off));
        wgmma_rs_t(ak[h], fds[kk], desc(Qt + off));
      }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < HALVES; ++h) {
      fence_regs(av[h]);
      fence_regs(ak[h]);
    }
    __syncthreads();  // every thread is done with this slot
    if (tid == 0 && rt + 2 < nrt) {
      fence_proxy_async();  // the statistics were read by generic loads
      load_rows(rt + 2, slot);
    }
  }

  const size_t head = (size_t)plane * n * DA;
#pragma unroll
  for (int h = 0; h < HALVES; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int i = 4 * j + 2 * hi, c = hi ? c_hi : c_lo;
        const size_t off = head + (size_t)c * DA + 64 * h + acc_col(j, 0, t);
        if (c < n) {
          *reinterpret_cast<__nv_bfloat162*>(dv + off) = __floats2bfloat162_rn(av[h][i], av[h][i + 1]);
          *reinterpret_cast<__nv_bfloat162*>(dk + off) =
              __floats2bfloat162_rn(ak[h][i] * scale, ak[h][i + 1] * scale);
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
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, const float* bias,
                         const void* g, void* dq, void* dk, void* dv, float* stats, float* part,
                         int nb, int na, int n, int causal, float scale, cudaStream_t stream) {
  using namespace lvt_hopper;
  using bf = __nv_bfloat16;
  CUtensorMap mq, mk, mv, mg;
  const uint64_t planes = (uint64_t)nb * na;
  if (!make_bf16_map(&mq, q, planes, n, DA) || !make_bf16_map(&mk, k, planes, n, DA) ||
      !make_bf16_map(&mv, v, planes, n, DA) || !make_bf16_map(&mg, g, planes, n, DA))
    return cudaErrorInvalidValue;
  const int tiles = (n + 63) / 64;
  cudaError_t err = set_smem_max(bwd_rows_wgmma<DA>, RowsSmem<DA>::BYTES);
  if (err != cudaSuccess) return err;
  bwd_rows_wgmma<DA><<<dim3(tiles, na, nb < DBIAS_PLANES ? nb : DBIAS_PLANES), 256,
                       RowsSmem<DA>::BYTES, stream>>>(mq, mk, mv, mg, bias, static_cast<bf*>(dq),
                                                      stats, part, nb, na, n, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = set_smem_max(bwd_keys_wgmma<DA>, KeysSmem<DA>::BYTES);
  if (err != cudaSuccess) return err;
  bwd_keys_wgmma<DA><<<dim3(tiles, na, nb), 128, KeysSmem<DA>::BYTES, stream>>>(
      mq, mk, mv, mg, bias, static_cast<bf*>(dk), static_cast<bf*>(dv), stats, nb, na, n, causal,
      scale);
  return cudaGetLastError();
}


// dtype: 0 = float32, 1 = bfloat16. Launches the query-tile, key-tile and
// dbias kernels on `stream`; returns the first failing cudaError_t, or 0.
// stats (3 * nb * na * np floats, np = n rounded up to 64) and part
// (planes * na * n * n floats, planes = min(nb, 8) in bf16, nb in fp32) are
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
    err = launch_wgmma<128>(q, k, v, bias, g, dq, dk, dv, stats, part, nb, na, n, causal, scale,
                            stream);
  else if (dtype == 1 && n <= 256 && da == 64)
    err = launch_wgmma<64>(q, k, v, bias, g, dq, dk, dv, stats, part, nb, na, n, causal, scale,
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
  const int planes = dtype == 1 && nb > DBIAS_PLANES ? DBIAS_PLANES : nb;
  dbias_reduce<<<blocks, 256, 0, stream>>>(part, dbias, planes, per);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace lvt_bwd
