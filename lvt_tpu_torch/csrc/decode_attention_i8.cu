// Per-pixel decode attention over one layer's int8 KV cache: kernels 3 and
// 4, one launch of thread-block clusters each (with or without the
// quantization of q and of the new cache row folded in), and kernels 5 and
// 12, one block per (batch row, head).
//
// They replace the TPU kernels of lvt_tpu/ops/cache_attention.py:
//   lvt_decode_attention_i8(_step)       decode_attention_i8_pallas (pallas_call at :202)
//   lvt_decode_attention_i8_live(_step)  decode_attention_i8_live_pallas (:409)
//   lvt_cache_attention_i8               cache_attention_pallas (:58)
// and the probe kernel of tools/probe_decode_kernel.py:
//   lvt_decode_attention_i8kv            decode_attn_pallas (pallas_call at :80)
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
//            the online-softmax recurrence: p = exp(logit - m_t), m_t the
//            running maximum through tile t, p * vs quantized per tile
//            (unnormalised), l = l * alpha_t + sum p, acc = acc * alpha_t +
//            float(int32 sum) * sw_t, alpha_t = exp(m_{t-1} - m_t), and
//            out = acc / (l + 1e-30) after the last live tile. The tile is
//            the quantization group and the step of the recurrence, so it is
//            part of the function.
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
// sums (the softmax denominator, a tile's sum of p) separate a kernel from
// its plain version: a weight that sits within an ulp of x.5 may round one
// step apart. Multiplies and adds whose pairing would let the compiler form
// an FMA are written with __fmul_rn / __fadd_rn, to round where the plain
// versions do.
//
// The fold (the *_step entries, the sampler's call): kernels 3 and 4 also
// take q and the new K and V rows in the io dtype (fp32 or bf16) and do what
// the sampler did around them in PyTorch. Every rank forms q8 and sq as
// ops/quant.py quantize_rows_i8 does (fp32 absmax, a true division by 127,
// rint of q / (sq + 1e-8), clip to +-127); the rank that owns row live - 1
// quantizes the new rows as ops/quant.py quantize_cache_row (the cache write)
// does on the card, with the rounding points in the io dtype (the absmax,
// / 127, + 1e-8 and the quotient each rounded to it; PyTorch's CUDA add
// keeps the Python number 1e-8 in fp32, where its CPU add first rounds it to
// the tensor's dtype), writes them and their scales into the cache at row
// live - 1, and attends with its own copy: the bulk copy of its last tile
// may land the stale row, so the row is written over the copy in shared
// memory once it has landed. All of it fp32 operations rounded once each,
// as PyTorch's CUDA kernels do them: bit-equal.
//
// What bounds kernels 3 and 4 on the H100: memory, then latency. One call
// reads 2 * b * na * live * da bytes of cache (2.1 MB at b = 8, na = 8, live
// = 256, da = 128: 0.6 us at 3.35 TB/s), half of kernel 2's bf16 traffic, and
// does 4 integer operations per byte; b * na single blocks do not fill 132
// SMs, and a call is one dependent step of the rollout. The design: C
// blocks per (batch row, head) (a cluster as in kernel 2,
// decode_attention.cu; a plain launch for C = 1), C from
// ops/cache_attention.py decode_i8_plan / decode_i8_live_plan; rank r owns
// a contiguous range of live rows (kernel 4: whole row tiles). A rank of 4
// warps reads up to 8 KB of K rows (64 at da = 128), one of 8 warps up to
// 16 KB, straight into registers at entry, K and V at once, before anything
// else is waited for: 4 loads of 16 bytes a thread each. The plans keep to
// that at the rollout's shapes: one rank up to 128 live rows, ranks of 4
// warps past it. A longer range arrives through rings of 8 KB bulk copies
// (cp.async.bulk on mbarriers), K and V at once, so V is in flight while
// the logits run. The scales and the bias row come in by coalesced loads
// meanwhile. q8 . k8 runs on __dp4a (four int8 products per instruction);
// the V product multiplies one weight into four different columns per
// word, so it uses __dp4a with the weight in one byte lane. With C > 1 the
// ranks meet through st.async pushes into each receiver's shared memory,
// completing on its mbarriers (one cluster barrier, at entry; with C = 1
// plain stores and __syncthreads):
//   kernel 3: (m_r, l_r) as kernel 2 does; then max|w| (it needs the global
//     sum); then each rank's int32 column sums to the column's owner, which
//     adds the C of them (exact in any order) and multiplies by sw once.
//   kernel 4: the running maximum is all that the recurrence carries from
//     tile to tile, so each rank pushes its tiles' maxima, every rank forms
//     the prefix maxima, and each tile's p, sum p, sw_t, w8 and int32 column
//     sums follow without waiting for another rank; each tile's (sum p,
//     sw_t) and column sums go to the column owners, which replay l and acc
//     in tile order with the fp32 operations of the recurrence above and
//     divide once.
// No atomics: two calls are bit-identical. A tensor-core mma.sync m16n8k32
// would idle 15 of its 16 rows at one query row per head.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "reduce.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace lvt;

constexpr int NTHREADS = 256;  // kernels 5 and 12: 8 warps
constexpr int NWARPS = NTHREADS / 32;
constexpr int UNROLL = 4;      // row groups a warp loads before it reduces
constexpr int VEC = 16;        // int8 per lane load

// how the lanes of a block of `WARPS` warps map onto cache rows of DA int8
template <int DA, int WARPS = NWARPS>
struct RowMap {
  static constexpr int LPR = DA / VEC;       // lanes per cache row
  static constexpr int RPW = 32 / LPR;       // rows per warp load
  static constexpr int STEP = WARPS * RPW;   // rows per block load
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

// ------------------------------------------------------- kernels 3 and 4
// A rank is 4 warps, or 8 where it loads more rows into registers than 4
// warps hold (4 loads of 16 bytes a thread: 8 KB of K rows for 4 warps,
// 16 KB for 8)
constexpr int TILE_BYTES = 8192;  // one bulk copy of K or V rows
constexpr int DIRECT_BYTES = 4 * 32 * VEC;  // K bytes a warp loads into registers
constexpr int NSTAGES = 4;        // bulk copies of K and of V in flight
constexpr int MAX_CLUSTER = 16;   // the non-portable cluster size limit
constexpr int MAX_SMEM = 232448;  // dynamic shared memory of one block

struct I8Args {
  const int8_t* q8;  // unfused: q8 (b, na, da) int8 and sq (b, na) fp32
  const float* sq;
  const void* q;     // fused: q (b, na, da) and the new K and V rows (b, 2,
  const void* kv;    // na, da) in the io dtype, batch strides in elements
  long long q_bs, kv_bs;
  int8_t* q8_out;    // fused, optional (null): q8 and sq as rank 0 formed them
  float* sq_out;
  int8_t* k8;        // (b, na, R, da) int8; the fused entries write row live - 1
  void* ks;          // (b, na, R) in the scale dtype, = the io dtype when fused
  int8_t* v8;
  void* vs;
  const float* bias;  // (na, R) fp32
  void* out;          // (b, na * da)
  int na, R, live;
  int chunk;      // rows per rank (kernel 4: a multiple of rtile)
  int rtile;      // kernel 4: rows per tile
  int ring_rows;  // rows per bulk copy (kernel 4: tiles never straddle one)
  int stages;     // ring stages of K and of V (0 when direct)
  int direct;     // rows <= ring_rows, each thread's K and V rows loaded into
                  // registers at entry, no ring
  float scale;
  int scale_bf16, out_bf16;
};

__host__ __device__ inline size_t up16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }

// Shared memory of a rank, byte offsets: K ring [stages][TILE_BYTES] | V
// ring | s [chunk] logits, then weights | ks, vs of the rank's rows | x1, x2,
// x3: what the other ranks push (kernel 3: (m_r, l_r) pairs, max|w| of every
// rank, every rank's column sums of this rank's columns; kernel 4: every
// tile's maximum, every tile's (sum p, sw_t), every tile's column sums of
// this rank's columns) | partial [nw][da] int | red [nw] | q8 [da] | the new
// K and V rows [2][da] int8 | sq and the new rows' scales | mbarriers: K
// [stages], V [stages], x1, x2, x3
struct Smem {
  size_t s, ks, vs, x1, x2, x3, partial, red, q8, newrow, vals, bars, total;
};

__host__ __device__ inline Smem smem_layout(int da, int nw, int C, int chunk, int stages,
                                            int tiles, bool live) {
  Smem m;
  const size_t per = da / C;
  size_t o = (size_t)2 * stages * TILE_BYTES;
  m.s = o;
  o = up16(o + 4 * (size_t)chunk);
  m.ks = o;
  o = up16(o + 4 * (size_t)chunk);
  m.vs = o;
  o = up16(o + 4 * (size_t)chunk);
  m.x1 = o;
  o = up16(o + 4 * (size_t)(live ? tiles : 2 * C));
  m.x2 = o;
  o = up16(o + 4 * (size_t)(live ? 2 * tiles : C));
  m.x3 = o;
  o = up16(o + 4 * (size_t)(live ? tiles : C) * per);
  m.partial = o;
  o = up16(o + 4 * (size_t)nw * da);
  m.red = o;
  o = up16(o + 4 * (size_t)nw);
  m.q8 = o;
  o = up16(o + da);
  m.newrow = o;
  o = up16(o + 2 * (size_t)da);
  m.vals = o;
  o = up16(o + 4 * 4);
  m.bars = o;
  m.total = o + 8 * (size_t)(2 * stages + 3);
  return m;
}

__device__ __forceinline__ float round_io(float x, int bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16(x)) : x;
}

// One warp: q8 and sq of (batch row bi, head a) as quantize_rows_i8 forms
// them, into q8s and vals[0] (and into the optional outputs).
template <int DA>
__device__ __forceinline__ void quantize_q(const I8Args& p, int bi, int a, int8_t* q8s,
                                           float* vals, bool write) {
  constexpr int E = DA / 32;
  const int lane = threadIdx.x % 32;
  const size_t src = (size_t)bi * p.q_bs + (size_t)a * DA + lane * E;
  float x[E], amax = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    x[e] = load_scalar(p.q, src + e, p.scale_bf16);
    amax = fmaxf(amax, fabsf(x[e]));
  }
  const float sq = __fdiv_rn(warp_max(amax), 127.f);
  const float den = __fadd_rn(sq, 1e-8f);
  const size_t head = (size_t)bi * p.na + a;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int8_t v = (int8_t)fminf(fmaxf(rintf(__fdiv_rn(x[e], den)), -127.f), 127.f);
    q8s[lane * E + e] = v;
    if (write) p.q8_out[head * DA + lane * E + e] = v;
  }
  if (lane == 0) {
    vals[0] = sq;
    if (write) p.sq_out[head] = sq;
  }
}

// One warp: the new K (which = 0) or V (1) row of (bi, a) as
// _quantize_cache_row forms it, every rounding point in the io dtype; into
// the cache at `row` (an index of (b, na, R)), its scale too, and into
// newrow[which] and vals[1 + which].
template <int DA>
__device__ __forceinline__ void quantize_new_row(const I8Args& p, int bi, int a, size_t row,
                                                 int which, int8_t* newrow, float* vals) {
  constexpr int E = DA / 32;
  const int lane = threadIdx.x % 32, io = p.scale_bf16;
  const size_t src = (size_t)bi * p.kv_bs + ((size_t)which * p.na + a) * DA + lane * E;
  float x[E], amax = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    x[e] = load_scalar(p.kv, src + e, io);
    amax = fmaxf(amax, fabsf(x[e]));
  }
  const float sc = round_io(__fdiv_rn(warp_max(amax), 127.f), io);
  const float den = round_io(__fadd_rn(sc, 1e-8f), io);
  int8_t* dst = (which ? p.v8 : p.k8) + row * DA + lane * E;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int8_t v =
        (int8_t)fminf(fmaxf(rintf(round_io(__fdiv_rn(x[e], den), io)), -127.f), 127.f);
    newrow[which * DA + lane * E + e] = v;
    dst[e] = v;
  }
  if (lane == 0) {
    vals[1 + which] = sc;
    store_scalar(which ? p.vs : p.ks, row, sc, io);
  }
}

template <int DA, int CW, bool LIVE, bool FUSED>
__global__ void __launch_bounds__(CW * 32) decode_i8_kernel(const I8Args p) {
  using namespace lvt_hopper;
  using M = RowMap<DA, CW>;
  constexpr int CT = CW * 32;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int per = DA / C;  // output columns each rank owns
  const int stages = p.stages, RT = p.ring_rows;
  const int rt = LIVE ? p.rtile : p.chunk;  // rows of a quantization group
  const int tiles = LIVE ? (p.live + rt - 1) / rt : C;

  extern __shared__ __align__(128) unsigned char dsmem[];
  const Smem L = smem_layout(DA, CW, C, p.chunk, stages, tiles, LIVE);
  unsigned char* kring = dsmem;
  unsigned char* vring = dsmem + stages * TILE_BYTES;
  float* s = reinterpret_cast<float*>(dsmem + L.s);
  float* sks = reinterpret_cast<float*>(dsmem + L.ks);
  float* svs = reinterpret_cast<float*>(dsmem + L.vs);
  float* x1 = reinterpret_cast<float*>(dsmem + L.x1);
  float* x2 = reinterpret_cast<float*>(dsmem + L.x2);
  int* x3 = reinterpret_cast<int*>(dsmem + L.x3);
  int* partial = reinterpret_cast<int*>(dsmem + L.partial);
  float* red = reinterpret_cast<float*>(dsmem + L.red);
  int8_t* q8s = reinterpret_cast<int8_t*>(dsmem + L.q8);
  int8_t* newrow = reinterpret_cast<int8_t*>(dsmem + L.newrow);
  float* vals = reinterpret_cast<float*>(dsmem + L.vals);
  uint64_t* kbar = reinterpret_cast<uint64_t*>(dsmem + L.bars);
  uint64_t* vbar = kbar + stages;
  uint64_t* x1bar = vbar + stages;
  uint64_t* x2bar = x1bar + 1;
  uint64_t* x3bar = x2bar + 1;

  const int a = blockIdx.x / C, bi = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int sub = lane / M::LPR, col = (lane % M::LPR) * VEC;
  const size_t head = (size_t)bi * p.na + a;
  const int j0 = min(rank * p.chunk, p.live);  // this rank's rows [j0, j0 + rows)
  const int rows = min(j0 + p.chunk, p.live) - j0;
  const int ncopies = (rows + RT - 1) / RT;  // bulk copies of K, and of V
  const size_t row0 = head * (size_t)p.R + j0;
  const int8_t* kh = p.k8 + row0 * DA;
  const int8_t* vh = p.v8 + row0 * DA;
  const bool owns_new = FUSED && rows > 0 && j0 + rows == p.live;  // row live - 1

  // copy t of K (or V) rows into its ring stage
  auto issue = [&](const int8_t* src, unsigned char* ring, uint64_t* bars, int t) {
    const int nr = min(RT, rows - t * RT);
    uint64_t* bar = &bars[t % stages];
    mbar_expect_tx(bar, nr * DA);
    bulk_load(ring + (t % stages) * TILE_BYTES, src + (size_t)t * RT * DA, nr * DA, bar);
  };
  const bool direct = p.direct, solo = C == 1;  // solo: no cluster, nothing to exchange
  if (tid == 0 && !(direct && solo)) {
    for (int i = 0; i < 2 * stages + 3; ++i) mbar_init(&kbar[i], 1);
    fence_barrier_init();
    for (int t = 0; t < ncopies && t < stages; ++t) issue(kh, kring, kbar, t);
    for (int t = 0; t < ncopies && t < stages; ++t) issue(vh, vring, vbar, t);
    // what the other ranks will push into this one
    if (LIVE && !solo) {
      mbar_expect_tx(x1bar, tiles * 4);
      mbar_expect_tx(x3bar, tiles * (8 + 4 * per));
    } else if (!solo) {
      mbar_expect_tx(x1bar, C * 8);
      mbar_expect_tx(x2bar, C * 4);
      mbar_expect_tx(x3bar, C * 4 * per);
    }
  }
  if (!solo) cluster_arrive();
  // direct: this thread's K and V rows, u * STEP + warp * RPW + sub, in
  // registers (the row live - 1 may be stale: it is replaced below)
  uint4 kreg[4], vreg[4];
  if (direct) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int jt = u * M::STEP + warp * M::RPW + sub;
      kreg[u] = jt < rows ? load_row16(kh + (size_t)jt * DA + col) : make_uint4(0, 0, 0, 0);
      vreg[u] = jt < rows ? load_row16(vh + (size_t)jt * DA + col) : make_uint4(0, 0, 0, 0);
    }
  }
  // the bias row and the scales of this rank's rows, q8 and sq, and the new
  // rows, while the loads are in flight
  const float* brow = p.bias + (size_t)a * p.R + j0;
  for (int j = tid; j < rows; j += CT) {
    s[j] = brow[j];
    sks[j] = load_scalar(p.ks, row0 + j, p.scale_bf16);
    svs[j] = load_scalar(p.vs, row0 + j, p.scale_bf16);
  }
  if (FUSED) {
    if (warp == 0) quantize_q<DA>(p, bi, a, q8s, vals, p.q8_out != nullptr && rank == 0);
    else if (owns_new && warp <= 2)
      quantize_new_row<DA>(p, bi, a, row0 + rows - 1, warp - 1, newrow, vals);
  } else {
    if (tid < DA / 16)
      *reinterpret_cast<uint4*>(q8s + 16 * tid) = load_row16(p.q8 + head * DA + 16 * tid);
    if (tid == 0) vals[0] = p.sq[head];
  }
  __syncthreads();
  const uint4 qv = *reinterpret_cast<const uint4*>(q8s + col);
  const float qs = __fmul_rn(vals[0], p.scale);

  // ---- logits of this rank's rows: LPR lanes per row
  if (direct) {
    if (owns_new) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (u * M::STEP + warp * M::RPW + sub == rows - 1) {
          kreg[u] = *reinterpret_cast<const uint4*>(newrow + col);
          vreg[u] = *reinterpret_cast<const uint4*>(newrow + DA + col);
        }
      }
      if (tid == 0) {
        sks[rows - 1] = vals[1];
        svs[rows - 1] = vals[2];
      }
      __syncthreads();
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int jt = u * M::STEP + warp * M::RPW + sub;
      int dot = jt < rows ? dot16(kreg[u], qv) : 0;
#pragma unroll
      for (int o = M::LPR / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (lane % M::LPR == 0 && jt < rows)
        s[jt] = __fadd_rn(__fmul_rn(__fmul_rn((float)dot, qs), sks[jt]), s[jt]);
    }
  }
  for (int t = 0; t < ncopies && !direct; ++t) {
    mbar_wait(&kbar[t % stages], (t / stages) & 1);
    const int8_t* kt = reinterpret_cast<const int8_t*>(kring + (t % stages) * TILE_BYTES);
    if (owns_new && t == ncopies - 1) {  // the copy may hold the stale row
      if (tid < DA / 16)
        *reinterpret_cast<uint4*>(kring + (t % stages) * TILE_BYTES + (rows - 1 - t * RT) * DA +
                                  16 * tid) = *reinterpret_cast<const uint4*>(newrow + 16 * tid);
      if (tid == 0) {
        sks[rows - 1] = vals[1];
        svs[rows - 1] = vals[2];
      }
      __syncthreads();
    }
    const int nr = min(RT, rows - t * RT);
#pragma unroll 4
    for (int r0 = 0; r0 < nr; r0 += M::STEP) {
      const int jt = r0 + warp * M::RPW + sub;
      int dot = jt < nr ? dot16(load_row16(kt + jt * DA + col), qv) : 0;
#pragma unroll
      for (int o = M::LPR / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (lane % M::LPR == 0 && jt < nr) {
        const int j = t * RT + jt;
        s[j] = __fadd_rn(__fmul_rn(__fmul_rn((float)dot, qs), sks[j]), s[j]);
      }
    }
    if (t + stages < ncopies) {
      __syncthreads();  // every warp is done with this stage
      if (tid == 0) {
        fence_proxy_async();  // generic reads before the copy's writes
        issue(kh, kring, kbar, t + stages);
      }
    }
  }
  __syncthreads();

  // this rank's tiles [t0, t0 + nt) (kernel 4)
  const int t0 = j0 / rt, nt = (rows + rt - 1) / rt;
  float sw = 0.f;  // kernel 3: the weight row's scale
  if (!LIVE) {
    // ---- kernel 3: softmax over the live rows in fp32, as kernel 2 forms it
    float mr = -INFINITY;
    for (int j = tid; j < rows; j += CT) mr = fmaxf(mr, s[j]);
    mr = block_reduce<true, CW>(mr, red);
    float lr = 0.f;
    for (int j = tid; j < rows; j += CT) lr += expf(s[j] - mr);
    lr = block_reduce<false, CW>(lr, red);
    if (solo) {
      if (tid == 0) x1[0] = mr, x1[1] = lr;
      __syncthreads();
    } else {
      cluster_wait();  // every rank's mbarriers are initialised
      if (tid < C) push2(map_rank(x1 + 2 * rank, tid), mr, lr, map_rank(x1bar, tid));
      mbar_wait(x1bar, 0);
    }
    float m = -INFINITY;
    for (int r = 0; r < C; ++r) m = fmaxf(m, x1[2 * r]);
    float sum = 0.f;
    for (int r = 0; r < C; ++r) sum += x1[2 * r + 1] * expf(x1[2 * r] - m);  // 0 if empty
    // the weights times the V scales, and one absmax scale for the row: its
    // maximum needs the global sum, so the ranks meet again
    float amax = 0.f;
    for (int j = tid; j < rows; j += CT) {
      const float w = __fmul_rn(expf(s[j] - m) / sum, svs[j]);
      s[j] = w;
      amax = fmaxf(amax, fabsf(w));
    }
    amax = block_reduce<true, CW>(amax, red);
    if (solo) {
      if (tid == 0) x2[0] = amax;
      __syncthreads();
    } else {
      if (tid < C) push(map_rank(x2 + rank, tid), amax, map_rank(x2bar, tid));
      mbar_wait(x2bar, 0);
    }
    float wmax = 0.f;
    for (int r = 0; r < C; ++r) wmax = fmaxf(wmax, x2[r]);
    sw = wmax / 127.f;
    for (int j = tid; j < rows; j += CT) s[j] = quantize_i8(s[j], sw);
  } else {
    // ---- kernel 4: each of this rank's tiles' maximum to every rank, one
    // warp a tile
    if (!solo) cluster_wait();
    for (int i = warp; i < nt; i += CW) {
      float mx = -1e30f;  // rows past `live` of a tile carry -1e30 in the reference
      for (int j = i * rt + lane; j < min((i + 1) * rt, rows); j += 32) mx = fmaxf(mx, s[j]);
      mx = warp_max(mx);
      if (solo && lane == 0) x1[t0 + i] = mx;
      else if (!solo && lane < C) push(map_rank(x1 + t0 + i, lane), mx, map_rank(x1bar, lane));
    }
    if (solo) __syncthreads();
    else mbar_wait(x1bar, 0);
    // each tile on its own: m_t the maximum through it, p, sum p, p * vs,
    // sw_t and w8; (sum p, sw_t) to every rank
    for (int i = warp; i < nt; i += CW) {
      float m = -1e30f;
      for (int t = 0; t <= t0 + i; ++t) m = fmaxf(m, x1[t]);
      const int hi = min((i + 1) * rt, rows);
      float psum = 0.f, amax = 0.f;
      for (int j = i * rt + lane; j < hi; j += 32) {
        const float pj = expf(s[j] - m);
        psum += pj;
        const float pw = __fmul_rn(pj, svs[j]);
        s[j] = pw;
        amax = fmaxf(amax, fabsf(pw));
      }
      psum = warp_sum(psum);
      const float swt = warp_max(amax) / 127.f;
      for (int j = i * rt + lane; j < hi; j += 32) s[j] = quantize_i8(s[j], swt);
      if (solo && lane == 0) x2[2 * (t0 + i)] = psum, x2[2 * (t0 + i) + 1] = swt;
      else if (!solo && lane < C)
        push2(map_rank(x2 + 2 * (t0 + i), lane), psum, swt, map_rank(x3bar, lane));
    }
  }
  __syncthreads();

  // ---- int32 w8 . v8 by column over the V rows, in groups of rows (kernel
  // 3: one group, also for a rank with no rows; kernel 4: a tile each), in
  // order; each group's column sums go to the columns' owners (kernel 3:
  // slot rank, kernel 4: slot tile)
  const int grp = LIVE ? rt : rows, ngroups = LIVE ? nt : 1;
  int next = 0;  // the next V copy to wait for
  for (int g = 0; g < ngroups; ++g) {
    const int lo = g * grp, hi = min(lo + grp, rows);
    int acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0;
    if (direct) {  // the group's rows among this thread's
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int jr = u * M::STEP + warp * M::RPW + sub;
        if (jr >= lo && jr < hi) axpy16((int)s[jr], vreg[u], acc);
      }
    }
    for (int j = lo; j < hi && !direct;) {
      const int t = j / RT;
      unsigned char* stage = vring + (t % stages) * TILE_BYTES;
      const int8_t* vt = reinterpret_cast<const int8_t*>(stage);
      if (t == next) {
        mbar_wait(&vbar[t % stages], (t / stages) & 1);
        if (owns_new && t == ncopies - 1) {  // the copy may hold the stale row
          if (tid < DA / 16)
            *reinterpret_cast<uint4*>(stage + (rows - 1 - t * RT) * DA + 16 * tid) =
                *reinterpret_cast<const uint4*>(newrow + DA + 16 * tid);
          __syncthreads();
        }
        ++next;
      }
      const int end = min(hi, (t + 1) * RT);
#pragma unroll 4
      for (int r0 = j; r0 < end; r0 += M::STEP) {
        const int jr = r0 + warp * M::RPW + sub;
        if (jr < end)
          axpy16((int)s[jr], load_row16(vt + (jr - t * RT) * DA + col), acc);
      }
      j = end;
      if (end == min((t + 1) * RT, rows) && t + stages < ncopies) {  // copy t used up
        __syncthreads();
        if (tid == 0) {
          fence_proxy_async();
          issue(vh, vring, vbar, t + stages);
        }
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
    const int slot = (LIVE ? t0 + g : rank) * per;
    for (int d = tid; d < DA; d += CT) {
      int sum = 0;
#pragma unroll
      for (int w = 0; w < CW; ++w) sum += partial[w * DA + d];
      if (solo) x3[slot + d] = sum;
      else push(map_rank(x3 + slot + d % per, d / per), sum, map_rank(x3bar, d / per));
    }
    __syncthreads();  // partial is rewritten by the next group
  }
  if (!solo) mbar_wait(x3bar, 0);  // every push into this rank has landed

  // ---- this rank's output columns: kernel 3 adds the C sums (exact in any
  // order) and scales once; kernel 4 replays the recurrence in tile order
  // and divides once
  if (tid < per) {
    float o;
    if (!LIVE) {
      int total = 0;
      for (int r = 0; r < C; ++r) total += x3[r * per + tid];
      o = __fmul_rn((float)total, sw);
    } else {
      float m_run = -1e30f, l = 0.f, acc = 0.f;
      for (int t = 0; t < tiles; ++t) {
        const float m_new = fmaxf(m_run, x1[t]);
        const float alpha = expf(m_run - m_new);
        l = __fadd_rn(__fmul_rn(l, alpha), x2[2 * t]);
        acc = __fadd_rn(__fmul_rn(acc, alpha), __fmul_rn((float)x3[t * per + tid], x2[2 * t + 1]));
        m_run = m_new;
      }
      o = acc / __fadd_rn(l, 1e-30f);
    }
    store_scalar(p.out, head * DA + rank * per + tid, o, p.out_bf16);
  }
}

// the launch of kernel 3 or 4 with ranks of NW warps for `b` batch rows and
// a cluster of C; the caller has checked the shapes
template <int DA, int NW, bool LIVE, bool FUSED>
cudaError_t launch_i8(I8Args p, int b, int C, cudaStream_t stream) {
  p.ring_rows = LIVE ? p.ring_rows : TILE_BYTES / DA;
  p.stages = p.direct ? 0 : max(1, min(NSTAGES, (p.chunk + p.ring_rows - 1) / p.ring_rows));
  const int tiles = LIVE ? (p.live + p.rtile - 1) / p.rtile : C;
  const size_t smem = smem_layout(DA, NW, C, p.chunk, p.stages, tiles, LIVE).total;
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  auto kernel = decode_i8_kernel<DA, NW, LIVE, FUSED>;
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
  cfg.gridDim = dim3(p.na * C, b);
  cfg.blockDim = dim3(NW * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;  // one block per (batch row, head): a plain launch
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
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

// 8 warps a rank where its rows, read directly, need them; else 4
template <bool LIVE, bool FUSED>
int launch_i8_da(const I8Args& p, int b, int da, int C, cudaStream_t stream) {
  const bool wide = p.direct && p.chunk * da > 4 * DIRECT_BYTES;
  if (da == 128)
    return (int)(wide ? launch_i8<128, 8, LIVE, FUSED>(p, b, C, stream)
                      : launch_i8<128, 4, LIVE, FUSED>(p, b, C, stream));
  return (int)(wide ? launch_i8<64, 8, LIVE, FUSED>(p, b, C, stream)
                    : launch_i8<64, 4, LIVE, FUSED>(p, b, C, stream));
}

// a cluster of C ranks of `chunk` rows each must hold the live rows; a rank
// reads them directly only if they fit 4 loads of 16 bytes a thread of 8 warps
bool bad_plan(int C, int chunk, int live, int direct, int da) {
  return C < 1 || C > MAX_CLUSTER || (C & (C - 1)) != 0 || chunk < 1 ||
         (long long)C * chunk < live || (direct && chunk * da > 8 * DIRECT_BYTES);
}

// kernel 4's tiles and bulk copies: a copy holds whole tiles or a tile whole copies
bool bad_tiles(int R, int da, int rtile, int chunk, int ring_rows) {
  return rtile < 1 || R % rtile != 0 || chunk % rtile != 0 || ring_rows < 1 ||
         ring_rows * da > TILE_BYTES || (ring_rows % rtile != 0 && rtile % ring_rows != 0);
}

I8Args i8_args(const void* k8, const void* ks, const void* v8, const void* vs, const float* bias,
               void* out, int na, int R, int live, int chunk, int direct, int scale_bf16,
               int out_bf16, float scale) {
  I8Args p = {};
  p.k8 = static_cast<int8_t*>(const_cast<void*>(k8));
  p.ks = const_cast<void*>(ks);
  p.v8 = static_cast<int8_t*>(const_cast<void*>(v8));
  p.vs = const_cast<void*>(vs);
  p.bias = bias;
  p.out = out;
  p.na = na;
  p.R = R;
  p.live = live;
  p.chunk = chunk;
  p.rtile = chunk;
  p.direct = direct;
  p.scale = scale;
  p.scale_bf16 = scale_bf16;
  p.out_bf16 = out_bf16;
  return p;
}

}  // namespace


// Kernel 3. q8 (b, na, da) int8; sq (b, na) fp32; k8, v8 (b, na, R, da) int8;
// ks, vs (b, na, R) fp32 or bf16 (scale_bf16); bias (na, R) fp32; out
// (b, na*da) fp32 or bf16 (out_bf16); a cluster of `cluster` ranks of `chunk`
// rows each per (batch row, head) (ops/cache_attention.py decode_i8_plan),
// the rows read through the ring of bulk copies or, with `direct`, straight
// from device memory.
// Returns the cudaError_t of the launch: a cluster the card cannot place
// fails it (there is no single-block fallback).
extern "C" int lvt_decode_attention_i8(const void* q8, const float* sq, const void* k8,
                                       const void* ks, const void* v8, const void* vs,
                                       const float* bias, void* out, int b, int na, int R,
                                       int da, int live, int cluster, int chunk, int direct,
                                       int scale_bf16, int out_bf16, float scale,
                                       cudaStream_t stream) {
  if (bad_shape(b, na, R, da, live) || bad_plan(cluster, chunk, live, direct, da))
    return (int)cudaErrorInvalidValue;
  I8Args p = i8_args(k8, ks, v8, vs, bias, out, na, R, live, chunk, direct, scale_bf16, out_bf16,
                     scale);
  p.q8 = static_cast<const int8_t*>(q8);
  p.sq = sq;
  return launch_i8_da<false, false>(p, b, da, cluster, stream);
}

// Kernel 4: kernel 3's operands plus the row tile (bias without a causal
// mask); `chunk` a multiple of rtile (decode_i8_live_plan), `ring_rows` the
// rows of one bulk copy.
extern "C" int lvt_decode_attention_i8_live(const void* q8, const float* sq, const void* k8,
                                            const void* ks, const void* v8, const void* vs,
                                            const float* bias, void* out, int b, int na, int R,
                                            int da, int live, int rtile, int cluster, int chunk,
                                            int ring_rows, int direct, int scale_bf16,
                                            int out_bf16, float scale, cudaStream_t stream) {
  if (bad_shape(b, na, R, da, live) || bad_plan(cluster, chunk, live, direct, da) ||
      bad_tiles(R, da, rtile, chunk, ring_rows))
    return (int)cudaErrorInvalidValue;
  I8Args p = i8_args(k8, ks, v8, vs, bias, out, na, R, live, chunk, direct, scale_bf16, out_bf16,
                     scale);
  p.q8 = static_cast<const int8_t*>(q8);
  p.sq = sq;
  p.rtile = rtile;
  p.ring_rows = ring_rows;
  return launch_i8_da<true, false>(p, b, da, cluster, stream);
}

// Kernel 3 with the fold: q (b, na, da) and the new rows kv (b, 2, na, da)
// in the io dtype (io_bf16; also the scales' dtype), batch strides q_bs,
// kv_bs in elements, inner dimensions contiguous; the new K and V rows and
// their scales are written into k8, v8, ks, vs at row live - 1. q8_out (b,
// na, da) and sq_out (b, na) receive q8 and sq unless null.
extern "C" int lvt_decode_attention_i8_step(const void* q, const void* kv, long long q_bs,
                                            long long kv_bs, void* q8_out, float* sq_out,
                                            void* k8, void* ks, void* v8, void* vs,
                                            const float* bias, void* out, int b, int na, int R,
                                            int da, int live, int cluster, int chunk, int direct,
                                            int io_bf16, int out_bf16, float scale,
                                            cudaStream_t stream) {
  if (bad_shape(b, na, R, da, live) || bad_plan(cluster, chunk, live, direct, da) ||
      (q8_out == nullptr) != (sq_out == nullptr))
    return (int)cudaErrorInvalidValue;
  I8Args p = i8_args(k8, ks, v8, vs, bias, out, na, R, live, chunk, direct, io_bf16, out_bf16,
                     scale);
  p.q = q;
  p.kv = kv;
  p.q_bs = q_bs;
  p.kv_bs = kv_bs;
  p.q8_out = static_cast<int8_t*>(q8_out);
  p.sq_out = sq_out;
  return launch_i8_da<false, true>(p, b, da, cluster, stream);
}

// Kernel 4 with the fold: the operands of lvt_decode_attention_i8_step plus
// those of the row tiles of lvt_decode_attention_i8_live.
extern "C" int lvt_decode_attention_i8_live_step(
    const void* q, const void* kv, long long q_bs, long long kv_bs, void* q8_out, float* sq_out,
    void* k8, void* ks, void* v8, void* vs, const float* bias, void* out, int b, int na, int R,
    int da, int live, int rtile, int cluster, int chunk, int ring_rows, int direct, int io_bf16,
    int out_bf16, float scale, cudaStream_t stream) {
  if (bad_shape(b, na, R, da, live) || bad_plan(cluster, chunk, live, direct, da) ||
      bad_tiles(R, da, rtile, chunk, ring_rows) || (q8_out == nullptr) != (sq_out == nullptr))
    return (int)cudaErrorInvalidValue;
  I8Args p = i8_args(k8, ks, v8, vs, bias, out, na, R, live, chunk, direct, io_bf16, out_bf16,
                     scale);
  p.q = q;
  p.kv = kv;
  p.q_bs = q_bs;
  p.kv_bs = kv_bs;
  p.q8_out = static_cast<int8_t*>(q8_out);
  p.sq_out = sq_out;
  p.rtile = rtile;
  p.ring_rows = ring_rows;
  return launch_i8_da<true, true>(p, b, da, cluster, stream);
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
