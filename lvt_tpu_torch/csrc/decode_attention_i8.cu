// Per-pixel decode attention over one layer's int8 KV cache: kernels 3 and
// 4, one launch of thread-block clusters each (with or without the
// quantization of q and of the new cache row folded in), and kernels 5 and
// 12, one launch of clusters too (one warp a head at da = 16; their design
// above cache_i8_kernel below).
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

constexpr int VEC = 16;  // int8 per lane load

// how the lanes of a block of `WARPS` warps map onto cache rows of DA int8
template <int DA, int WARPS>
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
// A float q over int8 K and V with fp32 scales. Kernel 5 keeps the weight
// row in fp32; kernel 12 (ROUND_W) rounds it to the io dtype before the V
// product. Two launches:
//   cache_i8_kernel: C ranks of CW warps per (batch row, head), a cluster
//     for C > 1 (cache_attention_plan in ops/cache_attention.py), rank r
//     owning live rows [r * chunk, (r + 1) * chunk). Each thread requests
//     its K rows, its V rows, their scales, the extra row and q straight
//     into registers at entry (U = 4 or 8 rows of 16 bytes each, a "pass";
//     a rank whose rows need more passes loads the later ones as it reaches
//     them, keeping their logits in shared memory). The logits are held by
//     the lanes of their row; each warp forms (max, sum) of its rows, the warps
//     of a rank meet once, and the ranks push (m_r, l_r) to every rank
//     (st.async onto its mbarrier). The weights follow from the global sum
//     in registers (each lane of a row's group forms the exps and weights of
//     its share of the rows and a shuffle hands them round), the V product
//     in fp32, and each rank's column sums go to the column's owner, which
//     adds them in rank order.
//   cache_i8_warp_kernel (da 16 up to 256 live rows, the probe's shape): one
//     warp per (batch row, head), 8 heads a block, a lane per row and 8 rows
//     a lane, shuffles only and no block barrier.
// No atomics: two calls are bit-identical.

struct CacheArgs {
  const void* q;     // (b, na, da), io dtype
  const int8_t* k8;  // (b, na, R, da)
  const float* ks;   // (b, na, R)
  const int8_t* v8;
  const float* vs;
  const float* extra;   // (eb, na, R)
  void* out;            // (b, na, da), io dtype
  size_t extra_stride;  // batch stride of extra: 0 (eb = 1) or na * R
  int na, R, live, chunk;
  float scale;
  int io_bf16;
};

constexpr int WARP_U = 8;        // rows of a lane (cache_i8_warp_kernel)
constexpr int WARP_HEADS = 8;    // heads (warps) of a block of cache_i8_warp_kernel

// the 4 int8 of a word as exact floats: 2^23 + 128 + x assembled in the
// mantissa (the sign bit flipped gives x + 128), then 2^23 + 128 taken off
__device__ __forceinline__ void i8x4_to_f32(unsigned w, float* f) {
  const unsigned u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + i)) - 8388736.f;
}

__device__ __forceinline__ void row_to_f32(const uint4& r, float* f) {
  i8x4_to_f32(r.x, f);
  i8x4_to_f32(r.y, f + 4);
  i8x4_to_f32(r.z, f + 8);
  i8x4_to_f32(r.w, f + 12);
}

// q . float(row) over one lane's 16 columns, fp32 FMAs in column order
__device__ __forceinline__ float dot16f(const float* q, const uint4& r) {
  float k[VEC];
  row_to_f32(r, k);
  float d = 0.f;
#pragma unroll
  for (int e = 0; e < VEC; ++e) d = fmaf(q[e], k[e], d);
  return d;
}

// acc[e] += w * float(row[e])
__device__ __forceinline__ void axpy16f(float w, const uint4& r, float* acc) {
  float v[VEC];
  row_to_f32(r, v);
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = fmaf(w, v[e], acc[e]);
}

// logit_j = (q . k_j) * scale * ks_j + extra_j, rounded where the plain version rounds
__device__ __forceinline__ float cache_logit(float dot, float scale, float ks, float extra) {
  return __fadd_rn(__fmul_rn(__fmul_rn(dot, scale), ks), extra);
}

// The column sums of a warp's rows: acc[0..16) of columns col + e summed
// over the lanes that share `lane % LPR` (the warp's 32 / LPR rows), as a
// reduce-scatter: each level halves the values a lane keeps (the upper half
// where the lane's bit o is set) and adds its partner's, so 32 / LPR rows
// take 8 + 4 + ... shuffles where full butterflies take 16 a level. The lane
// is left with N columns in acc[0..N), the first at col + the returned
// offset; with LPR 1 the lanes L and L + 16 hold the same one.
template <int LPR>
struct ColumnSums {
  static constexpr int LEVELS = LPR == 1 ? 5 : LPR == 4 ? 3 : LPR == 8 ? 2 : 0;
  static constexpr int N = LEVELS >= 4 ? 1 : VEC >> LEVELS;
  static_assert(LEVELS > 0, "LPR must be 1, 4 or 8");
};

// one level at lane bit O with N values kept so far, then the next (all
// indices known at compile time, so acc stays in registers)
template <int O, int N>
__device__ __forceinline__ void column_sums_level(float (&acc)[VEC], int lane, int& c0) {
  if constexpr (N > 1) {
    constexpr int H = N / 2;
    const bool upper = lane & O;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float send = upper ? acc[i] : acc[i + H];
      const float keep = upper ? acc[i + H] : acc[i];
      acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    c0 += upper ? H : 0;
    if constexpr (O < 16) column_sums_level<2 * O, H>(acc, lane, c0);
  } else {
    acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], O);
    if constexpr (O < 16) column_sums_level<2 * O, 1>(acc, lane, c0);
  }
}

template <int LPR>
__device__ __forceinline__ int column_sums(float (&acc)[VEC], int lane) {
  int c0 = 0;
  column_sums_level<LPR, VEC>(acc, lane, c0);
  return c0;
}

// x[i] for an index known at run time, without local memory
template <int N>
__device__ __forceinline__ float pick(const float (&x)[N], int i) {
  float v = x[0];
#pragma unroll
  for (int j = 1; j < N; ++j) v = j == i ? x[j] : v;
  return v;
}

// w_j = p_j / sum * vs_j, kernel 12 rounding it to the io dtype
template <bool ROUND_W>
__device__ __forceinline__ float cache_weight(float p, float sum, float vs, int io_bf16) {
  const float w = __fmul_rn(p / sum, vs);
  return ROUND_W ? round_io(w, io_bf16) : w;
}

// shared memory of a rank of cache_i8_kernel with CW warps of U row loads a
// thread, in floats: x1 [2 C] at 0 | red [2 CW] at 32 | x3 [C * per = DA] at
// 48 | partial [CW][DA] | s (the logits of rows past the first pass) | 2
// mbarriers
__host__ __device__ inline size_t cache_smem_floats(int da, int cw, int u, int chunk) {
  const int pass = u * cw * (32 / (da / VEC));
  const size_t extra_rows = chunk > pass ? (size_t)(chunk - pass) : 0;
  return (48 + (size_t)da + (size_t)cw * da + extra_rows + 1) & ~static_cast<size_t>(1);
}
__host__ __device__ inline size_t cache_smem_bytes(int da, int cw, int u, int chunk) {
  return 4 * cache_smem_floats(da, cw, u, chunk) + 16;
}

// q's 16 columns of one lane (16-byte aligned: the wrapper sees to it)
__device__ __forceinline__ void load_q16(const void* q, size_t i, int io_bf16, float* qv) {
  if (io_bf16) {
    const uint4* src = reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(q) + i);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 w = src[h];
      const unsigned words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {  // a bf16 is the upper half of its fp32
        qv[8 * h + 2 * k] = __uint_as_float(words[k] << 16);
        qv[8 * h + 2 * k + 1] = __uint_as_float(words[k] & 0xffff0000u);
      }
    }
  } else {
    const float4* src = reinterpret_cast<const float4*>(static_cast<const float*>(q) + i);
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const float4 w = src[h];
      qv[4 * h] = w.x, qv[4 * h + 1] = w.y, qv[4 * h + 2] = w.z, qv[4 * h + 3] = w.w;
    }
  }
}

template <int DA, int CW, int U, bool ROUND_W>
__global__ void __launch_bounds__(CW * 32) cache_i8_kernel(const CacheArgs p) {
  using namespace lvt_hopper;
  using M = RowMap<DA, CW>;
  constexpr int PASS = U * M::STEP;  // rows of a rank per pass
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int per = DA / C;  // output columns each rank owns
  const bool solo = C == 1;

  extern __shared__ __align__(16) float csm[];
  float* x1 = csm;
  float* red = csm + 32;
  float* x3 = csm + 48;
  float* partial = x3 + DA;
  float* s = partial + CW * DA;
  uint64_t* bars = reinterpret_cast<uint64_t*>(csm + cache_smem_floats(DA, CW, U, p.chunk));

  const int a = blockIdx.x / C, bi = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int sub = lane / M::LPR, col = (lane % M::LPR) * VEC;
  const int gl = lane % M::LPR;  // a lane's place in its row's group
  const bool leader = gl == 0;
  // the rows of the first pass whose exps and weights a lane forms, u = gl +
  // k * LPR: every lane of a group holds the group's logits, and each takes
  // its own share of them
  constexpr int K = (U + M::LPR - 1) / M::LPR;
  const size_t head = (size_t)bi * p.na + a;
  const int j0 = min(rank * p.chunk, p.live);  // this rank's rows [j0, j0 + rows)
  const int rows = min(j0 + p.chunk, p.live) - j0;
  const size_t row0 = head * (size_t)p.R + j0;
  const int8_t* kh = p.k8 + row0 * DA + col;
  const int8_t* vh = p.v8 + row0 * DA + col;
  const float* ksr = p.ks + row0;
  const float* vsr = p.vs + row0;
  const float* er = p.extra + (size_t)bi * p.extra_stride + (size_t)a * p.R + j0;

  if (!solo) {
    if (tid == 0) {
      mbar_init(&bars[0], 1);
      mbar_init(&bars[1], 1);
      fence_barrier_init();
      mbar_expect_tx(&bars[0], C * 8);        // (m_r, l_r) of every rank
      mbar_expect_tx(&bars[1], C * 4 * per);  // every rank's sums of this rank's columns
    }
    cluster_arrive();
  }
  // the first pass of rows, its scales and extra row, and q, all requested now
  uint4 kreg[U], vreg[U];
  float ksv[U], vsv[U], ev[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int jt = u * M::STEP + warp * M::RPW + sub;
    const bool in = jt < rows;
    kreg[u] = in ? load_row16(kh + (size_t)jt * DA) : make_uint4(0, 0, 0, 0);
    vreg[u] = in ? load_row16(vh + (size_t)jt * DA) : make_uint4(0, 0, 0, 0);
    ksv[u] = in ? ksr[jt] : 0.f;
    vsv[u] = in ? vsr[jt] : 0.f;
    ev[u] = in ? er[jt] : 0.f;
  }
  float qv[VEC];
  load_q16(p.q, head * DA + col, p.io_bf16, qv);

  // ---- logits: LPR lanes per row, every lane of the group holds the sum
  float lg[U];
  float mw = -INFINITY;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    float dot = dot16f(qv, kreg[u]);
#pragma unroll
    for (int o = M::LPR / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
    const bool in = u * M::STEP + warp * M::RPW + sub < rows;
    lg[u] = in ? cache_logit(dot, p.scale, ksv[u], ev[u]) : -INFINITY;
    mw = fmaxf(mw, lg[u]);
  }
  for (int base = PASS; base < rows; base += PASS) {  // later passes: logits into s
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int jt = base + u * M::STEP + warp * M::RPW + sub;
      const bool in = jt < rows;
      float dot = dot16f(qv, in ? load_row16(kh + (size_t)jt * DA) : make_uint4(0, 0, 0, 0));
#pragma unroll
      for (int o = M::LPR / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (in) {
        const float l = cache_logit(dot, p.scale, ksr[jt], er[jt]);
        s[jt - PASS] = l;  // the row's lanes write the same value, and read it back
        mw = fmaxf(mw, l);
      }
    }
  }

  // ---- (max, sum) of each warp's rows, then of the rank's, then of all ranks'
  mw = warp_max(mw);
  float lw = 0.f;
  if (mw > -INFINITY) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int u = gl + k * M::LPR;
      const float x = u < U ? pick(lg, u) : -INFINITY;
      if (x > -INFINITY) lw += expf(x - mw);
    }
    for (int base = PASS; base < rows; base += PASS)
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int jt = base + u * M::STEP + warp * M::RPW + sub;
        if (leader && jt < rows) lw += expf(s[jt - PASS] - mw);
      }
  }
  lw = warp_sum(lw);
  if (lane == 0) red[warp] = mw, red[CW + warp] = lw;
  __syncthreads();
  float m = -INFINITY;
#pragma unroll
  for (int w = 0; w < CW; ++w) m = fmaxf(m, red[w]);
  float sum = 0.f;
#pragma unroll
  for (int w = 0; w < CW; ++w)
    if (red[CW + w] > 0.f) sum += red[CW + w] * expf(red[w] - m);
  if (!solo) {
    cluster_wait();  // every rank's mbarriers are initialised
    if (tid < C) push2(map_rank(x1 + 2 * rank, tid), m, sum, map_rank(&bars[0], tid));
    mbar_wait(&bars[0], 0);
    m = -INFINITY;
    for (int r = 0; r < C; ++r) m = fmaxf(m, x1[2 * r]);
    sum = 0.f;
    for (int r = 0; r < C; ++r)
      if (x1[2 * r + 1] > 0.f) sum += x1[2 * r + 1] * expf(x1[2 * r] - m);
  }

  // ---- weights (each lane its share, handed to the group by a shuffle)
  // and the fp32 V product
  float wk[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int u = gl + k * M::LPR;
    const float x = u < U ? pick(lg, u) : -INFINITY;
    wk[k] = x > -INFINITY ? cache_weight<ROUND_W>(expf(x - m), sum, pick(vsv, u), p.io_bf16)
                          : 0.f;
  }
  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const float w = M::LPR == 1 ? wk[u]
                                : __shfl_sync(0xffffffffu, wk[u / M::LPR],
                                              (lane & ~(M::LPR - 1)) | (u % M::LPR));
    axpy16f(w, vreg[u], acc);
  }
  for (int base = PASS; base < rows; base += PASS) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int jt = base + u * M::STEP + warp * M::RPW + sub;
      if (jt < rows)
        axpy16f(cache_weight<ROUND_W>(expf(s[jt - PASS] - m), sum, vsr[jt], p.io_bf16),
                load_row16(vh + (size_t)jt * DA), acc);
    }
  }
  // lanes of one warp that hold the same columns, then the warps in order
  {
    const int c0 = column_sums<M::LPR>(acc, lane);
    if (M::LPR > 1 || lane < 16) {
#pragma unroll
      for (int i = 0; i < ColumnSums<M::LPR>::N; ++i) partial[warp * DA + col + c0 + i] = acc[i];
    }
  }
  __syncthreads();
  if (tid < DA) {
    float o = partial[tid];
#pragma unroll
    for (int w = 1; w < CW; ++w) o += partial[w * DA + tid];
    if (solo) store_scalar(p.out, head * DA + tid, o, p.io_bf16);
    else push(map_rank(x3 + rank * per + tid % per, tid / per), o, map_rank(&bars[1], tid / per));
  }
  if (!solo) {
    mbar_wait(&bars[1], 0);  // every rank's sums of this rank's columns have landed
    if (tid < per) {
      float o = x3[tid];
      for (int r = 1; r < C; ++r) o += x3[r * per + tid];
      store_scalar(p.out, head * DA + rank * per + tid, o, p.io_bf16);
    }
  }
}

// da = 16: one warp per (batch row, head), `heads` = b * na of them, rows
// lane + 32 u for u < WARP_U (live <= 256)
template <bool ROUND_W>
__global__ void __launch_bounds__(WARP_HEADS * 32) cache_i8_warp_kernel(const CacheArgs p,
                                                                       int heads) {
  constexpr int DA = 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int hidx = blockIdx.x * WARP_HEADS + warp;
  if (hidx >= heads) return;
  const int bi = hidx / p.na, a = hidx % p.na;
  const size_t row0 = (size_t)hidx * p.R;
  const float* er = p.extra + (size_t)bi * p.extra_stride + (size_t)a * p.R;

  uint4 kreg[WARP_U], vreg[WARP_U];
  float ksv[WARP_U], vsv[WARP_U], ev[WARP_U];
#pragma unroll
  for (int u = 0; u < WARP_U; ++u) {
    const int j = lane + 32 * u;
    const bool in = j < p.live;
    kreg[u] = in ? load_row16(p.k8 + (row0 + j) * DA) : make_uint4(0, 0, 0, 0);
    vreg[u] = in ? load_row16(p.v8 + (row0 + j) * DA) : make_uint4(0, 0, 0, 0);
    ksv[u] = in ? p.ks[row0 + j] : 0.f;
    vsv[u] = in ? p.vs[row0 + j] : 0.f;
    ev[u] = in ? er[j] : 0.f;
  }
  float qv[DA];
  load_q16(p.q, (size_t)hidx * DA, p.io_bf16, qv);

  float lg[WARP_U], m = -INFINITY;
#pragma unroll
  for (int u = 0; u < WARP_U; ++u) {
    lg[u] = lane + 32 * u < p.live ? cache_logit(dot16f(qv, kreg[u]), p.scale, ksv[u], ev[u])
                                   : -INFINITY;
    m = fmaxf(m, lg[u]);
  }
  m = warp_max(m);
  float sum = 0.f;
#pragma unroll
  for (int u = 0; u < WARP_U; ++u)
    if (lg[u] > -INFINITY) sum += expf(lg[u] - m);
  sum = warp_sum(sum);
  float acc[DA];
#pragma unroll
  for (int e = 0; e < DA; ++e) acc[e] = 0.f;
#pragma unroll
  for (int u = 0; u < WARP_U; ++u) {
    const float w =
        lg[u] > -INFINITY ? cache_weight<ROUND_W>(expf(lg[u] - m), sum, vsv[u], p.io_bf16) : 0.f;
    axpy16f(w, vreg[u], acc);
  }
  const int c = column_sums<1>(acc, lane);
  if (lane < 16) store_scalar(p.out, (size_t)hidx * DA + c, acc[0], p.io_bf16);
}

// the launch of cache_i8_kernel with a cluster of C ranks of CW warps of U
// row loads a thread
template <int DA, int CW, int U, bool ROUND_W>
cudaError_t launch_cache(const CacheArgs& p, int b, int C, cudaStream_t stream) {
  const size_t smem = cache_smem_bytes(DA, CW, U, p.chunk);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  auto kernel = cache_i8_kernel<DA, CW, U, ROUND_W>;
  static size_t smem_set = 48 * 1024;  // granted without the attribute
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
  cfg.blockDim = dim3(CW * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int DA, bool ROUND_W>
cudaError_t launch_cache_warps(const CacheArgs& p, int b, int C, int warps, int loads,
                               cudaStream_t stream) {
  if (warps == 4) return launch_cache<DA, 4, 4, ROUND_W>(p, b, C, stream);
  return loads == 8 ? launch_cache<DA, 8, 8, ROUND_W>(p, b, C, stream)
                    : launch_cache<DA, 8, 4, ROUND_W>(p, b, C, stream);
}

// a plan of kernels 5 and 12: C ranks (a power of two up to MAX_CLUSTER) of
// `chunk` rows each holding the live rows, ranks of 4 warps of 4 row loads a
// thread or of 8 warps of 4 or 8; or one warp a head (warps 1: da 16, C 1,
// live <= 32 * WARP_U)
bool bad_cache_plan(int C, int chunk, int warps, int loads, int live, int da) {
  if (warps == 1) return C != 1 || da != 16 || live > 32 * WARP_U || chunk < live;
  return C < 1 || C > MAX_CLUSTER || (C & (C - 1)) != 0 || chunk < 1 ||
         (long long)C * chunk < live || (warps != 4 && warps != 8) ||
         (loads != 4 && (loads != 8 || warps != 8)) ||
         cache_smem_bytes(da, warps, loads, chunk) > MAX_SMEM;
}

template <bool ROUND_W>
int launch_cache_attention(const void* q, const void* k8, const float* ks, const void* v8,
                           const float* vs, const float* extra, void* out, int b, int na, int R,
                           int da, int live, int eb, int C, int chunk, int warps, int loads,
                           int io_bf16, float scale, cudaStream_t stream) {
  if (bad_cache_plan(C, chunk, warps, loads, live, da)) return (int)cudaErrorInvalidValue;
  CacheArgs p = {};
  p.q = q;
  p.k8 = static_cast<const int8_t*>(k8);
  p.ks = ks;
  p.v8 = static_cast<const int8_t*>(v8);
  p.vs = vs;
  p.extra = extra;
  p.out = out;
  p.extra_stride = eb == 1 ? 0 : (size_t)na * R;
  p.na = na;
  p.R = R;
  p.live = live;
  p.chunk = chunk;
  p.scale = scale;
  p.io_bf16 = io_bf16;
  if (warps == 1) {
    const int heads = b * na;
    cache_i8_warp_kernel<ROUND_W>
        <<<(heads + WARP_HEADS - 1) / WARP_HEADS, WARP_HEADS * 32, 0, stream>>>(p, heads);
    return (int)cudaGetLastError();
  }
  cudaError_t err = da == 128  ? launch_cache_warps<128, ROUND_W>(p, b, C, warps, loads, stream)
                    : da == 64 ? launch_cache_warps<64, ROUND_W>(p, b, C, warps, loads, stream)
                               : launch_cache_warps<16, ROUND_W>(p, b, C, warps, loads, stream);
  return (int)err;
}

bool bad_shape(int b, int na, int R, int da, int live) {
  return b < 1 || na < 1 || b > 65535 || na > 65535 || live < 1 || live > R || R > 32768 ||
         (da != 64 && da != 128);
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
// int8; ks, vs (b, na, R) fp32; extra (eb, na, R) fp32 with eb = b or 1; q
// 16-byte aligned; a cluster of `cluster` ranks of `warps` warps of `loads`
// row loads a thread and `chunk` rows each per (batch row, head)
// (ops/cache_attention.py cache_attention_plan). Returns the cudaError_t of
// the launch: a cluster the card cannot place fails it.
extern "C" int lvt_cache_attention_i8(const void* q, const void* k8, const float* ks,
                                      const void* v8, const float* vs, const float* extra,
                                      void* out, int b, int na, int R, int da, int live, int eb,
                                      int cluster, int chunk, int warps, int loads, int io_bf16,
                                      float scale, cudaStream_t stream) {
  if (bad_shape(b, na, R, da, live) || (eb != 1 && eb != b) ||
      reinterpret_cast<uintptr_t>(q) % 16)
    return (int)cudaErrorInvalidValue;
  return launch_cache_attention<false>(q, k8, ks, v8, vs, extra, out, b, na, R, da, live, eb,
                                       cluster, chunk, warps, loads, io_bf16, scale, stream);
}

// Kernel 12, the probe kernel: kernel 5's operands, layouts and plans, da
// also 16 (there also one warp a head: warps = 1); the weight row is rounded
// to the io dtype before the V product.
extern "C" int lvt_decode_attention_i8kv(const void* q, const void* k8, const float* ks,
                                         const void* v8, const float* vs, const float* extra,
                                         void* out, int b, int na, int R, int da, int live,
                                         int eb, int cluster, int chunk, int warps, int loads,
                                         int io_bf16, float scale, cudaStream_t stream) {
  if (bad_shape(b, na, R, da == 16 ? 64 : da, live) || (eb != 1 && eb != b) ||
      reinterpret_cast<uintptr_t>(q) % 16)
    return (int)cudaErrorInvalidValue;
  return launch_cache_attention<true>(q, k8, ks, v8, vs, extra, out, b, na, R, da, live, eb,
                                      cluster, chunk, warps, loads, io_bf16, scale, stream);
}
