// The fused block-local transformer layer: forward (kernel 7), backward of the
// FFN half (kernel 8) and backward of the attention half (kernel 9), for token
// blocks x (nb, n, d) with na heads of da:
//   y = LN(x);  qkv = y wqkv;  o_a = softmax(q_a k_a^T * scale + B_a [causal]) v_a
//   x2 = o_all proj + x (fp32);  y2 = LN(x2);  f = relu(y2 w1 + b1)
//   out = f w2 + b2 + x2
//
// Replaces the TPU kernels of lvt_tpu/ops/fused_layer.py:
// fused_layer_tokens_pallas (its pl.pallas_call at :173), ffn_half_bwd_pallas
// (:259) and attn_half_bwd_pallas (:413). Those run one program per 256-token
// block with every operand and accumulator in on-chip memory, the grid in
// sequence, and sum the weight gradients by revisiting one output block. On
// the H100 a (256, 512) tile does not fit a block's 227 KB of shared memory,
// blocks run in no order, and 64 programs would leave half the SMs idle. Each
// kernel here is several __global__ functions behind one C entry point, over
// row tiles of the (nb * n, d) token matrix:
//
// kernel 7  ln_qkv      LN prologue + QKV product per row tile (256 columns at
//                       a time), qkv rounded to the io dtype into a head-major
//                       scratch (3, nb, na, n, da);
//           kernel 1's device code (block_attention.cuh) on that scratch: P
//                       rounded to io, P.V rounded to io, o (nb, na, n, da);
//           proj_ffn    per row tile: o_all proj + x = x2, kept in fp32 in
//                       shared memory (also stored, rounded, when asked), LN,
//                       w1, bias, ReLU, rounding, w2, bias, + x2, one rounding
//                       on store.
// kernel 8  ffn_bwd_rows per row tile: LN and f_pre recomputed from the saved
//                       x2, df = g w2^T, the ReLU gate, dy2 = dfp w1^T, the LN
//                       backward and dx2 = dx2_ln + g; y2, f and dfp (io dtype)
//                       go to scratch, and the tile's column sums of dfp, g,
//                       dy2 * yhat and dy2 to a per-tile scratch;
//           gemm_tn     dw2 = f^T g and dw1 = y2^T dfp over all rows, the rows
//                       cut into ranges whose partial products a last kernel
//                       adds in a fixed order (no float atomicAdd: every
//                       output is bit-identical from call to call); the same
//                       reduction adds the per-tile column sums.
// kernel 9  ln_qkv (also storing y), do = dx2 proj^T (gemm_nt), kernel 1's
//           device code for o, kernel 10's (block_attention_bwd.cuh) for dq,
//           dk, dv and dbias from q, k, v and do, dy = dqkv wqkv^T (gemm_nt),
//           dproj = o^T dx2 and dwqkv = y^T dqkv (gemm_tn + reduction).
//
// Every matrix product is this file's or those headers' own code: bf16 on
// tensor cores through mma.sync m16n8k16 with fp32 accumulators, fp32 on FMAs
// (TF32 would round the inputs to 10 bits). Weights arrive as B operands with
// rows of consecutive k, i.e. (outputs, inputs): the wrapper passes w^T where
// the product is with w, and w itself where it is with w^T.
//
// What bounds it on the H100: at DSFVT (nb = 64, n = 256, d = 512, na = 8,
// da = 128) kernel 7 is ~103 GFLOP over ~50 MB of inputs and outputs, far
// above the 295 flops per byte at which bf16 tensor cores stop waiting on
// memory, so its bound is the tensor cores (0.10 ms); this simple design is
// instead bound by shared-memory fragment loads and barriers (no copy overlap,
// weights re-read from L2 by every row tile) and by the qkv scratch (100 MB
// written and read once). wgmma and TMA pipelines are later work.
//
// Shapes: d a multiple of 64 up to 512; da in {64, 128}; n <= 256 in bf16 and
// <= 1024 in fp32 (kernels 1 and 10); any nb.

#include "block_attention.cuh"
#include "mma_tiles.cuh"
#include "block_attention_bwd.cuh"

namespace {

using bf16 = __nv_bfloat16;
using lvt_mma::ld32;
using lvt_mma::load_a;
using lvt_mma::mma_bf16;

constexpr int THREADS = 256;  // every kernel of this file: 8 warps

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(bf16* p, float x) { *p = __float2bfloat16_rn(x); }

// A (rows, columns) matrix of activations in device memory: row-major with
// row stride ld (nh == 0), or head-major (parts, nb, nh, n, da), where row =
// blk * n + i and column = (part * nh + a) * da + c. 16-byte chunks of columns
// (starting at a multiple of 8) are contiguous in both.
template <class T>
struct View {
  T* p;
  long ld;
  int nb, nh, n, da;
  // an element's offset is a row's part plus a column's part (32-bit
  // divisions: rows = nb * n stay far below 2^31)
  __device__ __forceinline__ size_t row_off(int row) const {
    if (nh == 0) return (size_t)row * ld;
    const int blk = row / n, i = row - blk * n;
    return ((size_t)blk * nh * n + i) * da;
  }
  __device__ __forceinline__ size_t col_off(int col) const {
    if (nh == 0) return col;
    const int part = col / (nh * da), rem = col - part * nh * da;
    const int a = rem / da, c = rem - a * da;
    return ((size_t)part * nb * nh + a) * n * da + c;
  }
  __device__ __forceinline__ T* at(int row, int col) const {
    return p + row_off(row) + col_off(col);
  }
};

template <class T>
View<T> row_major(const void* p, int ld) {
  return View<T>{static_cast<T*>(const_cast<void*>(p)), ld, 0, 0, 0, 0};
}

template <class T>
View<T> head_major(const void* p, int nb, int nh, int n, int da) {
  return View<T>{static_cast<T*>(const_cast<void*>(p)), 0, nb, nh, n, da};
}

// ---------------------------------------------------------------------------
// Row-tile products: C (ROWS x NC) = A (ROWS x K) B^T, B (NC x K) a weight
// ---------------------------------------------------------------------------

// bf16: a block of 8 warps owns 32 rows x 256 columns; warp w owns all 32
// rows of columns [32 w, 32 w + 32) as 2 x 4 mma tiles. A sits row-major in
// shared memory (row stride a multiple of 64 plus 8 elements, so the 8 rows x
// 4 words of a fragment read hit 32 banks), B one 64-deep chunk at a time.
struct TileBF16 {
  using T = bf16;
  static constexpr int ROWS = 32, NC = 256, KC = 64, PAD = 8, VEC = 8;
  static constexpr int RPT = 4, CPT = 8;  // rows and columns held per thread
  static constexpr int PAIR = 2;          // columns 2 j and 2 j + 1 are neighbours
  float c[2][4][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[i][j][e] = 0.f;
  }
  // one chunk: A columns [0, KC) at As (row stride lda), B chunk Bs[NC][KC + PAD]
  __device__ __forceinline__ void mac(const T* As, int lda, const T* Bs) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      uint32_t fa[2][4];
      load_a(fa[0], As, lda, kk, g, t);
      load_a(fa[1], As + 16 * lda, lda, kk, g, t);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const T* br = Bs + (warp * 32 + j * 8 + g) * (KC + PAD) + kk * 16 + 2 * t;
        const uint32_t b0 = ld32(br), b1 = ld32(br + 8);
        mma_bf16(c[0][j], fa[0], b0, b1);
        mma_bf16(c[1][j], fa[1], b0, b1);
      }
    }
  }
  __device__ __forceinline__ int row(int i) const {
    return (i >> 1) * 16 + (i & 1) * 8 + (threadIdx.x % 32) / 4;
  }
  __device__ __forceinline__ int col(int j) const {
    return (threadIdx.x / 32) * 32 + (j >> 1) * 8 + 2 * (threadIdx.x % 4) + (j & 1);
  }
  __device__ __forceinline__ float val(int i, int j) const {
    return c[i >> 1][j >> 1][(i & 1) * 2 + (j & 1)];
  }
  // sum of v over the tile's 32 rows, given each thread's sum over its own 4:
  // the other rows of a column sit in the lanes of the same t (same warp)
  static __device__ __forceinline__ float colsum(float v) {
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
  }
  static __device__ __forceinline__ bool colsum_owner() { return (threadIdx.x % 32) / 4 == 0; }
  // two neighbouring columns rounded and stored as one 32-bit word
  static __device__ __forceinline__ void store(T* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};

// fp32: 16 rows x 256 columns; thread i owns column i of all 16 rows. A reads
// are warp-wide broadcasts, B rows of KC + 4 floats put a quarter warp's
// float4 reads on distinct banks.
struct TileF32 {
  using T = float;
  static constexpr int ROWS = 16, NC = 256, KC = 32, PAD = 4, VEC = 4;
  static constexpr int RPT = 16, CPT = 1, PAIR = 1;
  float c[16];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int r = 0; r < 16; ++r) c[r] = 0.f;
  }
  __device__ __forceinline__ void mac(const T* As, int lda, const T* Bs) {
    const float* b = Bs + threadIdx.x * (KC + PAD);
#pragma unroll
    for (int kk = 0; kk < KC; kk += 4) {
      const float4 bv = *reinterpret_cast<const float4*>(b + kk);
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float4 av = *reinterpret_cast<const float4*>(As + r * lda + kk);
        c[r] = fmaf(av.x, bv.x, c[r]);
        c[r] = fmaf(av.y, bv.y, c[r]);
        c[r] = fmaf(av.z, bv.z, c[r]);
        c[r] = fmaf(av.w, bv.w, c[r]);
      }
    }
  }
  __device__ __forceinline__ int row(int i) const { return i; }
  __device__ __forceinline__ int col(int) const { return threadIdx.x; }
  __device__ __forceinline__ float val(int i, int) const { return c[i]; }
  static __device__ __forceinline__ float colsum(float v) { return v; }
  static __device__ __forceinline__ bool colsum_owner() { return true; }
  static __device__ __forceinline__ void store(T* p, float a, float) { *p = a; }
};

template <class TL>
constexpr size_t bs_bytes() {
  return sizeof(typename TL::T) * TL::NC * (TL::KC + TL::PAD);
}
template <class TL>
constexpr size_t ac_bytes() {
  return sizeof(typename TL::T) * TL::ROWS * (TL::KC + TL::PAD);
}
template <class TL>
size_t tile_bytes(int d) {  // an io-dtype ROWS x d tile with padded rows
  return sizeof(typename TL::T) * TL::ROWS * (size_t)(d + TL::PAD);
}

// rows [col0, col0 + NC) of the weight W (N, K), columns [k0, k0 + KC), into
// Bs[NC][KC + PAD]; rows past N are zero
template <class TL>
__device__ __forceinline__ void stage_b(typename TL::T* Bs, const typename TL::T* W, int K,
                                        int N, int col0, int k0) {
  constexpr int CPR = TL::KC / TL::VEC;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < TL::NC * CPR; i += THREADS) {
    const int r = i / CPR, ch = (i % CPR) * TL::VEC;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (col0 + r < N) v = *reinterpret_cast<const uint4*>(W + (size_t)(col0 + r) * K + k0 + ch);
    *reinterpret_cast<uint4*>(Bs + r * (TL::KC + TL::PAD) + ch) = v;
  }
}

// rows [row0, row0 + ROWS) of the activations A, columns [k0, k0 + KC), into
// Ac[ROWS][KC + PAD]; rows past R are zero
template <class TL>
__device__ __forceinline__ void stage_a(typename TL::T* Ac, const View<typename TL::T>& A,
                                        int row0, long R, int k0) {
  constexpr int CPR = TL::KC / TL::VEC;
  for (int i = threadIdx.x; i < TL::ROWS * CPR; i += THREADS) {
    const int r = i / CPR, ch = (i % CPR) * TL::VEC;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < R) v = *reinterpret_cast<const uint4*>(A.at(row0 + r, k0 + ch));
    *reinterpret_cast<uint4*>(Ac + r * (TL::KC + TL::PAD) + ch) = v;
  }
}

// acc = As (ROWS x K, resident in shared memory) times rows [col0, col0 + NC)
// of W. The barrier at the head of each step also orders the caller's writes
// of As before the first product.
template <class TL>
__device__ __forceinline__ void gemm_resident(TL& acc, const typename TL::T* As, int lda,
                                              const typename TL::T* W, int K, int N, int col0,
                                              typename TL::T* Bs) {
  acc.zero();
  for (int k0 = 0; k0 < K; k0 += TL::KC) {
    __syncthreads();  // previous readers of Bs are done
    stage_b<TL>(Bs, W, K, N, col0, k0);
    __syncthreads();
    acc.mac(As + k0, lda, Bs);
  }
}

// the same with A streamed from device memory through Ac, chunk by chunk
template <class TL>
__device__ __forceinline__ void gemm_streamed(TL& acc, const View<typename TL::T>& A, int row0,
                                              long R, typename TL::T* Ac,
                                              const typename TL::T* W, int K, int N, int col0,
                                              typename TL::T* Bs) {
  acc.zero();
  for (int k0 = 0; k0 < K; k0 += TL::KC) {
    __syncthreads();
    stage_a<TL>(Ac, A, row0, R, k0);
    stage_b<TL>(Bs, W, K, N, col0, k0);
    __syncthreads();
    acc.mac(Ac, TL::KC + TL::PAD, Bs);
  }
}

// acc, the tile at (row0, col0), rounded to the io dtype into C; rows past R
// and columns past N (a multiple of 8) are dropped
template <class TL>
__device__ __forceinline__ void store_tile(const TL& acc, const View<typename TL::T>& C,
                                           int row0, long R, int col0, int N) {
  size_t ro[TL::RPT];
  bool in[TL::RPT];
#pragma unroll
  for (int i = 0; i < TL::RPT; ++i) {
    const int row = row0 + acc.row(i);
    in[i] = row < R;
    ro[i] = C.row_off(in[i] ? row : 0);
  }
#pragma unroll
  for (int j = 0; j < TL::CPT; j += TL::PAIR) {
    const int col = col0 + acc.col(j);
    if (col >= N) continue;
    const size_t co = C.col_off(col);
#pragma unroll
    for (int i = 0; i < TL::RPT; ++i)
      if (in[i]) TL::store(C.p + ro[i] + co, acc.val(i, j), acc.val(i, j + TL::PAIR - 1));
  }
}

// rows [row0, row0 + ROWS) of the row-major (R, d) matrix X as fp32 into
// Xf[ROWS][d], and, when Xs is given, unchanged into Xs[ROWS][d + PAD]; rows
// past R are zero
template <class TL>
__device__ __forceinline__ void load_rows_f32(float* Xf, typename TL::T* Xs,
                                              const typename TL::T* X, long row0, long R,
                                              int d) {
  using T = typename TL::T;
  const int cpr = d / TL::VEC;
  for (int i = threadIdx.x; i < TL::ROWS * cpr; i += THREADS) {
    const int r = i / cpr, ch = (i % cpr) * TL::VEC;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < R) v = *reinterpret_cast<const uint4*>(X + (size_t)(row0 + r) * d + ch);
    const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int j = 0; j < TL::VEC; ++j) Xf[r * d + ch + j] = to_f(e[j]);
    if (Xs != nullptr) *reinterpret_cast<uint4*>(Xs + r * (d + TL::PAD) + ch) = v;
  }
}

// the tile Xs[ROWS][d + PAD] to rows [row0, row0 + ROWS) of the row-major
// (R, d) matrix X
template <class TL>
__device__ __forceinline__ void store_rows(typename TL::T* X, const typename TL::T* Xs,
                                           long row0, long R, int d) {
  const int cpr = d / TL::VEC;
  for (int i = threadIdx.x; i < TL::ROWS * cpr; i += THREADS) {
    const int r = i / cpr, ch = (i % cpr) * TL::VEC;
    if (row0 + r < R)
      *reinterpret_cast<uint4*>(X + (size_t)(row0 + r) * d + ch) =
          *reinterpret_cast<const uint4*>(Xs + r * (d + TL::PAD) + ch);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// fp32 LayerNorm of the rows Xf[rows][d], one warp per row, the statistics as
// lvt_tpu's _ln_fwd_f32 (mean, then the mean of squared deviations):
// Y[rows][ldy] = yhat * gamma + beta rounded to T. With KEEP, Xf becomes yhat
// and rs[row] the reciprocal standard deviation, for the LN backward.
template <class T, bool KEEP>
__device__ __forceinline__ void ln_rows(float* Xf, int d, int rows, const T* gamma,
                                        const T* beta, T* Y, int ldy, float* rs) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += THREADS / 32) {
    float* x = Xf + r * d;
    float s = 0.f;
    for (int c = lane; c < d; c += 32) s += x[c];
    const float mu = warp_sum(s) / (float)d;
    float v = 0.f;
    for (int c = lane; c < d; c += 32) v += (x[c] - mu) * (x[c] - mu);
    const float rstd = rsqrtf(warp_sum(v) / (float)d + 1e-5f);
    for (int c = lane; c < d; c += 32) {
      const float yh = (x[c] - mu) * rstd;
      from_f(Y + r * ldy + c, yh * to_f(gamma[c]) + to_f(beta[c]));
      if (KEEP) x[c] = yh;
    }
    if (KEEP && lane == 0) rs[r] = rstd;
  }
}

// ---------------------------------------------------------------------------
// ln_qkv: C = LN(x) W^T per row tile, rounded to the io dtype
// ---------------------------------------------------------------------------

template <class TL>
size_t ln_qkv_smem(int d) {
  return sizeof(float) * TL::ROWS * (size_t)d + tile_bytes<TL>(d) + bs_bytes<TL>();
}

// Shared memory: Xf[ROWS][d] fp32 | Y[ROWS][d + PAD] | Bs. The LayerNorm runs
// once per row tile; the block then walks the N columns 256 at a time.
template <class TL>
__global__ void __launch_bounds__(THREADS)
ln_qkv(const typename TL::T* __restrict__ x, const typename TL::T* __restrict__ gamma,
       const typename TL::T* __restrict__ beta, const typename TL::T* __restrict__ W,
       View<typename TL::T> C, typename TL::T* __restrict__ y_out, long R, int d, int N) {
  using T = typename TL::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Xf = reinterpret_cast<float*>(smem_raw);
  T* Y = reinterpret_cast<T*>(Xf + TL::ROWS * d);
  T* Bs = Y + TL::ROWS * (d + TL::PAD);
  const int row0 = blockIdx.x * TL::ROWS;

  load_rows_f32<TL>(Xf, nullptr, x, row0, R, d);
  __syncthreads();
  ln_rows<T, false>(Xf, d, TL::ROWS, gamma, beta, Y, d + TL::PAD, nullptr);
  if (y_out != nullptr) {
    __syncthreads();
    store_rows<TL>(y_out, Y, row0, R, d);
  }
  TL acc;
  for (int col0 = 0; col0 < N; col0 += TL::NC) {
    gemm_resident<TL>(acc, Y, d + TL::PAD, W, d, N, col0, Bs);
    store_tile<TL>(acc, C, row0, R, col0, N);
  }
}

// ---------------------------------------------------------------------------
// gemm_nt: C = A W^T rounded to the io dtype, A streamed
// ---------------------------------------------------------------------------

template <class TL>
constexpr size_t gemm_nt_smem() {
  return ac_bytes<TL>() + bs_bytes<TL>();
}

template <class TL>
__global__ void __launch_bounds__(THREADS)
gemm_nt(View<typename TL::T> A, const typename TL::T* __restrict__ W, View<typename TL::T> C,
        long R, int K, int N) {
  using T = typename TL::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ac = reinterpret_cast<T*>(smem_raw);
  T* Bs = Ac + TL::ROWS * (TL::KC + TL::PAD);
  const int row0 = blockIdx.x * TL::ROWS;
  const int col0 = blockIdx.y * TL::NC;
  TL acc;
  gemm_streamed<TL>(acc, A, row0, R, Ac, W, K, N, col0, Bs);
  store_tile<TL>(acc, C, row0, R, col0, N);
}

// ---------------------------------------------------------------------------
// proj_ffn: the forward from the heads' outputs to the layer's output
// ---------------------------------------------------------------------------

template <class TL>
size_t proj_ffn_smem(int d) {
  return sizeof(float) * TL::ROWS * (size_t)d + 2 * tile_bytes<TL>(d) + ac_bytes<TL>() +
         bs_bytes<TL>();
}

// Shared memory: X2[ROWS][d] fp32 | Y2[ROWS][d + PAD] | F[ROWS][d + PAD] | Ac | Bs
template <class TL>
__global__ void __launch_bounds__(THREADS)
proj_ffn(View<typename TL::T> O, const typename TL::T* __restrict__ x,
         const typename TL::T* __restrict__ projT, const typename TL::T* __restrict__ gamma,
         const typename TL::T* __restrict__ beta, const typename TL::T* __restrict__ w1T,
         const typename TL::T* __restrict__ b1, const typename TL::T* __restrict__ w2T,
         const typename TL::T* __restrict__ b2, typename TL::T* __restrict__ x2_out,
         typename TL::T* __restrict__ out, long R, int d, int KO) {
  using T = typename TL::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* X2 = reinterpret_cast<float*>(smem_raw);
  T* Y2 = reinterpret_cast<T*>(X2 + TL::ROWS * d);
  T* F = Y2 + TL::ROWS * (d + TL::PAD);
  T* Ac = F + TL::ROWS * (d + TL::PAD);
  T* Bs = Ac + TL::ROWS * (TL::KC + TL::PAD);
  const int ldt = d + TL::PAD;
  const int row0 = blockIdx.x * TL::ROWS;
  TL acc;

  // x2 = o_all proj + x, fp32
  for (int col0 = 0; col0 < d; col0 += TL::NC) {
    gemm_streamed<TL>(acc, O, row0, R, Ac, projT, KO, d, col0, Bs);
#pragma unroll
    for (int i = 0; i < TL::RPT; ++i) {
      const int r = acc.row(i);
#pragma unroll
      for (int j = 0; j < TL::CPT; ++j) {
        const int c = col0 + acc.col(j);
        if (c < d)
          X2[r * d + c] =
              acc.val(i, j) + (row0 + r < R ? to_f(x[(size_t)(row0 + r) * d + c]) : 0.f);
      }
    }
  }
  __syncthreads();
  if (x2_out != nullptr) {
    for (int i = threadIdx.x; i < TL::ROWS * d; i += THREADS)
      if (row0 + i / d < R) from_f(x2_out + (size_t)row0 * d + i, X2[i]);
  }
  ln_rows<T, false>(X2, d, TL::ROWS, gamma, beta, Y2, ldt, nullptr);

  // f = relu(y2 w1 + b1), rounded
  for (int col0 = 0; col0 < d; col0 += TL::NC) {
    gemm_resident<TL>(acc, Y2, ldt, w1T, d, d, col0, Bs);
#pragma unroll
    for (int i = 0; i < TL::RPT; ++i) {
      const int r = acc.row(i);
#pragma unroll
      for (int j = 0; j < TL::CPT; ++j) {
        const int c = col0 + acc.col(j);
        if (c < d) from_f(F + r * ldt + c, fmaxf(acc.val(i, j) + to_f(b1[c]), 0.f));
      }
    }
  }

  // out = f w2 + b2 + x2
  for (int col0 = 0; col0 < d; col0 += TL::NC) {
    gemm_resident<TL>(acc, F, ldt, w2T, d, d, col0, Bs);
#pragma unroll
    for (int i = 0; i < TL::RPT; ++i) {
      const int r = acc.row(i);
#pragma unroll
      for (int j = 0; j < TL::CPT; ++j) {
        const int c = col0 + acc.col(j);
        if (c < d && row0 + r < R)
          from_f(out + (size_t)(row0 + r) * d + c, acc.val(i, j) + to_f(b2[c]) + X2[r * d + c]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// ffn_bwd_rows: the FFN half's backward per row tile
// ---------------------------------------------------------------------------

template <class TL>
size_t ffn_bwd_smem(int d) {
  return sizeof(float) * TL::ROWS * (size_t)d + 3 * tile_bytes<TL>(d) + (size_t)TL::ROWS * d +
         sizeof(float) * TL::ROWS + bs_bytes<TL>();
}

// Shared memory: XH[ROWS][d] fp32 (x2, then yhat) | Y2[ROWS][d + PAD] |
// G[ROWS][d + PAD] | F[ROWS][d + PAD] (f, then dfp) | gate[ROWS][d] bytes |
// rs[ROWS] fp32 | Bs. DY[ROWS][d] fp32 (dy2) lies over Y2 and G once both are
// spent. acts = (y2, f, dfp), each (R, d); part_r (tiles, 4, d): the tile's
// column sums of dfp, g, dy2 * yhat, dy2.
template <class TL>
__global__ void __launch_bounds__(THREADS)
ffn_bwd_rows(const typename TL::T* __restrict__ x2, const typename TL::T* __restrict__ g,
             const typename TL::T* __restrict__ gamma, const typename TL::T* __restrict__ beta,
             const typename TL::T* __restrict__ w1T, const typename TL::T* __restrict__ w1,
             const typename TL::T* __restrict__ b1, const typename TL::T* __restrict__ w2,
             typename TL::T* __restrict__ dx2, typename TL::T* __restrict__ acts,
             float* __restrict__ part_r, long R, int d) {
  using T = typename TL::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldt = d + TL::PAD;
  float* XH = reinterpret_cast<float*>(smem_raw);
  T* Y2 = reinterpret_cast<T*>(XH + TL::ROWS * d);
  T* G = Y2 + TL::ROWS * ldt;
  T* F = G + TL::ROWS * ldt;
  unsigned char* gate = reinterpret_cast<unsigned char*>(F + TL::ROWS * ldt);
  float* rs = reinterpret_cast<float*>(gate + TL::ROWS * d);
  T* Bs = reinterpret_cast<T*>(rs + TL::ROWS);
  float* DY = reinterpret_cast<float*>(Y2);
  const int row0 = blockIdx.x * TL::ROWS;
  float* sums = part_r + (size_t)blockIdx.x * 4 * d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  TL acc;

  // XH = x2 as fp32 (G is scratch for the loader's copy), then G = g
  load_rows_f32<TL>(XH, nullptr, x2, row0, R, d);
  {
    const int cpr = d / TL::VEC;
    for (int i = threadIdx.x; i < TL::ROWS * cpr; i += THREADS) {
      const int r = i / cpr, ch = (i % cpr) * TL::VEC;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + r < R) v = *reinterpret_cast<const uint4*>(g + (size_t)(row0 + r) * d + ch);
      *reinterpret_cast<uint4*>(G + r * ldt + ch) = v;
    }
  }
  __syncthreads();
  ln_rows<T, true>(XH, d, TL::ROWS, gamma, beta, Y2, ldt, rs);
  for (int c = threadIdx.x; c < d; c += THREADS) {  // db2's share: column sums of g
    float s = 0.f;
    for (int r = 0; r < TL::ROWS; ++r) s += to_f(G[r * ldt + c]);
    sums[1 * d + c] = s;
  }
  __syncthreads();
  store_rows<TL>(acts, Y2, row0, R, d);

  // f_pre = y2 w1 + b1; the gate f_pre > 0; f = relu(f_pre) rounded
  for (int col0 = 0; col0 < d; col0 += TL::NC) {
    gemm_resident<TL>(acc, Y2, ldt, w1T, d, d, col0, Bs);
#pragma unroll
    for (int i = 0; i < TL::RPT; ++i) {
      const int r = acc.row(i);
#pragma unroll
      for (int j = 0; j < TL::CPT; ++j) {
        const int c = col0 + acc.col(j);
        if (c < d) {
          const float fp = acc.val(i, j) + to_f(b1[c]);
          gate[r * d + c] = fp > 0.f ? 1 : 0;
          from_f(F + r * ldt + c, fmaxf(fp, 0.f));
        }
      }
    }
  }
  __syncthreads();
  store_rows<TL>(acts + (size_t)R * d, F, row0, R, d);

  // dfp = gate ? g w2^T : 0, its column sums (fp32), dfp rounded into F. The
  // barrier at the head of gemm_resident orders the store of f above before
  // the first write of dfp.
  for (int col0 = 0; col0 < d; col0 += TL::NC) {
    gemm_resident<TL>(acc, G, ldt, w2, d, d, col0, Bs);
    float cs[TL::CPT];
#pragma unroll
    for (int j = 0; j < TL::CPT; ++j) cs[j] = 0.f;
#pragma unroll
    for (int i = 0; i < TL::RPT; ++i) {
      const int r = acc.row(i);
#pragma unroll
      for (int j = 0; j < TL::CPT; ++j) {
        const int c = col0 + acc.col(j);
        if (c < d) {
          const float dfp = gate[r * d + c] ? acc.val(i, j) : 0.f;
          cs[j] += dfp;
          from_f(F + r * ldt + c, dfp);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < TL::CPT; ++j) {
      const float s = TL::colsum(cs[j]);
      const int c = col0 + acc.col(j);
      if (TL::colsum_owner() && c < d) sums[0 * d + c] = s;
    }
  }
  __syncthreads();
  store_rows<TL>(acts + 2 * (size_t)R * d, F, row0, R, d);

  // dy2 = dfp w1^T into DY (over Y2 and G: their last readers, the products
  // above, are behind the barrier at the head of gemm_resident); column sums
  // of dy2 * yhat and dy2
  for (int col0 = 0; col0 < d; col0 += TL::NC) {
    gemm_resident<TL>(acc, F, ldt, w1, d, d, col0, Bs);
    float cs[TL::CPT], cb[TL::CPT];
#pragma unroll
    for (int j = 0; j < TL::CPT; ++j) cs[j] = cb[j] = 0.f;
#pragma unroll
    for (int i = 0; i < TL::RPT; ++i) {
      const int r = acc.row(i);
#pragma unroll
      for (int j = 0; j < TL::CPT; ++j) {
        const int c = col0 + acc.col(j);
        if (c < d) {
          const float dy = acc.val(i, j);
          DY[r * d + c] = dy;
          cs[j] += dy * XH[r * d + c];
          cb[j] += dy;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < TL::CPT; ++j) {
      const float s = TL::colsum(cs[j]), b = TL::colsum(cb[j]);
      const int c = col0 + acc.col(j);
      if (TL::colsum_owner() && c < d) {
        sums[2 * d + c] = s;
        sums[3 * d + c] = b;
      }
    }
  }
  __syncthreads();

  // LN backward per row, plus the residual path: dx2 = dx2_ln + g
  for (int r = warp; r < TL::ROWS; r += THREADS / 32) {
    if (row0 + r >= R) continue;
    float m1 = 0.f, m2 = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float dyh = DY[r * d + c] * to_f(gamma[c]);
      m1 += dyh;
      m2 += dyh * XH[r * d + c];
    }
    m1 = warp_sum(m1) / (float)d;
    m2 = warp_sum(m2) / (float)d;
    for (int c = lane; c < d; c += 32) {
      const float dyh = DY[r * d + c] * to_f(gamma[c]);
      const float go = to_f(g[(size_t)(row0 + r) * d + c]);
      from_f(dx2 + (size_t)(row0 + r) * d + c, rs[r] * (dyh - m1 - XH[r * d + c] * m2) + go);
    }
  }
}

// ---------------------------------------------------------------------------
// gemm_tn: part[z] = A[rows of range z]^T B[rows of range z], fp32
// ---------------------------------------------------------------------------

constexpr int TN_TILE = 128;  // output tile: 128 (columns of A) x 128 (columns of B)

__device__ __forceinline__ void tn_range(long R, int chunk, long& begin, long& end) {
  const long chunks = (R + chunk - 1) / chunk;
  const long per = (chunks + gridDim.z - 1) / gridDim.z * chunk;
  begin = (long)blockIdx.z * per;
  end = begin + per < R ? begin + per : R;
}

// bf16: both operands go through shared memory transposed (At[m][r], Bt[n][r],
// 64 rows at a time), so that the fragments are 32-bit reads along the summed
// axis; neighbouring lanes take neighbouring rows, so their 2-byte stores into
// one row of At fall on distinct banks. Warps 2 x 4, 64 x 32 outputs each.
__global__ void __launch_bounds__(THREADS)
gemm_tn_bf16(View<bf16> A, View<bf16> B, float* __restrict__ part, long R, int M, int N) {
  constexpr int RC = 64, LD = RC + 8;
  __shared__ __align__(16) bf16 At[TN_TILE * LD];
  __shared__ __align__(16) bf16 Bt[TN_TILE * LD];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.x * TN_TILE, n0 = blockIdx.y * TN_TILE;
  long begin, end;
  tn_range(R, RC, begin, end);
  float c[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[i][j][e] = 0.f;

  for (long r0 = begin; r0 < end; r0 += RC) {
    __syncthreads();  // previous readers of At, Bt are done
    for (int i = tid; i < RC * (TN_TILE / 8); i += THREADS) {
      const int r = i % RC, ch = (i / RC) * 8;
      uint4 va = make_uint4(0u, 0u, 0u, 0u), vb = va;
      if (r0 + r < end) {
        if (m0 + ch < M) va = *reinterpret_cast<const uint4*>(A.at((int)(r0 + r), m0 + ch));
        if (n0 + ch < N) vb = *reinterpret_cast<const uint4*>(B.at((int)(r0 + r), n0 + ch));
      }
      const bf16* ea = reinterpret_cast<const bf16*>(&va);
      const bf16* eb = reinterpret_cast<const bf16*>(&vb);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        At[(ch + e) * LD + r] = ea[e];
        Bt[(ch + e) * LD + r] = eb[e];
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < RC / 16; ++kk) {
      uint32_t fa[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) load_a(fa[i], At + (wm * 64 + i * 16) * LD, LD, kk, g, t);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bf16* br = Bt + (wn * 32 + j * 8 + g) * LD + kk * 16 + 2 * t;
        const uint32_t b0 = ld32(br), b1 = ld32(br + 8);
#pragma unroll
        for (int i = 0; i < 4; ++i) mma_bf16(c[i][j], fa[i], b0, b1);
      }
    }
  }

  float* out = part + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm * 64 + i * 16 + g + (e >> 1) * 8;
        const int n = n0 + wn * 32 + j * 8 + 2 * t + (e & 1);
        if (m < M && n < N) out[(size_t)m * N + n] = c[i][j][e];
      }
}

// fp32: 16 rows at a time as they lie (As[r][m], Bs[r][n]); thread (ty, tx)
// owns the 8 x 8 outputs at rows {4 ty.., 64 + 4 ty..}, columns {4 tx.., 64 + 4 tx..}
__global__ void __launch_bounds__(THREADS)
gemm_tn_f32(View<float> A, View<float> B, float* __restrict__ part, long R, int M, int N) {
  constexpr int RC = 16, LD = TN_TILE + 4;
  __shared__ __align__(16) float As[RC * LD];
  __shared__ __align__(16) float Bs[RC * LD];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.x * TN_TILE, n0 = blockIdx.y * TN_TILE;
  long begin, end;
  tn_range(R, RC, begin, end);
  float c[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) c[i][j] = 0.f;

  for (long r0 = begin; r0 < end; r0 += RC) {
    __syncthreads();
    for (int i = tid; i < RC * (TN_TILE / 4); i += THREADS) {
      const int r = i / (TN_TILE / 4), ch = (i % (TN_TILE / 4)) * 4;
      float4 va = make_float4(0.f, 0.f, 0.f, 0.f), vb = va;
      if (r0 + r < end) {
        if (m0 + ch < M) va = *reinterpret_cast<const float4*>(A.at((int)(r0 + r), m0 + ch));
        if (n0 + ch < N) vb = *reinterpret_cast<const float4*>(B.at((int)(r0 + r), n0 + ch));
      }
      *reinterpret_cast<float4*>(As + r * LD + ch) = va;
      *reinterpret_cast<float4*>(Bs + r * LD + ch) = vb;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < RC; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(As + k * LD + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(As + k * LD + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(Bs + k * LD + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(Bs + k * LD + 64 + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) c[i][j] = fmaf(a[i], b[j], c[i][j]);
    }
  }

  float* out = part + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int m = m0 + (i / 4) * 64 + ty * 4 + i % 4;
      const int n = n0 + (j / 4) * 64 + tx * 4 + j % 4;
      if (m < M && n < N) out[(size_t)m * N + n] = c[i][j];
    }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

#define LVT_TRY(expr)                      \
  do {                                     \
    const cudaError_t err_ = (expr);       \
    if (err_ != cudaSuccess) return err_;  \
  } while (0)

template <class K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <class TL>
unsigned tiles_of(long R) {
  return (unsigned)((R + TL::ROWS - 1) / TL::ROWS);
}

template <class TL>
cudaError_t run_ln_qkv(const void* x, const void* gamma, const void* beta, const void* W,
                       View<typename TL::T> C, void* y_out, long R, int d, int N,
                       cudaStream_t stream) {
  using T = typename TL::T;
  const size_t smem = ln_qkv_smem<TL>(d);
  LVT_TRY(set_smem(ln_qkv<TL>, smem));
  ln_qkv<TL><<<tiles_of<TL>(R), THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma), static_cast<const T*>(beta),
      static_cast<const T*>(W), C, static_cast<T*>(y_out), R, d, N);
  return cudaGetLastError();
}

template <class TL>
cudaError_t run_gemm_nt(View<typename TL::T> A, const void* W, View<typename TL::T> C, long R,
                        int K, int N, cudaStream_t stream) {
  using T = typename TL::T;
  constexpr size_t smem = gemm_nt_smem<TL>();
  LVT_TRY(set_smem(gemm_nt<TL>, smem));
  gemm_nt<TL><<<dim3(tiles_of<TL>(R), (N + TL::NC - 1) / TL::NC), THREADS, smem, stream>>>(
      A, static_cast<const T*>(W), C, R, K, N);
  return cudaGetLastError();
}

inline void launch_gemm_tn(dim3 grid, cudaStream_t stream, View<bf16> A, View<bf16> B,
                           float* part, long R, int M, int N) {
  gemm_tn_bf16<<<grid, THREADS, 0, stream>>>(A, B, part, R, M, N);
}
inline void launch_gemm_tn(dim3 grid, cudaStream_t stream, View<float> A, View<float> B,
                           float* part, long R, int M, int N) {
  gemm_tn_f32<<<grid, THREADS, 0, stream>>>(A, B, part, R, M, N);
}

// out (M, N) fp32 = A^T B over the R rows: `splits` partial products into
// part (splits, M, N), added in the order of the row ranges
template <class T>
cudaError_t run_gemm_tn(View<T> A, View<T> B, float* part, float* out, long R, int M, int N,
                        int splits, cudaStream_t stream) {
  const dim3 grid((M + TN_TILE - 1) / TN_TILE, (N + TN_TILE - 1) / TN_TILE, splits);
  launch_gemm_tn(grid, stream, A, B, part, R, M, N);
  LVT_TRY(cudaGetLastError());
  const size_t per = (size_t)M * N;
  lvt_bwd::dbias_reduce<<<(unsigned)((per + 255) / 256), 256, 0, stream>>>(part, out, splits,
                                                                            per);
  return cudaGetLastError();
}

bool shapes_ok(int nb, int n, int d, int nh, int da, int splits) {
  return nb >= 1 && n >= 1 && n <= 1024 && nh >= 1 && d >= 64 && d <= 512 && d % 64 == 0 &&
         (da == 64 || da == 128) && splits >= 1 && splits <= 65535;
}

template <class TL>
cudaError_t fused_layer_fwd(const void* x, const void* ln_s, const void* ln_b,
                            const void* wqkvT, const void* projT, const void* fln_s,
                            const void* fln_b, const void* w1T, const void* b1,
                            const void* w2T, const void* b2, const float* bias, void* qkv,
                            void* o, void* x2_out, void* out, int nb, int n, int d, int na,
                            int da, int causal, int dtype, float scale, cudaStream_t stream) {
  using T = typename TL::T;
  const long R = (long)nb * n;
  const size_t head = (size_t)nb * na * n * da;
  LVT_TRY(run_ln_qkv<TL>(x, ln_s, ln_b, wqkvT, head_major<T>(qkv, nb, na, n, da), nullptr, R, d,
                         3 * na * da, stream));
  T* q = static_cast<T*>(qkv);
  LVT_TRY((cudaError_t)lvt_fwd::block_attention_fwd(q, q + head, q + 2 * head, bias, o, nb, na,
                                                    n, da, causal, dtype, scale, stream));
  const size_t smem = proj_ffn_smem<TL>(d);
  LVT_TRY(set_smem(proj_ffn<TL>, smem));
  proj_ffn<TL><<<tiles_of<TL>(R), THREADS, smem, stream>>>(
      head_major<T>(o, nb, na, n, da), static_cast<const T*>(x), static_cast<const T*>(projT),
      static_cast<const T*>(fln_s), static_cast<const T*>(fln_b), static_cast<const T*>(w1T),
      static_cast<const T*>(b1), static_cast<const T*>(w2T), static_cast<const T*>(b2),
      static_cast<T*>(x2_out), static_cast<T*>(out), R, d, na * da);
  return cudaGetLastError();
}

template <class TL>
cudaError_t ffn_half_bwd(const void* x2, const void* g, const void* fln_s, const void* fln_b,
                         const void* w1T, const void* w1, const void* b1, const void* w2,
                         void* dx2, float* dw, float* sums, void* acts, float* part_w,
                         float* part_r, long R, int d, int splits, cudaStream_t stream) {
  using T = typename TL::T;
  const size_t smem = ffn_bwd_smem<TL>(d);
  const unsigned tiles = tiles_of<TL>(R);
  LVT_TRY(set_smem(ffn_bwd_rows<TL>, smem));
  ffn_bwd_rows<TL><<<tiles, THREADS, smem, stream>>>(
      static_cast<const T*>(x2), static_cast<const T*>(g), static_cast<const T*>(fln_s),
      static_cast<const T*>(fln_b), static_cast<const T*>(w1T), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2), static_cast<T*>(dx2),
      static_cast<T*>(acts), part_r, R, d);
  LVT_TRY(cudaGetLastError());
  T* a = static_cast<T*>(acts);
  const size_t per = (size_t)R * d;
  // dw1 = y2^T dfp, dw2 = f^T g (part_w is reused: the stream orders them)
  LVT_TRY(run_gemm_tn(row_major<T>(a, d), row_major<T>(a + 2 * per, d), part_w, dw, R, d, d,
                      splits, stream));
  LVT_TRY(run_gemm_tn(row_major<T>(a + per, d), row_major<T>(g, d), part_w, dw + (size_t)d * d,
                      R, d, d, splits, stream));
  lvt_bwd::dbias_reduce<<<(4 * d + 255) / 256, 256, 0, stream>>>(part_r, sums, (int)tiles,
                                                                  (size_t)4 * d);
  return cudaGetLastError();
}

template <class TL>
cudaError_t attn_half_bwd(const void* x, const void* dx2, const void* ln_s, const void* ln_b,
                          const void* wqkvT, const void* wqkv, const void* proj,
                          const float* bias, void* dy, float* dwqkv, float* dproj, float* dbias,
                          void* y, void* qkv, void* do_o, void* dqkv, float* stats,
                          float* part_b, float* part_w, int nb, int n, int d, int nh, int da,
                          int causal, int splits, int dtype, float scale, cudaStream_t stream) {
  using T = typename TL::T;
  const long R = (long)nb * n;
  const size_t head = (size_t)nb * nh * n * da;
  const int wide = 3 * nh * da;
  T* q = static_cast<T*>(qkv);
  T* dO = static_cast<T*>(do_o);
  T* o = dO + head;
  T* dq = static_cast<T*>(dqkv);
  LVT_TRY(run_ln_qkv<TL>(x, ln_s, ln_b, wqkvT, head_major<T>(qkv, nb, nh, n, da), y, R, d, wide,
                         stream));
  // do = dx2 proj^T, rounded, head-major
  LVT_TRY(run_gemm_nt<TL>(row_major<T>(dx2, d), proj, head_major<T>(dO, nb, nh, n, da), R, d,
                          nh * da, stream));
  LVT_TRY((cudaError_t)lvt_fwd::block_attention_fwd(q, q + head, q + 2 * head, bias, o, nb, nh,
                                                    n, da, causal, dtype, scale, stream));
  LVT_TRY((cudaError_t)lvt_bwd::block_attention_bwd(q, q + head, q + 2 * head, bias, dO, dq,
                                                    dq + head, dq + 2 * head, dbias, stats,
                                                    part_b, nb, nh, n, da, causal, dtype, scale,
                                                    stream));
  // dy = dqkv wqkv^T, rounded
  LVT_TRY(run_gemm_nt<TL>(head_major<T>(dqkv, nb, nh, n, da), wqkv, row_major<T>(dy, d), R, wide,
                          d, stream));
  // dproj = o_all^T dx2, dwqkv = y^T dqkv
  LVT_TRY(run_gemm_tn(head_major<T>(o, nb, nh, n, da), row_major<T>(dx2, d), part_w, dproj, R,
                      nh * da, d, splits, stream));
  return run_gemm_tn(row_major<T>(y, d), head_major<T>(dqkv, nb, nh, n, da), part_w, dwqkv, R,
                     d, wide, splits, stream);
}

}  // namespace

// Kernel 7. dtype: 0 = float32, 1 = bfloat16 (activations and parameters; the
// bias is fp32). wqkvT (3 na da, d), projT (d, na da), w1T and w2T (d, d): the
// weights transposed. qkv (3, nb, na, n, da) and o (nb, na, n, da) are scratch
// the caller allocates; x2_out may be null. Launches on `stream`; returns the
// first failing cudaError_t, or 0.
extern "C" int lvt_fused_layer_fwd(const void* x, const void* ln_s, const void* ln_b,
                                   const void* wqkvT, const void* projT, const void* fln_s,
                                   const void* fln_b, const void* w1T, const void* b1,
                                   const void* w2T, const void* b2, const float* bias,
                                   void* qkv, void* o, void* x2_out, void* out, int nb, int n,
                                   int d, int na, int da, int causal, int dtype, float scale,
                                   cudaStream_t stream) {
  if (!shapes_ok(nb, n, d, na, da, 1)) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return (int)fused_layer_fwd<TileBF16>(x, ln_s, ln_b, wqkvT, projT, fln_s, fln_b, w1T, b1,
                                          w2T, b2, bias, qkv, o, x2_out, out, nb, n, d, na, da,
                                          causal, dtype, scale, stream);
  if (dtype == 0)
    return (int)fused_layer_fwd<TileF32>(x, ln_s, ln_b, wqkvT, projT, fln_s, fln_b, w1T, b1,
                                         w2T, b2, bias, qkv, o, x2_out, out, nb, n, d, na, da,
                                         causal, dtype, scale, stream);
  return (int)cudaErrorInvalidValue;
}

// Kernel 8. x2, g, dx2 (R, d) in the io dtype; w1T = w1^T; dw (2, d, d) fp32 =
// (dw1, dw2); sums (4, d) fp32 = (db1, db2, dls, dlb). Scratch: acts (3, R, d)
// io dtype, part_w (splits, d, d) fp32, part_r (row tiles, 4, d) fp32, a row
// tile being 32 rows in bf16 and 16 in fp32.
extern "C" int lvt_ffn_half_bwd(const void* x2, const void* g, const void* fln_s,
                                const void* fln_b, const void* w1T, const void* w1,
                                const void* b1, const void* w2, void* dx2, float* dw,
                                float* sums, void* acts, float* part_w, float* part_r, int R,
                                int d, int splits, int dtype, cudaStream_t stream) {
  if (!shapes_ok(1, 1, d, 1, 64, splits) || R < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return (int)ffn_half_bwd<TileBF16>(x2, g, fln_s, fln_b, w1T, w1, b1, w2, dx2, dw, sums,
                                       acts, part_w, part_r, R, d, splits, stream);
  if (dtype == 0)
    return (int)ffn_half_bwd<TileF32>(x2, g, fln_s, fln_b, w1T, w1, b1, w2, dx2, dw, sums, acts,
                                      part_w, part_r, R, d, splits, stream);
  return (int)cudaErrorInvalidValue;
}

// Kernel 9 for nh heads. wqkvT (3 nh da, d) and wqkv (d, 3 nh da): these heads'
// flat QKV weight both ways; proj (nh da, d) and bias (nh, n, n): their rows.
// Outputs: dy (nb, n, d) io dtype; dwqkv (d, 3 nh da), dproj (nh da, d), dbias
// (nh, n, n) fp32. Scratch: y (R, d), qkv and dqkv (3, nb, nh, n, da), do_o
// (2, nb, nh, n, da) in the io dtype; stats and part_b as kernel 10 takes
// them (block_attention_bwd.cuh, for nh heads), part_w (splits, d, 3 nh da)
// fp32.
extern "C" int lvt_attn_half_bwd(const void* x, const void* dx2, const void* ln_s,
                                 const void* ln_b, const void* wqkvT, const void* wqkv,
                                 const void* proj, const float* bias, void* dy, float* dwqkv,
                                 float* dproj, float* dbias, void* y, void* qkv, void* do_o,
                                 void* dqkv, float* stats, float* part_b, float* part_w, int nb,
                                 int n, int d, int nh, int da, int causal, int splits,
                                 int dtype, float scale, cudaStream_t stream) {
  if (!shapes_ok(nb, n, d, nh, da, splits)) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return (int)attn_half_bwd<TileBF16>(x, dx2, ln_s, ln_b, wqkvT, wqkv, proj, bias, dy, dwqkv,
                                        dproj, dbias, y, qkv, do_o, dqkv, stats, part_b, part_w,
                                        nb, n, d, nh, da, causal, splits, dtype, scale, stream);
  if (dtype == 0)
    return (int)attn_half_bwd<TileF32>(x, dx2, ln_s, ln_b, wqkvT, wqkv, proj, bias, dy, dwqkv,
                                       dproj, dbias, y, qkv, do_o, dqkv, stats, part_b, part_w,
                                       nb, n, d, nh, da, causal, splits, dtype, scale, stream);
  return (int)cudaErrorInvalidValue;
}
