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
// row tiles of the (nb * n, d) token matrix. In bf16:
//
// kernel 7  ln_rows_bf16 LN(x) into a scratch y; gemm_nt_wgmma: qkv = y wqkv,
//                        rounded, into a head-major scratch (3, nb, na, n, da);
//           kernel 1's device code (block_attention.cuh) on that scratch: P
//                        rounded, P.V rounded, o (nb, na, n, da);
//           gemm_nt_wgmma<FfnResidual>: x2 = o_all proj + x, an fp32 scratch
//                        (and x2 rounded, when asked);
//           ln_rows_bf16<float>: y2 = LN(x2), rounded once;
//           gemm_nt_wgmma<FfnBiasRelu>: f = relu(y2 w1 + b1), rounded;
//           gemm_nt_wgmma<FfnOut>: out = f w2 + b2 + x2, rounded once.
// kernel 8  ln_rows_bf16: y2 = LN(x2) and the rows' mean and rstd;
//           gemm_nt_wgmma<FfnBiasRelu>: f = relu(y2 w1 + b1) and the ReLU
//                        gate as bytes;
//           gemm_nt_wgmma<FfnGatedDf>: dfp = gate ? g w2^T : 0, rounded, and
//                        each row tile's column sums of the unrounded dfp;
//           gemm_nt_wgmma<StoreF32>: dy2 = dfp w1^T, an fp32 scratch;
//           ln_bwd_rows: the LN backward, dx2 = dx2_ln + g, and each row
//                        tile's column sums of g, dy2 yhat and dy2;
//           gemm_tn_wgmma: dw2 = f^T g and dw1 = y2^T dfp over all rows, the
//                        rows cut into ranges whose partial products a last
//                        kernel adds in a fixed order (no float atomicAdd:
//                        every output is bit-identical from call to call);
//                        the same reduction adds the row tiles' column sums.
// kernel 9  ln_qkv as in kernel 7 (also keeping y), do = dx2 proj^T
//           (gemm_nt_wgmma), kernel 1's device code for o, kernel 10's
//           (block_attention_bwd.cuh) for dq, dk, dv and dbias from q, k, v
//           and do, dy = dqkv wqkv^T (gemm_nt_wgmma), dproj = o^T dx2 and
//           dwqkv = y^T dqkv (gemm_tn_wgmma + reduction).
//
// fp32 runs the same functions on the older row-tile programs (TileF32 on
// FMAs: TF32 would round the inputs to 10 bits): ln_qkv and gemm_nt for the
// products of kernels 7 and 9, proj_ffn (x2 kept in shared memory, LN, w1,
// ReLU, w2, + x2 per 16-row tile) and ffn_bwd_rows (kernel 8's row work per
// 16-row tile), gemm_tn_f32. Weights arrive as B operands with rows of
// consecutive k, i.e. (outputs, inputs): the wrapper passes w^T where the
// product is with w, and w itself where it is with w^T.
//
// What bounds it on the H100: at DSFVT (nb = 64, n = 256, d = 512, na = 8,
// da = 128) kernel 7 is ~103 GFLOP over ~50 MB of inputs and outputs and
// kernel 9 ~240 GFLOP over ~120 MB, far above the 295 flops per byte at which
// bf16 tensor cores stop waiting on memory: their bound is the tensor cores
// (0.10 and 0.24 ms). In bf16 every product therefore runs on wgmma with its
// operands landed by TMA through a ring of mbarrier stages that one producer
// warp keeps full (gemm_nt_wgmma, gemm_tn_wgmma): 128-row tiles, so that W is
// read from L2 once per 128 rows, and no thread waits on a copy while a
// product can run. The work between the products (LayerNorm, bias, ReLU and
// its gate, residuals, column sums) rides in the products' epilogues or in
// row passes that stream at the memory rate; what joins them is device
// memory scratch (x2 and dy2 in fp32 keep their rounding points), ~64 MB a
// call at DSFVT, read back at 3.35 TB/s in ~0.02 ms.
//
// Shapes: d a multiple of 64 up to 512; da in {64, 128}; n <= 256 in bf16 and
// <= 1024 in fp32 (kernels 1 and 10); any nb.

#include <type_traits>

#include "block_attention.cuh"
#include "block_attention_bwd.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;  // 8 warps: every kernel of this file but the wgmma ones

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }

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
// fp32 row-tile products: C (ROWS x NC) = A (ROWS x K) B^T, B (NC x K) a
// weight
// ---------------------------------------------------------------------------

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
// ln_qkv: C = LN(x) W^T per row tile, rounded to the io dtype (fp32; bf16
// runs ln_rows_bf16 and gemm_nt_wgmma below)
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
// gemm_nt: C = A W^T rounded to the io dtype, A streamed (fp32; bf16 runs
// gemm_nt_wgmma below)
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
// bf16 products on wgmma, operands by TMA through an mbarrier ring
// ---------------------------------------------------------------------------
//
// One block: two consumer warpgroups (warps 0-7; warpgroup w owns the tile's
// rows [64 w, 64 w + 64)) and one producer warp (warp 8) whose lane 0 keeps
// the ring of stages full: it waits for a stage to be released, then issues
// that stage's TMA boxes onto its mbarrier. Each consumer warpgroup waits for
// a stage, runs one wgmma stage on it (fence, products, commit, wait; under
// warpgroup-uniform control, so that ptxas does not serialize the products),
// and releases it. Every operand lands in 128-byte-swizzled shared memory
// as 64-column boxes (hopper.cuh's layout): K-major where the product sums
// along a row (gemm_nt: k16 steps 32 bytes along the row), MN-major where it
// sums over rows (gemm_tn: transposed A and B, k16 steps of 16 rows).
// An output tile of 128 columns is two m64n64 products per warpgroup.
//
// Rows are addressed as (token block, row in the block): a tile or a row
// chunk never crosses a block, so a head-major activation (parts, nb, nh, n,
// da) is a 3-D tensor map of planes (part, blk, head) x n rows x da columns,
// and a row-major one a map of planes blk x n rows x width (one plane of R
// rows where no operand of the product is head-major); TMA zero-fills the
// rows past n. A 64-column box lies inside one head (da is 64 or 128).

constexpr int WG_ROWS = 128;             // rows of a tile: two warpgroups of m64
constexpr int WG_COLS = 128;             // output columns of a tile: two n64 products
constexpr int WG_CONSUMERS = 256;        // threads of the two consumer warpgroups
constexpr int WG_THREADS = WG_CONSUMERS + 32;  // + the producer warp
constexpr int BOX64 = 64 * 128;          // bytes of a 64-row x 64-column bf16 box
constexpr int ROWS_STAGES = 3;           // ring stages of gemm_nt and gemm_tn

// How a product addresses an activation's tensor map: (column, row, plane) of
// the box at token block blk, row i0 and column col.
struct Operand {
  int nb, nh, n, da;  // nh == 0: row-major, one plane per token block
  __device__ __forceinline__ void coords(int blk, int col, int& c, int& plane) const {
    if (nh == 0) {
      c = col;
      plane = blk;
      return;
    }
    const int part = col / (nh * da), rem = col - part * nh * da;
    const int a = rem / da;
    c = rem - a * da;
    plane = (part * nb + blk) * nh + a;
  }
};

// the two 64 x 64 accumulators of a consumer thread, rounded to bf16, to the
// output tile (rows i0.., columns n0..) of C; rows past ng and columns past N
// are dropped. Output row (blk, i) is C's row blk * ng + i. (for_each_pair
// below walks the same elements; this form keeps a row's offset out of the
// column loop, which a head-major C needs: through for_each_pair the QKV
// product read 0.236-0.242 ms instead of 0.193 on the H100.)
__device__ __forceinline__ void store_wg_tile(const float (&acc)[2][32], const View<bf16>& C,
                                              int blk, int ng, int i0, int n0, int N) {
  const int tid = threadIdx.x, wg = tid / 128, w = (tid / 32) % 4, g = (tid % 32) / 4,
            t = tid % 4;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int i = i0 + 64 * wg + lvt_hopper::acc_row(2 * hi, w, g);
    if (i >= ng) continue;
    const size_t ro = C.row_off(blk * ng + i);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + 64 * h + lvt_hopper::acc_col(j, 0, t);
        if (col < N)
          *reinterpret_cast<__nv_bfloat162*>(C.p + ro + C.col_off(col)) =
              __floats2bfloat162_rn(acc[h][4 * j + 2 * hi], acc[h][4 * j + 2 * hi + 1]);
      }
  }
}

// the bf16 dispatch; ROWS: the row tile of kernel 8's column-sum partials
// (gemm_nt_wgmma's rows over one plane of R rows)
struct BF16 {
  using T = bf16;
  static constexpr int ROWS = WG_ROWS;
};

// calls f(row, col, v0, v1) for each pair of adjacent outputs (row, col),
// (row, col + 1) of a consumer thread's two 64 x 64 accumulators in the
// output tile (blk, i0.., n0..), row = blk * ng + i; rows past ng and
// columns past N are skipped
template <class F>
__device__ __forceinline__ void for_each_pair(const float (&acc)[2][32], int blk, int ng, int i0,
                                              int n0, int N, F&& f) {
  const int tid = threadIdx.x, wg = tid / 128, w = (tid / 32) % 4, g = (tid % 32) / 4,
            t = tid % 4;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int i = i0 + 64 * wg + lvt_hopper::acc_row(2 * hi, w, g);
    if (i >= ng) continue;
    const long row = (long)blk * ng + i;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + 64 * h + lvt_hopper::acc_col(j, 0, t);
        if (col < N) f(row, col, acc[h][4 * j + 2 * hi], acc[h][4 * j + 2 * hi + 1]);
      }
  }
}

// the two consumer warpgroups meet (the producer warp has returned)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(WG_CONSUMERS) : "memory");
}

// Epilogues of gemm_nt_wgmma: every consumer thread calls one with its two
// accumulators once its products are done; `smem` is the ring, free once
// both consumer warpgroups have met. StoreBF16 rounds into C, row-major or
// head-major (ln_qkv's and kernel 9's products); the Ffn ones are kernels 7 and 8's FFN work
// on row-major (rows, N) outputs, with their rounding points: x2 and dy2
// stay fp32, y2, f and dfp are rounded, out once.
struct StoreBF16 {
  View<bf16> C;
  __device__ __forceinline__ void operator()(const float (&acc)[2][32], int blk, int ng, int i0,
                                             int n0, int N, unsigned char*) const {
    store_wg_tile(acc, C, blk, ng, i0, n0, N);
  }
};

// kernel 8's dy2 = dfp w1^T, fp32
struct StoreF32 {
  float* C;
  __device__ __forceinline__ void operator()(const float (&acc)[2][32], int blk, int ng, int i0,
                                             int n0, int N, unsigned char*) const {
    for_each_pair(acc, blk, ng, i0, n0, N, [&](long row, int col, float v0, float v1) {
      *reinterpret_cast<float2*>(C + row * N + col) = make_float2(v0, v1);
    });
  }
};

// kernel 7's x2 = o_all proj + x into the fp32 x2f, and rounded into x2_out
// where given
struct FfnResidual {
  const bf16* x;
  float* x2f;
  bf16* x2_out;
  __device__ __forceinline__ void operator()(const float (&acc)[2][32], int blk, int ng, int i0,
                                             int n0, int N, unsigned char*) const {
    for_each_pair(acc, blk, ng, i0, n0, N, [&](long row, int col, float v0, float v1) {
      const size_t o = (size_t)row * N + col;
      const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + o));
      const float a = v0 + xv.x, b = v1 + xv.y;
      *reinterpret_cast<float2*>(x2f + o) = make_float2(a, b);
      if (x2_out != nullptr)
        *reinterpret_cast<__nv_bfloat162*>(x2_out + o) = __floats2bfloat162_rn(a, b);
    });
  }
};

// f_pre = y2 w1 + b1; f = relu(f_pre) rounded; where gate is given (kernel 8)
// also the gate f_pre > 0, one byte an element
struct FfnBiasRelu {
  const bf16* b1;
  bf16* f;
  unsigned char* gate;
  __device__ __forceinline__ void operator()(const float (&acc)[2][32], int blk, int ng, int i0,
                                             int n0, int N, unsigned char*) const {
    for_each_pair(acc, blk, ng, i0, n0, N, [&](long row, int col, float v0, float v1) {
      const size_t o = (size_t)row * N + col;
      const float a = v0 + __bfloat162float(b1[col]), b = v1 + __bfloat162float(b1[col + 1]);
      *reinterpret_cast<__nv_bfloat162*>(f + o) =
          __floats2bfloat162_rn(fmaxf(a, 0.f), fmaxf(b, 0.f));
      if (gate != nullptr) *reinterpret_cast<uchar2*>(gate + o) = make_uchar2(a > 0.f, b > 0.f);
    });
  }
};

// kernel 7's out = f w2 + b2 + x2, rounded once
struct FfnOut {
  const bf16* b2;
  const float* x2f;
  bf16* out;
  __device__ __forceinline__ void operator()(const float (&acc)[2][32], int blk, int ng, int i0,
                                             int n0, int N, unsigned char*) const {
    for_each_pair(acc, blk, ng, i0, n0, N, [&](long row, int col, float v0, float v1) {
      const size_t o = (size_t)row * N + col;
      const float2 x2 = *reinterpret_cast<const float2*>(x2f + o);
      *reinterpret_cast<__nv_bfloat162*>(out + o) =
          __floats2bfloat162_rn(v0 + __bfloat162float(b2[col]) + x2.x,
                                v1 + __bfloat162float(b2[col + 1]) + x2.y);
    });
  }
};

// kernel 8's dfp = gate ? g w2^T : 0, rounded into dfp, and the fp32 column
// sums of the unrounded dfp over the tile's rows into part[tile][0] (part:
// (row tiles, 4, N); the rows are one plane, so the tile is blockIdx.x),
// added in a fixed order: a thread's two rows, the warp's eight row groups
// by a butterfly, then the eight consumer warps in order through the ring's
// shared memory
struct FfnGatedDf {
  const unsigned char* gate;
  bf16* dfp;
  float* part;
  __device__ __forceinline__ void operator()(const float (&acc)[2][32], int blk, int ng, int i0,
                                             int n0, int N, unsigned char* smem) const {
    const int tid = threadIdx.x, wg = tid / 128, warp = tid / 32, w = warp % 4,
              g = (tid % 32) / 4, t = tid % 4;
    float* red = reinterpret_cast<float*>(smem);  // [8 warps][128 columns]
    consumers_sync();                              // both warpgroups are done with the ring
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 64 * h + lvt_hopper::acc_col(j, 0, t), col = n0 + c;
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int i = i0 + 64 * wg + lvt_hopper::acc_row(2 * hi, w, g);
          if (i < ng && col < N) {
            const size_t o = ((size_t)blk * ng + i) * N + col;
            const uchar2 on = *reinterpret_cast<const uchar2*>(gate + o);
            const float a = on.x ? acc[h][4 * j + 2 * hi] : 0.f;
            const float b = on.y ? acc[h][4 * j + 2 * hi + 1] : 0.f;
            *reinterpret_cast<__nv_bfloat162*>(dfp + o) = __floats2bfloat162_rn(a, b);
            s0 += a;
            s1 += b;
          }
        }
#pragma unroll
        for (int m = 4; m < 32; m <<= 1) {
          s0 += __shfl_xor_sync(0xffffffffu, s0, m);
          s1 += __shfl_xor_sync(0xffffffffu, s1, m);
        }
        if (g == 0) {
          red[warp * WG_COLS + c] = s0;
          red[warp * WG_COLS + c + 1] = s1;
        }
      }
    consumers_sync();
    if (tid < WG_COLS && n0 + tid < N) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < WG_CONSUMERS / 32; ++k) s += red[k * WG_COLS + tid];
      part[(size_t)blockIdx.x * 4 * N + n0 + tid] = s;
    }
  }
};

// LayerNorm of the rows of x (R, d), bf16 or fp32, into y (R, d) bf16, one
// warp a row, with ln_rows' arithmetic: lane l sums the columns l, l + 32,
// ... in that order before the warp's butterfly; the mean, then the mean of
// squared deviations; y = yhat * gamma + beta rounded once. Where mu_out is
// given, each row's mean and rstd go to mu_out and rs_out (kernel 8's LN
// backward recomputes yhat = (x - mean) * rstd from them, bit for bit).
// ln_qkv in bf16 is this and gemm_nt_wgmma over y (a resident 128 x 512 tile
// of y, 128 KB, would leave one block an SM).
template <class Tin>
__global__ void __launch_bounds__(THREADS)
ln_rows_bf16(const Tin* __restrict__ x, const bf16* __restrict__ gamma,
             const bf16* __restrict__ beta, bf16* __restrict__ y, float* __restrict__ mu_out,
             float* __restrict__ rs_out, long R, int d) {
  constexpr int MAXC = 512 / 32;  // columns a lane holds (d <= 512)
  const long row = (long)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32, nc = d / 32;
  if (row >= R) return;
  const Tin* xr = x + row * d + lane;
  float xv[MAXC];
#pragma unroll
  for (int k = 0; k < MAXC; ++k) xv[k] = k < nc ? to_f(xr[32 * k]) : 0.f;
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < MAXC; ++k)
    if (k < nc) s += xv[k];
  const float mu = warp_sum(s) / (float)d;
  float v = 0.f;
#pragma unroll
  for (int k = 0; k < MAXC; ++k)
    if (k < nc) v += (xv[k] - mu) * (xv[k] - mu);
  const float rstd = rsqrtf(warp_sum(v) / (float)d + 1e-5f);
  if (mu_out != nullptr && lane == 0) {
    mu_out[row] = mu;
    rs_out[row] = rstd;
  }
  bf16* yr = y + row * d + lane;
  gamma += lane;
  beta += lane;
#pragma unroll
  for (int k = 0; k < MAXC; ++k)
    if (k < nc)
      yr[32 * k] = __float2bfloat16_rn((xv[k] - mu) * rstd * __bfloat162float(gamma[32 * k]) +
                                       __bfloat162float(beta[32 * k]));
}

// Kernel 8's last row pass in bf16, one block a 128-row tile, one warp a row
// (16 rows a warp): yhat recomputed from x2 and ln_rows_bf16's mean and
// rstd; dx2 = rstd (dy2 gamma - m1 - yhat m2) + g rounded once, m1 and m2
// the row means of dy2 gamma and dy2 gamma yhat (lane order, then the warp's
// butterfly); the tile's column sums of g (db2), dy2 yhat (dls) and dy2
// (dlb) into part[tile][1..3], the warps added in order.
__global__ void __launch_bounds__(THREADS)
ln_bwd_rows(const float* __restrict__ dy2, const bf16* __restrict__ x2,
            const bf16* __restrict__ g, const bf16* __restrict__ gamma,
            const float* __restrict__ mean, const float* __restrict__ rstd,
            bf16* __restrict__ dx2, float* __restrict__ part, long R, int d) {
  constexpr int MAXC = 512 / 32, WARPS = THREADS / 32, RPW = WG_ROWS / WARPS;
  __shared__ float red[WARPS][512];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nc = d / 32;
  float gam[MAXC], sg[MAXC], sdh[MAXC], sd[MAXC];
#pragma unroll
  for (int k = 0; k < MAXC; ++k) {
    gam[k] = k < nc ? __bfloat162float(gamma[lane + 32 * k]) : 0.f;
    sg[k] = sdh[k] = sd[k] = 0.f;
  }
  for (int r = 0; r < RPW; ++r) {
    const long row = (long)blockIdx.x * WG_ROWS + warp * RPW + r;
    if (row >= R) break;
    const float mu = mean[row], rs = rstd[row];
    const size_t o = (size_t)row * d + lane;
    float dy[MAXC], yh[MAXC];
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int k = 0; k < MAXC; ++k)
      if (k < nc) {
        dy[k] = dy2[o + 32 * k];
        yh[k] = (__bfloat162float(x2[o + 32 * k]) - mu) * rs;
        const float dyh = dy[k] * gam[k];
        m1 += dyh;
        m2 += dyh * yh[k];
      }
    m1 = warp_sum(m1) / (float)d;
    m2 = warp_sum(m2) / (float)d;
#pragma unroll
    for (int k = 0; k < MAXC; ++k)
      if (k < nc) {
        const float go = __bfloat162float(g[o + 32 * k]), dyh = dy[k] * gam[k];
        dx2[o + 32 * k] = __float2bfloat16_rn(rs * (dyh - m1 - yh[k] * m2) + go);
        sg[k] += go;
        sdh[k] += dy[k] * yh[k];
        sd[k] += dy[k];
      }
  }
  float* sums = part + (size_t)blockIdx.x * 4 * d;
#pragma unroll
  for (int s = 0; s < 3; ++s) {
#pragma unroll
    for (int k = 0; k < MAXC; ++k)
      if (k < nc) red[warp][lane + 32 * k] = s == 0 ? sg[k] : s == 1 ? sdh[k] : sd[k];
    __syncthreads();
    for (int c = threadIdx.x; c < d; c += THREADS) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) v += red[w][c];
      sums[(1 + s) * d + c] = v;
    }
    __syncthreads();
  }
}

// C (rows x N) = A W^T: A an activation addressed through amap and aop, W
// (N, K) a weight, K-major, both streamed by TMA; one tile of 128 rows (blk,
// i0) x 128 columns a block, k-chunks of 64; the epilogue epi (above) takes
// the accumulators.
template <class Epi>
__global__ void __launch_bounds__(WG_THREADS)
gemm_nt_wgmma(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap wmap,
              Operand aop, Epi epi, int ng, int K, int N) {
  using namespace lvt_hopper;
  constexpr int STAGE = 2 * WG_ROWS * 128;  // a 128-row x 64-column box of A, one of W
  extern __shared__ __align__(1024) unsigned char smem[];
  if (smem_u32(smem) & 1023) __trap();  // the swizzle atoms need 1024-byte alignment
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + ROWS_STAGES * STAGE);
  uint64_t* empty = full + ROWS_STAGES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tiles_per_blk = (ng + WG_ROWS - 1) / WG_ROWS;
  const int blk = blockIdx.x / tiles_per_blk;
  const int i0 = (blockIdx.x % tiles_per_blk) * WG_ROWS;
  const int n0 = blockIdx.y * WG_COLS;
  const int nk = K / 64;

  if (tid == 0) {
    for (int s = 0; s < ROWS_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == WG_CONSUMERS / 32) {  // ---- the producer
    if (lane == 0) {
      for (int t = 0; t < nk; ++t) {
        const int s = t % ROWS_STAGES;
        if (t >= ROWS_STAGES) mbar_wait(&empty[s], (t / ROWS_STAGES - 1) & 1);
        int c, plane;
        aop.coords(blk, 64 * t, c, plane);
        mbar_expect_tx(&full[s], STAGE);
        tma_load(smem + s * STAGE, &amap, &full[s], c, i0, plane);
        tma_load(smem + s * STAGE + STAGE / 2, &wmap, &full[s], 64 * t, n0, 0);
      }
    }
    return;
  }

  // ---- the consumers
  const int wg = warp / 4;
  float acc[2][32];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[h][e] = 0.f;
  for (int t = 0; t < nk; ++t) {
    const int s = t % ROWS_STAGES;
    mbar_wait(&full[s], (t / ROWS_STAGES) & 1);
    const unsigned char* a = smem + s * STAGE;
    const unsigned char* b = a + STAGE / 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) fence_regs(acc[h]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        wgmma_ss(acc[h], desc(a + wg * BOX64 + kk * 32), desc(b + h * BOX64 + kk * 32));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < 2; ++h) fence_regs(acc[h]);
    if (tid % 128 == 0) mbar_arrive(&empty[s]);
  }
  epi(acc, blk, ng, i0, n0, N, smem);
}

constexpr size_t gemm_nt_wgmma_smem() {
  return ROWS_STAGES * 2 * (size_t)WG_ROWS * 128 + 2 * ROWS_STAGES * sizeof(uint64_t);
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

// bf16: part[z] (M x N) = A^T B over the row chunks of range z, both operands
// MN-major by TMA (64-row x 64-column boxes), read through wgmma's transposed
// A and B. A block owns a 128 x 128 output tile; warpgroup w its rows [64 w,
// 64 w + 64). Row chunks are 64 rows of one token block (nb * ceil(n / 64)
// chunks, cut into gridDim.z ranges as tn_range cuts rows); the rows past n
// of a chunk are zero-filled and add nothing.
__global__ void __launch_bounds__(WG_THREADS)
gemm_tn_wgmma(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
              Operand aop, Operand bop, float* __restrict__ part, int nbg, int ng, int M, int N) {
  using namespace lvt_hopper;
  constexpr int STAGE = 4 * BOX64;  // A boxes (M columns m0, m0 + 64), B boxes (n0, n0 + 64)
  extern __shared__ __align__(1024) unsigned char smem[];
  if (smem_u32(smem) & 1023) __trap();
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + ROWS_STAGES * STAGE);
  uint64_t* empty = full + ROWS_STAGES;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.x * WG_COLS, n0 = blockIdx.y * WG_COLS;
  const int cpb = (ng + 63) / 64;  // row chunks per token block
  const long chunks = (long)nbg * cpb;
  const long per = (chunks + gridDim.z - 1) / gridDim.z;
  const long c0 = min((long)blockIdx.z * per, chunks), c1 = min(c0 + per, chunks);
  const int steps = (int)(c1 - c0);

  if (tid == 0) {
    for (int s = 0; s < ROWS_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == WG_CONSUMERS / 32) {  // ---- the producer: boxes wholly past M or N are not loaded
    if (lane == 0) {
      const int na_box = M - m0 > 64 ? 2 : 1, nb_box = N - n0 > 64 ? 2 : 1;
      for (int t = 0; t < steps; ++t) {
        const int s = t % ROWS_STAGES;
        if (t >= ROWS_STAGES) mbar_wait(&empty[s], (t / ROWS_STAGES - 1) & 1);
        const long chunk = c0 + t;
        const int blk = (int)(chunk / cpb), i0 = (int)(chunk % cpb) * 64;
        unsigned char* st = smem + s * STAGE;
        mbar_expect_tx(&full[s], (na_box + nb_box) * BOX64);
        for (int h = 0; h < na_box; ++h) {
          int c, plane;
          aop.coords(blk, m0 + 64 * h, c, plane);
          tma_load(st + h * BOX64, &amap, &full[s], c, i0, plane);
        }
        for (int h = 0; h < nb_box; ++h) {
          int c, plane;
          bop.coords(blk, n0 + 64 * h, c, plane);
          tma_load(st + (2 + h) * BOX64, &bmap, &full[s], c, i0, plane);
        }
      }
    }
    return;
  }

  // ---- the consumers
  const int wg = warp / 4;
  float acc[2][32];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[h][e] = 0.f;
  for (int t = 0; t < steps; ++t) {
    const int s = t % ROWS_STAGES;
    mbar_wait(&full[s], (t / ROWS_STAGES) & 1);
    const unsigned char* st = smem + s * STAGE;
#pragma unroll
    for (int h = 0; h < 2; ++h) fence_regs(acc[h]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        wgmma_ss_tt(acc[h], desc(st + wg * BOX64 + kk * 2048),
                    desc(st + (2 + h) * BOX64 + kk * 2048));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < 2; ++h) fence_regs(acc[h]);
    if (tid % 128 == 0) mbar_arrive(&empty[s]);
  }

  float* out = part + (size_t)blockIdx.z * M * N;
  const int w = warp % 4, g = lane / 4, tq = lane % 4;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int m = m0 + 64 * wg + acc_row(2 * hi, w, g);
    if (m >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + 64 * h + acc_col(j, 0, tq);
        if (n < N)
          *reinterpret_cast<float2*>(out + (size_t)m * N + n) =
              make_float2(acc[h][4 * j + 2 * hi], acc[h][4 * j + 2 * hi + 1]);
      }
  }
}

constexpr size_t gemm_tn_wgmma_smem() {
  return ROWS_STAGES * 4 * (size_t)BOX64 + 2 * ROWS_STAGES * sizeof(uint64_t);
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

// the tensor map of a bf16 activation of `width` columns for a product whose
// rows are grouped in nbg token blocks of ng rows, boxes of box_rows x 64:
// a head-major View has planes (part, blk, head) and must be grouped by its
// own blocks; a row-major one a plane per block. False where the View does
// not fit the grouping or the encoder refuses the map (a base or a stride
// that is not a multiple of 16 bytes).
bool act_map(CUtensorMap* map, Operand* op, const View<bf16>& v, int width, int nbg, int ng,
             int box_rows) {
  using lvt_hopper::make_map;
  if (v.nh == 0) {
    *op = Operand{nbg, 0, ng, 0};
    return v.ld == width && make_map(map, v.p, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, nbg, ng,
                                     width, box_rows, 64);
  }
  *op = Operand{v.nb, v.nh, v.n, v.da};
  return v.nb == nbg && v.n == ng && width % (v.nh * v.da) == 0 &&
         make_map(map, v.p, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                  (uint64_t)(width / (v.nh * v.da)) * v.nb * v.nh, v.n, v.da, box_rows, 64);
}

// the rows of a product: the token blocks of its first head-major operand,
// else one block of all R rows
void grouping(const View<bf16>& a, const View<bf16>& b, long R, int& nbg, int& ng) {
  const View<bf16>& h = a.nh ? a : b;
  nbg = h.nh ? h.nb : 1;
  ng = h.nh ? h.n : (int)R;
}

// a (N, K) bf16 weight, K-major boxes of 128 rows x 64 columns
bool weight_map(CUtensorMap* map, const void* W, int N, int K) {
  return lvt_hopper::make_map(map, W, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 1, N, K, WG_ROWS, 64);
}

// C = A W^T on gemm_nt_wgmma, the accumulators to the epilogue epi: A (R
// rows x K) a bf16 activation, W (N, K) a bf16 weight
template <class Epi>
cudaError_t launch_gemm_nt(const View<bf16>& A, const void* W, const Epi& epi, long R, int K,
                           int N, cudaStream_t stream) {
  int nbg, ng;
  grouping(A, A, R, nbg, ng);
  CUtensorMap amap, wmap;
  Operand aop;
  if (!act_map(&amap, &aop, A, K, nbg, ng, WG_ROWS) || !weight_map(&wmap, W, N, K))
    return cudaErrorInvalidValue;
  constexpr size_t smem = gemm_nt_wgmma_smem();
  LVT_TRY(lvt_hopper::set_smem_max(gemm_nt_wgmma<Epi>, (int)smem));
  const dim3 grid(nbg * ((ng + WG_ROWS - 1) / WG_ROWS), (N + WG_COLS - 1) / WG_COLS);
  gemm_nt_wgmma<Epi><<<grid, WG_THREADS, smem, stream>>>(amap, wmap, aop, epi, ng, K, N);
  return cudaGetLastError();
}

// the LayerNorm pass ln_rows_bf16 over R rows of x
template <class Tin>
cudaError_t run_ln_rows(const Tin* x, const void* gamma, const void* beta, bf16* y,
                        float* mu_out, float* rs_out, long R, int d, cudaStream_t stream) {
  ln_rows_bf16<Tin><<<(unsigned)((R + THREADS / 32 - 1) / (THREADS / 32)), THREADS, 0, stream>>>(
      x, static_cast<const bf16*>(gamma), static_cast<const bf16*>(beta), y, mu_out, rs_out, R,
      d);
  return cudaGetLastError();
}

// C = A W^T rounded to the io dtype (bf16: gemm_nt_wgmma with the plain store)
template <class TL>
cudaError_t run_gemm_nt(View<typename TL::T> A, const void* W, View<typename TL::T> C, long R,
                        int K, int N, cudaStream_t stream) {
  using T = typename TL::T;
  if constexpr (std::is_same<T, bf16>::value) {
    return launch_gemm_nt(A, W, StoreBF16{C}, R, K, N, stream);
  } else {
    constexpr size_t smem = gemm_nt_smem<TL>();
    LVT_TRY(set_smem(gemm_nt<TL>, smem));
    gemm_nt<TL><<<dim3(tiles_of<TL>(R), (N + TL::NC - 1) / TL::NC), THREADS, smem, stream>>>(
        A, static_cast<const T*>(W), C, R, K, N);
    return cudaGetLastError();
  }
}

// C = LN(x) W^T rounded to the io dtype; y_out, where given, takes LN(x) (in
// bf16 it must be given: y goes through it into gemm_nt)
template <class TL>
cudaError_t run_ln_qkv(const void* x, const void* gamma, const void* beta, const void* W,
                       View<typename TL::T> C, void* y_out, long R, int d, int N,
                       cudaStream_t stream) {
  using T = typename TL::T;
  if constexpr (std::is_same<T, bf16>::value) {
    if (y_out == nullptr) return cudaErrorInvalidValue;
    LVT_TRY(run_ln_rows(static_cast<const T*>(x), gamma, beta, static_cast<T*>(y_out), nullptr,
                        nullptr, R, d, stream));
    return run_gemm_nt<TL>(row_major<T>(y_out, d), W, C, R, d, N, stream);
  } else {
    const size_t smem = ln_qkv_smem<TL>(d);
    LVT_TRY(set_smem(ln_qkv<TL>, smem));
    ln_qkv<TL><<<tiles_of<TL>(R), THREADS, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(gamma), static_cast<const T*>(beta),
        static_cast<const T*>(W), C, static_cast<T*>(y_out), R, d, N);
    return cudaGetLastError();
  }
}

cudaError_t launch_gemm_tn(dim3 grid, cudaStream_t stream, View<bf16> A, View<bf16> B,
                           float* part, long R, int M, int N) {
  int nbg, ng;
  grouping(A, B, R, nbg, ng);
  CUtensorMap amap, bmap;
  Operand aop, bop;
  if (!act_map(&amap, &aop, A, M, nbg, ng, 64) || !act_map(&bmap, &bop, B, N, nbg, ng, 64))
    return cudaErrorInvalidValue;
  constexpr size_t smem = gemm_tn_wgmma_smem();
  LVT_TRY(lvt_hopper::set_smem_max(gemm_tn_wgmma, (int)smem));
  gemm_tn_wgmma<<<grid, WG_THREADS, smem, stream>>>(amap, bmap, aop, bop, part, nbg, ng, M, N);
  return cudaGetLastError();
}
cudaError_t launch_gemm_tn(dim3 grid, cudaStream_t stream, View<float> A, View<float> B,
                           float* part, long R, int M, int N) {
  gemm_tn_f32<<<grid, THREADS, 0, stream>>>(A, B, part, R, M, N);
  return cudaGetLastError();
}

// out (M, N) fp32 = A^T B over the R rows: `splits` partial products into
// part (splits, M, N), added in the order of the row ranges
template <class T>
cudaError_t run_gemm_tn(View<T> A, View<T> B, float* part, float* out, long R, int M, int N,
                        int splits, cudaStream_t stream) {
  const dim3 grid((M + TN_TILE - 1) / TN_TILE, (N + TN_TILE - 1) / TN_TILE, splits);
  LVT_TRY(launch_gemm_tn(grid, stream, A, B, part, R, M, N));
  const size_t per = (size_t)M * N;
  lvt_bwd::dbias_reduce<<<(unsigned)((per + 255) / 256), 256, 0, stream>>>(part, out, splits,
                                                                            per);
  return cudaGetLastError();
}

bool shapes_ok(int nb, int n, int d, int nh, int da, int splits) {
  return nb >= 1 && n >= 1 && n <= 1024 && nh >= 1 && d >= 64 && d <= 512 && d % 64 == 0 &&
         (da == 64 || da == 128) && splits >= 1 && splits <= 65535;
}

// Kernel 7's work after the attention in bf16: four launches, joined by the
// scratch work = (y2 | f | x2 in fp32), each (R, d)
cudaError_t proj_ffn_bf16(const View<bf16>& o, const bf16* x, const void* projT,
                          const void* fln_s, const void* fln_b, const void* w1T, const bf16* b1,
                          const void* w2T, const bf16* b2, bf16* work, bf16* x2_out, bf16* out,
                          long R, int d, int KO, cudaStream_t stream) {
  const size_t per = (size_t)R * d;
  bf16* y2 = work;
  bf16* f = work + per;
  float* x2f = reinterpret_cast<float*>(work + 2 * per);
  LVT_TRY(launch_gemm_nt(o, projT, FfnResidual{x, x2f, x2_out}, R, KO, d, stream));
  LVT_TRY(run_ln_rows(static_cast<const float*>(x2f), fln_s, fln_b, y2, nullptr, nullptr, R, d,
                      stream));
  LVT_TRY(launch_gemm_nt(row_major<bf16>(y2, d), w1T, FfnBiasRelu{b1, f, nullptr}, R, d, d,
                         stream));
  return launch_gemm_nt(row_major<bf16>(f, d), w2T, FfnOut{b2, x2f, out}, R, d, d, stream);
}

template <class TL>
cudaError_t fused_layer_fwd(const void* x, const void* ln_s, const void* ln_b,
                            const void* wqkvT, const void* projT, const void* fln_s,
                            const void* fln_b, const void* w1T, const void* b1,
                            const void* w2T, const void* b2, const float* bias, void* qkv,
                            void* o, void* y, void* x2_out, void* out, int nb, int n, int d,
                            int na, int da, int causal, int dtype, float scale,
                            cudaStream_t stream) {
  using T = typename TL::T;
  const long R = (long)nb * n;
  const size_t head = (size_t)nb * na * n * da;
  LVT_TRY(run_ln_qkv<TL>(x, ln_s, ln_b, wqkvT, head_major<T>(qkv, nb, na, n, da),
                         std::is_same<T, bf16>::value ? y : nullptr, R, d, 3 * na * da, stream));
  T* q = static_cast<T*>(qkv);
  LVT_TRY((cudaError_t)lvt_fwd::block_attention_fwd(q, q + head, q + 2 * head, bias, o, nb, na,
                                                    n, da, causal, dtype, scale, stream));
  if constexpr (std::is_same<T, bf16>::value) {
    return proj_ffn_bf16(head_major<T>(o, nb, na, n, da), static_cast<const T*>(x), projT, fln_s,
                         fln_b, w1T, static_cast<const T*>(b1), w2T, static_cast<const T*>(b2),
                         static_cast<T*>(y), static_cast<T*>(x2_out), static_cast<T*>(out), R, d,
                         na * da, stream);
  } else {
    const size_t smem = proj_ffn_smem<TL>(d);
    LVT_TRY(set_smem(proj_ffn<TL>, smem));
    proj_ffn<TL><<<tiles_of<TL>(R), THREADS, smem, stream>>>(
        head_major<T>(o, nb, na, n, da), static_cast<const T*>(x), static_cast<const T*>(projT),
        static_cast<const T*>(fln_s), static_cast<const T*>(fln_b), static_cast<const T*>(w1T),
        static_cast<const T*>(b1), static_cast<const T*>(w2T), static_cast<const T*>(b2),
        static_cast<T*>(x2_out), static_cast<T*>(out), R, d, na * da);
    return cudaGetLastError();
  }
}

// Kernel 8's row work in bf16: the LN pass, three products with their
// epilogues and the LN backward's row pass. acts = (y2, f, dfp); part_r =
// (tiles, 4, d) partials, then dy2 (R, d), mean (R), rstd (R), all fp32, and
// the ReLU gate (R, d) bytes.
cudaError_t ffn_bwd_rows_bf16(const bf16* x2, const bf16* g, const void* fln_s, const void* fln_b,
                              const void* w1T, const void* w1, const bf16* b1, const void* w2,
                              bf16* dx2, bf16* acts, float* part_r, long R, int d,
                              cudaStream_t stream) {
  const size_t per = (size_t)R * d;
  const unsigned tiles = tiles_of<BF16>(R);
  bf16* y2 = acts;
  bf16* f = acts + per;
  bf16* dfp = acts + 2 * per;
  float* dy2 = part_r + (size_t)tiles * 4 * d;
  float* mean = dy2 + per;
  float* rstd = mean + R;
  unsigned char* gate = reinterpret_cast<unsigned char*>(rstd + R);
  LVT_TRY(run_ln_rows(x2, fln_s, fln_b, y2, mean, rstd, R, d, stream));
  LVT_TRY(launch_gemm_nt(row_major<bf16>(y2, d), w1T, FfnBiasRelu{b1, f, gate}, R, d, d, stream));
  LVT_TRY(launch_gemm_nt(row_major<bf16>(g, d), w2, FfnGatedDf{gate, dfp, part_r}, R, d, d,
                         stream));
  LVT_TRY(launch_gemm_nt(row_major<bf16>(dfp, d), w1, StoreF32{dy2}, R, d, d, stream));
  ln_bwd_rows<<<tiles, THREADS, 0, stream>>>(dy2, x2, g, static_cast<const bf16*>(fln_s), mean,
                                              rstd, dx2, part_r, R, d);
  return cudaGetLastError();
}

template <class TL>
cudaError_t ffn_half_bwd(const void* x2, const void* g, const void* fln_s, const void* fln_b,
                         const void* w1T, const void* w1, const void* b1, const void* w2,
                         void* dx2, float* dw, float* sums, void* acts, float* part_w,
                         float* part_r, long R, int d, int splits, cudaStream_t stream) {
  using T = typename TL::T;
  const unsigned tiles = tiles_of<TL>(R);
  if constexpr (std::is_same<T, bf16>::value) {
    LVT_TRY(ffn_bwd_rows_bf16(static_cast<const T*>(x2), static_cast<const T*>(g), fln_s, fln_b,
                              w1T, w1, static_cast<const T*>(b1), w2, static_cast<T*>(dx2),
                              static_cast<T*>(acts), part_r, R, d, stream));
  } else {
    const size_t smem = ffn_bwd_smem<TL>(d);
    LVT_TRY(set_smem(ffn_bwd_rows<TL>, smem));
    ffn_bwd_rows<TL><<<tiles, THREADS, smem, stream>>>(
        static_cast<const T*>(x2), static_cast<const T*>(g), static_cast<const T*>(fln_s),
        static_cast<const T*>(fln_b), static_cast<const T*>(w1T), static_cast<const T*>(w1),
        static_cast<const T*>(b1), static_cast<const T*>(w2), static_cast<T*>(dx2),
        static_cast<T*>(acts), part_r, R, d);
    LVT_TRY(cudaGetLastError());
  }
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
// weights transposed. qkv (3, nb, na, n, da), o (nb, na, n, da) and, in
// bf16, y (4, nb, n, d) are scratch the caller allocates: y holds LN(x), then
// y2 (plane 0), f (plane 1) and x2 in fp32 (planes 2 and 3). y in fp32 and
// x2_out may be null.
// Launches on `stream`; returns the first failing cudaError_t, or 0.
extern "C" int lvt_fused_layer_fwd(const void* x, const void* ln_s, const void* ln_b,
                                   const void* wqkvT, const void* projT, const void* fln_s,
                                   const void* fln_b, const void* w1T, const void* b1,
                                   const void* w2T, const void* b2, const float* bias,
                                   void* qkv, void* o, void* y, void* x2_out, void* out, int nb,
                                   int n, int d, int na, int da, int causal, int dtype,
                                   float scale, cudaStream_t stream) {
  if (!shapes_ok(nb, n, d, na, da, 1)) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return (int)fused_layer_fwd<BF16>(x, ln_s, ln_b, wqkvT, projT, fln_s, fln_b, w1T, b1, w2T,
                                      b2, bias, qkv, o, y, x2_out, out, nb, n, d, na, da, causal,
                                      dtype, scale, stream);
  if (dtype == 0)
    return (int)fused_layer_fwd<TileF32>(x, ln_s, ln_b, wqkvT, projT, fln_s, fln_b, w1T, b1,
                                         w2T, b2, bias, qkv, o, y, x2_out, out, nb, n, d, na,
                                         da, causal, dtype, scale, stream);
  return (int)cudaErrorInvalidValue;
}

// Kernel 8. x2, g, dx2 (R, d) in the io dtype; w1T = w1^T; dw (2, d, d) fp32 =
// (dw1, dw2); sums (4, d) fp32 = (db1, db2, dls, dlb). Scratch: acts (3, R, d)
// io dtype, part_w (splits, d, d) fp32, part_r (row tiles, 4, d) fp32, a row
// tile being 128 rows in bf16 and 16 in fp32; in bf16 part_r goes on with
// dy2 (R, d), the rows' LN mean and rstd (R each), all fp32, and the ReLU
// gate, (R, d) bytes.
extern "C" int lvt_ffn_half_bwd(const void* x2, const void* g, const void* fln_s,
                                const void* fln_b, const void* w1T, const void* w1,
                                const void* b1, const void* w2, void* dx2, float* dw,
                                float* sums, void* acts, float* part_w, float* part_r, int R,
                                int d, int splits, int dtype, cudaStream_t stream) {
  if (!shapes_ok(1, 1, d, 1, 64, splits) || R < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return (int)ffn_half_bwd<BF16>(x2, g, fln_s, fln_b, w1T, w1, b1, w2, dx2, dw, sums, acts,
                                   part_w, part_r, R, d, splits, stream);
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
    return (int)attn_half_bwd<BF16>(x, dx2, ln_s, ln_b, wqkvT, wqkv, proj, bias, dy, dwqkv,
                                    dproj, dbias, y, qkv, do_o, dqkv, stats, part_b, part_w, nb,
                                    n, d, nh, da, causal, splits, dtype, scale, stream);
  if (dtype == 0)
    return (int)attn_half_bwd<TileF32>(x, dx2, ln_s, ln_b, wqkvT, wqkv, proj, bias, dy, dwqkv,
                                       dproj, dbias, y, qkv, do_o, dqkv, stats, part_b, part_w,
                                       nb, n, d, nh, da, causal, splits, dtype, scale, stream);
  return (int)cudaErrorInvalidValue;
}
