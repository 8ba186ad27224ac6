#pragma once
// Hopper (sm_90a) building blocks shared by the bf16 attention kernels
// (block_attention.cuh, kernel 1; block_attention_bwd.cuh, kernel 10), the
// fused layer's bf16 products (fused_layer.cu, kernels 7-9) and the decode
// kernels' bulk copies and cluster exchanges (decode_attention.cu, kernel 2;
// decode_attention_i8.cu, kernels 3 and 4): TMA tensor maps and
// loads completing on mbarriers, wgmma descriptors for 128-byte-swizzled
// shared memory, the m64n64k16 bf16 wgmma in its shared/shared (K-major or
// both operands transposed) and register/shared forms, and the conversion of
// an fp32 accumulator into the bf16 A operand of the next product.
//
// Layout of every bf16 tile: rows of 64 elements (128 bytes) as TMA writes
// them with CU_TENSOR_MAP_SWIZZLE_128B, 8 rows to a 1024-byte swizzle atom;
// a tile with 128 columns is two such tiles ("halves") one after the other.
// Every tile starts on a 1024-byte boundary. Read as
// * a K-major operand (rows = M or N, columns = K): one k16 step is 32
//   bytes along the row; the 8-row groups lie 1024 bytes apart (SBO);
// * an MN-major operand (rows = K, columns = N), through wgmma's transposed
//   mode: 64 N values per 128-byte row, a k16 step is 16 rows (2048 bytes),
//   8-row groups 1024 bytes apart (SBO); one instruction reads 64 columns,
//   so the leading offset (LBO, between 64-column blocks) is never used.
// (PTX ISA, "Matrix Descriptor Format" and "Shared Memory Matrix Layout";
// CUTLASS cute/atom/mma_traits_sm90_gmma.hpp for the canonical layouts.)

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace lvt_hopper {

constexpr int TILE_ROW_BYTES = 128;  // one swizzled row: 64 bf16 or 32 fp32

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's entry-point query, so that
// the library links no -lcuda
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 3-D map over a contiguous (planes, rows, cols) array, boxes of
// (1, box_rows, box_cols) with a 128-byte swizzle: box_cols * elem_bytes must
// be 128. Elements past rows or cols are zero-filled. Returns false where
// the encoder refuses it (a base or row stride not a multiple of 16 bytes).
inline bool make_map(CUtensorMap* map, const void* base, CUtensorMapDataType type,
                     int elem_bytes, uint64_t planes, uint64_t rows, uint64_t cols,
                     uint32_t box_rows, uint32_t box_cols) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {cols, rows, planes};
  const cuuint64_t strides[2] = {cols * elem_bytes, rows * cols * elem_bytes};
  const cuuint32_t box[3] = {box_cols, box_rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, type, 3, const_cast<void*>(base), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// (planes, rows, da) bf16, boxes of 64 rows x 64 columns
inline bool make_bf16_map(CUtensorMap* map, const void* base, uint64_t planes, uint64_t rows,
                          uint64_t da) {
  return make_map(map, base, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, planes, rows, da, 64, 64);
}

// dynamic shared memory of `bytes` for `kernel`, with the carveout at its
// largest, so that as many blocks share an SM as their shared memory allows
// (two of kernel 1's 112 KB blocks need 228 KB of the SM's 256 KB)
template <typename K>
cudaError_t set_smem_max(K kernel, int bytes) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// ---------------------------------------------------------------------------
// device: shared memory, mbarriers, TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// make barrier inits visible to the async proxy (TMA)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// order this thread's earlier generic-proxy accesses of shared memory before
// later async-proxy ones (a TMA write, a wgmma read)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// one arrival (no transaction bytes): a consumer releasing a ring stage
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// wait until the phase of parity `parity` has completed. A load that never
// lands (a wrong byte count, a refused tensor map) traps after ~2^28 polls
// instead of hanging the card: the launch then fails and the wrapper raises.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done, polls = 0;
  do {
    if (++polls == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 3-D map at (col, row, plane) into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int col,
                                         int row, int plane) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(row), "r"(plane)
      : "memory");
}

// rows [row, row + 64) of a (planes, rows, da) bf16 map: da / 64 boxes into
// consecutive 8 KB halves
template <int DA>
__device__ __forceinline__ void tma_tile(void* dst, const CUtensorMap* map, uint64_t* bar, int row,
                                         int plane) {
#pragma unroll
  for (int h = 0; h < DA / 64; ++h)
    tma_load(static_cast<char*>(dst) + h * 64 * TILE_ROW_BYTES, map, bar, h * 64, row, plane);
}

// `bytes` contiguous bytes (a multiple of 16, both addresses 16-byte aligned)
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---------------------------------------------------------------------------
// device: thread-block clusters
// ---------------------------------------------------------------------------

// the cluster barrier in two halves: arrive once this block's mbarriers are
// initialised (release), wait before the first store into another block
// (acquire), so that no store reaches a block before its mbarriers exist
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// the shared::cluster address of `p`'s counterpart in block `rank`
__device__ __forceinline__ uint32_t map_rank(const void* p, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(smem_u32(p)), "r"(rank));
  return out;
}

// stores into another block's shared memory that complete, with their byte
// counts, on that block's mbarrier (st.async): the receiver waits on its own
// mbarrier, and no cluster-wide barrier is needed
__device__ __forceinline__ void push(uint32_t dst, float a, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];\n" ::
                   "r"(dst), "f"(a), "r"(bar)
               : "memory");
}
__device__ __forceinline__ void push(uint32_t dst, int a, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.s32 [%0], %1, [%2];\n" ::
                   "r"(dst), "r"(a), "r"(bar)
               : "memory");
}
__device__ __forceinline__ void push2(uint32_t dst, float a, float b, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];\n" ::
          "r"(dst), "f"(a), "f"(b), "r"(bar)
      : "memory");
}

// ---------------------------------------------------------------------------
// device: wgmma
// ---------------------------------------------------------------------------

// descriptor of a 128-byte-swizzled operand at `p` (1024-byte aligned atom
// plus a k offset): start >> 4, LBO 16 bytes (unused), SBO 1024 bytes,
// layout 1 = SWIZZLE_128B
__device__ __forceinline__ uint64_t desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous products
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

#define LVT_WGMMA_D32                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define LVT_WGMMA_OUT32(d)                                                                     \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),          \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),  \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),            \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),            \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d (64 x 64 fp32) += A (64 x 16, K-major in shared memory) B (16 x 64,
// K-major in shared memory)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " LVT_WGMMA_D32
               ", %32, %33, p, 1, 1, 0, 0;\n}\n"
               : LVT_WGMMA_OUT32(d)
               : "l"(da), "l"(db), "r"(1));
}

// d (64 x 64 fp32) += A (64 x 16, MN-major in shared memory: wgmma's
// transposed A) B (16 x 64, MN-major: transposed B). A product over the rows
// of two row-major tiles, A^T B, reads both as TMA lays them down.
__device__ __forceinline__ void wgmma_ss_tt(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " LVT_WGMMA_D32
               ", %32, %33, p, 1, 1, 1, 1;\n}\n"
               : LVT_WGMMA_OUT32(d)
               : "l"(da), "l"(db), "r"(1));
}

// d (64 x 64 fp32) += A (64 x 16 bf16 in registers, the layout of
// acc_to_a) B (16 x 64, MN-major in shared memory: wgmma's transposed B)
__device__ __forceinline__ void wgmma_rs_t(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " LVT_WGMMA_D32
               ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
               : LVT_WGMMA_OUT32(d)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef LVT_WGMMA_D32
#undef LVT_WGMMA_OUT32

// Accumulator layout of a 64 x 64 fp32 product (PTX ISA, "wgmma register
// fragments"): thread = 32 w + 4 g + t holds rows 16 w + g (e = 0, 1) and
// 16 w + g + 8 (e = 2, 3) at columns 8 j + 2 t + (e & 1), in d[4 j + e].
__device__ __forceinline__ int acc_row(int e, int w, int g) { return 16 * w + g + (e & 2 ? 8 : 0); }
__device__ __forceinline__ int acc_col(int j, int e, int t) { return 8 * j + 2 * t + (e & 1); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// columns 16 kk .. 16 kk + 15 of a 64 x 64 accumulator, rounded to bf16, as
// the A operand of a k16 step: the register A layout is the accumulator's
// (a0 = row g, columns 2t..; a1 = row g + 8; a2, a3 the same 8 columns on),
// so no value changes thread
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&d)[32], int kk) {
  a[0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

}  // namespace lvt_hopper
