// C entry point of kernel 10, the block-local attention backward
// (block_attention_bwd.cuh).

#include "block_attention_bwd.cuh"

// dtype: 0 = float32, 1 = bfloat16. Launches the query-tile, key-tile and
// dbias kernels on `stream`; returns the first failing cudaError_t, or 0.
// stats (3 * nb * na * np floats, np = n rounded up to 64) and part
// (planes * na * n * n floats, planes = min(nb, 8) in bf16, nb in fp32) are
// scratch the caller allocates.
extern "C" int lvt_block_attention_bwd(const void* q, const void* k, const void* v,
                                       const float* bias, const void* g, void* dq, void* dk,
                                       void* dv, float* dbias, float* stats, float* part,
                                       int nb, int na, int n, int da, int causal, int dtype,
                                       float scale, cudaStream_t stream) {
  return lvt_bwd::block_attention_bwd(q, k, v, bias, g, dq, dk, dv, dbias, stats, part, nb, na, n,
                                      da, causal, dtype, scale, stream);
}
