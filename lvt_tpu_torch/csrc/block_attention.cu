// C entry point of kernel 1, the block-local attention forward
// (block_attention.cuh).

#include "block_attention.cuh"

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int lvt_block_attention_fwd(const void* q, const void* k, const void* v,
                                       const float* bias, void* out, int nb, int na,
                                       int n, int da, int causal, int dtype, float scale,
                                       cudaStream_t stream) {
  return lvt_fwd::block_attention_fwd(q, k, v, bias, out, nb, na, n, da, causal, dtype, scale,
                                      stream);
}
