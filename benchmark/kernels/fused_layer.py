"""Kernels 7, 8 and 9, the fused layer (``ops/fused_layer.py``
``fused_layer_fwd_cuda``, ``ffn_half_bwd_cuda``, ``attn_half_bwd_cuda``;
``csrc/fused_layer.cu`` with the attention of ``csrc/block_attention*.cuh``):
the bytes and operations of one call on nb blocks of n tokens of width d,
na heads of da, in bf16, counted from the shapes as ``chip_smoke.py`` counts
them (each input read once, each output written once; the products the
functions need). A causal call needs the score-space products of the lower
triangle only, n (n + 1) / 2 of the n^2 pairs."""

# the __global__ functions the three entry points launch (in a fused train
# step nothing else launches them)
KEYS = ("ln_qkv", "gemm_nt", "ln_rows_bf16", "ln_bwd_rows", "proj_ffn", "ffn_bwd_rows",
        "gemm_tn", "block_attention_wgmma_kernel", "block_attention_fwd_kernel", "bwd_rows_",
        "bwd_keys_", "dbias_reduce")
WRAPPERS = {7: "fused_layer_fwd_cuda", 8: "ffn_half_bwd_cuda", 9: "attn_half_bwd_cuda"}


def counts(nb: int, n: int, d: int, na: int, da: int, causal: bool = False, el: int = 2):
    """{kernel: (bytes, operations)} of one call of each."""
    rows, wide = nb * n, 3 * na * da
    w_bytes = (d * wide + na * da * d + 2 * d * d + 6 * d) * el
    bias_b = na * n * n * 4
    pairs = n * (n + 1) // 2 if causal else n * n
    attn = nb * na * pairs * da  # multiply-adds of one score-space product
    return {
        7: (3 * rows * d * el + w_bytes + bias_b,
            2 * rows * d * wide + 4 * attn + 2 * rows * na * da * d + 4 * rows * d * d),
        8: (3 * rows * d * el + 2 * d * d * el + 2 * d * d * 4 + 8 * d * 4, 10 * rows * d * d),
        9: (3 * rows * d * el + (d * wide + na * da * d) * el + bias_b
            + (d * wide + na * da * d) * 4 + bias_b,
            2 * 3 * rows * d * wide + 2 * 2 * rows * na * da * d + 12 * attn),
    }
