"""Kernel 2, ``lvt_decode_attention`` (``ops/cache_attention.py``
``decode_attention_cuda``, ``csrc/decode_attention.cu``): one query row a
(batch row, head) against the first ``live`` rows of its K and V cache.
The bytes and operations its calls need, counted from their shapes as
``chip_smoke.py`` counts them beside ``bound_ms``: q read and the output
written (b na da each), K and V's live rows read (b na live da each), in the
cache's element size, and the bias row read in fp32 (na live); QK^T and
P.V, 4 b na live da operations."""

KEYS = ("decode_attention_kernel",)  # its __global__ function's name
WRAPPER = "decode_attention_cuda"  # the wrapper that counts its launches


def call(b: int, na: int, live: int, da: int, el: int):
    """(bytes, operations) of one call."""
    return (2 * b * na * live * da + 2 * b * na * da) * el + na * live * 4, 4 * b * na * live * da


def rollout(b: int, na: int, da: int, layers: int, thw: int, rows: int, slices: int, el: int):
    """(bytes, operations, calls) of a rollout's calls: at pixel p of each
    slice and each layer one call over its block run's rows p mod rows + 1."""
    nbytes = ops = 0
    for p in range(thw):
        cb, co = call(b, na, p % rows + 1, da, el)
        nbytes += cb
        ops += co
    n = slices * layers
    return n * nbytes, n * ops, n * thw
