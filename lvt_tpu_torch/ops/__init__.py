"""Tensor operations of the port; the kernels' wrappers live in attention.py
(kernels 1 and 10, the block attention forward and backward) and
cache_attention.py (kernel 2), built by _lib.py."""
