"""Tensor operations of the port; the kernels' wrappers live in attention.py
(kernel 1) and cache_attention.py (kernel 2), built by _lib.py."""
