"""N-dimensional sinusoidal positional encoding (counterpart of
lvt_tpu/ops/posenc.py; reference vt_attention.py:10-50).

Channels-last layout: x is (..., t, h, w, d). Each spatial axis owns a
contiguous channel band of 2*num_timescales channels (sin block then cos
block), bands laid out axis-major from channel 0; trailing channels beyond
3*2*num_timescales stay untouched. The table is built in numpy, exactly as
the JAX package builds it, so both packages add the same fp32 values."""

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=16)
def _signal_np(shape, d_model, min_timescale=1.0, max_timescale=1.0e4):
    num_dims = len(shape)
    assert d_model >= num_dims * 2, "d_model must be >= 2 * num_dims"
    nts = d_model // (num_dims * 2)
    log_inc = np.log(max_timescale / min_timescale) / nts
    inv_timescales = min_timescale * np.exp(np.arange(nts, dtype=np.float32) * -log_inc)

    total = np.zeros(shape + (d_model,), dtype=np.float32)
    for dim, length in enumerate(shape):
        pos = np.arange(length, dtype=np.float32)
        scaled = pos[:, None] * inv_timescales[None, :]  # (length, nts)
        sig = np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1)  # (length, 2*nts)
        band = np.zeros((length, d_model), dtype=np.float32)
        band[:, dim * 2 * nts : (dim + 1) * 2 * nts] = sig
        bshape = [1] * num_dims + [d_model]
        bshape[dim] = length
        total = total + band.reshape(bshape)
    return total


def add_positional_encoding(x: torch.Tensor, num_dims: int = 3) -> torch.Tensor:
    """x: (..., s1, ..., s_num_dims, d); returns x + PE."""
    shape = tuple(int(s) for s in x.shape[-num_dims - 1 : -1])
    sig = _signal_np(shape, int(x.shape[-1]))
    return x + torch.as_tensor(sig, device=x.device).to(x.dtype)
