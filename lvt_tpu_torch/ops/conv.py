"""Convolution primitives with the reference's semantics (counterpart of
lvt_tpu/ops/conv.py).

Public layouts are the JAX package's: activations channels-last (NHWC for
2-D, NDHWC for 3-D), weights HWIO / DHWIO, transposed-conv weights
(kh, kw, out, in). Each function moves to PyTorch's channels-first layout
around one ``torch.nn.functional`` call; the bias is added afterwards, as
the JAX package adds it. These are plain PyTorch: the JAX package leaves
them to XLA, outside any kernel.

* ``conv2d`` / ``conv_transpose2d``: torch.nn.Conv2d / ConvTranspose2d
  arithmetic (ResEncoder / ResDecoder).
* ``masked_conv3d``: the decoder's causal 3-D conv, a constant binary mask
  on the weight and asymmetric padding (kt-1, 0), (kh-1, 0), (kw//2, kw//2).
* ``subscale_context_encode``: the VT encoder's Conv3d over a one-hot
  (nc*nv)-channel code video, computed as a sum of embedding rows, one per
  (channel, kernel tap); pad codes (< 0) read a zero row.
"""

from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .embedding import take_rows


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def conv2d(x, w, b=None, stride=1, padding=0):
    """NHWC conv. w: (kh, kw, in, out); inputs follow the weight dtype."""
    x = x.to(w.dtype).permute(0, 3, 1, 2)
    out = F.conv2d(x, w.permute(3, 2, 0, 1), stride=_pair(stride), padding=_pair(padding))
    out = out.permute(0, 2, 3, 1)
    return out + b if b is not None else out


def conv_transpose2d(x, w, b=None, stride=2, padding=1):
    """torch.nn.ConvTranspose2d semantics on NHWC. w: (kh, kw, out, in),
    i.e. torch's (in, out, kh, kw) weight permuted. Output size =
    (n-1)*s - 2p + k."""
    x = x.to(w.dtype).permute(0, 3, 1, 2)
    out = F.conv_transpose2d(x, w.permute(3, 2, 0, 1), stride=_pair(stride),
                             padding=_pair(padding))
    out = out.permute(0, 2, 3, 1)
    return out + b if b is not None else out


@lru_cache(maxsize=8)
def _causal_mask_np(kt: int, kh: int, kw: int) -> np.ndarray:
    """(kt, kh, kw, 1, 1) binary mask zeroing the current pixel and
    everything to its right in the current row of the current frame."""
    m = np.ones((kt, kh, kw, 1, 1), dtype=np.float32)
    m[kt - 1, kh - 1, kw // 2 :] = 0.0
    return m


def masked_conv3d(x, w, b=None):
    """Causal 3-D conv on (b, t, h, w, c); w: (kt, kh, kw, in, out). The
    padding keeps the output size while only past raster positions feed
    each output."""
    x = x.to(w.dtype)
    kt, kh, kw = w.shape[:3]
    w = w * torch.as_tensor(_causal_mask_np(kt, kh, kw), device=w.device).to(w.dtype)
    xc = x.permute(0, 4, 1, 2, 3)
    xc = F.pad(xc, (kw // 2, kw // 2, kh - 1, 0, kt - 1, 0))
    out = F.conv3d(xc, w.permute(4, 3, 0, 1, 2)).permute(0, 2, 3, 4, 1)
    return out + b if b is not None else out


def subscale_context_encode(ctx: torch.Tensor, table: torch.Tensor,
                            bias: Optional[torch.Tensor],
                            stride: Tuple[int, int, int], nv: int) -> torch.Tensor:
    """Conv3d(one_hot(ctx)) with VALID padding, as an index-gather-sum.

    ctx:   (b, nc, T', H', W') int codes, negative = pad (contributes zero)
    table: (nc, kt, kh, kw, nv, de) embedding-form conv weight
    Returns (b, t, h, w, de).
    """
    nc, kt, kh, kw, nv_t, de = table.shape
    assert nv_t == nv
    st, sh, sw = stride
    b = ctx.shape[0]
    Tp, Hp, Wp = ctx.shape[2:]
    t, h, w = (Tp - kt) // st + 1, (Hp - kh) // sh + 1, (Wp - kw) // sw + 1
    wins = [ctx[:, :, dt:dt + (t - 1) * st + 1:st, dh:dh + (h - 1) * sh + 1:sh,
                dw:dw + (w - 1) * sw + 1:sw]
            for dt in range(kt) for dh in range(kh) for dw in range(kw)]
    K = kt * kh * kw
    idx = torch.stack(wins, dim=2).long()  # (b, nc, K, t, h, w)
    idx = (idx + 1).clamp(0, nv)  # pad (-1) -> row 0 of its slot
    base = (torch.arange(nc * K, device=ctx.device) * (nv + 1)).reshape(1, nc, K, 1, 1, 1)
    gidx = (idx + base).reshape(b, nc * K, t * h * w)
    flat = table.reshape(nc * K, nv, de)
    flat = torch.cat([flat.new_zeros(nc * K, 1, de), flat], dim=1).reshape(-1, de)
    emb = take_rows(flat, gidx).sum(dim=1).reshape(b, t, h, w, de)
    return emb + bias if bias is not None else emb
