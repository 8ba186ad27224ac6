"""The subscale order of a video of codes: which positions make up each
slice, and which positions of the video a slice's context shows (a frozen
copy of the port's ``ops/subscale.py`` ``build_plan``, numpy only).

A video (T, H, W) with stride (st, sh, sw) has st * sh * sw slices, slice
(a, b, c) the positions [a::st, b::sh, c::sw], in row-major (a, b, c) order.
Slice s sees every slice before it. Its context is the video with the
slices not yet seen set to pad (-1), cropped and padded so that a
convolution with kernel (kt, kh, kw) and the stride, without padding, lands
its first window on the slice's first position.
"""

from functools import lru_cache
from typing import NamedTuple, Tuple

import numpy as np


class Plan(NamedTuple):
    stride: Tuple[int, int, int]
    shape: Tuple[int, int, int]  # (T, H, W)
    kernel: Tuple[int, int, int]
    ctx_src: np.ndarray  # (S, T', H', W') flat video index, -1 where pad
    slice_src: np.ndarray  # (S, t, h, w) flat video index of each slice position

    @property
    def num_slices(self) -> int:
        return int(self.slice_src.shape[0])

    @property
    def slice_shape(self) -> Tuple[int, int, int]:
        return tuple(int(x) for x in self.slice_src.shape[1:])


def _crop_pad(a: int, s: int, n: int, k: int):
    """(crop_lo, crop_hi, pad_lo, pad_hi) of one axis for slice offset a."""
    m = n // s
    lo, hi = a, a + (m - 1) * s
    front = k // 2 - lo
    back = k // 2 - (n - hi - 1)
    return max(0, -front), max(0, -back), max(0, front), max(0, back)


@lru_cache(maxsize=16)
def build_plan(stride, shape, kernel) -> Plan:
    st, sh, sw = stride
    T, H, W = shape
    if T % st or H % sh or W % sw:
        raise ValueError(f"video {shape} does not divide by the stride {stride}")
    order = [(a, b, c) for a in range(st) for b in range(sh) for c in range(sw)]
    flat = np.arange(T * H * W, dtype=np.int64).reshape(T, H, W)
    ctx, sl = [], []
    for i, (a, b, c) in enumerate(order):
        seen = np.zeros((T, H, W), dtype=bool)
        for (a2, b2, c2) in order[:i]:
            seen[a2::st, b2::sh, c2::sw] = True
        src = np.where(seen, flat, -1)
        cuts = [_crop_pad(o, s, n, k) for o, s, n, k in zip((a, b, c), stride, shape, kernel)]
        src = src[cuts[0][0]:T - cuts[0][1], cuts[1][0]:H - cuts[1][1], cuts[2][0]:W - cuts[2][1]]
        src = np.pad(src, [(p0, p1) for _, _, p0, p1 in cuts], constant_values=-1)
        ctx.append(src)
        sl.append(flat[a::st, b::sh, c::sw])
    return Plan(tuple(stride), tuple(shape), tuple(kernel), np.stack(ctx), np.stack(sl))
