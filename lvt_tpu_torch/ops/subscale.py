"""Subscale ordering machinery as static index arithmetic.

The reference builds boolean masks and uses masked_select / masked_fill /
masked_scatter with data-dependent shapes (vidgen/modeling/autoregressive/
vt_utils.py:6-128, meta_arch/vt.py:107-134). Here everything is precomputed
**gather/scatter index maps** on the host (numpy, once per (stride, kernel,
video shape)) and applied on the device with index_select / index_put — one
gather per slice. ``build_plan`` and ``SubscalePlan`` are lvt_tpu/ops/subscale.py's
numpy code unchanged; the appliers at the bottom are torch counterparts of its
jnp ones.

Geometry note: the reference's ``ss_shift`` crops/pads so a strided conv
centers its first application on slice element (a, b, c). The shifted shape
``kt + (t-1)*st`` per axis is independent of (a, b, c), so all per-slice
context maps share one static shape and stack into a single (S, T', H', W')
array.
"""

from functools import lru_cache
from typing import NamedTuple, Tuple

import numpy as np
import torch


def subscale_order(st: int, sh: int, sw: int):
    """Slice ordering bijection (reference vt_utils.py:6-14):
    slice index runs over (a, b, c) in row-major order."""
    idx2abc = [(a, b, c) for a in range(st) for b in range(sh) for c in range(sw)]
    abc2idx = {abc: i for i, abc in enumerate(idx2abc)}
    return idx2abc, abc2idx


def slice_mask_np(a, b, c, st, sh, sw, T, H, W) -> np.ndarray:
    """(T, H, W) bool mask of slice (a, b, c) (reference vt_utils.py:24-33)."""
    m = np.zeros((T, H, W), dtype=bool)
    m[a::st, b::sh, c::sw] = True
    return m


def visible_abc_mask_np(a, b, c, st, sh, sw, T, H, W) -> np.ndarray:
    """(T, H, W) bool mask of all slices strictly before (a, b, c)
    (reference vt_utils.py:48-57)."""
    idx2abc, abc2idx = subscale_order(st, sh, sw)
    m = np.zeros((T, H, W), dtype=bool)
    for (ai, bi, ci) in idx2abc[: abc2idx[(a, b, c)]]:
        m[ai::st, bi::sh, ci::sw] = True
    return m


def shifted_shape(st, sh, sw, T, H, W, kt, kh, kw) -> Tuple[int, int, int]:
    """Shape of ``ss_shift`` output; constant across (a, b, c).

    Per axis: (m-1)*s + 1 core positions plus k//2 padding each side —
    equal to k + (m-1)*s only for odd k (all shipped configs), hence the
    explicit half-width formula."""
    t, h, w = T // st, H // sh, W // sw
    return (2 * (kt // 2) + 1 + (t - 1) * st,
            2 * (kh // 2) + 1 + (h - 1) * sh,
            2 * (kw // 2) + 1 + (w - 1) * sw)


def _axis_shift(a, s, n, k):
    """Crop offsets and pads for one axis of ss_shift
    (reference vt_utils.py:104-128). Returns (crop_lo, crop_hi, pad_lo, pad_hi)."""
    m = n // s  # slice extent along this axis
    lo, hi = a, a + (m - 1) * s
    front = k // 2 - lo
    back = k // 2 - (n - hi - 1)
    return (max(0, -front), max(0, -back), max(0, front), max(0, back))


def ss_shift_np(x: np.ndarray, a, b, c, st, sh, sw, kt, kh, kw, pad_value=0) -> np.ndarray:
    """Reference-equivalent ss_shift on a (..., T, H, W) numpy array."""
    T, H, W = x.shape[-3:]
    (ot0, ot1, pt0, pt1) = _axis_shift(a, st, T, kt)
    (oh0, oh1, ph0, ph1) = _axis_shift(b, sh, H, kh)
    (ow0, ow1, pw0, pw1) = _axis_shift(c, sw, W, kw)
    x = x[..., ot0 : T - ot1, oh0 : H - oh1, ow0 : W - ow1]
    pad = [(0, 0)] * (x.ndim - 3) + [(pt0, pt1), (ph0, ph1), (pw0, pw1)]
    return np.pad(x, pad, mode="constant", constant_values=pad_value)


class SubscalePlan(NamedTuple):
    """All static index maps for one (stride, kernel, T, H, W) geometry.

    ctx_src:   (S, T', H', W') int32 — flat (T*H*W) video index feeding each
               shifted-context position, or -1 where the context is pad
               (outside the video or not yet generated).
    slice_src: (S, t, h, w) int32 — flat video index of each slice element.
    prime_tmask applied externally (prime frames are a property of sampling,
    not of the geometry).
    """

    st: int
    sh: int
    sw: int
    T: int
    H: int
    W: int
    kt: int
    kh: int
    kw: int
    ctx_src: np.ndarray
    slice_src: np.ndarray
    # (S, T') flat FRAME index per context frame, or None. Set when every
    # (H', W') plane of ctx_src is either all-pad or one whole video frame in
    # identity spatial layout (true whenever sh == sw == 1 and kh == kw == 1,
    # e.g. DSFVT's (16,1,1)/(7,1,1)). Lets gather_context run as a T'-row
    # frame gather (contiguous rows) instead of a per-element scalar gather.
    ctx_frame_src: "np.ndarray | None" = None

    @property
    def num_slices(self) -> int:
        return self.st * self.sh * self.sw

    @property
    def slice_shape(self) -> Tuple[int, int, int]:
        return (self.T // self.st, self.H // self.sh, self.W // self.sw)

    @property
    def ctx_shape(self) -> Tuple[int, int, int]:
        return shifted_shape(self.st, self.sh, self.sw, self.T, self.H, self.W,
                             self.kt, self.kh, self.kw)


@lru_cache(maxsize=32)
def build_plan(st, sh, sw, T, H, W, kt, kh, kw) -> SubscalePlan:
    assert T % st == 0 and H % sh == 0 and W % sw == 0
    idx2abc, _ = subscale_order(st, sh, sw)
    flat_idx = np.arange(T * H * W, dtype=np.int32).reshape(T, H, W)
    t, h, w = T // st, H // sh, W // sw

    ctx_maps, slice_maps = [], []
    for (a, b, c) in idx2abc:
        vis = visible_abc_mask_np(a, b, c, st, sh, sw, T, H, W)
        src = np.where(vis, flat_idx, np.int32(-1))
        src = ss_shift_np(src, a, b, c, st, sh, sw, kt, kh, kw, pad_value=-1)
        ctx_maps.append(src.astype(np.int32))
        slice_maps.append(flat_idx[a::st, b::sh, c::sw].astype(np.int32))

    ctx_src = np.stack(ctx_maps)
    return SubscalePlan(
        st, sh, sw, T, H, W, kt, kh, kw,
        ctx_src=ctx_src,
        slice_src=np.stack(slice_maps),
        ctx_frame_src=_frame_decompose(ctx_src, H, W),
    )


def _frame_decompose(ctx_src: np.ndarray, H: int, W: int):
    """(S, T', H', W') map -> (S, T') frame indices iff every (H', W') plane
    is all-pad (-1) or exactly one whole frame in identity layout."""
    S, Tp, Hp, Wp = ctx_src.shape
    if (Hp, Wp) != (H, W):
        return None
    HW = H * W
    ident = np.arange(HW, dtype=np.int64)
    out = np.full((S, Tp), -1, np.int32)
    for s in range(S):
        for i in range(Tp):
            row = ctx_src[s, i].reshape(-1).astype(np.int64)
            if (row == -1).all():
                continue
            f, r = divmod(row[0], HW)
            if r != 0 or not (row == row[0] + ident).all():
                return None
            out[s, i] = f
    return out


def plan_from_cfg(cfg, T, H, W) -> SubscalePlan:
    st, sh, sw = cfg.MODEL.AUTOREGRESSIVE.VT.STRIDE
    kt, kh, kw = cfg.MODEL.AUTOREGRESSIVE.VT.KERNEL
    return build_plan(st, sh, sw, T, H, W, kt, kh, kw)


# --------------------------------------------------------------------------
# Device-side appliers (torch). The gathers take per-sample maps, tensors
# on the video's device (a model caches them); scatter_slice takes one host
# numpy map for the whole batch.
# --------------------------------------------------------------------------

def _index(src, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(src, np.int64).reshape(-1), device=device)


def gather_context_frames(video4: torch.Tensor, frame_src: torch.Tensor,
                          pad_value: int) -> torch.Tensor:
    """Frame-row gather_context. video4: (b, nc, T, H*W); frame_src: (b, T')
    per-sample frame indices with -1 = pad, on video4's device. Returns
    (b, nc, T', H*W)."""
    b, nc, _, hw = video4.shape
    safe = frame_src.clamp(0, video4.shape[2] - 1).long()
    ctx = torch.gather(video4, 2, safe[:, None, :, None].expand(b, nc, -1, hw))
    return ctx.masked_fill((frame_src < 0)[:, None, :, None], pad_value)


def gather_context(video_flat: torch.Tensor, ctx_src: torch.Tensor, pad_value: int) -> torch.Tensor:
    """video_flat: (b, nc, T*H*W) int codes; ctx_src: (b, T', H', W')
    per-sample index maps on its device (-1 = pad). Returns
    (b, nc, T', H', W') with ``pad_value`` at pad positions."""
    b, nc = video_flat.shape[:2]
    idx = ctx_src.clamp(min=0).reshape(b, 1, -1).long().expand(b, nc, -1)
    ctx = torch.gather(video_flat, 2, idx).reshape((b, nc) + tuple(ctx_src.shape[1:]))
    return ctx.masked_fill((ctx_src < 0)[:, None], pad_value)


def gather_slice(video_flat: torch.Tensor, slice_src: torch.Tensor) -> torch.Tensor:
    """Extract each sample's slice: video_flat (b, nc, T*H*W), slice_src
    (b, t, h, w) per-sample index maps on its device. Returns
    (b, nc, t, h, w)."""
    b, nc = video_flat.shape[:2]
    idx = slice_src.reshape(b, 1, -1).long().expand(b, nc, -1)
    return torch.gather(video_flat, 2, idx).reshape((b, nc) + tuple(slice_src.shape[1:]))


def scatter_slice(video_flat: torch.Tensor, slice_src, values: torch.Tensor) -> torch.Tensor:
    """Write slice values back: inverse of gather_slice. Returns a new
    tensor; ``video_flat`` is left as it was."""
    flat_vals = values.reshape(values.shape[: values.ndim - 3] + (-1,))
    out = video_flat.clone()
    out[..., _index(slice_src, video_flat.device)] = flat_vals
    return out
