"""Video-frame preprocessing on the device: center-crop square + Lanczos
resize (counterpart of lvt_tpu/data/preprocess.py).

The reference preprocesses Kinetics frames on the host, one PIL call per
frame (reference scripts/convert_kinetics.py:41-47: crop the centered
min(H, W) square, ``Image.LANCZOS``-resize to ``img_size``). Here a whole
batch of frames is filtered at once on the tensor's device.

PyTorch has no Lanczos resize (``F.interpolate`` stops at bicubic), so the
filter is written out as ``jax.image.resize(method="lanczos3",
antialias=True)`` builds it (jax/_src/image/scale.py): for each resized axis
an (in, out) weight matrix of the radius-3 Lanczos kernel at the sample
positions ``(i + 0.5) / scale - 0.5``, its support widened by 1 / scale when
downscaling, each output's weights normalised to sum 1 and zeroed where the
sample falls outside the input; an axis whose size does not change is left
as it is. The two matrices are built in fp32 on the device and applied as
two fp32 products (TF32 is off: ``lvt_tpu_torch/__init__.py``), the
counterpart of the JAX package's ``Precision.HIGHEST`` einsum.

Against PIL (tests/test_preprocess.py's bounds): within 1/255 at the
Kinetics geometry (>= 240 px min-dim -> 64); up to ~10/255 on rare pixels
at small scale factors, where PIL's fixed-point two-pass resample with a
rounded uint8 intermediate is the less accurate side. The crop starts at
``(H - dim) // 2``, as PIL rounds the reference's fractional box.
"""

import math

import numpy as np
import torch

__all__ = ["center_crop_square", "center_crop_resize", "lanczos_weights"]

_RADIUS = 3.0


def center_crop_square(frames: torch.Tensor) -> torch.Tensor:
    """The centered min(H, W) square of (..., H, W, C) frames (a view)."""
    h, w = frames.shape[-3], frames.shape[-2]
    dim = min(h, w)
    top, left = (h - dim) // 2, (w - dim) // 2
    return frames[..., top:top + dim, left:left + dim, :]


def lanczos_weights(in_size: int, out_size: int, device=None) -> torch.Tensor:
    """(in_size, out_size) fp32 weights of the antialiased radius-3 Lanczos
    resample of one axis, as jax.image's ``compute_weight_mat``."""
    f32 = torch.float32
    # the scalars in fp32, as jax.image computes them; kept on the host, so
    # that the function copies nothing to the device and can be captured
    inv_scale = np.float32(1.0) / np.float32(out_size / in_size)
    kernel_scale = max(inv_scale, np.float32(1.0))  # antialias: widen when downscaling
    sample = (torch.arange(out_size, dtype=f32, device=device) + 0.5) * float(inv_scale) - 0.5
    x = (sample[None, :] - torch.arange(in_size, dtype=f32, device=device)[:, None]).abs() \
        / float(kernel_scale)
    y = _RADIUS * torch.sin(math.pi * x) * torch.sin(math.pi * x / _RADIUS)
    k = torch.where(x > 1e-3, y / torch.where(x != 0, math.pi ** 2 * x * x, 1.0),
                    torch.ones_like(x))
    weights = torch.where(x > _RADIUS, torch.zeros_like(x), k)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * torch.finfo(f32).eps,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def center_crop_resize(frames: torch.Tensor, img_size: int) -> torch.Tensor:
    """Center-crop square, then resize to (img_size, img_size), on the
    tensor's device.

    frames: (..., H, W, C) of any integer or float dtype, any leading batch
    axes. Integer frames are filtered in fp32, then rounded (half to even)
    and clipped to their dtype's range; float frames stay in their dtype.
    """
    x = center_crop_square(frames)
    dim, c = x.shape[-2], x.shape[-1]
    lead = x.shape[:-3]
    y = x.to(torch.float32).reshape((-1, dim, dim, c))
    if dim != img_size:
        w = lanczos_weights(dim, img_size, y.device)  # the same for H and W: a square
        n = y.shape[0]
        # H: (out, in) @ (n, in, dim * c); then W: (out, in) @ (n * out, in, c)
        y = torch.matmul(w.T, y.reshape(n, dim, dim * c)).reshape(n * img_size, dim, c)
        y = torch.matmul(w.T, y).reshape(n, img_size, img_size, c)
    y = y.reshape(lead + (img_size, img_size, c))
    if frames.dtype.is_floating_point:
        return y.to(frames.dtype)
    info = torch.iinfo(frames.dtype)
    return torch.round(y).clamp(info.min, info.max).to(frames.dtype)
