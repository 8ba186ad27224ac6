"""The port's center-crop + Lanczos resize (lvt_tpu_torch/data/preprocess.py)
held to lvt_tpu's (jax.image.resize "lanczos3", antialias) and to PIL on the
same numpy-seeded frames.

Bounds:
* uint8 frames: each pixel within one step of lvt_tpu's, and at most 0.1%
  of the pixels differ (a filtered sum within fp32 rounding of x.5 rounds
  either way);
* float frames on a [0, 255] scale: within FLOAT_TOL of a float64
  evaluation of the same filter (the weights from lvt_tpu's own
  ``compute_weight_mat``), and within lvt_tpu's own distance from that
  evaluation plus FLOAT_TOL of lvt_tpu's result. FLOAT_TOL = 2e-4 is 13
  fp32 ulps at 255: each output sums 240 products of up to 255 twice, in an
  order that differs between the CPU's and the card's libraries (measured
  8.2e-5 here, 1.19e-4 on the H100, tests/test_torch_kernels.py). lvt_tpu's
  jitted resize sits up to 6.1e-4 from the float64 value at 240 x 320 -> 64,
  so its result cannot itself be the reference there;
* against PIL, tests/test_preprocess.py's bounds: one step at the Kinetics
  downscale, 12 steps at small scale factors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.image.scale import _fill_lanczos_kernel, compute_weight_mat
from PIL import Image

from lvt_tpu.data.preprocess import center_crop_resize as jax_crop_resize
from lvt_tpu_torch.data.preprocess import (center_crop_resize, center_crop_square,
                                           lanczos_weights)

torch.set_num_threads(1)  # one intra-op thread: the test workers share the cores

# (frames shape, img_size): the Kinetics geometry, a small downscale, odd
# crop remainders (37 rows: no resize; 27 columns: a resize), a leading
# batch of 2 x 3
FLOAT_TOL = 2e-4
SHAPES = [((3, 240, 320, 3), 64), ((2, 48, 40, 3), 32), ((2, 101, 64, 3), 64),
          ((1, 77, 50, 3), 20), ((2, 3, 48, 40, 3), 32)]


def _frames(shape, dtype, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8).astype(dtype)


def _pil(img, size):
    """The reference's per-frame recipe (scripts/convert_kinetics.py:41-47)."""
    pil = Image.fromarray(img)
    w, h = pil.size
    dim = min(w, h)
    left, top = (w - dim) / 2, (h - dim) / 2
    return np.asarray(pil.crop((left, top, left + dim, top + dim))
                      .resize((size, size), Image.LANCZOS))


def _float64_resize(x, size):
    """The filter evaluated in float64, with lvt_tpu's weight matrix."""
    h, w = x.shape[-3], x.shape[-2]
    dim = min(h, w)
    x = x[..., (h - dim) // 2:(h - dim) // 2 + dim, (w - dim) // 2:(w - dim) // 2 + dim, :]
    if dim == size:
        return x.astype(np.float64)
    wm = np.asarray(compute_weight_mat(dim, size, jnp.float32(size / dim), jnp.float32(0.0),
                                       lambda v: _fill_lanczos_kernel(3.0, v), True),
                    np.float64)
    return np.einsum("...hwc,ho,wp->...opc", x.astype(np.float64), wm, wm, optimize=True)


@pytest.mark.parametrize("shape,size", SHAPES)
def test_uint8_matches_lvt_tpu(shape, size):
    x = _frames(shape, np.uint8)
    want = np.asarray(jax_crop_resize(jnp.asarray(x), size))
    got = center_crop_resize(torch.from_numpy(x), size)
    assert got.dtype == torch.uint8 and got.shape == want.shape == shape[:-3] + (size, size, 3)
    diff = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).mean())


@pytest.mark.parametrize("shape,size", SHAPES)
def test_float_matches_lvt_tpu(shape, size):
    x = _frames(shape, np.float32, seed=1)
    want = np.asarray(jax_crop_resize(jnp.asarray(x), size))
    got = center_crop_resize(torch.from_numpy(x), size)
    assert got.dtype == torch.float32 and got.shape == want.shape
    exact = _float64_resize(x, size)
    assert np.abs(got.numpy() - exact).max() <= FLOAT_TOL
    jax_err = np.abs(want - exact).max()
    assert np.abs(got.numpy() - want).max() <= jax_err + FLOAT_TOL


def test_weights_match_lvt_tpu():
    for n_in, n_out in ((240, 64), (40, 32), (50, 20), (20, 64)):
        want = np.asarray(compute_weight_mat(n_in, n_out, jnp.float32(n_out / n_in),
                                             jnp.float32(0.0),
                                             lambda v: _fill_lanczos_kernel(3.0, v), True))
        got = lanczos_weights(n_in, n_out).numpy()
        np.testing.assert_allclose(got, want, atol=2e-7, rtol=0)


@pytest.mark.parametrize("hw", [(240, 320), (320, 240), (101, 64), (64, 64)])
def test_matches_pil_at_the_kinetics_downscale(hw):
    img = _frames(hw + (3,), np.uint8, seed=2)
    got = center_crop_resize(torch.from_numpy(img), 64).numpy().astype(np.int32)
    diff = np.abs(got - _pil(img, 64).astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.25


def test_close_to_pil_at_a_small_scale_factor():
    img = _frames((120, 160, 3), np.uint8, seed=3)
    diff = np.abs(center_crop_resize(torch.from_numpy(img), 64).numpy().astype(np.int32)
                  - _pil(img, 64).astype(np.int32))
    assert diff.max() <= 12 and diff.mean() < 0.5
    grad = np.tile(np.linspace(0, 255, 160, dtype=np.float32)[None, :, None],
                   (120, 1, 3)).astype(np.uint8)
    got = center_crop_resize(torch.from_numpy(grad), 64).numpy().astype(np.int32)
    assert np.abs(got - _pil(grad, 64).astype(np.int32)).max() <= 1


def test_batched_equals_per_frame_and_crop_geometry():
    frames = torch.from_numpy(_frames((5, 48, 40, 3), np.uint8))
    batched = center_crop_resize(frames, 32)
    assert torch.equal(batched, torch.stack([center_crop_resize(f, 32) for f in frames]))
    x = torch.arange(7 * 10 * 3).reshape(7, 10, 3)
    assert torch.equal(center_crop_square(x), x[:, 1:8])
    bf = center_crop_resize(frames.to(torch.bfloat16), 32)
    assert bf.dtype == torch.bfloat16
