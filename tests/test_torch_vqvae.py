"""The port's PR-DVQVAE2 at full width, with the JAX package's weights
carried across: codebook indices of example/*.png and of random frames
equal lvt_tpu's, and decoded frames within 1e-4.

Indices: both packages compute fp32 distances, but the encoder's convolutions
sum in different orders (XLA vs oneDNN), so z_e differs in the last bits.
Where two codebook entries lie within a few fp32 ulps of z_e the choice
between them is decided by that rounding. The test allows a differing index
only at such a true near-tie (float64 distances of the two entries within 8
fp32 ulps of each other), and at most one per thousand indices."""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from lvt_tpu.config import get_cfg
from lvt_tpu.models.vqvae import VQVAE as JaxVQVAE
from lvt_tpu_torch.checkpoint import from_jax_vqvae
from lvt_tpu_torch.models.vqvae import VQVAE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEAR_TIE = 8 * float(np.finfo(np.float32).eps)


@pytest.fixture(scope="module")
def models():
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(ROOT, "configs/vqvae/PR-DVQVAE2.yaml"))
    jq = JaxVQVAE(cfg)
    jp, js = jq.init(jax.random.key(1))
    to_np = lambda t: jax.tree_util.tree_map(np.array, t)
    tp, ts = from_jax_vqvae(to_np(jp), to_np(js))
    return jq, jp, js, VQVAE(cfg), tp, ts


def _frames(kind):
    if kind == "example":
        paths = sorted(glob.glob(os.path.join(ROOT, "example", "*.png")))
        return np.stack([np.asarray(Image.open(p).convert("RGB"), np.float32) / 255.0
                         for p in paths])
    return np.random.default_rng(0).random((8, 64, 64, 3)).astype(np.float32)


def assert_indices_match(jq, jp, js, x, got, want):
    """Equal, or differing only at documented near-ties (see module doc)."""
    diff = np.argwhere(got != want)
    assert len(diff) <= max(1, want.size // 1000), f"{len(diff)} of {want.size} differ"
    if len(diff):
        z = np.asarray(jq.encode_features(jp, js, jnp.asarray(x))[0], np.float64)
        emb = np.asarray(js["netC"].embedding, np.float64)
        num, _, Dc = emb.shape
        for b, h, w, i in diff:
            zi = z[b, h, w].reshape(num, Dc)[i]
            d = ((zi[None] - emb[i]) ** 2).sum(1)
            dj, dt = d[want[b, h, w, i]], d[got[b, h, w, i]]
            assert abs(dj - dt) <= NEAR_TIE * dj, (b, h, w, i, dj, dt)


@pytest.mark.parametrize("kind", ["example", "random"])
def test_encode_indices_and_decode_match(models, kind):
    jq, jp, js, tq, tp, ts = models
    x = np.asarray(jq.normalize(jnp.asarray(_frames(kind))))
    want = np.asarray(jq.encode(jp, js, jnp.asarray(x)))
    with torch.no_grad():
        got = tq.encode(tp, ts, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (x.shape[0], 16, 16, 4)
    assert got.dtype == want.dtype == np.int32
    assert_indices_match(jq, jp, js, x, got, want)

    want_y = np.asarray(jq.denormalize(jq.decode(jp, js, jnp.asarray(want))))
    with torch.no_grad():
        got_y = tq.denormalize(tq.decode(tp, ts, torch.from_numpy(want))).numpy()
    assert got_y.shape == (x.shape[0], 64, 64, 3)
    np.testing.assert_allclose(got_y, want_y, atol=1e-4, rtol=0)


def test_normalize_matches(models):
    jq, _, _, tq, _, _ = models
    x = _frames("random")
    np.testing.assert_array_equal(tq.normalize(torch.from_numpy(x)).numpy(),
                                  np.asarray(jq.normalize(jnp.asarray(x))))
