"""The port's FVD pieces held to lvt_tpu's on the CPU:

* frechet_distance, gaussian_stats and fvd_from_features: the same float64
  numpy, so equal;
* the stub feature net: the committed weights (fvd_stub_weights.npz) are
  lvt_tpu's own draws, ``jax.random.normal`` of the two halves of
  ``jax.random.split(jax.random.key(0))`` times 0.1 (how the file was made),
  bit for bit; its features equal lvt_tpu's make_stub_features() on a seeded
  video within 1e-5 of the largest (fp32 convolutions summed in other
  orders: ~4e-7 relative);
* I3D: i3d_apply on lvt_tpu's init_i3d weights (drawn under jit, the same
  function of the key) carried across by from_jax_i3d, at
  (1, 16, 64, 64, 3) as tests/test_fvd.py runs it: within 1e-5 of the
  largest logit (measured ~2e-6); TensorFlow "SAME" padding on every stride-2
  conv and pool; the .npz round trip; the bilinear resize against
  jax.image.resize up (64 -> 224) and down (64 -> 40, 17), within 1e-5;
* FVDEvaluator end to end in both packages on the same codes and the same
  VQ-VAE weights (lvt_tpu's, saved as a port checkpoint): the same FVD_stub,
  and the same FVD through an I3D .npz, each within 1e-5 of the scale that
  FVD is a difference of (the covariances' traces plus the squared mean
  gap), the features' own bound.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lvt_tpu.evaluation.fvd as jfvd
import lvt_tpu_torch.evaluation.fvd as tfvd
from lvt_tpu.config import get_cfg as jax_get_cfg
from lvt_tpu.evaluation import vt_sampler as jvs
from lvt_tpu.evaluation.i3d import i3d_apply as jax_i3d_apply
from lvt_tpu.evaluation.i3d import init_i3d as jax_init_i3d
from lvt_tpu_torch.checkpoint import from_jax_i3d, from_jax_vqvae, save_checkpoint
from lvt_tpu_torch.config import get_cfg
from lvt_tpu_torch.evaluation.i3d import i3d_apply, init_i3d, load_i3d_npz, same_pad

torch.set_num_threads(1)  # one intra-op thread: the test workers share the cores

VQ_CFG = """\
MODEL:
  META_ARCHITECTURE: "VQVAEModel"
  INIT_TYPE: "xavier_uniform"
  PIXEL_MEAN: [0.5, 0.5, 0.5]
  PIXEL_STD: [0.5, 0.5, 0.5]
  ENCODER:
    NAME: "ResEncoder"
    IN_CHANNELS: 3
    NF: 8
    RES_CHANNELS: 4
    N_LAYERS: 1
  GENERATOR:
    NAME: "ResDecoder"
    IN_CHANNELS: 8
    NF: 8
    RES_CHANNELS: 4
    N_LAYERS: 1
    OUT_CHANNELS: 3
    OUT_ACTIVATION: "tanh"
  CODEBOOK:
    NUM: 2
    SIZE: 8
    DIM: 8
    EMA: True
INPUT:
  FORMAT: "RGB"
"""


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err, top = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= rel * top, (err, top)


# --------------------------------------------------------------------------
# Fréchet math
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["random", "identical", "diagonal", "d1"])
def test_frechet_functions_equal_lvt_tpu(case):
    rng = np.random.default_rng(0)
    d = 1 if case == "d1" else 12
    real = rng.normal(size=(40, d))
    fake = real.copy() if case == "identical" else rng.normal(0.5, 1.3, size=(50, d))
    if case == "diagonal":
        mu1, mu2 = rng.normal(size=d), rng.normal(size=d)
        s1, s2 = np.diag(rng.uniform(0.5, 2, d)), np.diag(rng.uniform(0.5, 2, d))
        assert tfvd.frechet_distance(mu1, s1, mu2, s2) == jfvd.frechet_distance(mu1, s1, mu2, s2)
    for a, b in zip(tfvd.gaussian_stats(real), jfvd.gaussian_stats(real)):
        assert a.shape == b.shape and np.array_equal(a, b)
    got, want = tfvd.fvd_from_features(real, fake), jfvd.fvd_from_features(real, fake)
    assert got == want
    if case == "identical":
        assert abs(got) < 1e-8


# --------------------------------------------------------------------------
# Feature networks
# --------------------------------------------------------------------------

def test_stub_weights_are_lvt_tpus_draws():
    k1, k2 = jax.random.split(jax.random.key(0))
    with np.load(tfvd.STUB_WEIGHTS) as f:
        assert sorted(f.files) == ["w1", "w2"]
        for name, key, shape in (("w1", k1, (3, 5, 5, 3, 16)), ("w2", k2, (3, 3, 3, 16, 64))):
            want = np.asarray(jax.random.normal(key, shape) * 0.1)
            assert f[name].dtype == np.float32 and np.array_equal(f[name], want), name


@pytest.mark.parametrize("shape", [(2, 16, 64, 64, 3), (1, 5, 17, 23, 3)])
def test_stub_features_equal_lvt_tpu(shape):
    video = np.random.default_rng(1).uniform(0, 255, shape)
    want = np.asarray(jfvd.make_stub_features()(video))
    got = tfvd.make_stub_features("cpu")(video)
    assert got.shape == want.shape == (shape[0], 64) and got.dtype == np.float32
    _close(got, want, 1e-5)


@pytest.mark.parametrize("size", [224, 40, 17])
def test_resize_matches_jax_image_resize(size):
    x = np.random.default_rng(2).random((2, 3, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 3, size, size, 3), "bilinear"))
    got = tfvd.resize_frames(torch.from_numpy(x), size).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("n,k,s", [(64, 7, 2), (33, 3, 2), (16, 2, 2), (9, 3, 1), (4, 1, 1)])
def test_same_pad_matches_tensorflow_same(n, k, s):
    """Output length ceil(n / s), the odd pad row at the end, -inf for pools:
    a max pool over the padded input equals lax.reduce_window "SAME"."""
    x = np.random.default_rng(3).normal(size=(1, 2, n, n, n)).astype(np.float32)
    want = jax.lax.reduce_window(jnp.asarray(x), -jnp.inf, jax.lax.max, (1, 1, k, k, k),
                                 (1, 1, s, s, s), "SAME")
    got = torch.nn.functional.max_pool3d(same_pad(torch.from_numpy(x), (k,) * 3, (s,) * 3,
                                                  -float("inf")), k, s)
    assert got.shape[2] == -(-n // s)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def i3d(tmp_path_factory):
    params = jax.jit(jax_init_i3d)(jax.random.key(0))
    path = str(tmp_path_factory.mktemp("i3d") / "i3d.npz")
    np.savez(path, **_flat(params))
    return params, path


def test_i3d_apply_matches_lvt_tpu(i3d):
    params, _ = i3d
    v = np.random.default_rng(0).uniform(-1, 1, (1, 16, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jax_i3d_apply)(params, v))
    tp = from_jax_i3d(_np(params))
    assert tp["Conv3d_1a_7x7"]["w"].shape == (64, 3, 7, 7, 7)
    assert tp["Logits"]["w"].shape == (400, 1024, 1, 1, 1)
    with torch.no_grad():
        got = i3d_apply(tp, torch.from_numpy(v)).numpy()
    assert got.shape == (1, 400) and np.all(np.isfinite(got))
    _close(got, want, 1e-5)


def test_i3d_npz_round_trip(i3d):
    """lvt_tpu's .npz read by the port: every leaf the converted tree's, in
    the layout of the port's own init_i3d."""
    params, path = i3d
    loaded = load_i3d_npz(path)
    want = _flat(from_jax_i3d(_np(params)))
    got = _flat(loaded)
    assert sorted(got) == sorted(want) == sorted(_flat(init_i3d(torch.Generator())))
    shapes = {k: v.shape for k, v in _flat(init_i3d(torch.Generator().manual_seed(1))).items()}
    for k, w in want.items():
        assert got[k].shape == shapes[k] and np.array_equal(got[k], w), k


# --------------------------------------------------------------------------
# The evaluator
# --------------------------------------------------------------------------

def _evaluators(tmp_path, i3d_path=None, resize=32):
    """FVDEvaluator of each package on lvt_tpu's VQ-VAE weights (key 0), the
    port's read from a checkpoint of them."""
    vq = tmp_path / "vq.yaml"
    vq.write_text(VQ_CFG)
    jcfg, tcfg = jax_get_cfg(), get_cfg()
    for cfg in (jcfg, tcfg):
        cfg.TEST.VT_SAMPLER.VQ_VAE.CFG = str(vq)
        cfg.TEST.FVD.I3D_WEIGHTS = i3d_path or ""
        cfg.TEST.FVD.RESIZE = resize
    jvs._PAIRED_VQVAE_CACHE.clear()
    _, jp, js, _ = jvs.load_paired_vqvae(jcfg)
    tp, ts = from_jax_vqvae(_np(jp), _np(js))
    ckpt = str(tmp_path / "vq_ckpt")
    save_checkpoint(ckpt, 0, {"params": tp, "model_state": ts})
    tcfg.TEST.VT_SAMPLER.VQ_VAE.CODEBOOK_WEIGHTS = ckpt
    return (jfvd.FVDEvaluator(jcfg, "toy", distributed=True),
            tfvd.FVDEvaluator(tcfg, "toy", distributed=True, device="cpu"))


def _fvd_close(got, want, ev, rel):
    """|got - want| within ``rel`` of the scale FVD is a difference of: the
    traces of the two covariances and the squared mean gap."""
    (mr, sr), (mf, sf) = (tfvd.gaussian_stats(np.stack(x)) for x in (ev._real, ev._fake))
    scale = np.trace(sr) + np.trace(sf) + float((mr - mf) @ (mr - mf))
    assert np.isfinite(got) and abs(got - want) <= rel * scale, (got, want, scale)


def _batch(n, seed, nc=2, T=4, h=4, w=4):
    r = np.random.default_rng(seed)
    inputs = [{"video": r.integers(0, 8, (nc, T, h, w)), "video_idx": i} for i in range(n)]
    outputs = [{"samples": [r.integers(0, 8, (nc, T, h, w)) for _ in range(2)]}
               for _ in range(n)]
    return inputs, outputs


def test_fvd_evaluator_stub_equals_lvt_tpu(tmp_path):
    jev, tev = _evaluators(tmp_path)
    assert jev._metric == tev._metric == "FVD_stub"
    values = []
    for ev in (jev, tev):
        ev.process(*_batch(3, 1))
        ev.process(*_batch(3, 2))
        values.append(ev.evaluate()["generation"]["FVD_stub"])
    want, got = values
    assert got >= 0
    _fvd_close(got, want, tev, 1e-5)
    # identical real and fake codes: (near) zero; too few videos: nan
    tev.reset()
    inputs, _ = _batch(4, 3)
    tev.process(inputs, [{"samples": [inp["video"].copy()]} for inp in inputs])
    assert abs(tev.evaluate()["generation"]["FVD_stub"]) < 1e-6
    tev.reset()
    tev.process(*_batch(1, 4))
    assert np.isnan(tev.evaluate()["generation"]["FVD_stub"])


def test_fvd_evaluator_i3d_equals_lvt_tpu(tmp_path, i3d):
    jev, tev = _evaluators(tmp_path, i3d[1])
    assert jev._metric == tev._metric == "FVD"
    values = []
    for ev in (jev, tev):
        ev.process(*_batch(3, 5))
        values.append(ev.evaluate()["generation"]["FVD"])
    want, got = values
    _fvd_close(got, want, tev, 1e-5)
