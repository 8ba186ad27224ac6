"""The generation slice as a whole — VQ-VAE encode of the priming frames,
greedy KV-cached rollout, VQ-VAE decode — through the port's entry point
(scripts/generate_videos_torch.generate) against the same pipeline in
lvt_tpu, at a narrow width, weights carried across."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from lvt_tpu.config import get_cfg
from lvt_tpu.models.vqvae import VQVAE as JaxVQVAE
from lvt_tpu.models.vt import VideoTransformer as JaxVT
from lvt_tpu_torch.checkpoint import from_jax_vqvae, from_jax_vt
from lvt_tpu_torch.models.vqvae import VQVAE
from lvt_tpu_torch.models.vt import VideoTransformer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import generate_videos_torch as gvt  # noqa: E402

from test_torch_vt import assert_greedy_codes_match  # noqa: E402

torch.set_num_threads(1)  # one intra-op thread: the test workers share the cores

T_FRAMES, N_PRIME, B = 8, 3, 2


def _vq_cfg():
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(ROOT, "configs/vqvae/PR-DVQVAE2.yaml"))
    cfg.MODEL.ENCODER.NF = cfg.MODEL.GENERATOR.NF = 32
    cfg.MODEL.ENCODER.RES_CHANNELS = cfg.MODEL.GENERATOR.RES_CHANNELS = 16
    cfg.MODEL.CODEBOOK.DIM = cfg.MODEL.GENERATOR.IN_CHANNELS = 32
    cfg.MODEL.CODEBOOK.SIZE = 16
    return cfg


def _vt_cfg():
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(ROOT, "configs/vt/DSFVT.yaml"))
    v = cfg.MODEL.AUTOREGRESSIVE.VT
    v.NV, v.D, v.DA, v.DE = 16, 32, 16, 16
    v.STRIDE = (T_FRAMES, 1, 1)
    v.KERNEL = (3, 1, 1)
    v.BLOCKS_E = v.BLOCKS_D = ((1, 4, 4),) * 2
    v.N_HEAD_E = v.N_HEAD_D = (2, 2)
    return cfg


def test_encode_rollout_decode_matches_jax():
    vq_cfg, vt_cfg = _vq_cfg(), _vt_cfg()
    jq, jm = JaxVQVAE(vq_cfg), JaxVT(vt_cfg, T=T_FRAMES, H=4, W=4)
    jqp, jqs = jq.init(jax.random.key(1))
    jvp, _ = jm.init(jax.random.key(2))
    frames = np.random.default_rng(0).random((B, N_PRIME, 16, 16, 3)).astype(np.float32) * 255

    # lvt_tpu: the pipeline of scripts/generate_videos.py, greedy
    x = jq.normalize(jnp.asarray(frames.reshape(-1, 16, 16, 3)) / 255.0)
    primed = jnp.transpose(jq.encode(jqp, jqs, x).reshape(B, N_PRIME, 4, 4, 4),
                           (0, 4, 1, 2, 3))
    video = jnp.zeros((B, 4, T_FRAMES, 4, 4), jnp.int32).at[:, :, :N_PRIME].set(primed)
    want_codes = np.asarray(jm.sample_video(jvp, video, jax.random.key(0), n_prime=N_PRIME,
                                            greedy=True))
    idx = jnp.transpose(jnp.asarray(want_codes), (0, 2, 3, 4, 1)).reshape(-1, 4, 4, 4)
    # decoded as scripts/generate_videos.py does (PR-DVQVAE2 scales to [0, 1])
    want_video = np.asarray(jnp.clip(jq.denormalize(jq.decode(jqp, jqs, idx)) * 255.0,
                                     0.0, 255.0))

    # the port, weights carried across
    to_np = lambda t: jax.tree_util.tree_map(np.array, t)
    tqp, tqs = from_jax_vqvae(to_np(jqp), to_np(jqs))
    tvp = {"netG": from_jax_vt(to_np(jvp["netG"]))}
    tq = VQVAE(vq_cfg)
    got_video, got_codes, got_primed, _ = gvt.generate(
        tq, tqp, tqs, VideoTransformer(vt_cfg, T=T_FRAMES, H=4, W=4), tvp,
        torch.from_numpy(frames), N_PRIME, None, greedy=True)

    np.testing.assert_array_equal(got_primed.numpy(), np.asarray(primed))
    got_codes = got_codes.numpy()
    assert_greedy_codes_match(jm, jvp, got_codes, want_codes, N_PRIME)
    assert got_video.shape == (B, T_FRAMES, 16, 16, 3)
    want_video = want_video.reshape(got_video.shape)
    with torch.no_grad():  # the decode stage on lvt_tpu's codes, always
        y = tq.decode(tqp, tqs, torch.from_numpy(np.array(idx)))
    np.testing.assert_allclose(
        (tq.denormalize(y) * 255.0).clamp(0, 255).numpy().reshape(want_video.shape),
        want_video, atol=255 * 1e-4, rtol=0)
    if np.array_equal(got_codes, want_codes):
        np.testing.assert_allclose(got_video.numpy(), want_video, atol=255 * 1e-4, rtol=0)


def test_generate_reads_the_sampler_knobs_of_the_config():
    """TEST.VT_SAMPLER.KV_DTYPE, ATTN_IMPL and WEIGHT_DTYPE reach the sampler
    through generate(): with them set, the codes are sample_video's in that
    mode and differ from the native codes, so a run that ignored the keys
    would not pass for one that read them."""
    vq_cfg, vt_cfg = _vq_cfg(), _vt_cfg()
    q_cfg = _vt_cfg()
    q_cfg.TEST.VT_SAMPLER.KV_DTYPE = "int8"
    q_cfg.TEST.VT_SAMPLER.ATTN_IMPL = "pallas"
    q_cfg.TEST.VT_SAMPLER.WEIGHT_DTYPE = "int8-pallas"
    q_cfg.TEST.VT_SAMPLER.SEG = 4  # accepted and ignored
    gen = torch.Generator().manual_seed(0)
    tq = VQVAE(vq_cfg)
    tqp, tqs = tq.init(gen, "cpu")
    native_vt = VideoTransformer(vt_cfg, T=T_FRAMES, H=4, W=4)
    quant_vt = VideoTransformer(q_cfg, T=T_FRAMES, H=4, W=4)
    tvp, _ = native_vt.init(gen, "cpu")
    frames = torch.from_numpy(
        np.random.default_rng(0).random((B, N_PRIME, 16, 16, 3)).astype(np.float32) * 255)

    calls = []
    inner = quant_vt.sample_video
    quant_vt.sample_video = lambda *a, **k: calls.append(k) or inner(*a, **k)
    _, q_codes, primed, _ = gvt.generate(tq, tqp, tqs, quant_vt, tvp, frames, N_PRIME, None,
                                         greedy=True)
    assert {k: calls[0][k] for k in ("kv_cache_dtype", "attn_impl", "weight_dtype",
                                     "kv_seg_size")} == {
        "kv_cache_dtype": "int8", "attn_impl": "pallas", "weight_dtype": "int8-pallas",
        "kv_seg_size": 4}
    video = torch.zeros((B, 4, T_FRAMES, 4, 4), dtype=torch.int64)
    video[:, :, :N_PRIME] = primed
    want = native_vt.sample_video(tvp, video, n_prime=N_PRIME, greedy=True,
                                  kv_cache_dtype="int8", attn_impl="pallas",
                                  weight_dtype="int8-pallas")
    assert torch.equal(q_codes, want)
    _, n_codes, _, _ = gvt.generate(tq, tqp, tqs, native_vt, tvp, frames, N_PRIME, None,
                                    greedy=True)
    assert torch.equal(n_codes, native_vt.sample_video(tvp, video, n_prime=N_PRIME, greedy=True))
    assert not torch.equal(q_codes, n_codes)
