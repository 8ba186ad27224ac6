"""The port's VTSampler and the samples half of build_vt_infer_fn held to
lvt_tpu's on the CPU, on the tiny geometries of tests/test_vt_sampler_eval.py
(paired VQ-VAE NF 16, K 16; VT d 32, 1 + 1 layers, nv 16), weights carried
across with from_jax_vqvae (the paired VQ-VAE, read by the port from a
checkpoint of lvt_tpu's weights) and from_jax_vt:

* VTSampler.process on the same codes: the same tree
  (samples/<dataset>/video_<s>_<v>/{codes.npy, <i>.png}), codes.npy equal,
  the PNGs equal but for one uint8 level where a decoded value sits within
  1e-4 of an integer (the float -> uint8 cast truncates, and the two
  packages' fp32 decoders differ in the last bits);
* run_test with VTSampler and sample_video patched to greedy=True on both
  sides: NUM_SAMPLES rollouts on the batch axis, the same codes;
* temperature sampling, which JAX's threefry and torch's Philox cannot draw
  alike, by distribution: 512 rollouts on the batch axis of one call, the
  first sampled pixel's first channel against the softmax of lvt_tpu's
  teacher-forced logits there, total variation <= 0.1 (sampling noise alone:
  E[TV] ~ 0.06 for 16 bins at n = 512), and the rollouts differ.
"""

import functools
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from lvt_tpu.config import get_cfg as jax_get_cfg
from lvt_tpu.data.datasets.latents import get_latent_video_paths as jax_latent_paths
from lvt_tpu.engine.defaults import run_test as jax_run_test
from lvt_tpu.evaluation import VTSampler as JaxVTSampler
from lvt_tpu.evaluation import vt_sampler as jvs
from lvt_tpu.models.vt import VideoTransformer as JaxVT
from lvt_tpu_torch.checkpoint import from_jax_vqvae, from_jax_vt, save_checkpoint
from lvt_tpu_torch.config import get_cfg
from lvt_tpu_torch.data.datasets.latents import get_latent_video_paths
from lvt_tpu_torch.engine.defaults import build_vt_infer_fn, run_test
from lvt_tpu_torch.evaluation import VTSampler
from lvt_tpu_torch.models.vt import VideoTransformer
from test_torch_evaluation import register
from test_vt_sampler_eval import TINY_VQ_YAML

torch.set_num_threads(1)  # one intra-op thread: the test workers share the cores


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfg(get, tmp, dataset, n_prime=2, num_samples=2):
    """tests/test_vt_sampler_eval.py's tiny VT and its paired VQ-VAE."""
    cfg = get()
    cfg.MODEL.META_ARCHITECTURE = "VideoTransformerModel"
    cfg.MODEL.AUTOREGRESSIVE.NAME = "VideoTransformer"
    v = cfg.MODEL.AUTOREGRESSIVE.VT
    v.NC, v.NV = 4, 16
    v.KERNEL, v.STRIDE = (3, 1, 1), (8, 1, 1)
    v.D, v.DA, v.DE = 32, 16, 16
    v.BLOCKS_E = ((1, 8, 8),) * 1
    v.N_HEAD_E = (2,)
    v.BLOCKS_D = ((1, 8, 8),) * 1
    v.N_HEAD_D = (2,)
    v.N_PRIME = 1
    v.SHARE_P = False
    cfg.INPUT.SCALE_TO_ZEROONE = False
    cfg.INPUT.N_FRAMES_PER_VIDEO_TEST = 8
    cfg.DATASETS.TEST = (dataset,)
    cfg.TEST.EVALUATORS = "VTSampler"
    cfg.TEST.VT_SAMPLER.VQ_VAE.CFG = str(tmp / "tiny_vq.yaml")
    cfg.TEST.VT_SAMPLER.N_PRIME = n_prime
    cfg.TEST.VT_SAMPLER.NUM_SAMPLES = num_samples
    cfg.DATALOADER.NUM_WORKERS = 0
    cfg.OUTPUT_DIR = str(tmp / ("jax_out" if get is jax_get_cfg else "port_out"))
    return cfg


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The tiny VQ-VAE yaml, lvt_tpu's paired VQ-VAE weights as a port
    checkpoint, two latent videos and both packages' VT weights."""
    tmp = tmp_path_factory.mktemp("vt_sampler_eval")
    (tmp / "tiny_vq.yaml").write_text(TINY_VQ_YAML)
    rng = np.random.default_rng(0)
    root = str(tmp / "lat")
    for v in range(2):
        d = os.path.join(root, f"video_{v}")
        os.makedirs(d)
        for t in range(8):
            np.save(os.path.join(d, f"{t}.npy"), rng.integers(0, 16, (4, 8, 8)).astype(np.int64))
    register("vt_sampler_eval_toy", lambda: jax_latent_paths(root, use_cache=False),
             lambda: get_latent_video_paths(root, use_cache=False))
    jcfg = _cfg(jax_get_cfg, tmp, "vt_sampler_eval_toy")
    jvs._PAIRED_VQVAE_CACHE.clear()
    _, jqp, jqs, _ = jvs.load_paired_vqvae(jcfg)
    tqp, tqs = from_jax_vqvae(_np(jqp), _np(jqs))
    save_checkpoint(str(tmp / "vq_ckpt"), 0, {"params": tqp, "model_state": tqs})
    jvt = JaxVT(jcfg, T=8, H=8, W=8)
    jparams, _ = jvt.init(jax.random.key(0))
    return tmp, jparams, {"netG": from_jax_vt(_np(jparams["netG"]))}


def _port_cfg(tmp, **kw):
    cfg = _cfg(get_cfg, tmp, "vt_sampler_eval_toy", **kw)
    cfg.TEST.VT_SAMPLER.VQ_VAE.CODEBOOK_WEIGHTS = str(tmp / "vq_ckpt")
    return cfg


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def assert_same_samples(jroot, troot, decoded=None):
    """Same files; codes.npy equal; PNGs equal but for one level at a
    truncation tie of the decoded floats (``decoded``: rel path -> lvt_tpu's
    float frame, where known)."""
    files = _tree(troot)
    assert files == _tree(jroot) and files
    for rel in files:
        a = np.load(os.path.join(jroot, rel)) if rel.endswith(".npy") else \
            np.asarray(Image.open(os.path.join(jroot, rel)), np.int16)
        b = np.load(os.path.join(troot, rel)) if rel.endswith(".npy") else \
            np.asarray(Image.open(os.path.join(troot, rel)), np.int16)
        assert a.shape == b.shape, rel
        if rel.endswith(".npy"):
            assert a.dtype == b.dtype and np.array_equal(a, b), rel
            continue
        diff = np.argwhere(a != b)
        assert np.abs(a - b).max(initial=0) <= 1, rel
        assert len(diff) <= max(1, a.size // 1000), (rel, len(diff))
        if decoded is not None and len(diff):
            f = decoded[rel][tuple(diff.T)]
            assert np.all(np.abs(f - np.round(f)) <= 1e-4), (rel, f)


def test_vt_sampler_process_matches_lvt_tpu(setup):
    tmp, _, _ = setup
    jcfg = _cfg(jax_get_cfg, tmp, "vt_sampler_eval_toy")
    tcfg = _port_cfg(tmp)
    rng = np.random.default_rng(5)
    inputs = [{"video_idx": 3}, {"video_idx": 7}]
    outputs = [{"samples": [rng.integers(0, 16, (4, 8, 8, 8)).astype(np.int32)
                            for _ in range(2)]} for _ in inputs]
    jev = JaxVTSampler(jcfg, "toy", output_dir=str(tmp / "process_jax"))
    tev = VTSampler(tcfg, "toy", output_dir=str(tmp / "process_port"), device="cpu")
    decoded = {}  # lvt_tpu's float frames, by png path
    for inp, out in zip(inputs, outputs):
        for s, codes in enumerate(out["samples"]):
            frames = jev._decode_shared(np.transpose(codes, (1, 0, 2, 3)))
            for f, frame in enumerate(frames):
                decoded[os.path.join("samples", "toy", f"video_{s}_{inp['video_idx']}",
                                     f"{f}.png")] = np.asarray(frame)
    for ev in (jev, tev):
        ev.process(inputs[:1], outputs[:1])
        ev.process(inputs[1:], outputs[1:])
        assert ev.evaluate() == {"samples": {}}
    assert_same_samples(str(tmp / "process_jax"), str(tmp / "process_port"), decoded)
    png = np.asarray(Image.open(str(tmp / "process_port" / "samples" / "toy" / "video_1_3" /
                                    "7.png")))
    assert png.shape == (32, 32, 3) and png.dtype == np.uint8


def _greedy(cls, monkeypatch):
    monkeypatch.setattr(cls, "sample_video",
                        functools.partialmethod(cls.sample_video, greedy=True))


def test_greedy_samples_through_run_test_match_lvt_tpu(setup, monkeypatch):
    """The samples half of build_vt_infer_fn: 2 videos x NUM_SAMPLES 2 on the
    batch axis, greedy on both sides, the same codes and frames."""
    tmp, jparams, tparams = setup
    _greedy(JaxVT, monkeypatch)
    _greedy(VideoTransformer, monkeypatch)
    jcfg = _cfg(jax_get_cfg, tmp, "vt_sampler_eval_toy")
    tcfg = _port_cfg(tmp)
    assert jax_run_test(jcfg, JaxVT(jcfg, T=8, H=8, W=8), jparams, {}) == {"samples": {}}
    assert run_test(tcfg, VideoTransformer(tcfg, T=8, H=8, W=8), tparams, {}) == {"samples": {}}
    sub = os.path.join("inference", "samples", "vt_sampler_eval_toy")
    jroot, troot = os.path.join(jcfg.OUTPUT_DIR, sub), os.path.join(tcfg.OUTPUT_DIR, sub)
    assert_same_samples(jroot, troot)
    assert len(_tree(troot)) == 2 * 2 * (1 + 8)
    codes = np.load(os.path.join(troot, "video_1_0", "codes.npy"))
    video0 = np.stack([np.load(os.path.join(str(tmp / "lat"), "video_0", f"{t}.npy"))
                       for t in range(8)], axis=1)
    assert codes.shape == (4, 8, 8, 8) and np.array_equal(codes[:, :2], video0[:, :2])


def test_temperature_samples_by_distribution(setup):
    """512 temperature rollouts of video 0 on the batch axis (one
    sample_video call through build_vt_infer_fn, 7 frames primed): the
    first sampled pixel's channel 0 against softmax(lvt_tpu's logits)."""
    tmp, jparams, tparams = setup
    n = 512
    tcfg = _port_cfg(tmp, n_prime=7, num_samples=n)
    video = np.stack([np.load(os.path.join(str(tmp / "lat"), "video_0", f"{t}.npy"))
                      for t in range(8)], axis=1)[None].astype(np.int32)  # (1, 4, 8, 8, 8)
    vt = VideoTransformer(tcfg, T=8, H=8, W=8)
    infer = build_vt_infer_fn(tcfg, vt, tparams, gen=torch.Generator().manual_seed(0))
    samples = np.stack(infer({"video": video, "video_idx": [0]})[0]["samples"])
    assert samples.shape == (n, 4, 8, 8, 8) and samples.dtype == np.int32
    assert np.array_equal(samples[:, :, :7], np.broadcast_to(video[:, :, :7], (n, 4, 7, 8, 8)))
    assert len({s.tobytes() for s in samples}) > n // 2  # the rollouts differ

    jcfg = _cfg(jax_get_cfg, tmp, "vt_sampler_eval_toy")
    logits = np.asarray(JaxVT(jcfg, T=8, H=8, W=8).logits_for_entire_video(jparams, video),
                        np.float64)[0, 7, 0, 0, 0]  # channel 0 of pixel (7, 0, 0): primed context
    p = np.exp(logits - logits.max())
    p /= p.sum()
    freq = np.bincount(samples[:, 0, 7, 0, 0], minlength=16) / n
    tv = 0.5 * np.abs(freq - p).sum()
    assert tv <= 0.1, (tv, freq, p)
