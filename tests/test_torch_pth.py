"""Reference ``.pth`` state dicts into the port
(lvt_tpu_torch/checkpoint/torch_convert.py, evaluation/vt_sampler.py)
against lvt_tpu's converter (lvt_tpu/checkpoint/torch_convert.py) on the same
state dicts, written from a numpy seed in the reference key layout:
every converted leaf bit-equal to lvt_tpu's (carried across by
``from_jax_*``), architecture mismatches raising the same error class, and
greedy codes generated from ``.pth`` files equal to lvt_tpu's."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvt_tpu.checkpoint import torch_convert as jtc
from lvt_tpu.config import get_cfg as jax_get_cfg
from lvt_tpu.evaluation import vt_sampler as jvs
from lvt_tpu.models.vqvae import VQVAE as JaxVQVAE
from lvt_tpu.models.vt import VideoTransformer as JaxVT
from lvt_tpu_torch.checkpoint import flatten, from_jax_vqvae, from_jax_vt
from lvt_tpu_torch.checkpoint import torch_convert as ttc
from lvt_tpu_torch.config import get_cfg
from lvt_tpu_torch.evaluation.vt_sampler import (load_paired_vqvae, load_vqvae_weights,
                                                  load_vt_weights)
from lvt_tpu_torch.models.vqvae import VQVAE
from lvt_tpu_torch.models.vt import VTConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import generate_videos_torch as gvt  # noqa: E402

from test_torch_generate import N_PRIME, T, VT_CFG, VT_OPTS, _argv, _frames, _vq_yaml  # noqa: E402
from test_torch_vt import assert_greedy_codes_match  # noqa: E402
from test_vt_torch_parity import _make_torch_state  # noqa: E402

torch.set_num_threads(1)  # one intra-op thread: the test workers share the cores

VQ_CFG = os.path.join(ROOT, "configs", "vqvae", "PR-DVQVAE2.yaml")
_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)


def _assert_trees_equal(got, want):
    got, want = flatten(got), flatten(want)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def _cfgs(path, opts=()):
    """The same configuration read by both packages."""
    tc, jc = get_cfg(), jax_get_cfg()
    for c in (tc, jc):
        c.merge_from_file(path)
        c.merge_from_list(list(opts))
    return tc, jc


# --------------------------------------------------------------------------
# state dicts in the reference key layout
# --------------------------------------------------------------------------

def _seqnet_state(rng, spec, norm, prefix="layers"):
    """A torch Sequential's state dict for a conv-net spec, in module order:
    a conv ``<prefix>.<i>.weight`` (out, in, k, k) with a bias unless a norm
    follows (the reference's norm_layer wrapper drops it), a transposed conv
    (in, out, k, k), a residual block ``<prefix>.<i>.block.<j>`` (ReLU, conv
    3x3, [norm,] ReLU, conv 1x1[, norm]), a norm's affine weights and, for
    the batch norms, its running statistics."""
    r = lambda *s: (0.1 * rng.standard_normal(s)).astype(np.float32)
    sd, ch = {}, None

    def put_norm(key, n):
        sd[f"{key}.weight"], sd[f"{key}.bias"] = 1 + r(n), r(n)
        if norm in ("BN", "SyncBN", "nnSyncBN", "FrozenBN"):
            sd[f"{key}.running_mean"] = r(n)
            sd[f"{key}.running_var"] = 1 + np.abs(r(n))
            sd[f"{key}.num_batches_tracked"] = np.array(7, np.int64)

    for i, layer in enumerate(spec):
        kind, key = layer[0], f"{prefix}.{i}"
        followed = i + 1 < len(spec) and spec[i + 1][0] == "norm"
        if kind in ("conv", "convT"):
            _, cin, cout, k = layer[:4]
            sd[f"{key}.weight"] = r(cout, cin, k, k) if kind == "conv" else r(cin, cout, k, k)
            if not followed:
                sd[f"{key}.bias"] = r(cout)
            ch = cout
        elif kind == "resblock":
            _, dim, res = layer
            if norm == "":
                sd[f"{key}.block.1.weight"], sd[f"{key}.block.1.bias"] = r(res, dim, 3, 3), r(res)
                sd[f"{key}.block.3.weight"], sd[f"{key}.block.3.bias"] = r(dim, res, 1, 1), r(dim)
            else:
                sd[f"{key}.block.1.weight"] = r(res, dim, 3, 3)
                put_norm(f"{key}.block.2", res)
                sd[f"{key}.block.4.weight"] = r(dim, res, 1, 1)
                put_norm(f"{key}.block.5", dim)
            ch = dim
        elif kind == "norm" and norm not in ("", "IN", "StdN", "StdNV2"):
            put_norm(key, ch)
    return sd


def _codebook_state(rng, num, K, dc, running=True, single=False):
    """DVQEmbedding's state dict (``ve.<i>.*``), or VQEmbedding's
    (``embedding.weight``) with ``single``; with or without the EMA's
    running statistics."""
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    if single:
        sd = {"embedding.weight": r(K, dc)}
        if running:
            sd["running_size"], sd["running_sum"] = np.abs(r(K)), r(K, dc)
        return sd
    sd = {}
    for i in range(num):
        sd[f"ve.{i}.embedding.weight"] = r(K, dc)
        if running:
            sd[f"ve.{i}.running_size"], sd[f"ve.{i}.running_sum"] = np.abs(r(K)), r(K, dc)
    return sd


def _save(path, sd):
    """A .pth file as fvcore's Checkpointer writes it: {"model": state_dict}."""
    torch.save({"model": {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
                "iteration": 100}, path)
    return str(path)


def _vt_state(rng, c, module=False):
    sd = _make_torch_state(rng, c, c.stride[0] * c.stride[1] * c.stride[2])
    if c.class_num > 0:
        sd["encoder.class_embedding.weight"] = rng.standard_normal(
            (c.class_num, c.de)).astype(np.float32)
        sd["encoder.linear_projector.weight"] = rng.standard_normal(
            (c.d, 2 * c.de, 1, 1, 1)).astype(np.float32)
    if c.share_p:
        for k in range(c.nc):
            del sd[f"ch_predictor.P.{k}.weight"], sd[f"ch_predictor.P.{k}.bias"]
        sd["ch_predictor.P.weight"] = rng.standard_normal((c.nv, c.d)).astype(np.float32)
        sd["ch_predictor.P.bias"] = rng.standard_normal((c.nv,)).astype(np.float32)
    return {f"module.{k}" if module else k: v for k, v in sd.items()}


# --------------------------------------------------------------------------
# the converters, leaf for leaf
# --------------------------------------------------------------------------

VT_CASES = {  # DSFVT at full width as configs/vt/DSFVT.yaml stands, and a narrow one
    "dsfvt": [],   # with a shared P and class conditioning
    "dsfvt_module": [],
    "shared_p_class": ["MODEL.AUTOREGRESSIVE.VT.SHARE_P", "True",
                       "MODEL.AUTOREGRESSIVE.VT.CLASS_NUM", "3"] + VT_OPTS,
}


@pytest.mark.parametrize("case", list(VT_CASES))
def test_video_transformer_pth_converts_as_lvt_tpu(case):
    """convert_video_transformer: the port's tree equals lvt_tpu's carried
    across by from_jax_vt, every leaf bit for bit and of the same dtype;
    ``module.`` prefixes stripped."""
    tc, jc = _cfgs(VT_CFG, VT_CASES[case])
    hw = 8 if VT_CASES[case] else 16  # DSFVT's own grid, or the narrow one's
    c, jm = VTConfig.from_cfg(tc), JaxVT(jc, T=tc.INPUT.N_FRAMES_PER_VIDEO_TEST, H=hw, W=hw)
    assert tuple(c) == tuple(jm.c)
    sd = _vt_state(np.random.default_rng(len(case)), jm.c, module=case == "dsfvt_module")
    want = from_jax_vt(_np(jtc.convert_video_transformer(sd, jm.c)))
    got = ttc.convert_video_transformer(sd, c)
    if case == "shared_p_class":
        assert got["encoder"]["class_embedding"].shape == (3, c.de)
        assert got["predictor"]["P_w"].shape == (c.d, c.nv)
    _assert_trees_equal(got, want)


VQ_NARROW = ["MODEL.ENCODER.NF", "32", "MODEL.ENCODER.RES_CHANNELS", "16",
             "MODEL.ENCODER.OUT_CHANNELS", "32", "MODEL.GENERATOR.NF", "32",
             "MODEL.GENERATOR.RES_CHANNELS", "16", "MODEL.GENERATOR.IN_CHANNELS", "32",
             "MODEL.CODEBOOK.DIM", "32", "MODEL.CODEBOOK.SIZE", "16"]


def _vq_opts(kind):
    """PR-DVQVAE2 as it stands (EMA), non-EMA, with batch norms (narrow), and
    with one codebook (NUM 1, narrow)."""
    return {"ema": [], "non_ema": ["MODEL.CODEBOOK.EMA", "False"],
            "bn": VQ_NARROW + ["MODEL.ENCODER.NORM", "BN", "MODEL.GENERATOR.NORM", "BN"],
            "num1": VQ_NARROW + ["MODEL.CODEBOOK.NUM", "1"]}[kind]


def _vq_files(tmp_path, tq, kind, seed):
    """netE, netG and netC .pth files of the VQ-VAE ``tq`` from a numpy seed."""
    rng = np.random.default_rng(seed)
    cb = tq.cfg.MODEL.CODEBOOK
    nets = {"netE": _seqnet_state(rng, tq.encoder.spec, tq.cfg.MODEL.ENCODER.NORM),
            "netG": _seqnet_state(rng, tq.generator.spec, tq.cfg.MODEL.GENERATOR.NORM),
            "netC": _codebook_state(rng, cb.NUM, cb.SIZE, cb.DIM // cb.NUM,
                                    running=kind != "non_ema", single=kind == "num1")}
    paths = {}
    for name, sd in nets.items():
        (tmp_path / name).mkdir(exist_ok=True)
        paths[name] = _save(tmp_path / name / "model_final.pth", sd)
    return paths


@pytest.mark.parametrize("kind", ["ema", "non_ema", "bn", "num1"])
def test_vqvae_pth_grafts_as_lvt_tpu(tmp_path, kind):
    """load_pretrained_vqvae: netE, netG and netC .pth files grafted onto a
    fresh VQ-VAE equal lvt_tpu's graft carried across by from_jax_vqvae, in
    params and state (batch norms' running statistics, the EMA codebook in
    the state or a non-EMA one's embedding in the params, the EMA defaults
    where the file has no running statistics); the sampler's loader places
    the same tree, or refuses one whose residual blocks lack their norms."""
    tc, jc = _cfgs(VQ_CFG, _vq_opts(kind))
    tq, jq = VQVAE(tc), JaxVQVAE(jc)
    paths = _vq_files(tmp_path, tq, kind, seed=5)
    kw = dict(encoder_path=paths["netE"], generator_path=paths["netG"],
              codebook_path=paths["netC"])
    jp, js = jtc.load_pretrained_vqvae(jq, *jq.init(jax.random.key(0)), **kw)
    want = from_jax_vqvae(_np(jp), _np(js))
    got = ttc.load_pretrained_vqvae(tq, *tq.init(torch.Generator().manual_seed(0)), **kw)
    _assert_trees_equal(got, want)
    if kind == "bn":
        assert "mean" in got[1]["netE"][1] and "mean" in got[1]["netG"][1]
    p0, s0 = tq.init(torch.Generator().manual_seed(1))
    load = lambda: load_vqvae_weights(tq, p0, s0, paths["netE"], paths["netG"], paths["netC"])
    if kind == "bn":
        # both converters take a residual block's two convolutions and no
        # norm of it (lvt_tpu/checkpoint/torch_convert.py:97-104): the
        # sampler's loader refuses the graft instead of running without them
        with pytest.raises(ValueError, match="missing \\['n1', 'n2'\\]"):
            load()
        return
    *placed, loaded = load()
    assert loaded
    _assert_trees_equal(tuple(placed), got)


def test_pth_grafts_on_top_of_a_port_checkpoint(tmp_path):
    """A port checkpoint named by one key loads first and a .pth named by
    another is grafted on top of it, as lvt_tpu's loader layers an orbax
    restore and .pth files: the encoder and generator are the checkpoint's,
    the codebook the netC file's."""
    from lvt_tpu_torch.checkpoint import save_checkpoint

    tc, _ = _cfgs(VQ_CFG, VQ_NARROW)
    tq = VQVAE(tc)
    saved = tq.init(torch.Generator().manual_seed(7))
    out = str(tmp_path / "vq_out")
    save_checkpoint(out, 3, {"params": saved[0], "model_state": saved[1]})
    netc = _save(tmp_path / "netC.pth", _codebook_state(np.random.default_rng(8), 4, 16, 8))
    params, state, loaded = load_vqvae_weights(tq, *tq.init(torch.Generator().manual_seed(9)),
                                               out, "", netc)
    assert loaded
    for net in ("netE", "netG"):
        _assert_trees_equal((params[net], state[net]), (saved[0][net], saved[1][net]))
    want = ttc.convert_codebook(ttc.load_torch_state_dict(netc), 4)
    _assert_trees_equal(state["netC"], want)
    assert not torch.equal(state["netC"]["embedding"], saved[1]["netC"]["embedding"])


def _mismatch_cases(rng):
    tc, jc = _cfgs(VQ_CFG, _vq_opts("bn"))
    spec = list(VQVAE(tc).encoder.spec)
    jspec = list(JaxVQVAE(jc).encoder.spec)
    full = _seqnet_state(rng, spec, "BN")
    short = {k: v for k, v in full.items() if not k.startswith(f"layers.{len(spec) - 3}.")}
    extra = dict(full, **{"layers.99.weight": np.zeros((4, 4, 1, 1), np.float32)})
    c_t, c_j = _cfgs(VT_CFG, VT_OPTS)
    vt_c, jvt_c = VTConfig.from_cfg(c_t), JaxVT(c_j, T=T, H=8, W=8).c
    vt_sd = _vt_state(rng, jvt_c)
    del vt_sd["decoder.block_local_attention.1.mha.w_q"]
    return {
        "seqnet_too_few": (lambda: ttc.convert_seqnet(short, spec),
                           lambda: jtc.convert_seqnet(short, jspec)),
        "seqnet_left_over": (lambda: ttc.convert_seqnet(extra, spec),
                             lambda: jtc.convert_seqnet(extra, jspec)),
        "vt_missing_key": (lambda: ttc.convert_video_transformer(vt_sd, vt_c),
                           lambda: jtc.convert_video_transformer(vt_sd, jvt_c)),
        "codebook_missing_entry": (lambda: ttc.convert_codebook(_codebook_state(rng, 2, 4, 3), 4),
                                   lambda: jtc.convert_codebook(_codebook_state(rng, 2, 4, 3), 4)),
    }


@pytest.mark.parametrize("case", ["seqnet_too_few", "seqnet_left_over", "vt_missing_key",
                                  "codebook_missing_entry"])
def test_mismatches_raise_what_lvt_tpu_raises(case):
    """An architecture mismatch raises the same error class in both packages
    (ValueError for a spec the layers do not fill or overfill, KeyError for
    a missing tensor), never a silent partial graft."""
    port, ref = _mismatch_cases(np.random.default_rng(9))[case]
    with pytest.raises(Exception) as want:
        ref()
    with pytest.raises(type(want.value)):
        port()


# --------------------------------------------------------------------------
# the generation path on .pth files
# --------------------------------------------------------------------------

def test_pth_files_generate_the_codes_lvt_tpu_generates(tmp_path):
    """netE, netG, netC and VT .pth files written from a seed: the
    generation script runs on them (CPU), and the port's loaders give the
    greedy codes and decoded frames that lvt_tpu's loaders (its
    load_paired_vqvae and convert_video_transformer) give on the same
    files, under the near-tie rule for codes."""
    vq_yaml = _vq_yaml(tmp_path, True)
    tc, jc = _cfgs(vq_yaml)
    paths = _vq_files(tmp_path, VQVAE(tc), "ema", seed=3)
    c_t, c_j = _cfgs(VT_CFG, VT_OPTS)
    jm = JaxVT(c_j, T=T, H=8, W=8)
    vt_path = _save(tmp_path / "vt.pth", _vt_state(np.random.default_rng(4), jm.c, module=True))
    opts = ["TEST.VT_SAMPLER.VQ_VAE.CFG", vq_yaml,
            "TEST.VT_SAMPLER.VQ_VAE.ENCODER_WEIGHTS", paths["netE"],
            "TEST.VT_SAMPLER.VQ_VAE.GENERATOR_WEIGHTS", paths["netG"],
            "TEST.VT_SAMPLER.VQ_VAE.CODEBOOK_WEIGHTS", paths["netC"],
            "MODEL.GENERATOR.WEIGHTS", vt_path]
    prime, out_dir = _frames(tmp_path), str(tmp_path / "out")
    video, codes, _, _ = gvt.main(_argv(prime, out_dir, vq_yaml, *opts[2:]), device="cpu")
    assert codes.shape == (1, 4, T, 8, 8) and int(codes.max()) < 16
    assert torch.isfinite(video).all() and os.path.exists(os.path.join(out_dir, f"{T - 1}.png"))

    # the port's loaders, greedy
    cfg_t, cfg_j = _cfgs(VT_CFG, VT_OPTS + opts)
    tq, tqp, tqs, _, loaded = load_paired_vqvae(cfg_t, torch.Generator(), "cpu")
    vt, vt_init = gvt.build_vt(cfg_t, torch.Generator(), "cpu", 8, 8)
    tvp = load_vt_weights(cfg_t, vt_init)
    frames = torch.from_numpy(gvt.load_priming_frames(prime, N_PRIME))[None]
    got_video, got_codes, primed, _ = gvt.generate(tq, tqp, tqs, vt, tvp, frames, N_PRIME, None,
                                                   greedy=True)

    # lvt_tpu's loaders on the same files, the pipeline of scripts/generate_videos.py
    jq, jqp, jqs, _ = jvs.load_paired_vqvae(cfg_j)
    jvp = {"netG": jtc.convert_video_transformer(jtc.load_torch_state_dict(vt_path), jm.c)}
    x = jq.normalize(jnp.asarray(frames.numpy().reshape(-1, 32, 32, 3)) / 255.0)
    want_primed = jnp.transpose(jq.encode(jqp, jqs, x).reshape(1, N_PRIME, 8, 8, 4),
                                (0, 4, 1, 2, 3))
    np.testing.assert_array_equal(primed.numpy(), np.asarray(want_primed))
    video0 = jnp.zeros((1, 4, T, 8, 8), jnp.int32).at[:, :, :N_PRIME].set(want_primed)
    want = np.asarray(jm.sample_video(jvp, video0, jax.random.key(0), n_prime=N_PRIME,
                                      greedy=True))
    assert_greedy_codes_match(jm, jvp, got_codes.numpy(), want, N_PRIME)
    if np.array_equal(got_codes.numpy(), want):
        idx = jnp.transpose(jnp.asarray(want), (0, 2, 3, 4, 1)).reshape(-1, 8, 8, 4)
        want_video = jnp.clip(jq.denormalize(jq.decode(jqp, jqs, idx)) * 255.0, 0.0, 255.0)
        np.testing.assert_allclose(got_video[0].numpy(), np.asarray(want_video), atol=2e-3)
