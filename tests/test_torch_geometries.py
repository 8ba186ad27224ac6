"""The three subscale geometries (frame-wise DSFVT, spatial DSSVT,
spatio-temporal DSTSVT; tiny widths, the cases of tests/test_torch_vt.py)
through the port's measurement paths, held to lvt_tpu:

* ``logits_for_entire_video_incremental`` (the KV-cached decoder,
  teacher-forced, every slice at once) with a native cache within 2e-4 of
  lvt_tpu's and of the port's own ``logits_for_entire_video``; with an int8
  cache finite and within lvt_tpu's own bound (0.25 max|ref| + 1e-3,
  tests/test_vt_incremental.py); with an int4 cache equal to lvt_tpu's int4
  logits within 2e-4 (half the gap to native at a rounding near-tie);
* tools/bench_sample_torch.py's ``run`` on the CPU: the reference tool's
  JSON keys, greedy codes equal to ``sample_video``'s, also with --streams 2
  and with --kv int4;
* tools/bench_train_torch.py's ``measure`` and ``run`` on the CPU, narrowed:
  the reference tool's keys.

Each model is built once per file.
"""

import ast
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_vt import CASES, IDS, _cfg, _models

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import bench_sample_torch  # noqa: E402
import bench_train_torch  # noqa: E402

torch.set_num_threads(1)  # one intra-op thread: the test workers share the cores

GEOMETRIES = {name: CASES[IDS.index(name)] for name in ("dsfvt", "dssvt", "dstsvt")}
_BUILT = {}


def _built(name):
    """(lvt_tpu's model, its params, the port's model, its params, a video of
    2 rows (numpy), lvt_tpu's logits_for_entire_video of it), once per file."""
    if name not in _BUILT:
        jm, jp, tm, tp = _models(GEOMETRIES[name], seed=3)
        video = np.random.default_rng(5).integers(
            0, jm.c.nv, size=(2, jm.c.nc, *GEOMETRIES[name][3])).astype(np.int64)
        ref = np.asarray(jm.logits_for_entire_video(jp, jnp.asarray(video, jnp.int32)))
        _BUILT[name] = (jm, jp, tm, tp, video, ref)
    return _BUILT[name]


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_incremental_logits_match_lvt_tpu_and_the_teacher_forced_path(name):
    jm, jp, tm, tp, video, ref = _built(name)
    got = tm.logits_for_entire_video_incremental(tp, torch.from_numpy(video))
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    # jitted: one compile instead of lvt_tpu's op-by-op slice loop (~4x faster here)
    want = np.asarray(jax.jit(jm.logits_for_entire_video_incremental)(
        jp, jnp.asarray(video, jnp.int32)))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-4)
    own = tm.logits_for_entire_video(tp, torch.from_numpy(video))
    np.testing.assert_allclose(got.numpy(), own.numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_incremental_logits_int8_cache_within_lvt_tpu_bound(name):
    _, _, tm, tp, video, ref = _built(name)
    q = tm.logits_for_entire_video_incremental(tp, torch.from_numpy(video),
                                               kv_cache_dtype="int8", kv_seg_size=16).numpy()
    assert np.isfinite(q).all()
    assert np.abs(q - ref).max() < 0.25 * np.abs(ref).max() + 1e-3


def test_incremental_logits_int4_refused(monkeypatch):
    """The int4 cache through the cached teacher pass: finite, within
    lvt_tpu's own bound of the teacher-forced logits, and equal to lvt_tpu's
    int4 logits within 2e-4 (measured 9.5e-7), or within half the int4
    cache's own gap to them where one of the port's roundings came within
    TIE_MARGIN of x.5 (tests/test_torch_sampler_int8.py)."""
    from test_torch_sampler_int8 import TIE_MARGIN, _TieMargin

    jm, jp, tm, tp, video, ref = _built("dssvt")
    ties = _TieMargin(monkeypatch)
    q = tm.logits_for_entire_video_incremental(tp, torch.from_numpy(video),
                                               kv_cache_dtype="int4").numpy()
    want = np.asarray(jax.jit(lambda p, v: jm.logits_for_entire_video_incremental(
        p, v, kv_cache_dtype="int4"))(jp, jnp.asarray(video, jnp.int32)))
    assert np.isfinite(q).all()
    gap = float(np.abs(q - ref).max())
    assert gap < 0.25 * np.abs(ref).max() + 1e-3
    err = float(np.abs(q - want).max())
    assert err <= (2e-4 if ties.margin >= TIE_MARGIN else 0.5 * gap), (err, gap, ties.margin)


def test_incremental_logits_class_conditional_rows():
    """With CLASS_NUM each video's rows carry its own class in every slice:
    the incremental logits equal logits_for_entire_video's per class."""
    stride, kernel, blocks, THW = GEOMETRIES["dstsvt"]
    cfg = _cfg(stride, kernel, blocks)
    cfg.MODEL.AUTOREGRESSIVE.VT.CLASS_NUM = 3
    from lvt_tpu_torch.models.vt import VideoTransformer

    m = VideoTransformer(cfg, T=THW[0], H=THW[1], W=THW[2])
    params, _ = m.init(torch.Generator().manual_seed(0))
    video = torch.from_numpy(np.random.default_rng(1).integers(0, m.c.nv,
                                                               size=(2, m.c.nc, *THW)))
    cls = torch.tensor([2, 0])
    got = m.logits_for_entire_video_incremental(params, video, cls)
    want = m.logits_for_entire_video(params, video, cls)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    other = m.logits_for_entire_video_incremental(params, video, torch.tensor([1, 0]))
    assert not torch.allclose(other[0], got[0]) and torch.allclose(other[1], got[1])


# --------------------------------------------------------------------------
# tools/bench_sample_torch.py
# --------------------------------------------------------------------------

def _reference_keys(rel):
    """The JSON keys of a reference tool, read from its source: the keys of
    the dict literal it passes to json.dumps, and the string keys it assigns
    into ``results``."""
    with open(os.path.join(ROOT, rel)) as f:
        tree = ast.parse(f.read())
    keys = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "dumps" and isinstance(node.args[0], ast.Dict)):
            keys |= {k.value for k in node.args[0].keys}
        if (isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Store)
                and isinstance(node.value, ast.Name) and node.value.id == "results"):
            keys.add(node.slice.value)
    assert keys, rel
    return keys


def _bench_args(*argv):
    return bench_sample_torch.parse_args(["--config", "configs/vt/DSSVT.yaml", "--batch", "2",
                                          "--iters", "1", *argv])


@pytest.fixture
def tiny_video(monkeypatch):
    """The tool's latent video at the dssvt case's 4 x 4 x 4."""
    monkeypatch.setattr(bench_sample_torch, "THW", GEOMETRIES["dssvt"][3])


def _tiny_cfg():
    """DSSVT's file with the geometry of the dssvt case: stride (1, 2, 2),
    slices of 4 x 2 x 2 in blocks of (2, 2, 2), d = 32."""
    stride, kernel, blocks, _ = GEOMETRIES["dssvt"]
    cfg = bench_sample_torch.load_cfg(_bench_args())
    ref = _cfg(stride, kernel, blocks)
    cfg.MODEL.AUTOREGRESSIVE.VT = ref.MODEL.AUTOREGRESSIVE.VT
    cfg.TEST.VT_SAMPLER.N_PRIME = 2
    return cfg


def test_bench_sample_keys_and_greedy_codes(tiny_video):
    cfg = _tiny_cfg()
    args = _bench_args("--greedy", "--dtype", "float32")
    res, _, _, video, out = bench_sample_torch.run(cfg, args, torch.device("cpu"))
    assert _reference_keys("tools/bench_sample.py") <= set(res)
    assert {"capture_seconds", "peak_memory_gb", "device"} <= set(res)
    assert res["config"] == "DSSVT.yaml" and res["n_prime"] == 2 and res["batch"] == 2
    assert res["frames_per_sec_per_chip"] > 0 and res["device"] == "cpu"
    # the same rollout through sample_video's eager loop, from the tool's seeds
    from lvt_tpu_torch.models.vt import VideoTransformer

    m = VideoTransformer(cfg, T=4, H=4, W=4)
    params, _ = m.init(torch.Generator().manual_seed(0))
    want = m.sample_video(params, video, None, n_prime=2, greedy=True, _eager=True)
    assert torch.equal(out, want)
    assert torch.equal(out[:, :, :2], video[:, :, :2])  # primed frames kept
    assert not torch.equal(out, video)


@pytest.mark.parametrize("argv,knobs", [
    (("--streams", "2"), dict(streams=2)), (("--kv", "int4"), dict(kv_cache_dtype="int4"))],
    ids=["argv0-NotImplementedError", "argv1-NotImplementedError"])  # the ids as they stood
def test_bench_sample_refusals(tiny_video, argv, knobs):
    """--streams 2 and --kv int4 run: the tool's codes equal ``sample_video``'s
    in the mode from the tool's seeds, and the JSON line names the mode."""
    cfg = _tiny_cfg()
    res, _, params, video, out = bench_sample_torch.run(
        cfg, _bench_args("--greedy", "--dtype", "float32", *argv), torch.device("cpu"))
    assert (res["streams"], res["kv"]) == (knobs.get("streams", 1),
                                           knobs.get("kv_cache_dtype", "native"))
    from lvt_tpu_torch.models.vt import VideoTransformer

    m = VideoTransformer(cfg, T=4, H=4, W=4)
    want = m.sample_video(params, video, None, n_prime=2, greedy=True, **knobs)
    assert torch.equal(out, want) and torch.equal(out[:, :, :2], video[:, :, :2])


def test_bench_tools_cli_need_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for tool in (bench_sample_torch, bench_train_torch):
        with pytest.raises(SystemExit, match="CUDA"):
            tool.main(["--steps" if tool is bench_train_torch else "--iters", "1"])


# --------------------------------------------------------------------------
# tools/bench_train_torch.py
# --------------------------------------------------------------------------

VQ_OPTS = ["MODEL.ENCODER.NF", "8", "MODEL.ENCODER.RES_CHANNELS", "4",
           "MODEL.ENCODER.N_LAYERS", "1", "MODEL.ENCODER.OUT_CHANNELS", "8",
           "MODEL.GENERATOR.NF", "8", "MODEL.GENERATOR.RES_CHANNELS", "4",
           "MODEL.GENERATOR.N_LAYERS", "1", "MODEL.GENERATOR.IN_CHANNELS", "8",
           "MODEL.CODEBOOK.NUM", "2", "MODEL.CODEBOOK.SIZE", "8", "MODEL.CODEBOOK.DIM", "8"]
_VT = "MODEL.AUTOREGRESSIVE.VT."
VT_OPTS = [_VT + "NC", "2", _VT + "NV", "8", _VT + "D", "16", _VT + "DA", "8", _VT + "DE", "8",
           _VT + "BLOCKS_E", "((1,16,16),)", _VT + "N_HEAD_E", "(2,)",
           _VT + "BLOCKS_D", "((1,16,16),)", _VT + "N_HEAD_D", "(2,)"]


def test_bench_train_keys():
    res = bench_train_torch.run(1, torch.device("cpu"), VQ_OPTS, VT_OPTS)
    want = _reference_keys("tools/bench_train.py")
    assert len(want) == 4 and want <= set(res) and res["device"] == "cpu"
    assert all(res[k] > 0 for k in want)


def test_bench_train_measure_steps_the_trainer():
    """``measure`` runs 3 + steps train steps on one batch, and the params
    move."""
    from lvt_tpu_torch.config import get_cfg
    from lvt_tpu_torch.engine.trainer import Trainer

    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(ROOT, "configs", "vt", "DSFVT.yaml"))
    cfg.merge_from_list(VT_OPTS)
    video = np.random.default_rng(0).integers(0, 8, size=(4, 2, 16, 16, 16)).astype(np.int32)
    tr = Trainer(cfg, [{"video": video}], device="cpu")
    before = tr.state.params["netG"]["decoder"]["projector"].detach().clone()
    s = bench_train_torch.measure(tr, 2)
    assert s > 0 and tr.state.step == 5
    assert not torch.equal(before, tr.state.params["netG"]["decoder"]["projector"])
