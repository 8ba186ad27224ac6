"""Multi-stream rollouts (``streams``) of the port's KV-cached sampler, held
to itself and to lvt_tpu on the tiny geometries of
tests/test_vt_incremental.py (fp32, weights carried across with
from_jax_vt), on the CPU, where the streams run in turn at each pixel:

* greedy ``sample_video`` codes at streams 2 and 4 bit-equal to one
  stream's, natively and with the int8 cache (``xla``, ``pallas``,
  ``pallas-live``), on the cases lvt_tpu's own streams test takes (dsfvt,
  dssvt, subblock);
* those codes against lvt_tpu's ``streams=2`` codes under the greedy parity
  bar of the mode: natively equal or first apart at a near-tie of lvt_tpu's
  logits (tests/test_torch_vt.py), with the int8 cache >= 98% equal
  (tests/test_torch_sampler_int8_greedy.py);
* teacher-forced logits at streams 2 bit-equal to one stream's, in batch
  order;
* a temperature rollout at streams 2: each block of rows equal to a
  one-stream rollout of those rows from its stream's generator, and the
  caller's generator advanced by the draw of the streams' seeds;
* the loop reads nothing back to the host, and the graph's key names the
  stream count;
* the refusals, each with lvt_tpu's error class.

The CUDA graph's branches run on the card only: tests/test_torch_kernels.py
holds them against the eager loop there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvt_tpu_torch.models import vt_incremental as tvti
from lvt_tpu_torch.models.rollout_graph import graph_key
from lvt_tpu_torch.models.vt import vt_encode
from lvt_tpu_torch.models.vt_incremental import STREAM_SEEDS, sample_slice_incremental

from test_torch_vt import CASES, IDS, _models, assert_greedy_codes_match

torch.set_num_threads(1)  # one intra-op thread: the test workers share the cores

MODES = {  # sample_video's knobs
    "native": {},
    "kv8": dict(kv_cache_dtype="int8"),
    "kv8-pallas": dict(kv_cache_dtype="int8", attn_impl="pallas"),
    "kv8-live": dict(kv_cache_dtype="int8", attn_impl="pallas-live"),
}
STREAM_CASES = ("dsfvt", "dssvt", "subblock")  # tests/test_vt_incremental.py's streams cases
# (case, mode) pairs held to lvt_tpu's streams=2 codes: lvt_tpu's own streams
# cases, and the kernel modes on the dsfvt case
JAX_PAIRS = [("dsfvt", "native"), ("dsfvt", "kv8"), ("dssvt", "kv8"), ("subblock", "native"),
             ("dsfvt", "kv8-pallas"), ("dsfvt", "kv8-live")]
_BUILT = {}


def _built(name):
    """(lvt_tpu's model, its params, the port's model, its params, a video
    of 4 rows (numpy int32)), once per file."""
    if name not in _BUILT:
        case = CASES[IDS.index(name)]
        jm, jp, tm, tp = _models(case)
        video = np.random.default_rng(7).integers(0, jm.c.nv,
                                                  size=(4, jm.c.nc, *case[3])).astype(np.int32)
        _BUILT[name] = (jm, jp, tm, tp, video)
    return _BUILT[name]


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", STREAM_CASES)
def test_greedy_streams_equal_one_stream(name, mode):
    _, _, tm, tp, video = _built(name)
    tv = torch.from_numpy(video)
    base = tm.sample_video(tp, tv, n_prime=1, greedy=True, **MODES[mode])
    assert not torch.equal(base, tv)  # something was sampled
    for streams in (2, 4):
        got = tm.sample_video(tp, tv, n_prime=1, greedy=True, streams=streams, **MODES[mode])
        assert torch.equal(got, base), streams


@pytest.mark.parametrize("name,mode", JAX_PAIRS, ids=[f"{n}-{m}" for n, m in JAX_PAIRS])
def test_greedy_streams_track_jax(name, mode):
    jm, jp, tm, tp, video = _built(name)
    want = np.asarray(jm.sample_video(jp, jnp.asarray(video), jax.random.key(5), n_prime=1,
                                      greedy=True, streams=2, **MODES[mode]))
    got = tm.sample_video(tp, torch.from_numpy(video), n_prime=1, greedy=True, streams=2,
                          **MODES[mode]).numpy()
    if mode == "native":
        assert_greedy_codes_match(jm, jp, got, want, 1)
    else:
        assert float((got == want).mean()) >= 0.98, float((got == want).mean())


def _slice(name, s=1):
    """(model, params, zl, slice codes, thw) of slice s of the video."""
    _, _, tm, tp, video = _built(name)
    sidx = torch.full((video.shape[0],), s, dtype=torch.int64)
    ctx, sl, _ = tm.prepare_slices(torch.from_numpy(video).long(), sidx)
    return tm, tp, vt_encode(tp["netG"], tm.c, ctx, sidx), sl, sl[0, 0].numel()


@pytest.mark.parametrize("kv", ["native", "int8", "int4"])
def test_teacher_logits_streams_equal_one_stream(kv):
    tm, tp, zl, sl, n = _slice("dsfvt")
    out = {}
    for streams in (1, 2):
        with torch.no_grad():
            codes, out[streams] = sample_slice_incremental(
                tp["netG"], tm.c, tm.plan.slice_shape, zl, sl, None, np.ones(n, bool), 1.0,
                kv_dtype=kv, streams=streams, teacher_logits=True)
        assert torch.equal(codes, sl)
    assert out[1].shape == (4, n, tm.c.nc, tm.c.nv)
    assert torch.equal(out[2], out[1])


@pytest.mark.parametrize("kv", ["native", "int4"])
def test_temperature_streams_are_one_stream_rollouts_of_their_rows(kv):
    """At temperature stream s draws from a generator seeded with the s-th
    of torch.randint(STREAM_SEEDS, (2,)) from the caller's generator: each
    block of two rows equals a one-stream rollout of those rows from such a
    generator, and the caller's generator stands where that draw leaves it."""
    tm, tp, zl, sl, n = _slice("dsfvt")
    primed = np.zeros(n, bool)
    primed[:3] = True  # a few primed pixels kept
    gen = torch.Generator().manual_seed(11)
    shadow = torch.Generator().manual_seed(11)
    seeds = torch.randint(STREAM_SEEDS, (2,), generator=shadow).tolist()
    with torch.no_grad():
        got = sample_slice_incremental(tp["netG"], tm.c, tm.plan.slice_shape, zl, sl, gen,
                                       primed, 0.9, kv_dtype=kv, streams=2)
        for s, seed in enumerate(seeds):
            r = slice(2 * s, 2 * s + 2)
            want = sample_slice_incremental(tp["netG"], tm.c, tm.plan.slice_shape, zl[r], sl[r],
                                            torch.Generator().manual_seed(seed), primed, 0.9,
                                            kv_dtype=kv)
            assert torch.equal(got[r], want), s
    assert torch.equal(gen.get_state(), shadow.get_state())
    keep = torch.from_numpy(primed).reshape(sl.shape[2:])
    assert torch.equal(got[:, :, keep], sl[:, :, keep])
    assert not torch.equal(got[:2], got[2:])  # the two streams drew apart


def _host_read(*args, **kwargs):
    raise AssertionError("a host read inside the pixel loop")


def test_streams_loop_reads_nothing_back(monkeypatch):
    """The multi-stream pixel loop, as a graph's branches capture it, reads
    no value back to the host, and gives the eager rollout's codes."""
    tm, tp, zl, sl, n = _slice("dsfvt")
    dec = tvti.SliceDecoder(tp["netG"], tm.c, tm.plan.slice_shape, 4, "cpu", kv_dtype="int4",
                            streams=2)
    primed = torch.zeros(n, dtype=torch.bool)
    with torch.no_grad():
        want = dec.run(zl, sl, primed, torch.Generator().manual_seed(3), 0.9)
        gens = tvti.stream_generators(torch.Generator().manual_seed(3), 2, "cpu")
        zlproj, sl_flat, emb = dec.inputs(zl, sl)
        assert len(zlproj) == 2 and zlproj[0].shape[0] == 2
        with monkeypatch.context() as m:
            for name in ("item", "__bool__", "__int__", "__float__", "tolist", "cpu", "numpy"):
                m.setattr(torch.Tensor, name, _host_read)
            dec.sample(zlproj, sl_flat, emb, primed, gens, 0.9)
    assert torch.equal(sl_flat.reshape(sl.shape), want)
    with pytest.raises(ValueError, match="generator"):  # one generator for two streams
        dec.sample(zlproj, sl_flat, emb, primed, torch.Generator(), 0.9)


def test_graph_key_names_the_streams():
    _, _, tm, tp, _ = _built("dsfvt")
    knobs = dict(kv_dtype="native", weight_dtype="native", mm_dtype="native", attn_impl="xla")
    keys = {s: graph_key(tp["netG"], tm.plan.slice_shape, 4, "cpu", dict(knobs, streams=s), 1.0,
                         True) for s in (1, 2, 4)}
    assert len(set(keys.values())) == 3


@pytest.mark.parametrize("kwargs,match", [
    (dict(streams=3), "streams"),  # does not divide the batch of 4
    (dict(streams=0), "streams"),
    (dict(kv_cache_dtype="int4", attn_impl="pallas"), "pallas"),
    (dict(incremental=False, streams=2), "streams"),
], ids=["streams3-batch4", "streams0", "int4-pallas", "full-streams"])
def test_refusals_match_jax(kwargs, match):
    jm, jp, tm, tp, video = _built("dsfvt")
    with pytest.raises(ValueError, match=match):
        tm.sample_video(tp, torch.from_numpy(video), n_prime=1, greedy=True, **kwargs)
    with pytest.raises(ValueError, match=match):  # lvt_tpu refuses the same call the same way
        jm.sample_video(jp, jnp.asarray(video), jax.random.key(0), n_prime=1, greedy=True,
                        **kwargs)
