"""The rollout's pixel loop as the CUDA graph captures it, on the CPU.

* Greedy ``sample_video`` codes equal lvt_tpu's bit for bit, natively and in
  every quantized mode, on the tiny DSFVT geometry (stride (4, 1, 1): every
  sampled slice unprimed) and on a stride-(4, 2, 2) geometry with two primed
  frames, where some slices mix primed and sampled pixels and others have
  none primed: the primed pixels are kept by a select on the device, so one
  loop (one graph on the card) serves every slice.
* The pixel loop reads nothing back to the host: with ``Tensor.item``,
  ``__bool__``, ``__int__``, ``__float__``, ``tolist``, ``cpu`` and ``numpy``
  raising, it runs and gives the same codes.
* The graph cache's key changes with the weights (in place or replaced),
  b, a knob or the temperature; the model's slot holds the weights its key
  names, so a weight freed from the tree and allocated anew cannot take the
  old address and pass for it.
* The draw of a channel equals ``torch.multinomial``'s from the same
  generator state.

The graph itself runs on the card only: tests/test_torch_kernels.py holds
it against the eager loop there.
"""

import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvt_tpu_torch.models import rollout_graph
from lvt_tpu_torch.models.rollout_graph import SliceGraphSlot, graph_key, launches_apart
from lvt_tpu_torch.models.vt import (_predictor_head, _predictor_u, vt_encode,
                                     vt_sample_pixel_channels)
from lvt_tpu_torch.models.vt_incremental import SliceDecoder

from test_torch_sampler_int8 import MODE_IDS, MODES, _knobs
from test_torch_vt import CASES, _models

torch.set_num_threads(1)  # one intra-op thread: the test workers share the cores

MIXED = ((4, 2, 2), (3, 3, 3), ((1, 2, 2),) * 2, (8, 4, 4))  # slices (2, 2, 2), 16 of them
GEOMETRIES = {"dsfvt": (CASES[0], 1), "mixed-primed": (MIXED, 2)}  # (case, n_prime)
ALL_MODES = [("native", "native", "native", "xla")] + MODES
ALL_IDS = ["native"] + MODE_IDS


def _primed_patterns(tm, n_prime):
    H, W = tm.H, tm.W
    return {tuple(tm.plan.slice_src[s].reshape(-1) // (H * W) < n_prime)
            for s in range(tm.plan.num_slices)}


@pytest.mark.parametrize("mode", ALL_MODES, ids=ALL_IDS)
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_greedy_codes_equal_jax(rng, geometry, mode):
    case, n_prime = GEOMETRIES[geometry]
    jm, jp, tm, tp = _models(case)
    if geometry == "mixed-primed":  # partly primed slices beside unprimed ones
        patterns = {p for p in _primed_patterns(tm, n_prime) if not all(p)}
        assert len(patterns) > 1 and any(any(p) for p in patterns)
    video = rng.integers(0, jm.c.nv, size=(2, jm.c.nc, *case[3])).astype(np.int32)
    knobs, kv = _knobs(mode)
    want = np.asarray(jm.sample_video(jp, jnp.asarray(video), jax.random.key(5),
                                      n_prime=n_prime, greedy=True, kv_cache_dtype=kv, **knobs))
    got = tm.sample_video(tp, torch.from_numpy(video), n_prime=n_prime, greedy=True,
                          kv_cache_dtype=kv, **knobs).numpy()
    assert np.array_equal(got, want)
    assert not np.array_equal(got, video)  # something was sampled


def _loop_inputs(rng, mode):
    """A SliceDecoder of the mixed geometry in ``mode`` and the inputs of a
    slice with primed and unprimed pixels."""
    _, _, tm, tp = _models(MIXED)
    video = torch.from_numpy(rng.integers(0, tm.c.nv, size=(2, tm.c.nc, *MIXED[3])))
    s = 1  # frames 1 and 5: the first primed, the second sampled
    primed = tm.plan.slice_src[s].reshape(-1) // (tm.H * tm.W) < 2
    assert primed.any() and not primed.all()
    sidx = torch.full((2,), s, dtype=torch.int64)
    ctx, sl, _ = tm.prepare_slices(video, sidx)
    zl = vt_encode(tp["netG"], tm.c, ctx, sidx)
    knobs, kv = _knobs(mode)
    dec = SliceDecoder(tp["netG"], tm.c, tm.plan.slice_shape, 2, "cpu", kv_dtype=kv, **knobs)
    return dec, zl, sl, torch.as_tensor(primed)


def _host_read(*args, **kwargs):
    raise AssertionError("a host read inside the pixel loop")


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "temperature"])
@pytest.mark.parametrize("mode", ALL_MODES, ids=ALL_IDS)
def test_pixel_loop_reads_nothing_back(rng, monkeypatch, mode, greedy):
    dec, zl, sl, primed = _loop_inputs(rng, mode)
    with torch.no_grad():
        want = dec.run(zl, sl, primed, torch.Generator().manual_seed(3), 0.9, greedy)
        zlproj, sl_flat, emb = dec.inputs(zl, sl)
        with monkeypatch.context() as m:
            for name in ("item", "__bool__", "__int__", "__float__", "tolist", "cpu", "numpy"):
                m.setattr(torch.Tensor, name, _host_read)
            dec.sample(zlproj, sl_flat, emb, primed, torch.Generator().manual_seed(3), 0.9,
                       greedy)
    assert torch.equal(sl_flat.reshape(sl.shape), want)
    keep = primed.reshape(sl.shape[2:])
    assert torch.equal(want[:, :, keep], sl[:, :, keep])  # primed codes kept


def test_graph_key_names_weights_batch_knobs_and_temperature():
    _, _, tm, tp = _models(MIXED)
    netg = tp["netG"]
    native = dict(kv_dtype="native", weight_dtype="native", mm_dtype="native",
                  attn_impl="xla")

    def key(params=netg, b=2, knobs=native, temp=0.9, greedy=False):
        return graph_key(params, tm.plan.slice_shape, b, "cpu", knobs, temp, greedy)

    first = key()
    assert key() == first
    assert key(b=3) != first
    assert key(knobs=dict(native, kv_dtype="int8")) != first
    assert key(knobs=dict(native, weight_dtype="int8")) != first
    assert key(temp=1.0) != first
    assert key(greedy=True) != first and key(greedy=True, temp=1.0) == key(greedy=True)
    with torch.no_grad():
        netg["decoder"]["layers"][1]["ffn_w1"].mul_(1.0)  # in place, the same values
    assert key() != first and key()[1:] == first[1:]
    changed = key()
    netg["predictor"]["ln_scale"] = netg["predictor"]["ln_scale"].clone()  # replaced
    assert key() not in (first, changed)


def test_the_slot_holds_the_weights_its_key_names(monkeypatch):
    """A weight deleted from the tree after a capture and allocated anew
    (same shape, values and a fresh version) gets another address, because
    the slot keeps the old tensor alive: the key changes and the slice is
    captured again. The slot then lets the old weight go. The capture
    itself needs the card and is stood in for here."""
    _, _, tm, tp = _models(MIXED)
    netg, shape = tp["netG"], tm.plan.slice_shape
    monkeypatch.setattr(rollout_graph, "SliceGraph", lambda *args: object())
    slot = SliceGraphSlot()
    zl = torch.zeros((2, *shape, tm.c.d))
    sl = torch.zeros((2, tm.c.nc, *shape), dtype=torch.int64)
    primed = torch.zeros(int(np.prod(shape)), dtype=torch.bool)
    knobs = dict(kv_dtype="native", weight_dtype="native", mm_dtype="native", attn_impl="xla")

    def get():
        return slot.get(netg, tm.c, shape, zl, sl, primed, knobs, 0.9, False)

    first = get()
    assert get() is first
    lp = netg["decoder"]["layers"][0]
    values, old = lp["wq"].numpy().copy(), weakref.ref(lp["wq"])
    del lp["wq"]  # the tree lets go of it first
    lp["wq"] = torch.tensor(values)
    assert old() is not None and lp["wq"]._version == 0
    assert get() is not first
    assert old() is None


def test_launches_apart_takes_the_counts_out():
    from lvt_tpu_torch.ops.cache_attention import decode_attention_cuda
    from lvt_tpu_torch.ops.quant import matmul_i8w_cuda

    before = (decode_attention_cuda.launches, matmul_i8w_cuda.launches)
    with launches_apart() as took:
        decode_attention_cuda.launches += 3
    assert took == {decode_attention_cuda: 3}
    assert (decode_attention_cuda.launches, matmul_i8w_cuda.launches) == before


def test_channel_draw_is_multinomials(rng):
    """``vt_sample_pixel_channels`` draws as torch.multinomial(probs, 1)
    does, without its host-side checks: the same codes from the same
    generator state."""
    _, _, tm, tp = _models(MIXED)
    netg, c = tp["netG"], tm.c
    y = torch.from_numpy(rng.standard_normal((5, c.d)).astype(np.float32))
    got = vt_sample_pixel_channels(netg, c, y, torch.Generator().manual_seed(7), 0.8)
    gen = torch.Generator().manual_seed(7)
    want = torch.zeros_like(got)
    pred = netg["predictor"]
    for k in range(c.nc):
        logits = _predictor_head(pred, c, k, _predictor_u(pred, c, k, y, want),
                                 netg["decoder"]).float()
        want[:, k] = torch.multinomial(torch.softmax(logits / 0.8, dim=-1), 1,
                                       generator=gen)[:, 0].to(torch.int32)
    assert torch.equal(got, want)
