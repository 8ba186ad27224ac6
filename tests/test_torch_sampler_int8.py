"""The port's quantized sampler (int8 KV cache, int8 weights) held to
lvt_tpu's sampler in the same mode, on the tiny geometries of
tests/test_vt_incremental.py, fp32, weights carried across with from_jax_vt.
lvt_tpu's Pallas kernels run in interpret mode (its default off the TPU).

* Teacher-forced logits of one slice (``teacher_logits=True``) within
  LOGIT_TOL = 2e-5 of lvt_tpu's in the same mode. Measured: at most 1.3e-6
  over all cases and modes, at |logits| <= 3.0; the gap between a quantized
  mode and the native sampler on the same case is 4.3e-3 to 2.3e-2, so the
  bound sits two to three orders of magnitude under what it must tell apart,
  and each case asserts that its own gap is at least 10x the bound. The
  exception is a near-tie: an activation that one package is about to round
  to an integer and that sits within fp32 noise of x.5 may round the other
  way in the other package, and one such step moves the logits by 2.0e-4 to
  9.6e-4 (measured on the cases where it happens). The test watches the
  port's roundings; where one came within TIE_MARGIN of x.5, the bound is
  half the mode's own gap instead.
* Greedy ``sample_video`` codes: tests/test_torch_sampler_int8_greedy.py.
* One bf16 case: the cache's scales are computed and kept in bf16.
* The int4 cache (MODES "kv4", "kv4-w8-pallas"): its rows quantized as
  lvt_tpu quantizes them, every level -7..7 through the packing and back,
  and half of the int8 cache's bytes.
* The refusals, each with lvt_tpu's error class.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvt_tpu.models import vt_incremental as jvti
from lvt_tpu.models.vt import vt_encode as jax_vt_encode
from lvt_tpu_torch.models.vt import vt_encode
from lvt_tpu_torch.models.vt_incremental import sample_slice_incremental

from test_torch_vt import CASES, _models, _slice_inputs

torch.set_num_threads(1)  # one intra-op thread: the test workers share the cores

LOGIT_TOL = 2e-5
# A value that the port is about to round to an integer (a cache entry, a
# weight, q) and that lies within this of x.5, in quantization steps, is a
# near-tie: the two packages' fp32 activations differ by ~1e-6 relative
# (|x| <= 127: ~1e-4 steps), so one of them may round it the other way.
TIE_MARGIN = 1e-4


class _TieMargin:
    """While active, records how close any activation that the port rounds
    to an integer came to x.5: the least distance, in ``margin``. The
    weights' quantization is left out: both packages round the same numbers
    there."""

    def __init__(self, monkeypatch):
        import lvt_tpu_torch.models.vt_incremental as tvti

        self.margin, self.on = float("inf"), True
        inner_round, inner_cols = torch.round, tvti.quantize_cols

        def recording_round(x, *args, **kwargs):
            if self.on:
                frac = x.detach().float()
                self.margin = min(self.margin, float((frac - frac.floor() - 0.5).abs().min()))
            return inner_round(x, *args, **kwargs)

        def quiet_cols(*args, **kwargs):
            self.on = False
            try:
                return inner_cols(*args, **kwargs)
            finally:
                self.on = True

        monkeypatch.setattr(torch, "round", recording_round)
        monkeypatch.setattr(tvti, "quantize_cols", quiet_cols)


MODES = [  # (kv, weights, mm, attn)
    ("int8", "native", "native", "xla"),
    ("int8", "native", "int8", "xla"),
    ("int8", "native", "native", "pallas"),
    ("int8", "native", "native", "pallas-live"),
    ("native", "int8", "native", "xla"),
    ("native", "int8-pallas", "native", "xla"),
    ("int8", "int8-pallas", "native", "pallas"),
    ("int4", "native", "native", "xla"),
    ("int4", "int8-pallas", "native", "xla"),
]
MODE_IDS = ["kv8", "kv8-mm8", "kv8-pallas", "kv8-live", "w8", "w8-pallas", "kv8-w8-pallas", "kv4",
            "kv4-w8-pallas"]
GEOMETRIES = {"dsfvt": 0, "dssvt": 1, "subblock": 3, "nonsquare": 4}


def _knobs(mode):
    kv, weights, mm, attn = mode
    return dict(weight_dtype=weights, mm_dtype=mm, attn_impl=attn), kv


def _teacher_logits(case, mode, rng, dtype=None):
    """(port's logits, lvt_tpu's logits, the port's native logits) of the
    middle slice, teacher-forced, in ``mode``, fp32 or cast to ``dtype``."""
    jm, jp, tm, tp = _models(case)
    if dtype is not None:
        from lvt_tpu_torch.models import cast_floats

        tp = cast_floats(tp, dtype)
        jp = jax.tree_util.tree_map(
            lambda x: x.astype(jnp.bfloat16) if jnp.issubdtype(x.dtype, jnp.floating) else x, jp)
    video = rng.integers(0, tm.c.nv, size=(2, tm.c.nc, *case[3])).astype(np.int64)
    s = tm.plan.num_slices // 2
    ctx, sl, sidx = _slice_inputs(tm, video, s)
    n = sl[0, 0].numel()
    knobs, kv = _knobs(mode)

    zl = vt_encode(tp["netG"], tm.c, ctx, sidx)
    with torch.no_grad():
        _, got = sample_slice_incremental(tp["netG"], tm.c, tm.plan.slice_shape, zl, sl, None,
                                          np.ones(n, bool), 1.0, kv_dtype=kv,
                                          teacher_logits=True, **knobs)
        _, native = sample_slice_incremental(tp["netG"], tm.c, tm.plan.slice_shape, zl, sl, None,
                                             np.ones(n, bool), 1.0, teacher_logits=True)

    def jax_side(netg, ctx, sl, sidx):
        zl = jax_vt_encode(netg, jm.c, ctx, sidx, use_pallas=False)
        return jvti.sample_slice_incremental(
            netg, jm.c, jm.plan.slice_shape, zl, sl, jax.random.key(0), jnp.ones((n,), bool),
            1.0, kv_dtype=kv, teacher_logits=True, **knobs)[2]

    want = jax.jit(jax_side)(jp["netG"], jnp.asarray(ctx.numpy()),
                             jnp.asarray(sl.numpy().astype(np.int32)),
                             jnp.asarray(sidx.numpy().astype(np.int32)))
    return got.numpy(), np.asarray(want), native.numpy()


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_teacher_logits_match_jax_in_the_same_mode(rng, monkeypatch, geometry, mode):
    ties = _TieMargin(monkeypatch)
    got, want, native = _teacher_logits(CASES[GEOMETRIES[geometry]], mode, rng)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    gap = float(np.abs(got - native).max())
    assert gap >= 10 * LOGIT_TOL, f"the mode's own gap to native, {gap}, is too near the bound"
    if ties.margin >= TIE_MARGIN:
        assert err <= LOGIT_TOL, (err, gap, ties.margin)
    else:  # a near-tie may round one step apart: one step of the many that make the gap
        assert err <= 0.5 * gap, (err, gap, ties.margin)


def test_bf16_cache_scales_follow_the_parameter_dtype(rng):
    """bf16 parameters: the cache's scales (absmax / 127, the division by
    scale + 1e-8) are computed and kept in bf16 on both sides
    (test_cache_row_quantization_in_bf16 holds that arithmetic to equality).
    Logits in bf16 carry 2^-8 relative rounding per operation through two
    layers, where the two packages' products round apart, so the bound is a
    few bf16 ulps of the largest logit, not LOGIT_TOL: measured 1.8e-2 at
    |logits| <= 2.7, the size of the int8 gap itself in bf16 (1.6e-2)."""
    got, want, native = _teacher_logits(CASES[0], MODES[0], rng, dtype=torch.bfloat16)
    scale = float(np.abs(want).max())
    assert np.isfinite(got).all()
    assert float(np.abs(got - want).max()) <= 2 ** -5 * scale


def test_cache_row_quantization_in_bf16():
    """The new row's scale and integers in bf16, the JAX sampler's lines
    (vt_incremental.py: sk = max|k| .astype(cdtype) / 127, k / (sk + 1e-8))."""
    from lvt_tpu_torch.models.vt_incremental import _quantize_cache_row

    x = np.random.default_rng(3).standard_normal((3, 2, 16)).astype(np.float32)
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
        xj = jnp.asarray(x).astype(jdt)
        sk = jnp.max(jnp.abs(xj), axis=-1).astype(jdt) / 127.0
        k8 = jnp.clip(jnp.round(xj / (sk[..., None] + 1e-8)), -127.0, 127.0).astype(jnp.int8)
        xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt)
        g8, gs = _quantize_cache_row(xt, tdt)
        assert gs.dtype == tdt and g8.dtype == torch.int8
        assert np.array_equal(g8.numpy(), np.asarray(k8))
        assert np.array_equal(gs.float().numpy(), np.asarray(sk.astype(jnp.float32)))


def test_quantized_weights_equal_jax(rng):
    """Nothing new is converted: the int8 weights are made inside the sampler
    from the carried-across weights, and equal lvt_tpu's integers and scales."""
    from lvt_tpu.ops.fused_layer import _wqkv_flat
    from lvt_tpu_torch.ops.quant import quantize_cols

    jm, jp, tm, tp = _models(CASES[0])
    for jl, tl in zip(jp["netG"]["decoder"]["layers"], tp["netG"]["decoder"]["layers"]):
        na, d, da = tl["wq"].shape
        t_qkv = torch.cat([tl[n].permute(1, 0, 2).reshape(d, na * da)
                           for n in ("wq", "wk", "wv")], dim=1)
        pairs = [(_wqkv_flat(jl.wq, jl.wk, jl.wv), t_qkv), (jl.proj, tl["proj"]),
                 (jl.ffn_w1, tl["ffn_w1"]), (jl.ffn_w2, tl["ffn_w2"])]
        for jw, tw in pairs:
            wi, ws = jvti._quantize_cols(jw, jnp.float32)
            gi, gs = quantize_cols(tw, torch.float32)
            assert np.array_equal(gi.numpy(), np.asarray(wi))
            assert np.array_equal(gs.numpy(), np.asarray(ws))


# --------------------------------------------------------------------------
# refusals
# --------------------------------------------------------------------------

def _tiny(rng):
    jm, jp, tm, tp = _models(CASES[0])
    video = rng.integers(0, tm.c.nv, size=(2, tm.c.nc, *CASES[0][3])).astype(np.int32)
    return jm, jp, tm, tp, video


@pytest.mark.parametrize("kwargs,error,match", [
    (dict(kv_cache_dtype="native", mm_dtype="int8"), ValueError, "mm_dtype"),
    (dict(kv_cache_dtype="native", attn_impl="pallas-live"), ValueError, "pallas-live"),
    (dict(kv_cache_dtype="int2"), ValueError, "kv_dtype"),
    (dict(weight_dtype="int4"), ValueError, "weight_dtype"),
    (dict(attn_impl="triton"), ValueError, "attn_impl"),
    (dict(incremental=False, weight_dtype="int8"), ValueError, "weight_dtype"),
    (dict(incremental=False, kv_cache_dtype="int8", mm_dtype="int8"), ValueError, "mm_dtype"),
    (dict(incremental=False, attn_impl="pallas"), ValueError, "attn_impl"),
], ids=["mm8-native-kv", "live-native-kv", "kv-unknown", "weights-unknown", "attn-unknown",
        "full-weights", "full-mm", "full-attn"])
def test_refusals_match_jax(rng, kwargs, error, match):
    jm, jp, tm, tp, video = _tiny(rng)
    with pytest.raises(error, match=match):
        tm.sample_video(tp, torch.from_numpy(video), n_prime=1, greedy=True, **kwargs)
    with pytest.raises(error, match=match):  # lvt_tpu refuses the same call the same way
        jm.sample_video(jp, jnp.asarray(video), jax.random.key(0), n_prime=1, greedy=True,
                        **kwargs)


def test_int4_is_not_ported(rng):
    """The int4 cache runs through ``sample_video`` with native and int8
    weights (codes in range, the primed frame kept), and refuses what
    lvt_tpu refuses with it: int8 attention products and the live kernel,
    each with lvt_tpu's class."""
    jm, jp, tm, tp, video = _tiny(rng)
    tv = torch.from_numpy(video)
    for weights in ("native", "int8"):
        got = tm.sample_video(tp, tv, n_prime=1, greedy=True, kv_cache_dtype="int4",
                              weight_dtype=weights)
        assert got.shape == tv.shape and int(got.min()) >= 0 and int(got.max()) < tm.c.nv
        assert torch.equal(got[:, :, :1], tv[:, :, :1])
    for kwargs, match in ((dict(mm_dtype="int8"), "mm_dtype"),
                          (dict(attn_impl="pallas-live"), "pallas-live")):
        with pytest.raises(ValueError, match=match):
            tm.sample_video(tp, tv, n_prime=1, greedy=True, kv_cache_dtype="int4", **kwargs)
        with pytest.raises(ValueError, match=match):
            jm.sample_video(jp, jnp.asarray(video), jax.random.key(0), n_prime=1, greedy=True,
                            kv_cache_dtype="int4", **kwargs)


def test_int4_rows_quantize_as_jax_and_pack_exactly():
    """The int4 cache's row quantization equals lvt_tpu's (qmax 7, the scale
    in the parameter dtype), every level -7..7 survives the packing and the
    unpack exactly (the extremes, and all pairs of neighbours), and the
    packed cache holds half the int8 cache's bytes."""
    from lvt_tpu_torch.models.vt_incremental import SliceDecoder, _quantize_cache_row
    from lvt_tpu_torch.ops.quant import pack_int4, unpack_int4

    x = np.random.default_rng(4).standard_normal((3, 2, 16)).astype(np.float32)
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
        xj = jnp.asarray(x).astype(jdt)
        sk = jnp.max(jnp.abs(xj), axis=-1).astype(jdt) / 7.0
        k4 = jnp.clip(jnp.round(xj / (sk[..., None] + 1e-8)), -7.0, 7.0).astype(jnp.int4)
        g4, gs = _quantize_cache_row(torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt),
                                     tdt, 7)
        assert np.array_equal(g4.numpy(), np.asarray(k4).astype(np.int8))
        assert np.array_equal(gs.float().numpy(), np.asarray(sk.astype(jnp.float32)))
    levels = torch.arange(-7, 8, dtype=torch.int8)
    pairs = torch.cartesian_prod(levels, levels).reshape(15, 30)  # every (even, odd) pair
    packed = pack_int4(pairs)
    assert packed.dtype == torch.int8 and packed.shape == (15, 15)
    for dtype in (torch.float32, torch.int8):
        out = torch.full((15, 30), 99, dtype=dtype)
        unpack_int4(packed, out, torch.empty_like(packed))
        assert torch.equal(out.to(torch.int8), pairs)
    _, _, tm, tp, _ = _tiny(np.random.default_rng(0))
    bytes_ = {kv: SliceDecoder(tp["netG"], tm.c, tm.plan.slice_shape, 4, "cpu", kv_dtype=kv)
              .cache_bytes() for kv in ("int8", "int4")}
    assert 2 * bytes_["int4"] == bytes_["int8"] > 0


def test_full_recompute_ignores_the_cache_dtype(rng):
    """incremental=False has no cache: kv_cache_dtype means nothing there and
    is let through, as in lvt_tpu."""
    _, _, tm, tp, video = _tiny(rng)
    tv = torch.from_numpy(video)
    a = tm.sample_video(tp, tv, n_prime=1, greedy=True, incremental=False)
    b = tm.sample_video(tp, tv, n_prime=1, greedy=True, incremental=False, kv_cache_dtype="int8")
    assert torch.equal(a, b)
