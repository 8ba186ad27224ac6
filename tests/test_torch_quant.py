"""The port's int8 quantization ops and the plain versions of kernels 3, 4,
5 and 11 held to lvt_tpu on the same inputs, made from a numpy seed. The
Pallas kernels run in interpret mode, as tests/test_cache_attention.py and
tests/test_quant_matmul.py run them.

The port keeps heads apart, (b, na, R, da), where lvt_tpu's decode kernels
take fused-lane (b, R, na*da) caches and a block-diagonal q: the mapping is
made here. lvt_tpu masks the rows at or past ``live`` with a -1e9 logit (or,
in the live kernel, from the live length); the port never reads them.

Tolerances (fp32 outputs): kernel 5 1e-5, kernel 3 1e-4, kernel 11 1e-5
(lvt_tpu's own bounds for its kernels against its XLA references); kernel 4
1e-4 (the same scheme on both sides, so far tighter than the 3e-2 lvt_tpu
allows between its two schemes). Quantized integers and scales are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvt_tpu.models.vt_incremental import _quantize_cols as jax_quantize_cols
from lvt_tpu.ops import cache_attention as jca
from lvt_tpu.ops import quant_matmul as jqm
from lvt_tpu_torch.ops import cache_attention as tca
from lvt_tpu_torch.ops import quant as tq

torch.set_num_threads(1)  # one intra-op thread: the test workers share the cores

BF16 = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _to_torch(x):
    """A jax array as a torch tensor of the same dtype (bf16 via fp32)."""
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    return torch.from_numpy(np.array(x))


def _same(got, want):
    """Equal values and dtypes, got a torch tensor and want a jax array."""
    want = _to_torch(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


# --------------------------------------------------------------------------
# quantize_rows_i8, quantize_cols
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 64), (3, 2, 16), (1, 128)])
def test_quantize_rows_i8_equals_jax(rng, dtype, shape):
    jdt, tdt = BF16[dtype]
    y = rng.standard_normal(shape).astype(np.float32)
    y[0, ..., 0] = 0.5 * np.abs(y[0]).max()  # a half-way case or two for the rounding mode
    yj = jnp.asarray(y).astype(jdt)
    wi, ws = jqm.quantize_rows_i8(yj)
    gi, gs = tq.quantize_rows_i8(_to_torch(yj))
    _same(gi, wi)
    _same(gs, ws)
    assert gs.dtype == torch.float32 and gs.shape == shape[:-1] + (1,)


def test_quantize_rows_i8_rounds_half_to_even():
    # scale 1: absmax 127, so x.5 values hit the rounding mode itself
    y = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]])
    yi, sy = tq.quantize_rows_i8(y)
    assert float(sy) == 1.0
    assert yi.tolist() == [[127, 0, 2, 2, 0, -2, -2, 126]]
    wi, _ = jqm.quantize_rows_i8(jnp.asarray(y.numpy()))
    assert np.array_equal(np.asarray(wi), yi.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_cols_equals_jax(rng, dtype):
    jdt, tdt = BF16[dtype]
    w = jnp.asarray(rng.standard_normal((48, 40)).astype(np.float32)).astype(jdt)
    wi, ws = jax_quantize_cols(w, jdt)
    gi, gs = tq.quantize_cols(_to_torch(w), tdt)
    _same(gi, wi)
    _same(gs, ws)
    assert gs.dtype == tdt and gs.shape == (40,)


def test_quantize_cols_zero_column():
    w = torch.randn((8, 4), generator=torch.Generator().manual_seed(0))
    w[:, 2] = 0.0
    wi, s = tq.quantize_cols(w, torch.float32)
    assert float(s[2]) == 0.0 and not wi[:, 2].any()


# --------------------------------------------------------------------------
# kernel 11: matmul_i8w
# --------------------------------------------------------------------------

def _cols(rng, d, n):
    w = rng.standard_normal((d, n))
    s = np.max(np.abs(w), axis=0) / 127.0
    wi = np.clip(np.round(w / (s[None, :] + 1e-8)), -127, 127).astype(np.int8)
    return wi, s.astype(np.float32)


@pytest.mark.parametrize("b,d,n", [(4, 32, 96), (6, 64, 48), (8, 128, 128), (1, 1024, 32)])
def test_matmul_i8w_plain_matches_pallas(rng, b, d, n):
    y = rng.standard_normal((b, d)).astype(np.float32)
    wi, sw = _cols(rng, d, n)
    want = np.asarray(jqm.matmul_i8w_pallas(jnp.asarray(y), jnp.asarray(wi), jnp.asarray(sw),
                                            interpret=True))
    ref = np.asarray(jqm.matmul_i8w_xla(jnp.asarray(y), jnp.asarray(wi), jnp.asarray(sw)))
    wt = torch.from_numpy(wi).t().contiguous()
    got = tq.matmul_i8w_plain(torch.from_numpy(y), wt, torch.from_numpy(sw))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)
    # the dispatcher takes the plain version on a CPU tensor
    assert torch.equal(tq.matmul_i8w(torch.from_numpy(y), wt, torch.from_numpy(sw)), got)


def test_matmul_i8w_plain_bf16(rng):
    """bf16 activations and scales, as the bf16 sampler calls it: the fp32
    product is rounded once, so it equals lvt_tpu's to one bf16 ulp."""
    b, d, n = 4, 64, 48
    y = jnp.asarray(rng.standard_normal((b, d)).astype(np.float32)).astype(jnp.bfloat16)
    wi, sw = _cols(rng, d, n)
    swj = jnp.asarray(sw).astype(jnp.bfloat16)
    want = jqm.matmul_i8w_pallas(y, jnp.asarray(wi), swj, out_dtype=jnp.bfloat16, interpret=True)
    got = tq.matmul_i8w_plain(_to_torch(y), torch.from_numpy(wi).t().contiguous(),
                              _to_torch(swj), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), _to_torch(want).float(), atol=0, rtol=2 ** -7)


def test_matmul_i8w_integer_sum_is_exact():
    """At K = 2048 the integer sum passes 2^24: an fp32 sum of the products
    loses bits in most orders, the plain version's float64 sum does not."""
    K = 2048
    y = torch.full((1, K), 3.0)
    wt = torch.full((2, K), 127, dtype=torch.int8)
    wt[1, ::2] = -126
    got = tq.matmul_i8w_plain(y, wt, torch.ones(2))
    sums = torch.tensor([[127 * 127 * K, 127 * (127 - 126) * K // 2]], dtype=torch.int64)
    assert int(sums[0, 0]) > 2 ** 24
    want = sums.float() * torch.tensor(3.0 / 127.0)
    assert torch.equal(got, want)


# --------------------------------------------------------------------------
# kernel 11's row_amax: a row split over a model group
# --------------------------------------------------------------------------

def _rows_case(dtype, b=6, K=64, N=40, seed=11):
    g = torch.Generator().manual_seed(seed)
    y = torch.randn((b, K), generator=g).to(dtype)
    y[0, 3] = 0.0  # a row with a zero and a row of zeros
    y[1] = 0.0
    wi, sw = tq.quantize_cols(torch.randn((K, N), generator=g).to(dtype), dtype)
    return y, wi.t().contiguous(), sw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_amax_equal_to_the_rows_own_is_bit_equal(dtype):
    y, wt, sw = _rows_case(dtype)
    amax = y.abs().amax(dim=-1).float()
    assert torch.equal(tq.matmul_i8w_plain(y, wt, sw, dtype, row_amax=amax),
                       tq.matmul_i8w_plain(y, wt, sw, dtype))
    assert torch.equal(tq.matmul_i8w(y, wt, sw, dtype, row_amax=amax),
                       tq.matmul_i8w(y, wt, sw, dtype))
    q8, sq = tq.quantize_rows_i8(y, amax)
    w8, wq = tq.quantize_rows_i8(y)
    assert torch.equal(q8, w8) and torch.equal(sq, wq)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_a_larger_row_amax_quantizes_with_that_scale(dtype):
    """row_amax above the row's own absmax: the row is quantized by
    row_amax / 127 (true division), the product scaled by it; and the two
    halves of a row quantized with the whole row's absmax are the whole
    row's integers, their int32 sums adding to the whole row's."""
    y, wt, sw = _rows_case(dtype)
    amax = 3.0 * y.abs().amax(dim=-1).float() + 0.25
    sy = amax[:, None] / torch.tensor(127.0)
    y8 = torch.clamp(torch.round(y.float() / (sy + 1e-8)), -127, 127).to(torch.int8)
    q8, sq = tq.quantize_rows_i8(y, amax)
    assert torch.equal(q8, y8) and torch.equal(sq, sy)
    acc = (y8.double() @ wt.double().t()).float()
    want = (acc * sy * sw.float()).to(dtype)
    assert torch.equal(tq.matmul_i8w_plain(y, wt, sw, dtype, row_amax=amax), want)
    assert not torch.equal(want, tq.matmul_i8w_plain(y, wt, sw, dtype))  # the scale counts
    # a row split in two over its K: the group's absmax, the parts' integers
    whole_amax = y.abs().amax(dim=-1).float()
    K = y.shape[1]
    halves = (slice(0, K // 2), slice(K // 2, K))
    for h in halves:
        assert torch.equal(tq.quantize_rows_i8(y[:, h], whole_amax)[0],
                           tq.quantize_rows_i8(y)[0][:, h])
    parts = [tq.matmul_i8w_plain(y[:, h], wt[:, h].contiguous(), sw, torch.int32,
                                 row_amax=whole_amax) for h in halves]
    assert torch.equal(parts[0] + parts[1], tq.matmul_i8w_plain(y, wt, sw, torch.int32))


def test_matmul_i8w_writes_the_integer_sums_unscaled():
    """out_dtype int32: the exact integer sums of the int8 rows and weight
    columns, which the epilogue (x sy, then x sw, in fp32) turns into the
    scaled output bit for bit."""
    y, wt, sw = _rows_case(torch.bfloat16)
    got = tq.matmul_i8w_plain(y, wt, sw, torch.int32)
    q8, sq = tq.quantize_rows_i8(y)
    assert got.dtype == torch.int32
    assert torch.equal(got, (q8.long() @ wt.long().t()).int())
    assert torch.equal((got.float() * sq * sw.float()).to(torch.bfloat16),
                       tq.matmul_i8w_plain(y, wt, sw, torch.bfloat16))
    assert torch.equal(tq.matmul_i8w(y, wt, sw, torch.int32), got)


def test_matmul_i8w_writes_fp32_from_bf16_inputs():
    """out_dtype float32 from bf16 activations and scales: the fp32 epilogue
    unrounded, which a row-split product sums over its group before the one
    rounding to bf16."""
    y, wt, sw = _rows_case(torch.bfloat16)
    got = tq.matmul_i8w_plain(y, wt, sw, torch.float32)
    assert got.dtype == torch.float32
    q8, sq = tq.quantize_rows_i8(y)
    want = (q8.double() @ wt.double().t()).float() * sq * sw.float()
    assert torch.equal(got, want)
    assert torch.equal(got.to(torch.bfloat16), tq.matmul_i8w_plain(y, wt, sw, torch.bfloat16))
    assert torch.equal(tq.matmul_i8w(y, wt, sw, torch.float32), got)


# --------------------------------------------------------------------------
# kernels 3, 4, 5: the layouts of the two packages
# --------------------------------------------------------------------------

def _fused_lane(x):
    """(b, na, R, da) heads-apart -> (b, R, na*da) fused-lane."""
    b, na, R, da = x.shape
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(b, R, na * da))


def _i8_inputs(rng, b, na, R, da):
    q8 = rng.integers(-127, 128, size=(b, na, da)).astype(np.int8)
    sq = (np.abs(rng.standard_normal((b, na))) * 0.01 + 1e-4).astype(np.float32)
    k8 = rng.integers(-127, 128, size=(b, na, R, da)).astype(np.int8)
    v8 = rng.integers(-127, 128, size=(b, na, R, da)).astype(np.int8)
    ks = (np.abs(rng.standard_normal((b, na, R))) * 0.01).astype(np.float32)
    vs = (np.abs(rng.standard_normal((b, na, R))) * 0.01).astype(np.float32)
    bias = (rng.standard_normal((na, R)) * 0.1).astype(np.float32)
    return q8, sq, k8, ks, v8, vs, bias


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("b", [4, 3])  # an odd batch too
@pytest.mark.parametrize("live", [32, 17, 1])
def test_decode_attention_i8_plain_matches_pallas(rng, b, live):
    na, R, da = 2, 32, 16
    q8, sq, k8, ks, v8, vs, bias = _i8_inputs(rng, b, na, R, da)
    scale = 1 / np.sqrt(da)
    extra = np.where(np.arange(R)[None, None, :] >= live, -1e9, bias[None]).astype(np.float32)
    want = np.asarray(jca.decode_attention_i8_pallas(
        jca.blockdiag_expand(jnp.asarray(q8)), jnp.asarray(sq[:, :, None]),
        jnp.asarray(_fused_lane(k8)), jnp.asarray(ks), jnp.asarray(_fused_lane(v8)),
        jnp.asarray(vs), jnp.asarray(extra), scale, out_dtype=jnp.float32, interpret=True))
    args = _t(q8, sq, k8, ks, v8, vs)
    got = tca.decode_attention_i8_plain(*args, live, torch.from_numpy(bias), scale)
    assert got.dtype == torch.float32 and got.shape == (b, na * da)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    assert torch.equal(tca.decode_attention_i8(*args, live, torch.from_numpy(bias), scale), got)
    # rows at or past live are never read
    for x in (args[2], args[4]):
        x[:, :, live:] = 127
    for x in (args[3], args[5]):
        x[:, :, live:] = 1e6
    assert torch.equal(tca.decode_attention_i8_plain(*args, live, torch.from_numpy(bias), scale),
                       got)


def test_decode_attention_i8_plain_bf16_scales(rng):
    """Scales in bf16 (the bf16 sampler's caches) are cast to fp32 inside, and
    the output is rounded once to bf16, as in lvt_tpu's kernel."""
    b, na, R, da, live = 2, 2, 32, 16, 20
    q8, sq, k8, ks, v8, vs, bias = _i8_inputs(rng, b, na, R, da)
    ksj, vsj = (jnp.asarray(x).astype(jnp.bfloat16) for x in (ks, vs))
    scale = 1 / np.sqrt(da)
    extra = np.where(np.arange(R)[None, None, :] >= live, -1e9, bias[None]).astype(np.float32)
    want = jca.decode_attention_i8_pallas(
        jca.blockdiag_expand(jnp.asarray(q8)), jnp.asarray(sq[:, :, None]),
        jnp.asarray(_fused_lane(k8)), ksj, jnp.asarray(_fused_lane(v8)), vsj,
        jnp.asarray(extra), scale, out_dtype=jnp.bfloat16, interpret=True)
    q8t, sqt, k8t, v8t = _t(q8, sq, k8, v8)
    got = tca.decode_attention_i8_plain(q8t, sqt, k8t, _to_torch(ksj), v8t, _to_torch(vsj), live,
                                        torch.from_numpy(bias), scale)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), _to_torch(want).float(), atol=1e-4, rtol=2 ** -7)


@pytest.mark.parametrize("live", [1, 7, 16, 21, 48, 64])
def test_decode_attention_i8_live_plain_matches_pallas(rng, live):
    b, na, R, da, rtile = 4, 2, 64, 16, 16
    q8, sq, k8, ks, v8, vs, bias = _i8_inputs(rng, b, na, R, da)
    scale = 1 / np.sqrt(da)
    want = np.asarray(jca.decode_attention_i8_live_pallas(
        live, jca.blockdiag_expand(jnp.asarray(q8)), jnp.asarray(sq[:, None, :]),
        jnp.asarray(_fused_lane(k8)), jnp.asarray(ks.transpose(0, 2, 1)),
        jnp.asarray(_fused_lane(v8)), jnp.asarray(vs.transpose(0, 2, 1)),
        jnp.asarray(bias.T[None]), scale, rtile=rtile, out_dtype=jnp.float32, interpret=True))
    args = _t(q8, sq, k8, ks, v8, vs)
    got = tca.decode_attention_i8_live_plain(*args, live, torch.from_numpy(bias), scale,
                                             rtile=rtile)
    assert got.dtype == torch.float32 and got.shape == (b, na * da)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    assert torch.equal(tca.decode_attention_i8_live(*args, live, torch.from_numpy(bias), scale,
                                                    rtile=rtile), got)
    # the two schemes (per tile, per row) are views of one attention: lvt_tpu's bar
    single = tca.decode_attention_i8_plain(*args, live, torch.from_numpy(bias), scale)
    np.testing.assert_allclose(got.numpy(), single.numpy(), atol=3e-2, rtol=1e-1)


def test_decode_attention_i8_live_plain_ignores_stale_rows(rng):
    """Rows at or past live left from an earlier block run (never zeroed)
    must be dead: poisoned, they change nothing, in either package."""
    b, na, R, da, rtile, live = 4, 2, 64, 16, 16, 20
    q8, sq, k8, ks, v8, vs, bias = _i8_inputs(rng, b, na, R, da)
    scale = 1 / np.sqrt(da)
    args = _t(q8, sq, k8, ks, v8, vs)
    clean = tca.decode_attention_i8_live_plain(*args, live, torch.from_numpy(bias), scale,
                                               rtile=rtile)
    k8p, v8p, ksp, vsp = k8.copy(), v8.copy(), ks.copy(), vs.copy()
    k8p[:, :, live:], v8p[:, :, live:] = 127, -128
    ksp[:, :, live:], vsp[:, :, live:] = 1e6, 1e6
    got = tca.decode_attention_i8_live_plain(*_t(q8, sq, k8p, ksp, v8p, vsp), live,
                                             torch.from_numpy(bias), scale, rtile=rtile)
    assert torch.equal(got, clean)
    want = np.asarray(jca.decode_attention_i8_live_pallas(
        live, jca.blockdiag_expand(jnp.asarray(q8)), jnp.asarray(sq[:, None, :]),
        jnp.asarray(_fused_lane(k8p)), jnp.asarray(ksp.transpose(0, 2, 1)),
        jnp.asarray(_fused_lane(v8p)), jnp.asarray(vsp.transpose(0, 2, 1)),
        jnp.asarray(bias.T[None]), scale, rtile=rtile, out_dtype=jnp.float32, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_decode_attention_i8_live_rtile_must_divide(rng):
    args = _t(*_i8_inputs(rng, 1, 2, 48, 16))
    with pytest.raises(ValueError, match="rtile"):
        tca.decode_attention_i8_live_plain(*args[:6], 5, args[6], 0.25, rtile=32)
    # the default tile of 64 is cut to the buffer
    out = tca.decode_attention_i8_live_plain(*args[:6], 5, args[6], 0.25)
    assert out.shape == (1, 32)


@pytest.mark.parametrize("b,eb", [(2, 2), (3, 1)])
def test_cache_attention_i8_plain_matches_pallas(rng, b, eb):
    na, CL, da = 2, 32, 16
    q = rng.standard_normal((b, na, da)).astype(np.float32)
    _, _, k8, ks, v8, vs, _ = _i8_inputs(rng, b, na, CL, da)
    extra = rng.standard_normal((eb, na, CL)).astype(np.float32)
    scale = 1 / np.sqrt(da)
    want = np.asarray(jca.cache_attention_pallas(
        *(jnp.asarray(x) for x in (q, k8, ks, v8, vs, np.broadcast_to(extra, (b, na, CL)))),
        scale, interpret=True))
    args = _t(q, k8, ks, v8, vs, extra)
    got = tca.cache_attention_i8_plain(*args, scale)
    assert got.dtype == torch.float32 and got.shape == (b, na, da)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert torch.equal(tca.cache_attention_i8(*args, scale), got)
    # live < CL against extra = -1e9 on the rows above
    live = 11
    masked = np.where(np.arange(CL)[None, None, :] >= live, -1e9,
                      np.broadcast_to(extra, (b, na, CL))).astype(np.float32)
    want = np.asarray(jca.cache_attention_pallas(
        *(jnp.asarray(x) for x in (q, k8, ks, v8, vs, masked)), scale, interpret=True))
    got = tca.cache_attention_i8_plain(*args, scale, live=live)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_i8_weight_step_is_the_quantization_step(rng):
    """i8_weight_step is the scale kernel 3 quantizes its weights with: moving
    one weight by one step moves an output by step * |v8|."""
    b, na, R, da, live = 2, 2, 32, 16, 32
    q8, sq, k8, ks, v8, vs, bias = _t(*_i8_inputs(rng, b, na, R, da))
    step = tca.i8_weight_step(q8, sq, k8, ks, vs, live, bias, 0.25)
    assert step.shape == (b, na) and step.dtype == torch.float32
    out = tca.decode_attention_i8_plain(q8, sq, k8, ks, v8, vs, live, bias, 0.25)
    # the output is an integer multiple of the step, head by head
    ratio = out.reshape(b, na, da) / step[:, :, None]
    assert float((ratio - ratio.round()).abs().max()) < 1e-2


def test_dispatchers_refuse_other_devices():
    meta = torch.empty((1, 2, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        tca.cache_attention_i8(meta, torch.empty((1, 2, 4, 16), device="meta"), None, None, None,
                               None, 1.0)
    with pytest.raises(ValueError, match="no kernel for device"):
        tq.matmul_i8w(torch.empty((1, 16), device="meta"), None, None)


# --------------------------------------------------------------------------
# Kernels 3 and 4 with the fold: the plain composite, and the arithmetic the
# CUDA kernels run in its place
# --------------------------------------------------------------------------

def _step_case(seed, b, na, R, da, live, dtype):
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn((b, 3, na, da), generator=g).to(dtype)
    k8, v8 = (torch.randint(-127, 128, (b, na, R, da), generator=g, dtype=torch.int8)
              for _ in range(2))
    ks, vs = ((0.02 * torch.rand((b, na, R), generator=g) + 1e-3).to(dtype) for _ in range(2))
    k8[:, :, live:], v8[:, :, live:] = 127, -128  # rows an earlier block run left
    ks[:, :, live:], vs[:, :, live:] = 1e6, 1e6
    bias = 0.5 * torch.randn((na, R), generator=g)
    return qkv, k8, ks, v8, vs, bias


@pytest.mark.parametrize("live_kernel", [False, True], ids=["kernel3", "kernel4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("live", [1, 63, 64, 65, 256])
def test_step_plain_is_the_samplers_eager_sequence(live_kernel, dtype, live):
    """decode_attention_i8(_live)_step_plain, which the sampler calls on the
    CPU, equals the sequence the sampler ran before the fold, bit for bit:
    the new rows quantized in the parameter dtype and written at row
    live - 1, q quantized in fp32, then the plain kernel. q8, sq, the cache
    (rows and scales) and the output."""
    b, na, R, da, scale = 3, 2, 256, 64, 0.125
    qkv, k8, ks, v8, vs, bias = _step_case(live, b, na, R, da, live, dtype)
    theirs = [t.clone() for t in (k8, ks, v8, vs)]
    kv8, kvs = tq.quantize_cache_row(qkv[:, 1:], dtype)  # the eager sequence
    theirs[0][:, :, live - 1], theirs[2][:, :, live - 1] = kv8[:, 0], kv8[:, 1]
    theirs[1][:, :, live - 1], theirs[3][:, :, live - 1] = kvs[:, 0], kvs[:, 1]
    q8, sq = tq.quantize_rows_i8(qkv[:, 0])
    plain = tca.decode_attention_i8_live_plain if live_kernel else tca.decode_attention_i8_plain
    want = plain(q8, sq[..., 0], *theirs, live, bias, scale, dtype)
    mine = [t.clone() for t in (k8, ks, v8, vs)]
    step = tca.decode_attention_i8_live_step if live_kernel else tca.decode_attention_i8_step
    got = step(qkv[:, 0], qkv[:, 1:], *mine, live, bias, scale, dtype)
    assert torch.equal(got, want)
    for a, w in zip(mine, theirs):
        assert torch.equal(a, w)
    composite = tca.decode_attention_i8_live_step_plain if live_kernel \
        else tca.decode_attention_i8_step_plain
    again = [t.clone() for t in (k8, ks, v8, vs)]
    out, q8_got, sq_got = composite(qkv[:, 0], qkv[:, 1:], *again, live, bias, scale, dtype,
                                    q_out=True)
    assert torch.equal(out, want) and torch.equal(q8_got, q8) and torch.equal(sq_got, sq[..., 0])


def _round_io(x, dtype):
    return x.to(dtype).float()


def _kernel_row_quantization(x, dtype, eps_in_io=False):
    """csrc/decode_attention_i8.cu quantize_new_row, written out in fp32
    with the io dtype's rounding after each operation: the absmax, a true
    division by 127, + 1e-8, the quotient, then rint and the clip. The
    kernel adds 1e-8 in fp32, as PyTorch's CUDA add does; PyTorch's CPU add
    first rounds the Python number to the tensor's dtype (eps_in_io)."""
    xf = x.float()
    sc = _round_io(xf.abs().amax(dim=-1) / torch.tensor(127.0), dtype)
    eps = torch.tensor(1e-8)
    den = _round_io(sc + (_round_io(eps, dtype) if eps_in_io else eps), dtype)
    q = _round_io(xf / den[..., None], dtype)
    return torch.clamp(torch.round(q), -127.0, 127.0).to(torch.int8), sc.to(dtype)


def _kernel_q_quantization(x):
    """quantize_q of the same file: fp32 absmax, / 127, + 1e-8, the
    quotient, rint, the clip."""
    xf = x.float()
    sq = xf.abs().amax(dim=-1) / torch.tensor(127.0)
    den = sq + torch.tensor(1e-8, dtype=torch.float32)
    return torch.clamp(torch.round(xf / den[..., None]), -127.0, 127.0).to(torch.int8), sq


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["randn", "halves", "tiny", "zero"])
def test_the_kernels_quantization_arithmetic_is_pytorchs(dtype, case):
    """The fold's arithmetic, each operation rounded once in fp32 and then to
    the io dtype where the kernel rounds it, equals quantize_cache_row and
    quantize_rows_i8 bit for bit: on random rows, on rows of scale 1 whose
    values sit at x.5 and next to it, on rows of tiny values (where + 1e-8
    is not lost) and on zero rows. On tiny bf16 rows the CPU's add rounds
    1e-8 to bf16 first and the card's does not: the CPU sequence is held to
    that variant here, the kernel to the card's sequence in
    tests/test_torch_kernels.py."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn((4, 2, 8, 128), generator=g)
    if case == "halves":
        x = torch.randint(-126, 126, x.shape, generator=g).float() + 0.5
        x = x + torch.tensor([0.0, 2 ** -9, -2 ** -9])[torch.randint(0, 3, x.shape, generator=g)]
        x[..., 0] = 127.0
    elif case == "tiny":
        x = x * 1e-7
    elif case == "zero":
        x = torch.zeros_like(x)
    x = x.to(dtype)
    k8, ks = tq.quantize_cache_row(x, dtype)
    e8, es = _kernel_row_quantization(x, dtype)
    if case == "tiny" and dtype == torch.bfloat16:
        assert not torch.equal(k8, e8)  # the two adds part here
        e8, es = _kernel_row_quantization(x, dtype, eps_in_io=True)
    assert torch.equal(k8, e8) and torch.equal(ks, es)
    q8, sq = tq.quantize_rows_i8(x)
    f8, fs = _kernel_q_quantization(x)
    assert torch.equal(q8, f8) and torch.equal(sq[..., 0], fs)
