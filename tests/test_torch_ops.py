"""The port's ops held to lvt_tpu on the same inputs, made with numpy from a
seed: the two kernels' plain versions against the Pallas kernels (interpret
mode) and their XLA twins, the subscale plans, posenc, the convolutions and
the nearest-code search. The kernels themselves run only on a CUDA card:
tests/test_torch_kernels.py holds them to these plain versions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lvt_tpu.ops.attention as jatt
import lvt_tpu.ops.cache_attention as jca
import lvt_tpu.ops.conv as jconv
import lvt_tpu.ops.posenc as jpos
import lvt_tpu.ops.subscale as jss
import lvt_tpu.ops.vq as jvq
import lvt_tpu_torch.ops.attention as tatt
import lvt_tpu_torch.ops.cache_attention as tca
import lvt_tpu_torch.ops.conv as tconv
import lvt_tpu_torch.ops.posenc as tpos
import lvt_tpu_torch.ops.subscale as tss
import lvt_tpu_torch.ops.vq as tvq
from lvt_tpu.config import get_cfg

T = torch.from_numpy


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# --------------------------------------------------------------------------
# kernel 1: attention_core
# --------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("block", [(1, 4, 4), (2, 2, 3)])
def test_attention_core_plain_matches_pallas_and_xla(rng, masked, block):
    n = int(np.prod(block))
    q, k, v = (_f32(rng, 3, 2, n, 8) for _ in range(3))
    bias = _f32(rng, 2, n, n, scale=0.5)
    mask = jatt.causal_mask(n) if masked else None
    want_xla = np.asarray(jatt.attention_core_xla(q, k, v, bias, mask))
    want_pallas = np.asarray(jatt.attention_core_pallas(q, k, v, bias, mask, interpret=True))
    got = tatt.attention_core(T(q), T(k), T(v), T(bias), masked).numpy()
    np.testing.assert_allclose(got, want_xla, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, want_pallas, atol=1e-5, rtol=0)


def test_attention_core_bf16_rounds_p_like_the_pallas_kernel(rng):
    """bf16 operands: P is rounded to v's dtype before P.V, in both."""
    n = 16
    q, k, v = (jnp.asarray(_f32(rng, 2, 2, n, 8), jnp.bfloat16) for _ in range(3))
    bias = _f32(rng, 2, n, n, scale=0.5)
    want = np.asarray(jatt.attention_core_pallas(q, k, v, bias, jatt.causal_mask(n),
                                                 interpret=True), np.float32)
    tq, tk, tv = (T(np.asarray(x, np.float32)).to(torch.bfloat16) for x in (q, k, v))
    got = tatt.attention_core(tq, tk, tv, T(bias), True).float().numpy()
    # one bf16 rounding of the output apart at most (2^-8 relative)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=2 ** -8)


@pytest.mark.parametrize("block", [(1, 4, 4), (2, 2, 3), (4, 8, 8)])
def test_relative_bias_and_block_split_match(rng, block):
    t, h, w = block
    banks = [_f32(rng, 2, 2 * s - 1) for s in block]
    want = np.asarray(jatt.relative_bias(*banks, block))
    got = tatt.relative_bias(*(T(b) for b in banks), block).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    x = _f32(rng, 2, 2 * t, 2 * h, w, 3)
    jt, geom = jatt.split_blocks(jnp.asarray(x), block)
    tt, tgeom = tatt.split_blocks(T(x), block)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tatt.merge_blocks(tt, tgeom).numpy(), x)


@pytest.mark.parametrize("masked", [False, True])
def test_block_local_attention_layer_matches(rng, masked):
    block, na, d, da = (1, 4, 4), 2, 16, 8
    p = jatt.init_block_attn(jax.random.key(1), block, na, d, da)
    p = p._replace(dt_bank=jnp.asarray(_f32(rng, na, 1)),
                   dh_bank=jnp.asarray(_f32(rng, na, 7)),
                   dw_bank=jnp.asarray(_f32(rng, na, 7)))
    x = _f32(rng, 2, 2, 4, 4, d)
    want = np.asarray(jatt.block_local_attention(jnp.asarray(x), p, block, masked,
                                                 use_pallas=False))
    tp = {k: T(np.array(v)) for k, v in p._asdict().items()}
    got = tatt.block_local_attention(T(x), tp, block, masked).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_layer_norm_uses_biased_variance(rng):
    x = _f32(rng, 4, 32)
    s, b = _f32(rng, 32), _f32(rng, 32)
    want = np.asarray(jatt._layer_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b)))
    got = tatt._layer_norm(T(x), T(s), T(b)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


# --------------------------------------------------------------------------
# kernel 2: decode attention over the KV cache
# --------------------------------------------------------------------------

@pytest.mark.parametrize("live", [1, 7, 31, 32])
def test_decode_attention_plain_matches_pallas_and_xla(rng, live):
    """The port's (b, na, R, da) cache and the JAX package's fused-lane
    (b, R, na*da) cache with a block-diagonal q, from the same bias row and
    the same live mask."""
    b, na, R, da = 3, 2, 32, 16
    q = _f32(rng, b, na, da)
    kc, vc = _f32(rng, b, na, R, da), _f32(rng, b, na, R, da)
    row = _f32(rng, na, R, scale=0.5)
    scale = 1.0 / np.sqrt(da)
    qbd = jca.blockdiag_expand(jnp.asarray(q))
    k4 = jnp.asarray(kc.transpose(0, 2, 1, 3).reshape(b, R, na * da))
    v4 = jnp.asarray(vc.transpose(0, 2, 1, 3).reshape(b, R, na * da))
    extra = np.where(np.arange(R)[None, None, :] >= live, np.float32(-1e9), row[None])
    want_xla = np.asarray(jca.decode_attention_xla(qbd, k4, v4, extra[0], scale))
    want_pallas = np.asarray(jca.decode_attention_pallas(
        qbd, k4, v4, jnp.asarray(extra), scale, out_dtype=jnp.float32, interpret=True))
    kc_t, vc_t = T(kc.copy()), T(vc.copy())
    kc_t[:, :, live:] = float("nan")  # stale rows are never read
    vc_t[:, :, live:] = float("nan")
    got = tca.decode_attention(T(q), kc_t, vc_t, live, T(row), scale).numpy()
    np.testing.assert_allclose(got, want_xla, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, want_pallas, atol=1e-5, rtol=0)


def test_cpu_tensors_never_reach_the_kernels(rng):
    """Dispatch: CPU tensors run the plain versions (no launch counted); the
    kernel wrappers refuse anything but CUDA tensors."""
    q = T(_f32(rng, 1, 2, 4, 64))
    before = (tatt.block_attention_fwd_cuda.launches, tca.decode_attention_cuda.launches)
    tatt.attention_core(q, q, q, torch.zeros(2, 4, 4), True)
    tca.decode_attention(q[:, :, 0], q, q, 2, torch.zeros(2, 4), 0.125)
    assert (tatt.block_attention_fwd_cuda.launches,
            tca.decode_attention_cuda.launches) == before
    with pytest.raises(ValueError):
        tatt.block_attention_fwd_cuda(q, q, q, torch.zeros(2, 4, 4), False)
    with pytest.raises(ValueError):
        tca.decode_attention_cuda(q[:, :, 0], q, q, 2, torch.zeros(2, 4), 0.125)


# --------------------------------------------------------------------------
# subscale plans and appliers, posenc
# --------------------------------------------------------------------------

VT_CONFIGS = ["DSFVT", "DSSVT", "DSTSVT", "KDSFVT"]


@pytest.mark.parametrize("name", VT_CONFIGS)
def test_subscale_plan_arrays_equal(name):
    cfg = get_cfg()
    cfg.merge_from_file(f"configs/vt/{name}.yaml")
    a = jss.plan_from_cfg(cfg, 16, 16, 16)
    b = tss.plan_from_cfg(cfg, 16, 16, 16)
    assert a._fields == b._fields
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f)
        else:
            assert x == y, f


@pytest.mark.parametrize("stride,kernel", [((4, 1, 1), (3, 1, 1)), ((2, 2, 2), (3, 3, 3))])
def test_subscale_appliers_match(rng, stride, kernel):
    """The port's gathers take one map per sample: sample 0 reads slice s,
    sample 1 slice s + 1, each against lvt_tpu's one-map gather of its row."""
    plan = jss.build_plan(*stride, 4, 4, 4, *kernel)
    video = rng.integers(0, 8, size=(2, 3, 64)).astype(np.int64)
    S = plan.num_slices

    def per_sample(maps, s):  # (2, ...) int64 tensor: rows s and s + 1
        return T(np.stack([maps[s], maps[(s + 1) % S]]).astype(np.int64))

    def jax_rows(fn, v, maps, s):
        return np.stack([np.asarray(fn(jnp.asarray(v[i:i + 1]), jnp.asarray(maps[(s + i) % S])))[0]
                         for i in range(2)])

    for s in range(S):
        want = jax_rows(lambda v, m: jss.gather_context(v, m, -1), video, plan.ctx_src, s)
        np.testing.assert_array_equal(
            tss.gather_context(T(video), per_sample(plan.ctx_src, s), -1).numpy(), want)
        want = jax_rows(jss.gather_slice, video, plan.slice_src, s)
        np.testing.assert_array_equal(
            tss.gather_slice(T(video), per_sample(plan.slice_src, s)).numpy(), want)
        sl = np.asarray(jss.gather_slice(jnp.asarray(video), jnp.asarray(plan.slice_src[s])))
        new = rng.integers(0, 8, size=sl.shape).astype(np.int64)
        want = np.asarray(jss.scatter_slice(jnp.asarray(video), jnp.asarray(plan.slice_src[s]),
                                            jnp.asarray(new)))
        np.testing.assert_array_equal(
            tss.scatter_slice(T(video), plan.slice_src[s], T(new)).numpy(), want)
        if plan.ctx_frame_src is not None:
            v4 = video.reshape(2, 3, 4, 16)
            want = jax_rows(lambda v, m: jss.gather_context_frames(v, m, -1), v4,
                            plan.ctx_frame_src, s)
            np.testing.assert_array_equal(
                tss.gather_context_frames(T(v4), per_sample(plan.ctx_frame_src, s), -1).numpy(),
                want)


def test_posenc_matches(rng):
    x = _f32(rng, 2, 3, 4, 5, 24)
    want = np.asarray(jpos.add_positional_encoding(jnp.asarray(x)))
    np.testing.assert_array_equal(tpos.add_positional_encoding(T(x)).numpy(), want)


# --------------------------------------------------------------------------
# convolutions
# --------------------------------------------------------------------------

@pytest.mark.parametrize("k,stride,pad", [(4, 2, 1), (3, 1, 1), (1, 1, 0)])
def test_conv2d_matches(rng, k, stride, pad):
    x, w, b = _f32(rng, 2, 8, 8, 5), _f32(rng, k, k, 5, 6, scale=0.3), _f32(rng, 6)
    want = np.asarray(jconv.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride, pad))
    got = tconv.conv2d(T(x), T(w), T(b), stride, pad).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_conv_transpose2d_matches(rng):
    """(kh, kw, out, in) weights flipped spatially: torch ConvTranspose2d."""
    x, w, b = _f32(rng, 2, 5, 5, 6), _f32(rng, 4, 4, 3, 6, scale=0.3), _f32(rng, 3)
    want = np.asarray(jconv.conv_transpose2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    got = tconv.conv_transpose2d(T(x), T(w), T(b)).numpy()
    assert got.shape == (2, 10, 10, 3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("kernel", [(3, 3, 3), (2, 3, 5)])
def test_masked_conv3d_matches(rng, kernel):
    x = _f32(rng, 2, 3, 4, 5, 4)
    w, b = _f32(rng, *kernel, 4, 6, scale=0.3), _f32(rng, 6)
    want = np.asarray(jconv.masked_conv3d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    got = tconv.masked_conv3d(T(x), T(w), T(b)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("stride,kernel", [((4, 1, 1), (3, 1, 1)), ((1, 2, 2), (1, 3, 3)),
                                           ((2, 2, 2), (3, 3, 3))])
def test_subscale_context_encode_matches(rng, stride, kernel):
    nc, nv, de = 2, 8, 6
    plan = jss.build_plan(*stride, 4, 4, 4, *kernel)
    video = rng.integers(0, nv, size=(2, nc, 64)).astype(np.int32)
    ctx = np.asarray(jss.gather_context(jnp.asarray(video), jnp.asarray(plan.ctx_src[1]), -1))
    table, bias = _f32(rng, nc, *kernel, nv, de), _f32(rng, de)
    want = np.asarray(jconv.subscale_context_encode(
        jnp.asarray(ctx), jnp.asarray(table), jnp.asarray(bias), stride, nv))
    got = tconv.subscale_context_encode(T(ctx), T(table), T(bias), stride, nv).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# --------------------------------------------------------------------------
# nearest codebook entry
# --------------------------------------------------------------------------

def test_nearest_indices_bit_equal_with_planted_ties(rng):
    K, Dc = 64, 16
    cb = _f32(rng, K, Dc)
    cb[40] = cb[7]  # exact duplicates: ties go to the lowest index
    cb[63] = cb[7]
    cb[20] = cb[3]
    z = _f32(rng, 300, Dc, scale=1.5)
    z[:10] = cb[7]  # planted: exactly on the duplicated entries
    z[10:20] = cb[20]
    want = np.asarray(jvq.nearest_indices(jnp.asarray(z), jnp.asarray(cb), use_pallas=False))
    got = tvq.nearest_indices(T(z), T(cb)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    assert (got[:10] == 7).all() and (got[10:20] == 3).all()


def test_encode_and_embed_indices_match(rng):
    emb = _f32(rng, 4, 32, 8)
    z = _f32(rng, 2, 3, 3, 32)
    state = jvq.EmaCodebookState(jnp.asarray(emb), jnp.zeros((4, 32)), jnp.asarray(emb))
    cb = {"embedding": T(emb), "running_size": torch.zeros(4, 32), "running_sum": T(emb)}
    want = np.asarray(jvq.encode_indices(jnp.asarray(z), state))
    got = tvq.encode_indices(T(z), cb)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tvq.embed_indices(got, cb).numpy(),
                                  np.asarray(jvq.embed_indices(jnp.asarray(want), state)))
