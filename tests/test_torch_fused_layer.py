"""The fused layer of the port (lvt_tpu_torch/ops/fused_layer.py) held to
lvt_tpu's (lvt_tpu/ops/fused_layer.py) on the CPU: the port runs its
kernels' plain versions, lvt_tpu its Pallas kernels in interpret mode, on the
same numpy inputs and the same weights (``from_jax_layer``).

Tolerances: fp32 1e-5 of the output's largest value for per-row outputs and
1e-4 for sums over all rows (fp32 sums taken in another order); bf16 one
bf16 ulp (2^-7) of the output's largest value. The bf16 cases pin the
kernels' rounding points: against the unfused layer bf16 only holds at 0.15
(tests/test_fused_layer.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvt_tpu.ops import attention as jatt
from lvt_tpu.ops import fused_layer as jfl
from lvt_tpu_torch.checkpoint import from_jax_layer
from lvt_tpu_torch.ops import attention as tatt
from lvt_tpu_torch.ops import fused_layer as tfl

BLOCK = (1, 4, 4)
N = 16
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _layer(rng, na, d, da, jdt=jnp.float32):
    t, h, w = BLOCK
    r = lambda *s: jnp.asarray(rng.standard_normal(s) * 0.1, jnp.float32)
    p = jatt.BlockAttnParams(
        ln_scale=1.0 + r(d), ln_bias=r(d), wq=r(na, d, da), wk=r(na, d, da), wv=r(na, d, da),
        proj=r(na * da, d), ffn_ln_scale=1.0 + r(d), ffn_ln_bias=r(d), ffn_w1=r(d, d),
        ffn_b1=r(d), ffn_w2=r(d, d), ffn_b2=r(d), dt_bank=r(na, 2 * t - 1),
        dh_bank=r(na, 2 * h - 1), dw_bank=r(na, 2 * w - 1))
    return jax.tree_util.tree_map(lambda a: a.astype(jdt), p)


def _port(tree):
    return from_jax_layer(jax.tree_util.tree_map(np.asarray, tree))


def _t(a):
    """A jax array as a torch tensor of the same dtype."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _close(name, got, want, dtype, summed=False):
    want = _t(want)
    assert got.dtype == want.dtype and got.shape == want.shape, name
    got, want = got.float(), want.float()
    scale = max(float(want.abs().max()), 1e-3)
    rel = 2 ** -7 if dtype == "bfloat16" else (1e-4 if summed else 1e-5)
    err = float((got - want).abs().max())
    assert err <= rel * scale, f"{name}: max abs err {err:.3g} > {rel:.3g} x {scale:.3g}"


def _inputs(rng, dtype, na=2, d=32, da=16, nb=3):
    jdt, _ = DTYPES[dtype]
    p = _layer(rng, na, d, da, jdt)
    tok = jnp.asarray(rng.standard_normal((nb, N, d)), jdt)
    g = jnp.asarray(rng.standard_normal((nb, N, d)), jdt)
    bias = jatt.relative_bias(p.dt_bank, p.dh_bank, p.dw_bank, BLOCK)
    return p, tok, g, bias


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_x2", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_forward_plain_matches_pallas_interpret(rng, causal, with_x2, dtype):
    p, tok, _, bias = _inputs(rng, dtype)
    want = jfl.fused_layer_tokens_pallas(tok, p, bias, jatt.causal_mask(N) if causal else None,
                                         with_x2=with_x2, interpret=True)
    got = tfl.fused_layer_tokens_plain(_t(tok), _port(p), _t(bias), causal, with_x2=with_x2)
    if with_x2:
        _close("out", got[0], want[0], dtype)
        _close("x2", got[1], want[1], dtype)
    else:
        _close("out", got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ffn_half_bwd_plain_matches_pallas_interpret(rng, dtype):
    p, x2, g, _ = _inputs(rng, dtype)
    want = jfl.ffn_half_bwd_pallas(x2, g, p, interpret=True)
    got = tfl.ffn_half_bwd_plain(_t(x2), _t(g), _port(p))
    assert len(got) == len(want) == 7
    for name, a, b in zip(("dx2", "dw1", "db1", "dw2", "db2", "dls", "dlb"), got, want):
        _close(name, a, b, dtype, summed=name != "dx2")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("heads", [(0, 2), (2, 4), (0, 4)])
def test_attn_half_bwd_plain_matches_pallas_interpret(rng, heads, causal, dtype):
    p, x, dx2, bias = _inputs(rng, dtype, na=4)
    want = jfl.attn_half_bwd_pallas(x, dx2, p, bias, jatt.causal_mask(N) if causal else None,
                                    *heads, interpret=True)
    got = tfl.attn_half_bwd_plain(_t(x), _t(dx2), _port(p), _t(bias), causal, *heads)
    for name, a, b in zip(("dy", "dwqkv", "dproj", "dbias"), got, want):
        if name != "dy":
            assert a.dtype == torch.float32, name  # the sums over the blocks stay fp32
            _close(name, a, b, "float32", summed=True) if dtype == "float32" else \
                _close(name, a, b, dtype)
        else:
            _close(name, a, b, dtype)


@pytest.mark.parametrize("na", [2, 4])
@pytest.mark.parametrize("causal", [False, True])
def test_fused_block_layer_value_and_grads_match_jax(rng, causal, na):
    """The port's autograd Function against jax.value_and_grad through
    lvt_tpu's custom_vjp with its kernels in interpret mode (fp32: lvt_tpu
    sums two head groups' dy partials, the port makes one call; exact in
    fp32). Every gradient: tok, each parameter, the bias."""
    p, tok, _, bias = _inputs(rng, "float32", na=na, nb=2)
    weights = jnp.asarray(np.linspace(-1, 1, tok.size).reshape(tok.shape), jnp.float32)
    jfl._FORCE_INTERPRET = True
    jfl._fused_layer_ad.cache_clear()
    try:
        want, wgrads = jax.value_and_grad(
            lambda t, pp, b: jnp.sum(jfl.fused_block_layer(t, pp, b, causal) * weights),
            argnums=(0, 1, 2))(tok, p, bias)
    finally:
        jfl._FORCE_INTERPRET = False
        jfl._fused_layer_ad.cache_clear()
    tp = {k: v.requires_grad_(True) for k, v in _port(p).items()}
    tt, tb = _t(tok).requires_grad_(True), _t(bias).requires_grad_(True)
    out = tfl.fused_block_layer(tt, tp, tb, causal)
    got = (out * _t(weights)).sum()
    got.backward()
    _close("out", out.detach(), jfl.fused_layer_tokens_pallas(
        tok, p, bias, jatt.causal_mask(N) if causal else None, interpret=True), "float32")
    # a weighted sum of 1,024 outputs of either sign: it cancels to ~1e-2 of its terms
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4)
    _close("dtok", tt.grad, wgrads[0], "float32")
    _close("dbias", tb.grad, wgrads[2], "float32", summed=True)
    for k in tfl.PARAM_KEYS:
        _close(k, tp[k].grad, getattr(wgrads[1], k), "float32", summed=True)
    for k in ("dt_bank", "dh_bank", "dw_bank"):  # reach the layer through the bias only
        assert tp[k].grad is None and not np.asarray(getattr(wgrads[1], k)).any()


@pytest.mark.parametrize("causal", [False, True])
def test_explicit_backward_matches_autograd_of_the_plain_forward(rng, causal):
    """_FusedLayer's backward (the plain versions of kernels 8 and 9 plus the
    LN tail) against autograd through fused_layer_tokens_plain, fp32: 1e-4
    of each gradient's largest value."""
    p, tok, g, bias = _inputs(rng, "float32", na=3, nb=2)
    leaves = {k: v.requires_grad_(True) for k, v in _port(p).items() if k in tfl.PARAM_KEYS}
    leaves["tok"], leaves["bias"] = _t(tok).requires_grad_(True), _t(bias).requires_grad_(True)

    def grads(fn):
        out = fn(leaves["tok"], leaves, leaves["bias"], causal)
        return out, torch.autograd.grad(out, list(leaves.values()), _t(g))

    out, got = grads(tfl.fused_block_layer)
    ref, want = grads(tfl.fused_layer_tokens_plain)
    assert torch.equal(out, ref)
    for name, a, b in zip(leaves, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()), name


def test_no_grad_forward_is_the_single_output_variant(rng, monkeypatch):
    p, tok, _, bias = _inputs(rng, "float32")
    seen = []
    plain = tfl.fused_layer_tokens_plain
    monkeypatch.setattr(tfl, "fused_layer_tokens_plain",
                        lambda *a, **k: seen.append(a[4] if len(a) > 4 else k["with_x2"])
                        or plain(*a, **k))
    tp = _port(p)
    with torch.no_grad():
        out = tfl.fused_block_layer(_t(tok), tp, _t(bias), True)
    tp["ffn_w1"].requires_grad_(True)
    out2 = tfl.fused_block_layer(_t(tok), tp, _t(bias), True)
    assert seen == [False, True] and torch.equal(out, out2)
    assert out.grad_fn is None and out2.grad_fn is not None


def test_bf16_weight_gradients_come_back_in_bf16(rng):
    """Under bf16 compute the bf16 copies' gradients are bf16 (they then flow
    to the fp32 masters), dbias too, as in lvt_tpu."""
    p, tok, g, bias = _inputs(rng, "bfloat16")
    tp = {k: v.requires_grad_(True) for k, v in _port(p).items()}
    tb = _t(bias).requires_grad_(True)
    assert tb.dtype == torch.bfloat16
    tfl.fused_block_layer(_t(tok), tp, tb, True).backward(_t(g))
    assert all(tp[k].grad.dtype == torch.bfloat16 for k in tfl.PARAM_KEYS)
    assert tb.grad.dtype == torch.bfloat16


def test_fused_layer_supported_gate():
    """The semantic conditions give lvt_tpu's answers (one block size, one
    head shape); the rest are the H100 kernels' own limits."""
    def layers(*shapes):
        return [{"wq": torch.zeros(s)} for s in shapes]

    class L:
        def __init__(self, shape):
            self.wq = np.zeros(shape)

    dsfvt = [(8, 512, 128)] * 2
    for blocks, shapes in (([(1, 16, 16)] * 2, dsfvt),                      # DSFVT
                           ([(4, 8, 8)] * 2, dsfvt),                        # DSSVT
                           ([(1, 16, 16), (4, 8, 8)], dsfvt),               # mixed blocks
                           ([(1, 16, 16)] * 2, [(8, 512, 128), (4, 512, 128)])):  # mixed heads
        assert tfl.fused_layer_supported(layers(*shapes), blocks) == \
            jfl.fused_layer_supported([L(s) for s in shapes], blocks)
    assert tfl.fused_layer_supported(layers(*dsfvt), [(1, 16, 16)] * 2)
    assert not tfl.fused_layer_supported(layers(*dsfvt), [(1, 16, 16), (4, 8, 8)])
    # the port's own limits
    assert tfl.fused_layer_supported(layers((8, 512, 64), (8, 512, 64)), [(1, 16, 16)] * 2)
    assert tfl.fused_layer_supported(layers((3, 64, 64)), [(2, 4, 4)])   # odd head counts too
    assert not tfl.fused_layer_supported(layers(*dsfvt), [(2, 16, 16)] * 2)        # n = 512
    assert not tfl.fused_layer_supported(layers((8, 1024, 128)), [(1, 16, 16)])    # d > 512
    assert not tfl.fused_layer_supported(layers((2, 96, 64)), [(1, 4, 4)])         # d % 64
    assert not tfl.fused_layer_supported(layers((2, 24, 12)), [(2, 4, 4)])         # da
