"""The VT encoder's context sum in every LVT_CTX_IMPL formulation
(lvt_tpu_torch/ops/conv.py) held to lvt_tpu's on the same inputs, made with
numpy from a seed: the forward of each formulation, the auto choice, the
table gradient of the one backward every formulation shares, and what that
backward keeps and makes."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import lvt_tpu.ops.conv as jconv
import lvt_tpu.ops.subscale as jss
import lvt_tpu_torch.ops.conv as tconv
from lvt_tpu_torch.config import get_cfg
from lvt_tpu_torch.models.vt import VTConfig

torch.set_num_threads(1)  # one intra-op thread: the test workers share the cores

T = torch.from_numpy
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# "" is auto; an unknown value computes gather_sum in both packages
IMPLS = ("", "gather_sum", "chunk", "chain", "onehot", "minor", "no_such_impl")
# tests/test_torch_ops.py's geometries: (stride, kernel) on a 4 x 4 x 4 grid
GEOMETRIES = [((4, 1, 1), (3, 1, 1)), ((1, 2, 2), (1, 3, 3)), ((2, 2, 2), (3, 3, 3))]
# tests/test_ops.py's backward cases: (stride, kernel, extra padded rows)
GRAD_CASES = [((4, 1, 1), (3, 1, 1), 0), ((1, 2, 2), (1, 3, 3), 0),
              ((2, 1, 1), (4, 1, 1), 1)]


def _set_impl(monkeypatch, impl):
    monkeypatch.setenv("LVT_CTX_IMPL", impl)
    if impl == "chunk":  # several chunks, so the chunk-boundary adds run
        monkeypatch.setenv("LVT_CTX_CHUNK", "2")


def _geometry(stride, kernel, nc=2, nv=8, de=6, seed=0):
    rng = np.random.default_rng(seed)
    plan = jss.build_plan(*stride, 4, 4, 4, *kernel)
    video = rng.integers(0, nv, size=(2, nc, 64)).astype(np.int32)
    ctx = np.array(jss.gather_context(jnp.asarray(video), jnp.asarray(plan.ctx_src[1]), -1))
    table = rng.standard_normal((nc, *kernel, nv, de)).astype(np.float32)
    return ctx, table, nv


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("stride,kernel", GEOMETRIES)
def test_formulation_matches_lvt_tpu(monkeypatch, impl, stride, kernel):
    """Each formulation, auto and the fall-through against lvt_tpu's same
    formulation (both read the environment at call time), fp32."""
    ctx, table, nv = _geometry(stride, kernel)
    _set_impl(monkeypatch, impl)
    want = np.asarray(jconv.subscale_context_encode(jnp.asarray(ctx), jnp.asarray(table), None,
                                                    stride, nv))
    got = tconv.subscale_context_encode(T(ctx), T(table), None, stride, nv).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("impl", ["chunk", "chain", "onehot", "minor"])
@pytest.mark.parametrize("stride,kernel", GEOMETRIES)
def test_formulation_matches_port_gather_sum(monkeypatch, impl, stride, kernel):
    """Within the port every formulation adds the same slot rows. "chain"
    and "onehot" add them one slot at a time in slot order and are bit-equal
    (a one-hot product gives each row exactly). Against "gather_sum" they
    hold to chunk's bound (rtol 1e-5, atol 1e-6), not bit for bit: PyTorch's
    CPU sum adds a reduced axis of more than a few terms in a blocked order
    (at 18 terms of N(0, 1) ~1e-6 apart from left to right), where XLA adds
    left to right."""
    ctx, table, nv = _geometry(stride, kernel)
    monkeypatch.setenv("LVT_CTX_IMPL", "gather_sum")
    want = tconv._ctx_encode_impl(T(ctx), T(table), stride).numpy()
    monkeypatch.setenv("LVT_CTX_IMPL", "chain")
    chain = tconv._ctx_encode_impl(T(ctx), T(table), stride).numpy()
    _set_impl(monkeypatch, impl)
    got = tconv._ctx_encode_impl(T(ctx), T(table), stride).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    if impl == "onehot":
        np.testing.assert_array_equal(got, chain)


def _grad_case(stride, kernel, extra, dtype):
    rng = np.random.default_rng(1)
    nc, nv, de = 2, 6, 8
    kt, kh, kw = kernel
    st, sh, sw = stride
    t, h, w = 2, 4, 4
    Tp, Hp, Wp = (t - 1) * st + kt + extra, (h - 1) * sh + kh, (w - 1) * sw + kw
    t = (Tp - kt) // st + 1  # the windows the grid gives
    table = rng.standard_normal((nc, kt, kh, kw, nv, de)).astype(np.float32)
    ctx = rng.integers(-1, nv, size=(3, nc, Tp, Hp, Wp)).astype(np.int32)
    g = rng.standard_normal((3, t, h, w, de)).astype(np.float32)
    if dtype == "bfloat16":  # the inputs on bf16's grid on both sides
        table, g = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32) for a in (table, g))
    return ctx, table, g, nv


_JAX_GRADS = {}


def _jax_table_grad(stride, kernel, extra, dtype):
    """jax.grad of <_ctx_encode(ctx, table), g> through lvt_tpu's custom
    VJP (the same for every formulation), once per case."""
    key = (stride, kernel, extra, dtype)
    if key not in _JAX_GRADS:
        ctx, table, g, nv = _grad_case(stride, kernel, extra, dtype)
        jdt = jnp.dtype(dtype)
        gj = jnp.asarray(g, jdt)
        grad = jax.grad(lambda tab: jnp.vdot(
            jconv._ctx_encode(jnp.asarray(ctx), tab, stride, nv, kernel).astype(jnp.float32),
            gj.astype(jnp.float32)))(jnp.asarray(table, jdt))
        _JAX_GRADS[key] = np.asarray(grad, np.float32)
    return _JAX_GRADS[key]


@pytest.mark.parametrize("impl", IMPLS[:-1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stride,kernel,extra", GRAD_CASES)
def test_table_gradient_matches_lvt_tpu(monkeypatch, impl, dtype, stride, kernel, extra):
    """d(table) through the port's per-slot backward against jax.grad
    through lvt_tpu's _ctx_encode, the even kernel with its extra padded row
    included. fp32 to 1e-4; bf16 within one bf16 step of the value: both
    sum fp32 products in fp32 and round once, in another order, so a sum
    near a rounding boundary can land one bf16 ulp (2^-7 relative) apart."""
    ctx, table, g, nv = _grad_case(stride, kernel, extra, dtype)
    want = _jax_table_grad(stride, kernel, extra, dtype)
    _set_impl(monkeypatch, impl)
    tdt = getattr(torch, dtype)
    tab = T(table).to(tdt).requires_grad_(True)
    out = tconv.subscale_context_encode(T(ctx), tab, None, stride, nv)
    out.backward(T(g).to(tdt))
    assert tab.grad.dtype == tdt and tab.grad.shape == tab.shape
    got = tab.grad.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    else:
        np.testing.assert_array_less(np.abs(got - want), 2 ** -7 * np.abs(want) + 1e-30)


_VT_CONFIGS = ("DSFVT", "DSSVT", "DSTSVT")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b", [64, 1024])
@pytest.mark.parametrize("name", _VT_CONFIGS)
def test_auto_choice_is_lvt_tpus(monkeypatch, name, b, dtype):
    """Auto picks what lvt_tpu's expression (ops/conv.py:163-172) picks
    for one slice of each shipped VT on its 16 x 16 x 16 latent grid,
    computed from the shapes alone."""
    monkeypatch.delenv("LVT_CTX_IMPL", raising=False)
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(ROOT, "configs", "vt", f"{name}.yaml"))
    c = VTConfig.from_cfg(cfg)
    (kt, kh, kw), (st, sh, sw) = c.kernel, c.stride
    t, h, w = 16 // st, 16 // sh, 16 // sw
    itemsize = torch.empty((), dtype=dtype).element_size()
    inter = b * c.nc * (kt * kh * kw) * t * h * w * c.de * itemsize  # lvt_tpu's expression
    want = "chain" if inter > 2 ** 31 else "gather_sum"
    assert tconv.ctx_encode_impl(b, c.nc * kt * kh * kw, t * h * w, c.de, itemsize) == want
    if b == 1024:  # bf16: 1.75 / 9.0 / 11.25 GiB; only DSFVT's stays under 2 GiB
        bf16_dsfvt = name == "DSFVT" and dtype == torch.bfloat16
        assert want == ("gather_sum" if bf16_dsfvt else "chain")
    monkeypatch.setenv("LVT_CTX_IMPL", "minor")
    assert tconv.ctx_encode_impl(b, c.nc * kt * kh * kw, t * h * w, c.de, itemsize) == "minor"


class _Largest(TorchDispatchMode):
    """The element count of the largest tensor any operation makes."""

    def __init__(self):
        super().__init__()
        self.most = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else [out]:
            if isinstance(t, torch.Tensor):
                self.most = max(self.most, t.numel())
        return out


@pytest.mark.parametrize("impl", IMPLS[:-1])
def test_saves_only_the_codes_and_expands_nothing(monkeypatch, impl):
    """_CtxEncode saves nothing larger than ctx (saved_tensors_hooks sees
    every saved tensor), and its backward makes no tensor as large as the
    (b, nc*K, thw, de) gather nor an expanded g: its largest is one slot's
    one-hot (b*thw, nv+1), g's fp32 copy or the (nc*K, nv+1, de) table
    gradient."""
    stride, kernel = (1, 2, 2), (1, 3, 3)
    ctx, table, nv = _geometry(stride, kernel, nc=2, nv=6, de=8)
    _set_impl(monkeypatch, impl)
    ctx_t = T(ctx)
    tab = T(table).requires_grad_(True)
    saved = []

    def pack(t):
        saved.append((t.numel() * t.element_size(), t.dtype))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = tconv.subscale_context_encode(ctx_t, tab, None, stride, nv)
    assert saved == [(ctx_t.numel() * ctx_t.element_size(), ctx_t.dtype)]
    b, t, h, w, de = out.shape
    S, thw = 2 * 9, t * h * w
    mode = _Largest()
    with mode:
        out.backward(torch.ones_like(out))
    assert mode.most <= max(b * thw * (nv + 1), S * (nv + 1) * de, b * thw * de)
    assert mode.most < b * S * thw * de
