"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card. Marked ``cuda``: where torch.cuda.is_available() is false they
skip. This file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Tolerances, |kernel - plain| on the same inputs: fp32 1e-4 absolute (sums
in another order only); bf16 1e-3 + 2^-7 relative (plus one bf16 rounding of
the output, and of P where the two versions land on either side of a
rounding boundary). Kernel 10 (the backward) is held to the same bounds for
dq, dk, dv in fp32; in bf16 to one rounding of the output (2^-7 relative)
plus one bf16 rounding at the output's largest value (2^-8 of it: one ds
term rounded the other way, |ds| up to ~4, moves a dq or dk sum by up to
ulp(ds) |k| / sqrt(da)). Its dbias is fp32 in both dtypes, a sum over the
nb blocks of fp32 terms, held to 1e-4 + 1e-5 relative."""

import pytest
import torch

import lvt_tpu_torch.ops.attention as tatt
import lvt_tpu_torch.ops.cache_attention as tca

TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (1e-3, 2 ** -7)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype,n,da", [
    (dt, n, da) for dt in (torch.float32, torch.bfloat16)
    for n, da in ((48, 128), (200, 128), (256, 128), (400, 128), (256, 64), (1024, 64))
    if dt == torch.float32 or n <= 256])  # bf16 takes n <= 256 only
def test_block_attention_kernel_matches_plain(cuda, dtype, causal, n, da):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((3, 4, n, da), generator=g, device=cuda).to(dtype)
               for _ in range(3))
    bias = torch.randn((4, n, n), generator=g, device=cuda)
    before = tatt.block_attention_fwd_cuda.launches
    got = tatt.attention_core(q, k, v, bias, causal).float()
    assert tatt.block_attention_fwd_cuda.launches == before + 1
    want = tatt.attention_core_plain(q, k, v, bias, causal).float()
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("live", [1, 100, 256])
@pytest.mark.parametrize("da", [64, 128])
def test_decode_attention_kernel_matches_plain(cuda, dtype, live, da):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((5, 8, da), generator=g, device=cuda).to(dtype)
    kc, vc = (torch.randn((5, 8, 256, da), generator=g, device=cuda).to(dtype)
              for _ in range(2))
    kc[:, :, live:] = float("nan")  # rows >= live are never read
    vc[:, :, live:] = float("nan")
    bias = torch.randn((8, 256), generator=g, device=cuda)
    before = tca.decode_attention_cuda.launches
    got = tca.decode_attention(q, kc, vc, live, bias, da ** -0.5).float()
    assert tca.decode_attention_cuda.launches == before + 1
    want = tca.decode_attention_plain(q, kc, vc, live, bias, da ** -0.5).float()
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.randn((2, 2, 16, 32), device=cuda)  # da = 32: no kernel
    with pytest.raises(ValueError):
        tatt.block_attention_fwd_cuda(q, q, q, torch.zeros((2, 16, 16), device=cuda), False)
    q = torch.randn((2, 2, 16, 128), device=cuda)
    with pytest.raises(ValueError):  # bias must be fp32
        tatt.block_attention_fwd_cuda(q, q, q, torch.zeros((2, 16, 16), device=cuda,
                                                           dtype=torch.bfloat16), False)
    qb = torch.randn((1, 2, 400, 128), device=cuda).to(torch.bfloat16)
    with pytest.raises(ValueError):  # bf16 blocks wider than 256
        tatt.block_attention_fwd_cuda(qb, qb, qb, torch.zeros((2, 400, 400), device=cuda), False)
    with pytest.raises(ValueError):  # live beyond the cache
        tca.decode_attention_cuda(q[:, :, 0], q, q, 17, torch.zeros((2, 16), device=cuda), 0.1)
    flat = torch.randn(2 * 2 * 16 * 128 + 1, device=cuda)
    odd = flat[1:].view(2, 2, 16, 128)  # contiguous, but 4 bytes past a 16-byte boundary
    with pytest.raises(ValueError):
        tatt.block_attention_fwd_cuda(odd, odd, odd, torch.zeros((2, 16, 16), device=cuda), False)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype,nb,n,da", [
    (dt, nb, n, da) for dt in (torch.float32, torch.bfloat16)
    for nb, n, da in ((3, 48, 128), (2, 200, 64), (4, 256, 128), (2, 400, 128), (1, 1024, 64))
    if dt == torch.float32 or n <= 256])
def test_block_attention_bwd_kernel_matches_plain(cuda, dtype, causal, nb, n, da):
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v, go = (torch.randn((nb, 4, n, da), generator=g, device=cuda).to(dtype)
                   for _ in range(4))
    bias = 0.5 * torch.randn((4, n, n), generator=g, device=cuda)
    before = tatt.block_attention_bwd_cuda.launches
    got = tatt.block_attention_bwd_cuda(q, k, v, bias, go, causal)
    assert tatt.block_attention_bwd_cuda.launches == before + 1
    want = tatt.attention_core_bwd_plain(q, k, v, bias, go, causal)
    for name, a, b in zip(("dq", "dk", "dv"), got[:3], want[:3]):
        assert a.dtype == dtype, name
        atol, rtol = TOL[dtype]
        if dtype == torch.bfloat16:
            atol = 2 ** -8 * float(b.float().abs().max())
        torch.testing.assert_close(a.float(), b.float(), atol=atol, rtol=rtol, msg=name)
    assert got[3].dtype == torch.float32
    torch.testing.assert_close(got[3], want[3], atol=1e-4, rtol=1e-5, msg="dbias")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_attention_bwd_is_deterministic(cuda, dtype):
    """Two calls on the same inputs give bit-identical dq, dk, dv and dbias
    (dbias sums its nb terms in a fixed order, with no atomics)."""
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v, go = (torch.randn((64, 8, 256, 128), generator=g, device=cuda).to(dtype)
                   for _ in range(4))
    bias = torch.randn((8, 256, 256), generator=g, device=cuda)
    first = tatt.block_attention_bwd_cuda(q, k, v, bias, go, True)
    second = tatt.block_attention_bwd_cuda(q, k, v, bias, go, True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_gradients_flow_through_kernel_1(cuda):
    """The attention of a layer on the card is differentiable through
    kernels 1 and 10: every parameter gets its gradient (wq, wk, wv and the
    attention LayerNorm only through the attention), equal to the plain
    path's on the CPU (fp32: 1e-4 of each leaf's largest gradient, floored
    at 1e-2 of the largest gradient of all leaves: each bank entry sums
    thousands of dbias terms that partly cancel)."""
    from lvt_tpu_torch.models.vt import init_block_attn
    from lvt_tpu_torch.ops.attention import block_local_attention

    # two frames per block: a one-frame block's dt bank has one entry, whose
    # gradient sums softmax gradient rows to exactly zero (float noise)
    block = (2, 8, 8)
    p_cpu = init_block_attn(torch.Generator().manual_seed(0), block, 2, 128, 64)
    # nonzero banks and LN bias, so no gradient is zero by symmetry
    for key in ("dt_bank", "dh_bank", "dw_bank", "ln_bias"):
        p_cpu[key] = 0.1 * torch.randn(p_cpu[key].shape, generator=torch.Generator().manual_seed(1))
    x = torch.randn((2, 2, 8, 8, 128), generator=torch.Generator().manual_seed(2))
    grads = {}
    for dev in ("cpu", "cuda"):
        p = {k: v.detach().to(dev).requires_grad_(True) for k, v in p_cpu.items()}
        before = (tatt.block_attention_fwd_cuda.launches, tatt.block_attention_bwd_cuda.launches)
        out = block_local_attention(x.to(dev), p, block, True)
        (out * torch.linspace(-1, 1, out.numel(), device=dev).reshape(out.shape)).sum().backward()
        if dev == "cuda":
            assert (tatt.block_attention_fwd_cuda.launches,
                    tatt.block_attention_bwd_cuda.launches) == (before[0] + 1, before[1] + 1)
        grads[dev] = {k: v.grad for k, v in p.items()}
    floor = 1e-2 * max(float(w.abs().max()) for w in grads["cpu"].values())
    for k, want in grads["cpu"].items():
        got = grads["cuda"][k]
        assert got is not None, k
        bound = 1e-4 * max(float(want.abs().max()), floor)
        assert float((got.cpu() - want).abs().max()) <= bound, k


@pytest.mark.cuda
def test_bwd_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q = torch.randn((2, 2, 16, 128), device=cuda)
    bias = torch.zeros((2, 16, 16), device=cuda)
    with pytest.raises(ValueError):  # g of another dtype
        tatt.block_attention_bwd_cuda(q, q, q, bias, q.to(torch.bfloat16), False)
    with pytest.raises(ValueError):  # g of another shape
        tatt.block_attention_bwd_cuda(q, q, q, bias, q[:1], False)
    q32 = torch.randn((2, 2, 16, 32), device=cuda)
    with pytest.raises(ValueError):  # da = 32
        tatt.block_attention_bwd_cuda(q32, q32, q32, bias, q32, False)
    qb = torch.randn((1, 2, 400, 128), device=cuda).to(torch.bfloat16)
    with pytest.raises(ValueError):  # bf16 blocks wider than 256
        tatt.block_attention_bwd_cuda(qb, qb, qb, torch.zeros((2, 400, 400), device=cuda), qb,
                                      False)
    with pytest.raises(ValueError):  # a CPU cotangent
        tatt.block_attention_bwd_cuda(q, q, q, bias, q.cpu(), False)


# --------------------------------------------------------------------------
# The fused layer: kernels 7, 8 and 9 (ops/fused_layer.py)
# --------------------------------------------------------------------------
# Tolerances, |kernel - plain| relative to the output's largest value: fp32
# 2e-5 (sums of up to 3,072 fp32 terms in another order; 1e-4 for the sums
# over all rows); bf16 2^-6 (one bf16 rounding of the output, plus
# intermediates such as qkv, P, f or ds rounded to the other side of a bf16
# boundary where the two versions' fp32 values differ by an ulp).

FUSED_TOL = {torch.float32: 2e-5, torch.bfloat16: 2 ** -6}
FUSED_SHAPES = [  # nb, block, na, d, da
    (3, (1, 5, 4), 2, 64, 64), (2, (2, 4, 4), 2, 128, 128), (2, (1, 8, 5), 3, 512, 64),
    (4, (1, 16, 16), 8, 512, 128)]


def _fused_inputs(cuda, dtype, nb, block, na, d, da, seed=0):
    from lvt_tpu_torch.models.vt import init_block_attn

    g = torch.Generator().manual_seed(seed)
    p = init_block_attn(g, block, na, d, da)
    p = {k: (v + 0.1 * torch.randn(v.shape, generator=g)).to(cuda, dtype) for k, v in p.items()}
    n = block[0] * block[1] * block[2]
    tok, go = (torch.randn((nb, n, d), generator=g).to(cuda, dtype) for _ in range(2))
    bias = (tatt.relative_bias(p["dt_bank"], p["dh_bank"], p["dw_bank"], block).float()
            + 0.3 * torch.randn((na, n, n), generator=g).to(cuda))
    return p, tok, go, bias.contiguous()


def _fused_close(name, got, want, tol):
    assert got.dtype == want.dtype and got.shape == want.shape, name
    got, want = got.float(), want.float()
    assert bool(torch.isfinite(got).all()), name
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    assert err <= tol * max(scale, 1e-3), f"{name}: max abs err {err:.3g} at scale {scale:.3g}"


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nb,block,na,d,da", FUSED_SHAPES)
def test_fused_layer_kernels_match_plain(cuda, dtype, causal, nb, block, na, d, da):
    import lvt_tpu_torch.ops.fused_layer as tfl

    p, tok, go, bias = _fused_inputs(cuda, dtype, nb, block, na, d, da)
    tol = FUSED_TOL[dtype]
    before = (tfl.fused_layer_fwd_cuda.launches, tfl.ffn_half_bwd_cuda.launches,
              tfl.attn_half_bwd_cuda.launches)
    out, x2 = tfl.fused_layer_tokens(tok, p, bias, causal, with_x2=True)
    alone = tfl.fused_layer_tokens(tok, p, bias, causal)
    want_out, want_x2 = tfl.fused_layer_tokens_plain(tok, p, bias, causal, with_x2=True)
    _fused_close("out", out, want_out, tol)
    _fused_close("x2", x2, want_x2, tol)
    assert torch.equal(out, alone)
    got = tfl.ffn_half_bwd(want_x2, go, p)
    want = tfl.ffn_half_bwd_plain(want_x2, go, p)
    for name, a, b in zip(("dx2", "dw1", "db1", "dw2", "db2", "dls", "dlb"), got, want):
        _fused_close(name, a, b, 5 * tol if dtype == torch.float32 and name != "dx2" else tol)
    groups = [(0, na)] + ([(0, na // 2), (na // 2, na)] if na > 1 else [])
    for h0, h1 in groups:
        got = tfl.attn_half_bwd(tok, want[0], p, bias, causal, h0, h1)
        want9 = tfl.attn_half_bwd_plain(tok, want[0], p, bias, causal, h0, h1)
        for name, a, b in zip(("dy", "dwqkv", "dproj", "dbias"), got, want9):
            _fused_close(f"{name}[{h0}:{h1}]", a, b,
                         5 * tol if dtype == torch.float32 and name != "dy" else tol)
    assert (tfl.fused_layer_fwd_cuda.launches, tfl.ffn_half_bwd_cuda.launches,
            tfl.attn_half_bwd_cuda.launches) == (before[0] + 2, before[1] + 1,
                                                 before[2] + len(groups))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_layer_kernels_are_deterministic(cuda, dtype):
    """Two calls on the same inputs at the DSFVT training shape give
    bit-identical outputs: the sums over the rows have a fixed order."""
    import lvt_tpu_torch.ops.fused_layer as tfl

    p, tok, go, bias = _fused_inputs(cuda, dtype, 64, (1, 16, 16), 8, 512, 128)
    runs = []
    for _ in range(2):
        out, x2 = tfl.fused_layer_tokens(tok, p, bias, True, with_x2=True)
        k8 = tfl.ffn_half_bwd(x2, go, p)
        k9 = tfl.attn_half_bwd(tok, k8[0], p, bias, True, 0, 8)
        runs.append((out, x2, *k8, *k9))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_fused_block_layer_gradients_on_the_card(cuda, causal):
    """fused_block_layer on the card (kernels 7, 8, 9) against the same
    Function on the CPU (their plain versions), fp32: the value, and every
    gradient within 1e-4 of its largest value (floored at 1e-2 of the
    largest gradient of all)."""
    import lvt_tpu_torch.ops.fused_layer as tfl

    block = (2, 8, 8)
    p_dev, tok, _, _ = _fused_inputs(cuda, torch.float32, 3, block, 2, 128, 64, seed=3)
    res = {}
    for dev in ("cpu", "cuda"):
        p = {k: v.detach().to(dev).requires_grad_(True) for k, v in p_dev.items()}
        t = tok.detach().to(dev).requires_grad_(True)
        before = (tfl.fused_layer_fwd_cuda.launches, tfl.ffn_half_bwd_cuda.launches,
                  tfl.attn_half_bwd_cuda.launches)
        bias = tatt.relative_bias(p["dt_bank"], p["dh_bank"], p["dw_bank"], block)
        out = tfl.fused_block_layer(t, p, bias, causal)
        (out * torch.linspace(-1, 1, out.numel(), device=dev).reshape(out.shape)).sum().backward()
        if dev == "cuda":
            assert (tfl.fused_layer_fwd_cuda.launches, tfl.ffn_half_bwd_cuda.launches,
                    tfl.attn_half_bwd_cuda.launches) == tuple(b + 1 for b in before)
        res[dev] = (out.detach().cpu(), {**{k: v.grad.cpu() for k, v in p.items()},
                                         "tok": t.grad.cpu()})
    _fused_close("out", res["cuda"][0], res["cpu"][0], 2e-5)
    floor = 1e-2 * max(float(w.abs().max()) for w in res["cpu"][1].values())
    for k, want in res["cpu"][1].items():
        bound = 1e-4 * max(float(want.abs().max()), floor)
        assert float((res["cuda"][1][k] - want).abs().max()) <= bound, k


@pytest.mark.cuda
def test_fused_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    import lvt_tpu_torch.ops.fused_layer as tfl

    p, tok, go, bias = _fused_inputs(cuda, torch.float32, 2, (1, 4, 4), 2, 64, 64)
    with pytest.raises(ValueError):  # parameters of another dtype
        tfl.fused_layer_fwd_cuda(tok.to(torch.bfloat16), p, bias, False)
    with pytest.raises(ValueError):  # a bf16 bias
        tfl.fused_layer_fwd_cuda(tok, p, bias.to(torch.bfloat16), False)
    with pytest.raises(ValueError):  # a cotangent of another shape
        tfl.ffn_half_bwd_cuda(tok, go[:1], p)
    with pytest.raises(ValueError):  # a head range outside the layer
        tfl.attn_half_bwd_cuda(tok, go, p, bias, False, 1, 3)
    with pytest.raises(ValueError):  # a CPU input
        tfl.fused_layer_fwd_cuda(tok.cpu(), p, bias, False)
    p96, tok96, _, bias96 = _fused_inputs(cuda, torch.float32, 2, (1, 4, 4), 2, 96, 64)
    with pytest.raises(ValueError):  # d not a multiple of 64
        tfl.fused_layer_fwd_cuda(tok96, p96, bias96, False)
