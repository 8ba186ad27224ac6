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
