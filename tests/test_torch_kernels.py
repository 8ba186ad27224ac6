"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card. Marked ``cuda``: where torch.cuda.is_available() is false they
skip. This file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Tolerances, |kernel - plain| on the same inputs: fp32 1e-4 absolute (sums
in another order only); bf16 1e-3 + 2^-7 relative (plus one bf16 rounding of
the output, and of P where the two versions land on either side of a
rounding boundary)."""

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
