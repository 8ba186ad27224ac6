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

torch.set_num_threads(1)  # one intra-op thread: the test workers share the cores

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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("live", [1, 3, 100, 256])
@pytest.mark.parametrize("b", [1, 8, 16, 32])
@pytest.mark.parametrize("da", [64, 128])
def test_decode_attention_cluster_matches_plain(cuda, dtype, live, b, da):
    """Kernel 2 at the rollout's batch sizes, whose clusters are 16, 4 and 2
    blocks up to 128 live rows and 16, 8 and 4 above (decode_plan), and at
    b = 32 (one block, then 2): live = 1 and 3 leave ranks empty, 100 is no
    multiple of the cluster. One launch per call, rows >= live never read,
    two calls bit-identical."""
    g = torch.Generator(device=cuda).manual_seed(b * 1000 + live)
    q = torch.randn((b, 8, da), generator=g, device=cuda).to(dtype)
    kc, vc = (torch.randn((b, 8, 256, da), generator=g, device=cuda).to(dtype)
              for _ in range(2))
    kc[:, :, live:] = float("nan")
    vc[:, :, live:] = float("nan")
    bias = torch.randn((8, 256), generator=g, device=cuda)
    before = tca.decode_attention_cuda.launches
    got = tca.decode_attention(q, kc, vc, live, bias, da ** -0.5)
    assert tca.decode_attention_cuda.launches == before + 1
    again = tca.decode_attention(q, kc, vc, live, bias, da ** -0.5)
    assert torch.equal(got, again)
    want = tca.decode_attention_plain(q, kc, vc, live, bias, da ** -0.5).float()
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=rtol)


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
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n,da", [(48, 64), (50, 128), (200, 64), (256, 64)])
def test_block_attention_bf16_kernels_take_other_widths(cuda, causal, n, da):
    """The bf16 kernels at the widths the DSFVT cases above leave out: da 64
    at each n, and n = 50, whose bias rows TMA cannot take (their stride is
    not a multiple of 16 bytes), so kernel 1 reads them from device memory."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v, go = (torch.randn((3, 2, n, da), generator=g, device=cuda).to(torch.bfloat16)
                   for _ in range(4))
    bias = 0.5 * torch.randn((2, n, n), generator=g, device=cuda)
    atol, rtol = TOL[torch.bfloat16]
    torch.testing.assert_close(tatt.block_attention_fwd_cuda(q, k, v, bias, causal).float(),
                               tatt.attention_core_plain(q, k, v, bias, causal).float(),
                               atol=atol, rtol=rtol)
    got = tatt.block_attention_bwd_cuda(q, k, v, bias, go, causal)
    want = tatt.attention_core_bwd_plain(q, k, v, bias, go, causal)
    for name, a, b in zip(("dq", "dk", "dv"), got[:3], want[:3]):
        torch.testing.assert_close(a.float(), b.float(), atol=2 ** -8 * float(b.float().abs().max()),
                                   rtol=rtol, msg=name)
    torch.testing.assert_close(got[3], want[3], atol=1e-4, rtol=1e-5, msg="dbias")


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("nb", [1, 3, 130])
def test_block_attention_bwd_dbias_runs(cuda, causal, nb):
    """bf16 dbias goes through min(nb, 8) planes, each the sum of a fixed
    run of attention blocks: runs of one block (nb = 1, 3) and runs of 16
    and 17 blocks (nb = 130) agree with the plain sum over all blocks."""
    g = torch.Generator(device=cuda).manual_seed(4)
    q, k, v, go = (torch.randn((nb, 2, 256, 128), generator=g, device=cuda).to(torch.bfloat16)
                   for _ in range(4))
    bias = 0.5 * torch.randn((2, 256, 256), generator=g, device=cuda)
    got = tatt.block_attention_bwd_cuda(q, k, v, bias, go, causal)
    want = tatt.attention_core_bwd_plain(q, k, v, bias, go, causal)
    scale = float(want[3].abs().max())
    torch.testing.assert_close(got[3], want[3], atol=1e-4 * max(1.0, scale), rtol=1e-5,
                               msg="dbias")
    again = tatt.block_attention_bwd_cuda(q, k, v, bias, go, causal)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_attention_fwd_is_deterministic(cuda, dtype):
    """Two calls of kernel 1 on the same inputs give bit-identical output."""
    g = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn((16, 8, 256, 128), generator=g, device=cuda).to(dtype)
               for _ in range(3))
    bias = torch.randn((8, 256, 256), generator=g, device=cuda)
    for causal in (False, True):
        first = tatt.block_attention_fwd_cuda(q, k, v, bias, causal)
        assert torch.equal(first, tatt.block_attention_fwd_cuda(q, k, v, bias, causal))


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
# The rows of most shapes leave the bf16 products' 128-row tiles part-empty
# (R = 60, 80, 125, 288, 384); n < 128 leaves one part-empty tile a token
# block in the product over the head-major o, and n = 144 a second tile of
# 16 rows; d in {64, 128, 256, 512}, da in {64, 128}.
FUSED_SHAPES = [  # nb, block, na, d, da
    (3, (1, 5, 4), 2, 64, 64), (2, (2, 4, 4), 2, 128, 128), (2, (1, 8, 5), 3, 512, 64),
    (4, (1, 16, 16), 8, 512, 128), (3, (1, 4, 5), 2, 256, 128), (5, (1, 5, 5), 4, 512, 64),
    (3, (2, 8, 8), 1, 256, 64), (2, (1, 12, 12), 3, 512, 128)]
DSFVT_SHAPE = (64, (1, 16, 16), 8, 512, 128)  # the training path's full shape


# the parameters that _fused_inputs perturbs when it leaves the weights at
# their initial scale (as chip_smoke.py phase 7 does)
_NOT_WEIGHTS = ("dt_bank", "dh_bank", "dw_bank", "ln_bias", "ffn_ln_bias", "ffn_b1", "ffn_b2")


def _fused_inputs(cuda, dtype, nb, block, na, d, da, seed=0, noisy_weights=True):
    from lvt_tpu_torch.models.vt import init_block_attn

    g = torch.Generator().manual_seed(seed)
    p = init_block_attn(g, block, na, d, da)
    p = {k: (v + 0.1 * torch.randn(v.shape, generator=g)
             if noisy_weights or k in _NOT_WEIGHTS else v).to(cuda, dtype)
         for k, v in p.items()}
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


def assert_gates_near_ties(gate, y2, p, x2, tol_share=1e-5):
    """Kernel 8's ReLU gate (and the y2 it read) against the plain
    version's: at most one gate in 1 / tol_share (and at most 2 at the
    small shapes) differs, and each that differs is a near-tie of f_pre =
    y2 w1 + b1 in float64. Where the two versions' fp32 f_pre fall on
    either side of 0, the float64 f_pre of the plain version's y2 lies
    within the two versions' y2 difference carried through w1 (the two
    float64 f_pre apart), plus three fp32 summation errors (d 2^-24 sum
    |y2 w1|, b1 included), of 0. Returns the count that differ."""
    import lvt_tpu_torch.ops.fused_layer as tfl

    d = x2.shape[-1]
    y2_plain = tfl._ln_fwd_f32(x2.float(), p["ffn_ln_scale"].float(),
                               p["ffn_ln_bias"].float())[0].to(x2.dtype).reshape(-1, d)
    f_pre = tfl._mm(y2_plain, p["ffn_w1"]) + p["ffn_b1"].float()
    rows, cols = torch.nonzero(gate != (f_pre > 0.0), as_tuple=True)
    assert len(rows) <= max(2, int(tol_share * gate.numel())), (len(rows), gate.numel())
    w1, b1 = p["ffn_w1"].double(), p["ffn_b1"].double()
    for r, c in zip(rows.tolist(), cols.tolist()):
        terms = y2_plain[r].double() * w1[:, c]
        mine = float((y2[r].double() * w1[:, c]).sum() + b1[c])
        theirs = float(terms.sum() + b1[c])
        acc = d * 2 ** -24 * float(terms.abs().sum() + b1[c].abs())
        assert abs(theirs) <= abs(mine - theirs) + 3 * acc, (r, c, mine, theirs, acc)
    return len(rows)


def _kernel8_with_gate(x2, g, p):
    """Kernel 8's outputs, its ReLU gate (rows, d) bool and the LN output y2
    (rows, d) that f_pre was computed from, read from its scratch. In bf16
    the gate is bytes at the end of part_r (after the partials, dy2, mean
    and rstd: ``ffn_bwd_scratch``); in fp32 the kernel keeps it in shared
    memory, and its f = max(f_pre, 0) in acts is positive exactly where the
    gate is set."""
    import lvt_tpu_torch.ops.fused_layer as tfl

    out, acts, part_r = tfl._ffn_half_bwd_launch(x2, g, p)
    rows, d = acts.shape[1:]
    if x2.dtype == torch.float32:
        gate = acts[1] > 0.0
    else:
        gate = part_r[part_r.numel() - rows * d // 4:].view(torch.uint8).reshape(rows, d) != 0
    return list(out), gate, acts[0]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nb,block,na,d,da", FUSED_SHAPES + [DSFVT_SHAPE])
def test_fused_layer_kernels_match_plain(cuda, dtype, causal, nb, block, na, d, da):
    """Kernels 7, 8 and 9 against their plain versions, each called twice:
    the two calls bit-identical (their products share ln_qkv and gemm_tn;
    in bf16 those run on wgmma over row tiles cut per token block). At
    DSFVT's full shape the weights keep their initial scale. Kernel 8's ReLU
    gate is read back and held to the plain version's: among the 8.4 M gates
    of DSFVT's shape a few sit within the two versions' difference of 0
    (their LN statistics, summed in other orders, put a few y2 values on
    either side of a bf16 rounding boundary, which moves f_pre by ~1e-4),
    and one gate flipped moves a whole row of dx2 by up to ~0.2 and a
    column of dw1 by up to ~8 (read on the card: 1-2 rows of dx2 in bf16).
    So the gates that differ are counted and each verified as a float64
    near-tie (``assert_gates_near_ties``), the plain version is run again
    with the kernel's gate, and all seven outputs are held to the bounds of
    every shape."""
    import lvt_tpu_torch.ops.fused_layer as tfl

    full = (nb, block, na, d, da) == DSFVT_SHAPE
    p, tok, go, bias = _fused_inputs(cuda, dtype, nb, block, na, d, da, noisy_weights=not full)
    tol = FUSED_TOL[dtype]
    before = (tfl.fused_layer_fwd_cuda.launches, tfl.ffn_half_bwd_cuda.launches,
              tfl.attn_half_bwd_cuda.launches)
    out, x2 = tfl.fused_layer_tokens(tok, p, bias, causal, with_x2=True)
    alone = tfl.fused_layer_tokens(tok, p, bias, causal)
    want_out, want_x2 = tfl.fused_layer_tokens_plain(tok, p, bias, causal, with_x2=True)
    _fused_close("out", out, want_out, tol)
    _fused_close("x2", x2, want_x2, tol)
    assert torch.equal(out, alone)
    got, gate, y2 = _kernel8_with_gate(want_x2, go, p)
    again = tfl.ffn_half_bwd(want_x2, go, p)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    flips = assert_gates_near_ties(gate, y2, p, want_x2)
    print(f"kernel 8, {dtype}, causal={causal}, nb={nb}, d={d}: {flips} of {gate.numel()} "
          "gates differ from the plain version's, each a float64 near-tie")
    want = tfl._ffn_half_bwd_plain_gated(want_x2, go, p, gate)
    for name, a, b in zip(("dx2", "dw1", "db1", "dw2", "db2", "dls", "dlb"), got, want):
        _fused_close(name, a, b, 5 * tol if dtype == torch.float32 and name != "dx2" else tol)
    groups = [(0, na)] + ([(0, na // 2), (na // 2, na)] if na > 1 else [])
    for h0, h1 in groups:
        got = tfl.attn_half_bwd(tok, want[0], p, bias, causal, h0, h1)
        again = tfl.attn_half_bwd(tok, want[0], p, bias, causal, h0, h1)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        want9 = tfl.attn_half_bwd_plain(tok, want[0], p, bias, causal, h0, h1)
        for name, a, b in zip(("dy", "dwqkv", "dproj", "dbias"), got, want9):
            _fused_close(f"{name}[{h0}:{h1}]", a, b,
                         5 * tol if dtype == torch.float32 and name != "dy" else tol)
    assert (tfl.fused_layer_fwd_cuda.launches, tfl.ffn_half_bwd_cuda.launches,
            tfl.attn_half_bwd_cuda.launches) == (before[0] + 2, before[1] + 2,
                                                 before[2] + 2 * len(groups))


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


# --------------------------------------------------------------------------
# The quantized sampler: kernels 3, 4, 5 (ops/cache_attention.py) and 11
# (ops/quant.py)
# --------------------------------------------------------------------------
# Kernels 3 and 4 against their plain versions: both integer products are
# exact, so the two differ only where exp or the order of the softmax's fp32
# sum puts a weight on the other side of x.5: it then rounds one step apart,
# which moves an output of that (batch row, head) by i8_weight_step * |v8|.
# Bound per output: I8_FLIPS such steps at |v8| = 127, plus 1e-5 of the
# head's largest output (sw itself differs by ulps), plus for bf16 outputs one
# bf16 ulp (2^-7 relative: fp32 values an ulp apart on either side of a
# rounding boundary). And at most I8_ROWS_OFF of the (batch row, head)
# pairs may differ by more than the rounding part alone.
# Kernel 5 keeps everything fp32: sums in another order, 1e-5 of the largest
# output. Kernel 11: every operation is exact or IEEE-rounded the same way on
# both sides, so fp32 outputs agree to 1e-6 relative (bit-equal in practice).

I8_FLIPS, I8_ROWS_OFF = 2, 0.05


def _i8_cache_inputs(cuda, b, na, R, da, scale_dtype, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q8 = torch.randint(-127, 128, (b, na, da), generator=g, device=cuda, dtype=torch.int8)
    sq = 0.01 * torch.rand((b, na), generator=g, device=cuda) + 1e-3
    k8, v8 = (torch.randint(-127, 128, (b, na, R, da), generator=g, device=cuda,
                            dtype=torch.int8) for _ in range(2))
    ks, vs = ((0.02 * torch.rand((b, na, R), generator=g, device=cuda) + 1e-3).to(scale_dtype)
              for _ in range(2))
    bias = 0.5 * torch.randn((na, R), generator=g, device=cuda)
    return q8, sq, k8, ks, v8, vs, bias


def _poison(k8, ks, v8, vs, live):
    """Rows at or past live hold what an earlier block run might have left."""
    k8[:, :, live:], v8[:, :, live:] = 127, -128
    ks[:, :, live:], vs[:, :, live:] = 1e6, 1e6


def assert_i8_close(got, want, step, out_dtype):
    """The bound above; got, want (b, na*da), step (b, na) from i8_weight_step."""
    b, na = step.shape
    got, want = got.float().reshape(b, na, -1), want.float().reshape(b, na, -1)
    assert bool(torch.isfinite(got).all())
    rounding = 1e-5 * want.abs().amax(dim=-1, keepdim=True)
    if out_dtype == torch.bfloat16:
        rounding = rounding + 2 ** -7 * want.abs()
    diff = (got - want).abs()
    assert bool((diff <= I8_FLIPS * 127 * step[:, :, None] + rounding).all()), float(diff.max())
    rows_off = float((diff > rounding).any(dim=-1).float().mean())
    assert rows_off <= I8_ROWS_OFF, rows_off


@pytest.mark.cuda
@pytest.mark.parametrize("live_kernel", [False, True], ids=["kernel3", "kernel4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("live", [1, 64, 100, 200, 256])
@pytest.mark.parametrize("da", [64, 128])
def test_decode_attention_i8_kernels_match_plain(cuda, live_kernel, dtype, live, da):
    b, na, R = 5, 8, 256
    q8, sq, k8, ks, v8, vs, bias = _i8_cache_inputs(cuda, b, na, R, da, dtype)
    _poison(k8, ks, v8, vs, live)
    wrapper = tca.decode_attention_i8_live_cuda if live_kernel else tca.decode_attention_i8_cuda
    fn, plain = ((tca.decode_attention_i8_live, tca.decode_attention_i8_live_plain) if live_kernel
                 else (tca.decode_attention_i8, tca.decode_attention_i8_plain))
    before = wrapper.launches
    got = fn(q8, sq, k8, ks, v8, vs, live, bias, da ** -0.5, dtype)
    assert wrapper.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, na * da)
    want = plain(q8, sq, k8, ks, v8, vs, live, bias, da ** -0.5, dtype)
    step = tca.i8_weight_step(q8, sq, k8, ks, vs, live, bias, da ** -0.5)
    assert_i8_close(got, want, step, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("rtile", [16, 32, 256])
def test_decode_attention_i8_live_kernel_takes_other_tiles(cuda, rtile):
    b, na, R, da, live = 3, 2, 256, 64, 77
    q8, sq, k8, ks, v8, vs, bias = _i8_cache_inputs(cuda, b, na, R, da, torch.float32, seed=1)
    got = tca.decode_attention_i8_live(q8, sq, k8, ks, v8, vs, live, bias, 0.125, rtile=rtile)
    want = tca.decode_attention_i8_live_plain(q8, sq, k8, ks, v8, vs, live, bias, 0.125,
                                              rtile=rtile)
    step = tca.i8_weight_step(q8, sq, k8, ks, vs, live, bias, 0.125)
    assert_i8_close(got, want, step, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("live_kernel", [False, True], ids=["kernel3", "kernel4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("live", [1, 63, 64, 65, 128, 200, 256])
@pytest.mark.parametrize("b", [1, 8, 16])
@pytest.mark.parametrize("da", [64, 128])
def test_decode_attention_i8_clusters_match_plain(cuda, live_kernel, dtype, live, b, da):
    """Kernels 3 and 4 at the rollout's batch sizes, whose plans
    (decode_i8_plan, decode_i8_live_plan) range from one block of 4 or 8
    warps to a cluster of 4 per (batch row, head), each rank's rows read
    into registers: one launch per call, rows >= live poisoned and never
    read, two calls bit-identical."""
    na, R = 8, 256
    q8, sq, k8, ks, v8, vs, bias = _i8_cache_inputs(cuda, b, na, R, da, dtype,
                                                    seed=100 * b + live)
    _poison(k8, ks, v8, vs, live)
    wrapper = tca.decode_attention_i8_live_cuda if live_kernel else tca.decode_attention_i8_cuda
    plain = tca.decode_attention_i8_live_plain if live_kernel else tca.decode_attention_i8_plain
    before = wrapper.launches
    got = wrapper(q8, sq, k8, ks, v8, vs, live, bias, da ** -0.5, dtype)
    assert wrapper.launches == before + 1
    assert torch.equal(wrapper(q8, sq, k8, ks, v8, vs, live, bias, da ** -0.5, dtype), got)
    want = plain(q8, sq, k8, ks, v8, vs, live, bias, da ** -0.5, dtype)
    step = tca.i8_weight_step(q8, sq, k8, ks, vs, live, bias, da ** -0.5)
    assert_i8_close(got, want, step, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("live_kernel,R,live,rtile", [
    (False, 4096, 3000, 64), (False, 4096, 4096, 64), (True, 512, 300, 256),
    (True, 512, 512, 256), (True, 4096, 2500, 16)])
def test_decode_attention_i8_long_caches_take_the_ring(cuda, live_kernel, R, live, rtile):
    """Ranges longer than a rank's registers hold arrive through the ring of
    bulk copies, with a cluster exchange: kernel 3 at 16 ranks of 192 or 256
    rows, kernel 4 at 2 ranks of one 256-row tile and at 16 ranks of ten
    16-row tiles."""
    b, na, da = 2, 2, 128
    q8, sq, k8, ks, v8, vs, bias = _i8_cache_inputs(cuda, b, na, R, da, torch.bfloat16, seed=R)
    _poison(k8, ks, v8, vs, live)
    if live_kernel:
        plan = tca.decode_i8_live_plan(live, rtile, da)
        got = tca.decode_attention_i8_live_cuda(q8, sq, k8, ks, v8, vs, live, bias, 0.1,
                                                rtile=rtile)
        want = tca.decode_attention_i8_live_plain(q8, sq, k8, ks, v8, vs, live, bias, 0.1,
                                                  rtile=rtile)
    else:
        plan = tca.decode_i8_plan(live, da)
        got = tca.decode_attention_i8_cuda(q8, sq, k8, ks, v8, vs, live, bias, 0.1)
        want = tca.decode_attention_i8_plain(q8, sq, k8, ks, v8, vs, live, bias, 0.1)
    assert plan[0] > 1 and not plan[-1]  # a cluster, and no direct read
    step = tca.i8_weight_step(q8, sq, k8, ks, vs, live, bias, 0.1)
    assert_i8_close(got, want, step, torch.bfloat16)


def _step_inputs(cuda, b, na, R, da, dtype, live, seed, rows="randn"):
    """q and the new rows as views of one (b, 3, na, da) product, as the
    sampler passes them, over a poisoned cache. With rows="halves", each
    row's absmax is 127 (scale 1: the quotients are the values themselves)
    and the rest sit at x.5 and next to it, which the roundings must meet as
    PyTorch does; "tiny" rows have scales of the order of the 1e-8 that the
    divisions add."""
    _, _, k8, ks, v8, vs, bias = _i8_cache_inputs(cuda, b, na, R, da, dtype, seed=seed)
    _poison(k8, ks, v8, vs, live)
    g = torch.Generator(device=cuda).manual_seed(seed + 1)
    qkv = torch.randn((b, 3, na, da), generator=g, device=cuda)
    if rows == "halves":
        pick = torch.randint(-126, 126, (b, 3, na, da), generator=g, device=cuda).float() + 0.5
        qkv = pick + torch.tensor([0.0, 2 ** -10, -2 ** -10], device=cuda)[
            torch.randint(0, 3, (b, 3, na, da), generator=g, device=cuda)]
        qkv[..., 0] = 127.0
    elif rows == "tiny":  # scales near 1e-8, which the division's + 1e-8 then moves
        qkv = qkv * 1e-7
    return qkv.to(dtype), k8, ks, v8, vs, bias


@pytest.mark.cuda
@pytest.mark.parametrize("live_kernel", [False, True], ids=["kernel3", "kernel4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("live", [1, 64, 65, 200, 256])
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("rows", ["randn", "halves", "tiny"])
def test_decode_attention_i8_step_equals_the_pytorch_sequence(cuda, live_kernel, dtype, live, b,
                                                              rows):
    """The fused entries: q8, sq, the new cache rows and their scales equal
    the plain composite's (quantize_rows_i8, quantize_cache_row, the row
    writes) bit for bit, the rest of the cache is untouched, and the output
    is the unfused kernel's function within its bound. One launch a call."""
    na, R, da = 8, 256, 128
    qkv, k8, ks, v8, vs, bias = _step_inputs(cuda, b, na, R, da, dtype, live, 7 * live + b,
                                             rows)
    step = tca.decode_attention_i8_live_step_cuda if live_kernel \
        else tca.decode_attention_i8_step_cuda
    plain = tca.decode_attention_i8_live_step_plain if live_kernel \
        else tca.decode_attention_i8_step_plain
    dispatch = tca.decode_attention_i8_live_step if live_kernel else tca.decode_attention_i8_step
    mine = [t.clone() for t in (k8, ks, v8, vs)]
    theirs = [t.clone() for t in (k8, ks, v8, vs)]
    before = step.launches
    got, q8, sq = step(qkv[:, 0], qkv[:, 1:], *mine, live, bias, da ** -0.5, dtype, q_out=True)
    assert step.launches == before + 1
    want, q8_want, sq_want = plain(qkv[:, 0], qkv[:, 1:], *theirs, live, bias, da ** -0.5, dtype,
                                   q_out=True)
    assert torch.equal(q8, q8_want) and torch.equal(sq, sq_want)
    for a, w in zip(mine, theirs):  # the new row, and nothing else, written
        assert torch.equal(a, w)
    step_size = tca.i8_weight_step(q8_want, sq_want, *theirs[:2], theirs[3], live, bias,
                                   da ** -0.5)
    assert_i8_close(got, want, step_size, dtype)
    again = [t.clone() for t in (k8, ks, v8, vs)]
    assert torch.equal(dispatch(qkv[:, 0], qkv[:, 1:], *again, live, bias, da ** -0.5, dtype),
                       got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("live", [1, 100, 256])
@pytest.mark.parametrize("da,eb", [(64, 1), (128, 5)])
def test_cache_attention_i8_kernel_matches_plain(cuda, dtype, live, da, eb):
    b, na, R = 5, 8, 256
    _, _, k8, ks, v8, vs, _ = _i8_cache_inputs(cuda, b, na, R, da, torch.float32, seed=2)
    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn((b, na, da), generator=g, device=cuda).to(dtype)
    extra = torch.randn((eb, na, R), generator=g, device=cuda)
    k8[:, :, live:], v8[:, :, live:] = 127, -128
    before = tca.cache_attention_i8_cuda.launches
    got = tca.cache_attention_i8(q, k8, ks, v8, vs, extra, da ** -0.5, live)
    assert tca.cache_attention_i8_cuda.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, na, da)
    want = tca.cache_attention_i8_plain(q, k8, ks, v8, vs, extra, da ** -0.5, live)
    atol = 1e-5 * float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=2 ** -7 if dtype == torch.bfloat16 else 0)
    if live == R:  # no live length: the whole buffer
        assert torch.equal(tca.cache_attention_i8(q, k8, ks, v8, vs, extra, da ** -0.5), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,K,N", [(1, 512, 3072), (8, 512, 512), (8, 1024, 512), (5, 64, 40),
                                   (19, 2048, 33), (16, 512, 3072), (16, 1024, 512),
                                   (16, 512, 512), (8, 1040, 512), (3, 16384, 7)])
def test_matmul_i8w_kernel_matches_plain(cuda, dtype, b, K, N):
    import lvt_tpu_torch.ops.quant as tq

    g = torch.Generator(device=cuda).manual_seed(4)
    y = torch.randn((b, K), generator=g, device=cuda).to(dtype)
    wi, sw = tq.quantize_cols(torch.randn((K, N), generator=g, device=cuda).to(dtype), dtype)
    wt = wi.t().contiguous()
    before = tq.matmul_i8w_cuda.launches
    got = tq.matmul_i8w(y, wt, sw, dtype)
    assert tq.matmul_i8w_cuda.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, N)
    want = tq.matmul_i8w_plain(y, wt, sw, dtype)
    torch.testing.assert_close(got.float(), want.float(), atol=1e-6 * float(want.float().abs().max()),
                               rtol=2 ** -7 if dtype == torch.bfloat16 else 1e-6)
    assert torch.equal(got, want)  # the integer sum is exact: bit-equal at every grid
    # the other weight mode of the sampler is another function: no activation rounding
    other = ((y @ wi.to(dtype)) * sw).float()
    assert float((other - want.float()).abs().max()) > 1e-4 * float(want.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_i8w_kernel_rounds_at_half_integers_as_plain(cuda, dtype):
    """Rows whose scale is 1 (absmax 127): every x / (s + 1e-8) is x itself,
    so values at and next to half-integers test the kernel's rounding (half
    to even, the true quotient where x r lies near a half) against the plain
    version's division, bit for bit."""
    import lvt_tpu_torch.ops.quant as tq

    g = torch.Generator(device=cuda).manual_seed(11)
    K, N = 512, 64
    halves = torch.arange(-126, 127, device=cuda, dtype=torch.float32) + 0.5
    y = torch.empty((8, K), device=cuda)
    y[:, 0] = 127.0
    y[:, 1:] = halves[torch.randint(0, len(halves), (8, K - 1), generator=g, device=cuda)]
    y[1:4, 1:] += torch.tensor([-2 ** -17, 2 ** -17, 2 ** -16], device=cuda)[:, None]
    y = y.to(dtype)
    wi, sw = tq.quantize_cols(torch.randn((K, N), generator=g, device=cuda).to(dtype), dtype)
    wt = wi.t().contiguous()
    got = tq.matmul_i8w(y, wt, sw, dtype)
    assert torch.equal(got, tq.matmul_i8w_plain(y, wt, sw, dtype))


# DSFVT's four products on one rank of a model group of 2 (b 8): qkv and FFN 1
# split by columns, proj and FFN 2 by rows (these take row_amax)
I8W_SHARD_SHAPES = [(8, 512, 768), (8, 512, 256), (8, 256, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("out", ["io", "float32", "int32"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,K,N", I8W_SHARD_SHAPES + [(19, 1040, 40), (3, 2048, 7)])
def test_matmul_i8w_row_amax_matches_plain(cuda, dtype, out, b, K, N):
    """Kernel 11 with and without row_amax at a tensor-parallel rank's
    shapes (and past one block's rows, past the rows held in registers),
    each bit-equal to its plain version, with the output in the io dtype,
    fp32 or int32 (the unscaled sums of a row-split product). row_amax
    equal to the rows' own absmax gives the kernel's own output; a larger
    one, the group's, scales each row by it."""
    import lvt_tpu_torch.ops.quant as tq

    g = torch.Generator(device=cuda).manual_seed(23)
    out_dtype = {"io": dtype, "float32": torch.float32, "int32": torch.int32}[out]
    y = torch.randn((b, K), generator=g, device=cuda).to(dtype)
    wi, sw = tq.quantize_cols(torch.randn((K, N), generator=g, device=cuda).to(dtype), dtype)
    wt = wi.t().contiguous()
    own = y.abs().amax(dim=-1).float()
    group = own * (1.0 + 3.0 * torch.rand((b,), generator=g, device=cuda))
    plain = tq.matmul_i8w_plain(y, wt, sw, out_dtype)
    for amax, want in ((None, plain), (own, plain),
                       (group, tq.matmul_i8w_plain(y, wt, sw, out_dtype, row_amax=group))):
        before = tq.matmul_i8w_cuda.launches
        got = tq.matmul_i8w(y, wt, sw, out_dtype, row_amax=amax)
        assert tq.matmul_i8w_cuda.launches == before + 1
        assert got.dtype == out_dtype and got.shape == (b, N)
        assert torch.equal(got, want)
    assert not torch.equal(want, plain)  # the group's scale moves the output


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,K,N", [(8, 512, 512), (8, 1024, 512), (19, 1056, 40)])
def test_matmul_i8w_row_split_sums_to_the_whole_product(cuda, dtype, b, K, N):
    """A product split in two over its input rows, as a model group of 2
    computes proj and FFN 2 (ops/quant.py matmul_i8w_split without the
    collectives): each half's int32 sums given the whole row's absmax, added,
    then scaled as the kernel's epilogue scales, equal the kernel's output
    on the whole rows bit for bit."""
    import lvt_tpu_torch.ops.quant as tq

    g = torch.Generator(device=cuda).manual_seed(29)
    y = torch.randn((b, K), generator=g, device=cuda).to(dtype)
    wi, sw = tq.quantize_cols(torch.randn((K, N), generator=g, device=cuda).to(dtype), dtype)
    amax = y.abs().amax(dim=-1).float()
    acc = sum(tq.matmul_i8w(y[:, h].contiguous(), wi[h].t().contiguous(), sw, torch.int32,
                            row_amax=amax) for h in (slice(0, K // 2), slice(K // 2, K)))
    got = (acc.float() * tq.absmax_scale(amax)[:, None] * sw.float()).to(dtype)
    assert torch.equal(got, tq.matmul_i8w(y, wi.t().contiguous(), sw, dtype))


def _card_vt(stride=(4, 1, 1), kernel=(3, 1, 1), blocks=(1, 8, 8), T=4):
    """A small VT whose decoder the card's kernels take (da = 64, d = 128),
    on an 8x8 grid, and its fp32 weights from a seed."""
    from lvt_tpu_torch.config import get_cfg
    from lvt_tpu_torch.models.vt import VideoTransformer

    cfg = get_cfg()
    v = cfg.MODEL.AUTOREGRESSIVE.VT
    v.NC, v.NV, v.D, v.DA, v.DE = 2, 16, 128, 64, 32
    v.STRIDE, v.KERNEL = stride, kernel
    v.BLOCKS_E = v.BLOCKS_D = (blocks,) * 2
    v.N_HEAD_E = v.N_HEAD_D = (2, 2)
    vt = VideoTransformer(cfg, T=T, H=8, W=8)
    params, _ = vt.init(torch.Generator().manual_seed(0))
    return vt, params


@pytest.mark.cuda
def test_quantized_sampler_on_the_card_matches_the_cpu(cuda):
    """One slice, teacher-forced, fp32, in every quantized mode: the card
    (kernels 3, 4 with the fold, one launch per layer and pixel, and 11; in
    the int8 KV `xla`, `mm_dtype` int8 and `weight_dtype` int8 modes PyTorch's
    CUDA ops) against the plain path on the CPU. The two sides'
    fp32 activations differ by rounding, so a few of the ~65,000 values
    that are rounded to int8 on the way sit at a near-tie and round one
    step apart; the bound is half the mode's own gap to the native sampler,
    which is what ~65,000 such steps add up to."""
    import numpy as np

    from lvt_tpu_torch.models import to_device
    from lvt_tpu_torch.models.vt import vt_encode
    from lvt_tpu_torch.models.vt_incremental import sample_slice_incremental
    import lvt_tpu_torch.ops.quant as tq

    vt, params = _card_vt()
    video = torch.from_numpy(np.random.default_rng(0).integers(0, 16, (2, 2, 4, 8, 8)))
    modes = {"pallas": dict(kv_dtype="int8", attn_impl="pallas"),
             "pallas-live": dict(kv_dtype="int8", attn_impl="pallas-live"),
             "int8-pallas": dict(kv_dtype="int8", attn_impl="pallas", weight_dtype="int8-pallas"),
             "xla": dict(kv_dtype="int8"),
             "xla-mm8": dict(kv_dtype="int8", mm_dtype="int8"),
             "int8": dict(weight_dtype="int8"),
             "int4": dict(kv_dtype="int4")}
    out = {}
    for dev in ("cpu", "cuda"):
        p = to_device(params, dev)["netG"]
        sidx = torch.full((2,), 2, dtype=torch.int64, device=dev)
        ctx, sl, _ = vt.prepare_slices(video.to(dev), sidx)
        with torch.no_grad():
            zl = vt_encode(p, vt.c, ctx, sidx)
            run = lambda **k: sample_slice_incremental(
                p, vt.c, vt.plan.slice_shape, zl, sl, None, np.ones(64, bool), 1.0,
                teacher_logits=True, **k)[1].cpu()
            out[dev, "native"] = run()
            for name, knobs in modes.items():
                before = (tca.decode_attention_i8_step_cuda.launches,
                          tca.decode_attention_i8_live_step_cuda.launches,
                          tq.matmul_i8w_cuda.launches)
                out[dev, name] = run(**knobs)
                took = (tca.decode_attention_i8_step_cuda.launches - before[0],
                        tca.decode_attention_i8_live_step_cuda.launches - before[1],
                        tq.matmul_i8w_cuda.launches - before[2])
                if dev == "cuda":
                    assert took == {"pallas": (128, 0, 0), "pallas-live": (0, 128, 0),
                                    "int8-pallas": (128, 0, 512)}.get(name, (0, 0, 0))
                else:
                    assert took == (0, 0, 0)
    for name in modes:
        gap = float((out["cpu", name] - out["cpu", "native"]).abs().max())
        err = float((out["cuda", name] - out["cpu", name]).abs().max())
        assert err <= 0.5 * gap, (name, err, gap)


# --------------------------------------------------------------------------
# The rollout as CUDA graphs (models/rollout_graph.py)
# --------------------------------------------------------------------------

GRAPH_MODES = {  # sample_video's knobs of every sampler mode
    "native": {}, "xla": dict(kv_cache_dtype="int8"),
    "xla-mm8": dict(kv_cache_dtype="int8", mm_dtype="int8"),
    "pallas": dict(kv_cache_dtype="int8", attn_impl="pallas"),
    "pallas-live": dict(kv_cache_dtype="int8", attn_impl="pallas-live"),
    "int8": dict(weight_dtype="int8"), "int8-pallas": dict(weight_dtype="int8-pallas"),
    "pallas+int8-pallas": dict(kv_cache_dtype="int8", attn_impl="pallas",
                               weight_dtype="int8-pallas"),
    "int4": dict(kv_cache_dtype="int4"), "int4+int8-pallas": dict(kv_cache_dtype="int4",
                                                                  weight_dtype="int8-pallas"),
    "streams2": dict(streams=2), "streams4-pallas": dict(kv_cache_dtype="int8",
                                                         attn_impl="pallas", streams=4)}
GRAPH_GEOMETRIES = {  # (stride, kernel, blocks, T, n_prime)
    "dsfvt": ((4, 1, 1), (3, 1, 1), (1, 8, 8), 4, 1),  # every sampled slice unprimed
    "mixed-primed": ((4, 2, 2), (3, 3, 3), (1, 4, 4), 8, 2)}  # half the slices half primed


def _graph_case(cuda, geometry, dtype=torch.bfloat16):
    import numpy as np

    from lvt_tpu_torch.models import cast_floats, to_device

    stride, kernel, blocks, T, n_prime = GRAPH_GEOMETRIES[geometry]
    vt, params = _card_vt(stride, kernel, blocks, T)
    params = cast_floats(to_device(params, cuda), dtype)
    video = torch.from_numpy(np.random.default_rng(1).integers(0, 16, (4, 2, T, 8, 8)))
    return vt, params, video.to(cuda), n_prime


def _counts():
    from lvt_tpu_torch.ops._lib import COUNTED

    return {fn.__name__: fn.launches for fn in COUNTED}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(GRAPH_MODES))
@pytest.mark.parametrize("geometry", list(GRAPH_GEOMETRIES))
def test_slice_graph_equals_the_eager_loop(cuda, geometry, mode):
    """Greedy codes of the graph rollout equal the eager loop's bit for bit,
    b = 4, bf16, in every sampler mode, and the launch counts of the two
    rollouts are equal: each replay adds what its capture launched."""
    from lvt_tpu_torch.models.rollout_graph import SliceGraph

    vt, params, video, n_prime = _graph_case(cuda, geometry)
    knobs = GRAPH_MODES[mode]
    before = _counts()
    eager = vt.sample_video(params, video, n_prime=n_prime, greedy=True, _eager=True, **knobs)
    mid = _counts()
    captures = SliceGraph.captures
    graph = vt.sample_video(params, video, n_prime=n_prime, greedy=True, **knobs)
    after = _counts()
    assert SliceGraph.captures == captures + 1  # one graph serves every slice
    assert torch.equal(graph, eager)
    assert {k: mid[k] - before[k] for k in before} == {k: after[k] - mid[k] for k in mid}
    assert torch.equal(vt.sample_video(params, video, n_prime=n_prime, greedy=True, **knobs),
                       eager)  # replayed only
    assert SliceGraph.captures == captures + 1


@pytest.mark.cuda
def test_slice_graph_draws_as_the_eager_loop_and_advances_the_generator(cuda):
    """Temperature sampling: from the same generator state the graph draws
    what the eager loop draws, and leaves the generator where the eager loop
    leaves it, so two replays draw differently."""
    vt, params, video, n_prime = _graph_case(cuda, "mixed-primed")
    runs = {}
    for eager in (True, False):
        gen = torch.Generator(device=cuda).manual_seed(5)
        runs[eager] = [vt.sample_video(params, video, gen, n_prime=n_prime, temp=1.0,
                                       _eager=eager) for _ in range(2)]
        runs[eager].append(gen.get_state())
    assert torch.equal(runs[True][0], runs[False][0])
    assert torch.equal(runs[True][1], runs[False][1])
    assert torch.equal(runs[True][2], runs[False][2])
    first, second = runs[False][:2]
    assert not torch.equal(first[:, :, n_prime:], second[:, :, n_prime:])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["streams2", "streams4-pallas"])
def test_slice_graph_streams_equal_one_stream_rollouts_of_their_blocks(cuda, mode):
    """A rollout whose slices are graphs of S parallel branches equals, bit
    for bit, one-stream rollouts of each block of b / S rows (the same
    shapes on the card), and its graph has S times a one-stream graph's
    launches at b / S rows."""
    from lvt_tpu_torch.models.rollout_graph import SliceGraph

    vt, params, video, n_prime = _graph_case(cuda, "mixed-primed")
    knobs = dict(GRAPH_MODES[mode])
    streams = knobs.pop("streams")
    bs = video.shape[0] // streams
    got = vt.sample_video(params, video, n_prime=n_prime, greedy=True, streams=streams, **knobs)
    launches = vt._slice_graph_slot.graph.launches
    for s in range(streams):
        want = vt.sample_video(params, video[s * bs:(s + 1) * bs], n_prime=n_prime, greedy=True,
                               **knobs)
        assert torch.equal(got[s * bs:(s + 1) * bs], want), s
    one = vt._slice_graph_slot.graph.launches
    assert {fn: n * streams for fn, n in one.items()} == launches
    assert SliceGraph.captures > 0


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["native", "int4"])
def test_slice_graph_streams_draw_as_the_eager_loop(cuda, kv):
    """Temperature sampling at two streams: from the same generator state
    the graph's branches draw what the eager loop's streams draw, and the
    caller's generator is left where the eager loop leaves it."""
    vt, params, video, n_prime = _graph_case(cuda, "mixed-primed")
    runs = {}
    for eager in (True, False):
        gen = torch.Generator(device=cuda).manual_seed(5)
        runs[eager] = [vt.sample_video(params, video, gen, n_prime=n_prime, temp=1.0, streams=2,
                                       kv_cache_dtype=kv, _eager=eager) for _ in range(2)]
        runs[eager].append(gen.get_state())
    for a, b in zip(runs[True], runs[False]):
        assert torch.equal(a, b)
    assert not torch.equal(runs[False][0][:, :, n_prime:], runs[False][1][:, :, n_prime:])


@pytest.mark.cuda
def test_int4_packing_is_exact_on_the_card(cuda):
    """Every pair of levels -7..7 through ``pack_int4`` and ``unpack_int4``
    on the card, equal to the CPU's bytes."""
    from lvt_tpu_torch.ops.quant import pack_int4, unpack_int4

    levels = torch.arange(-7, 8, dtype=torch.int8)
    pairs = torch.cartesian_prod(levels, levels).reshape(15, 30)
    packed = pack_int4(pairs.to(cuda))
    assert torch.equal(packed.cpu(), pack_int4(pairs))
    out = torch.empty((15, 30), dtype=torch.float32, device=cuda)
    unpack_int4(packed, out, torch.empty_like(packed))
    assert torch.equal(out.cpu().to(torch.int8), pairs)


@pytest.mark.cuda
def test_slice_graph_recaptures_after_the_weights_change(cuda):
    """A weight changed in place after a capture gives a new capture, whose
    codes are the eager loop's on the new weights; the stale graph is
    dropped, never replayed."""
    from lvt_tpu_torch.models.rollout_graph import SliceGraph

    vt, params, video, n_prime = _graph_case(cuda, "dsfvt")
    first = vt.sample_video(params, video, n_prime=n_prime, greedy=True)
    captures, stale = SliceGraph.captures, vt._slice_graph_slot.graph
    with torch.no_grad():
        params["netG"]["decoder"]["layers"][0]["ffn_w2"].mul_(3.0)
    got = vt.sample_video(params, video, n_prime=n_prime, greedy=True)
    assert SliceGraph.captures == captures + 1
    assert vt._slice_graph_slot.graph is not stale
    want = vt.sample_video(params, video, n_prime=n_prime, greedy=True, _eager=True)
    assert torch.equal(got, want) and not torch.equal(got, first)


@pytest.mark.cuda
def test_i8_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    import lvt_tpu_torch.ops.quant as tq

    q8, sq, k8, ks, v8, vs, bias = _i8_cache_inputs(cuda, 2, 2, 32, 64, torch.float32)
    args = (q8, sq, k8, ks, v8, vs)
    with pytest.raises(ValueError):  # live beyond the buffer
        tca.decode_attention_i8_cuda(*args, 33, bias, 0.1)
    with pytest.raises(ValueError):  # a float q
        tca.decode_attention_i8_cuda(q8.float(), sq, k8, ks, v8, vs, 4, bias, 0.1)
    with pytest.raises(ValueError):  # scales of two dtypes
        tca.decode_attention_i8_cuda(q8, sq, k8, ks, v8, vs.to(torch.bfloat16), 4, bias, 0.1)
    with pytest.raises(ValueError):  # a tile that does not divide the buffer
        tca.decode_attention_i8_live_cuda(*args, 4, bias, 0.1, rtile=24)
    with pytest.raises(ValueError):  # a CPU cache
        tca.decode_attention_i8_cuda(q8, sq, k8.cpu(), ks, v8, vs, 4, bias, 0.1)
    qkv = torch.randn((2, 3, 2, 64), device=cuda)
    with pytest.raises(ValueError):  # q in another dtype than the scales
        tca.decode_attention_i8_step_cuda(qkv[:, 0].bfloat16(), qkv[:, 1:], k8, ks, v8, vs, 4,
                                          bias, 0.1)
    with pytest.raises(ValueError):  # rows of q not contiguous
        tca.decode_attention_i8_step_cuda(qkv[:, 0, :, ::2], qkv[:, 1:], k8, ks, v8, vs, 4,
                                          bias, 0.1)
    with pytest.raises(ValueError):  # a tile that does not divide the buffer
        tca.decode_attention_i8_live_step_cuda(qkv[:, 0], qkv[:, 1:], k8, ks, v8, vs, 4, bias,
                                               0.1, rtile=24)
    with pytest.raises(ValueError):  # kernel 5 takes fp32 scales only
        tca.cache_attention_i8_cuda(q8.float(), k8, ks.to(torch.bfloat16),
                                    v8, vs.to(torch.bfloat16), bias[None], 0.1)
    y = torch.randn((2, 24), device=cuda)
    wt = torch.zeros((8, 24), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):  # K not a multiple of 16
        tq.matmul_i8w_cuda(y, wt, torch.ones(8, device=cuda))
    with pytest.raises(ValueError):  # a weight that is not int8
        tq.matmul_i8w_cuda(torch.randn((2, 32), device=cuda),
                           torch.zeros((8, 32), device=cuda), torch.ones(8, device=cuda))
    # rows of y that do not start on 16 bytes: the kernel refuses them, the
    # dispatcher copies y first
    y = torch.randn(2 * 32 + 1, device=cuda)[1:].view(2, 32)
    wt = torch.randint(-127, 128, (8, 32), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):
        tq.matmul_i8w_cuda(y, wt, torch.ones(8, device=cuda))
    assert torch.equal(tq.matmul_i8w(y, wt, torch.ones(8, device=cuda)),
                       tq.matmul_i8w_plain(y, wt, torch.ones(8, device=cuda)))


# --------------------------------------------------------------------------
# Kernel 6 (nearest codebook entry) and kernel 12 (the probe kernel)
# --------------------------------------------------------------------------

def assert_indices_close(got, want, z, codebook):
    """Kernel 6 against its plain version: equal, or differing only where the
    float64 distances of the two codes lie within 8 fp32 ulps of the sums that
    form them (||z||^2 + ||c||^2), and at most one such row per thousand."""
    diff = torch.nonzero(got != want).flatten()
    assert len(diff) <= max(1, want.numel() // 1000), f"{len(diff)} of {want.numel()} differ"
    z64, c64 = z.double(), codebook.double()
    for r in diff.tolist():
        dg = ((z64[r] - c64[got[r]]) ** 2).sum()
        dw = ((z64[r] - c64[want[r]]) ** 2).sum()
        size = (z64[r] ** 2).sum() + (c64[want[r]] ** 2).sum()
        assert abs(float(dg - dw)) <= 8 * 2 ** -23 * float(size), (r, float(dg), float(dw))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,K,Dc", [(1, 512, 64), (300, 100, 64), (8192 + 37, 512, 64),
                                    (2048, 512, 256), (100, 7, 4)])
@pytest.mark.parametrize("strided", [False, True])
def test_nearest_indices_kernel_matches_plain(cuda, dtype, N, K, Dc, strided):
    import lvt_tpu_torch.ops.vq as tvq

    g = torch.Generator(device=cuda).manual_seed(N + K)
    codebook = torch.randn((K, Dc), generator=g, device=cuda)
    if strided:  # sub-codebook 1 of 3, read in place
        z = torch.randn((N, 3, Dc), generator=g, device=cuda).to(dtype)[:, 1, :]
        assert not z.is_contiguous() or N == 1
    else:
        z = torch.randn((N, Dc), generator=g, device=cuda).to(dtype)
    before = tvq.nearest_indices_grouped_cuda.launches
    got = tvq.nearest_indices(z, codebook)
    assert tvq.nearest_indices_grouped_cuda.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == (N,)
    assert torch.equal(got, tvq.nearest_indices(z, codebook))  # two calls, the same bits
    want = tvq.nearest_indices(z, codebook, use_kernel=False)
    assert tvq.nearest_indices_grouped_cuda.launches == before + 2
    assert_indices_close(got, want, z, codebook)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,G,K,Dc", [(8192, 4, 512, 64), (8192, 1, 512, 256),
                                      (8192 + 37, 4, 512, 64), (1, 4, 512, 64),
                                      (300, 3, 300, 20), (129, 2, 7, 4),
                                      (1000, 1, 129, 252), (77, 5, 513, 36)])
@pytest.mark.parametrize("strided", [False, True])
def test_nearest_indices_grouped_kernel_matches_plain(cuda, dtype, N, G, K, Dc, strided):
    """One launch for all G sub-codebooks, at PR-DVQVAE2's and Base-VQVAE's
    training shapes and at odd N, G, K and Dc (K split over a cluster where
    the row tiles leave SMs idle): each column against the plain version of
    its sub-codebook, two calls bit-identical."""
    import lvt_tpu_torch.ops.vq as tvq

    g = torch.Generator(device=cuda).manual_seed(N + G + K + Dc)
    codebooks = torch.randn((G, K, Dc), generator=g, device=cuda)
    zz = torch.randn((N, 2 * G if strided else G, Dc), generator=g, device=cuda).to(dtype)
    z = zz[:, 1::2, :] if strided else zz  # every other sub-codebook of a wider z, in place
    before = tvq.nearest_indices_grouped_cuda.launches
    got = tvq.nearest_indices_grouped(z, codebooks)
    assert tvq.nearest_indices_grouped_cuda.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == (N, G)
    assert torch.equal(got, tvq.nearest_indices_grouped(z, codebooks))
    want = tvq.nearest_indices_grouped(z, codebooks, use_kernel=False)
    assert tvq.nearest_indices_grouped_cuda.launches == before + 2
    for i in range(G):
        assert_indices_close(got[:, i], want[:, i], z[:, i, :], codebooks[i])


@pytest.mark.cuda
def test_nearest_indices_kernel_breaks_ties_to_the_lowest_index(cuda):
    import lvt_tpu_torch.ops.vq as tvq

    g = torch.Generator(device=cuda).manual_seed(6)
    base = torch.randn((50, 64), generator=g, device=cuda)
    codebook = base.repeat(4, 1)  # rows k, k + 50, k + 100, k + 150 are equal
    z = torch.cat([base[[7, 49, 0]], torch.randn((200, 64), generator=g, device=cuda)])
    got = tvq.nearest_indices(z, codebook)
    assert got[:3].tolist() == [7, 49, 0]  # z equals a code: the first of its copies
    assert int(got.max()) < 50
    assert torch.equal(got, tvq.nearest_indices(z, codebook, use_kernel=False))


@pytest.mark.cuda
def test_quantize_st_reaches_kernel_6_on_the_card(cuda):
    """quantize_st on CUDA tensors launches kernel 6 once for all
    sub-codebooks by default, returns the plain path's values, sends the identity gradient to
    z_e, and its EMA statistics are the same bits on every call."""
    import lvt_tpu_torch.ops.vq as tvq
    from lvt_tpu_torch.models import to_device

    cb = to_device(tvq.init_codebook(torch.Generator().manual_seed(0), 4, 64, 64), cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    z_e = (0.02 * torch.randn((2, 8, 8, 64), generator=g, device=cuda)).requires_grad_(True)
    before = tvq.nearest_indices_grouped_cuda.launches
    st, zq, idx, new = tvq.quantize_st(z_e, cb, ema=True, train=True)
    assert tvq.nearest_indices_grouped_cuda.launches == before + 1
    st.sum().backward()
    assert torch.equal(z_e.grad, torch.ones_like(z_e))
    st2, zq2, idx2, new2 = tvq.quantize_st(z_e.detach(), cb, ema=True, train=True,
                                           use_kernel=False)
    assert tvq.nearest_indices_grouped_cuda.launches == before + 1
    assert torch.equal(idx, idx2)
    for k in new:
        assert torch.equal(new[k], new2[k]) and not new[k].requires_grad, k
    torch.testing.assert_close(st.detach(), st2, atol=0, rtol=0)


@pytest.mark.cuda
def test_nearest_indices_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    import lvt_tpu_torch.ops.vq as tvq

    cb = torch.randn((8, 64), device=cuda)
    for z, c in ((torch.randn((4, 6), device=cuda), torch.randn((8, 6), device=cuda)),  # Dc % 4
                 (torch.randn((4, 260), device=cuda), torch.randn((8, 260), device=cuda)),
                 (torch.randn((4, 64), device=cuda).half(), cb),
                 (torch.randn((64, 4), device=cuda).T, cb),  # column stride != 1
                 (torch.randn((4, 64), device=cuda), cb.bfloat16()),
                 (torch.randn((4, 64)), cb),
                 (torch.randn(4 * 64 + 1, device=cuda)[1:].view(4, 64), cb),  # rows off 16 B
                 (torch.randn(4 * 64 + 2, device=cuda).bfloat16()[2:].view(4, 64), cb)):
        with pytest.raises(ValueError):
            tvq.nearest_indices_cuda(z, c)
    with pytest.raises(ValueError):  # a sub-codebook count that differs from z's
        tvq.nearest_indices_grouped_cuda(torch.randn((4, 3, 64), device=cuda),
                                         torch.randn((2, 8, 64), device=cuda))
    with pytest.raises(ValueError):  # a group stride not a multiple of 4
        tvq.nearest_indices_grouped_cuda(
            torch.randn(4 * 198, device=cuda).as_strided((4, 3, 64), (198, 66, 1)),
            torch.randn((3, 8, 64), device=cuda))


def _i8kv_inputs(dev, b, na, R, da, dtype, eb, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, na, da), generator=g, device=dev).to(dtype)
    k8, v8 = (torch.randint(-127, 128, (b, na, R, da), generator=g, device=dev,
                            dtype=torch.int8) for _ in range(2))
    ks, vs = (0.01 + 0.01 * torch.rand((b, na, R), generator=g, device=dev) for _ in range(2))
    extra = 0.5 * torch.randn((eb, na, R), generator=g, device=dev)
    return q, k8, ks, v8, vs, extra


def i8kv_tol(q, k8, ks, v8, vs, extra, scale, live, want):
    """Kernel 12, |kernel - plain|: 1e-5 of the largest output (fp32 sums in
    another order); with bf16 io one rounding of the output (2^-7 relative)
    plus two weights whose fp32 values sit on either side of a bf16 boundary
    in the two versions: each moves an output by ulp_bf16(w) * |v| <=
    2^-8 * max(w) * 127."""
    atol = 1e-5 * float(want.float().abs().max())
    if q.dtype == torch.float32:
        return atol, 0.0
    logits = torch.einsum("bad,bajd->baj", q.float(), k8[:, :, :live].float()) * scale
    w = torch.softmax(logits * ks[:, :, :live] + extra[:, :, :live], -1) * vs[:, :, :live]
    return atol + 2 * 2 ** -8 * float(w.max()) * 127, 2 ** -7


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("live", [1, 64, 200, 256])
@pytest.mark.parametrize("b,da,eb", [(32, 16, 1), (5, 64, 5), (16, 128, 1)])
def test_decode_attention_i8kv_kernel_matches_plain(cuda, dtype, live, b, da, eb):
    na, R, scale = 8, 256, da ** -0.5
    q, k8, ks, v8, vs, extra = _i8kv_inputs(cuda, b, na, R, da, dtype, eb, seed=12)
    k8[:, :, live:], v8[:, :, live:] = 127, -128  # rows >= live are never read
    before = tca.decode_attention_i8kv_cuda.launches
    got = tca.decode_attention_i8kv(q, k8, ks, v8, vs, extra, scale, live)
    assert tca.decode_attention_i8kv_cuda.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, na, da)
    want = tca.decode_attention_i8kv_plain(q, k8, ks, v8, vs, extra, scale, live)
    atol, rtol = i8kv_tol(q, k8, ks, v8, vs, extra, scale, live, want)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    if live == R:
        assert torch.equal(tca.decode_attention_i8kv(q, k8, ks, v8, vs, extra, scale), got)
    if dtype == torch.float32 and da != 16:  # with fp32 io it is kernel 5's function
        assert torch.equal(got, tca.cache_attention_i8(q, k8, ks, v8, vs, extra, scale, live))


@pytest.mark.cuda
def test_i8kv_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q, k8, ks, v8, vs, extra = _i8kv_inputs(cuda, 2, 2, 32, 32, torch.float32, 1, seed=0)
    with pytest.raises(ValueError):  # da = 32
        tca.decode_attention_i8kv_cuda(q, k8, ks, v8, vs, extra, 1.0)
    q, k8, ks, v8, vs, extra = _i8kv_inputs(cuda, 2, 2, 32, 16, torch.float32, 1, seed=0)
    with pytest.raises(ValueError):  # bf16 scales
        tca.decode_attention_i8kv_cuda(q, k8, ks.bfloat16(), v8, vs.bfloat16(), extra, 1.0)
    with pytest.raises(ValueError):  # live past the buffer
        tca.decode_attention_i8kv_cuda(q, k8, ks, v8, vs, extra, 1.0, live=33)
    with pytest.raises(ValueError):  # da = 16 is kernel 12's alone
        tca.cache_attention_i8_cuda(q, k8, ks, v8, vs, extra, 1.0)


def _cache_plans(live, da):
    """Every launch plan of kernels 5 and 12 at `live` rows: C = 1 to the
    largest cluster, ranks of 4 warps and of 8 warps of 4 or 8 row loads a
    thread, and one warp a head at da 16."""
    plans = [(c, -(-live // c), w, u) for c in (1, 2, 4, 8, 16)
             for w, u in ((4, 4), (8, 4), (8, 8))]
    if da == 16 and live <= tca.CACHE_WARP_ROWS:
        plans.append((1, live, 1, 8))
    return plans


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", [5, 12])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("live", [1, 63, 200, 256])
@pytest.mark.parametrize("b,da,eb", [(3, 16, 1), (3, 64, 3), (2, 128, 1), (2, 128, 2)])
def test_cache_attention_kernels_take_every_plan(cuda, kernel, dtype, live, b, da, eb):
    """Kernels 5 and 12 against their plain versions at every plan the launch
    takes (kernel 5 has no da 16); each plan's two calls bit-identical; the
    public wrapper launches once, at cache_attention_plan's plan."""
    if kernel == 5 and da == 16:
        da = 64
    na, R, scale = 4, 256, da ** -0.5
    q, k8, ks, v8, vs, extra = _i8kv_inputs(cuda, b, na, R, da, dtype, eb, seed=kernel + live)
    k8[:, :, live:], v8[:, :, live:] = 127, -128  # rows >= live are never read
    name, entry, public, plain = {
        5: ("cache_attention_i8_cuda", "lvt_cache_attention_i8", tca.cache_attention_i8_cuda,
            tca.cache_attention_i8_plain),
        12: ("decode_attention_i8kv_cuda", "lvt_decode_attention_i8kv",
             tca.decode_attention_i8kv_cuda, tca.decode_attention_i8kv_plain)}[kernel]
    want = plain(q, k8, ks, v8, vs, extra, scale, live)
    if kernel == 12:
        atol, rtol = i8kv_tol(q, k8, ks, v8, vs, extra, scale, live, want)
    else:
        atol = 1e-5 * float(want.float().abs().max())
        rtol = 2 ** -7 if dtype == torch.bfloat16 else 0.0
    for plan in _cache_plans(live, da):
        got = tca._float_query_cuda(name, entry, (16, 64, 128), q, k8, ks, v8, vs, extra, scale,
                                    live, plan)
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol,
                                   msg=lambda m, plan=plan: f"plan {plan}: {m}")
        again = tca._float_query_cuda(name, entry, (16, 64, 128), q, k8, ks, v8, vs, extra,
                                      scale, live, plan)
        assert torch.equal(again, got), plan
    before = public.launches
    got = public(q, k8, ks, v8, vs, extra, scale, live)
    assert public.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", [5, 12])
@pytest.mark.parametrize("da,live,plan", [
    (128, 4096, None), (128, 4096, (16, 256, 4, 4)), (128, 3000, (1, 3000, 8, 8)),
    (128, 600, (1, 600, 8, 4)), (64, 32768, None), (16, 4000, None), (16, 4000, (1, 4000, 4, 4)),
    (16, 257, None)])
def test_cache_attention_long_caches_take_passes(cuda, kernel, da, live, plan):
    """Ranks with more rows than one pass of register loads (4 or 8 rows a
    thread) keep the later passes' logits in shared memory; the plan's own
    choice (None) at long caches, and single ranks of 600-4,000 rows."""
    if kernel == 5 and da == 16:
        da = 64
    b, na, R, scale = 1, 2, max(live, 256), da ** -0.5
    q, k8, ks, v8, vs, extra = _i8kv_inputs(cuda, b, na, R, da, torch.float32, 1, seed=7)
    name, entry, plain = {
        5: ("cache_attention_i8_cuda", "lvt_cache_attention_i8", tca.cache_attention_i8_plain),
        12: ("decode_attention_i8kv_cuda", "lvt_decode_attention_i8kv",
             tca.decode_attention_i8kv_plain)}[kernel]
    got = tca._float_query_cuda(name, entry, (16, 64, 128), q, k8, ks, v8, vs, extra, scale, live,
                                plan)
    want = plain(q, k8, ks, v8, vs, extra, scale, live)
    torch.testing.assert_close(got, want, atol=1e-5 * float(want.abs().max()), rtol=0.0)


# --------------------------------------------------------------------------
# The data path on the card machine: center_crop_resize (plain PyTorch on
# the device, no hand-written kernel) and the native IO library
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("shape,size", [((64, 240, 320, 3), 64), ((2, 3, 48, 40, 3), 32),
                                        ((1, 77, 50, 3), 20)])
def test_center_crop_resize_on_the_card_matches_the_cpu(cuda, shape, size):
    """The bounds of tests/test_torch_preprocess.py: uint8 within one step
    of the CPU's result, at most 0.1% of the pixels apart; float frames on a
    [0, 255] scale within 2e-4 of the filter in float64 (13 fp32 ulps at
    255; cuBLAS sums the 240-term products in its own order). TF32 off."""
    import numpy as np

    from lvt_tpu_torch.data.preprocess import center_crop_resize, center_crop_square, \
        lanczos_weights

    assert not torch.backends.cuda.matmul.allow_tf32
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8))
    got = center_crop_resize(x.to(cuda), size).cpu()
    want = center_crop_resize(x, size)
    assert got.dtype == torch.uint8 and got.shape == want.shape
    diff = (got.int() - want.int()).abs()
    assert int(diff.max()) <= 1 and float((diff > 0).double().mean()) <= 1e-3
    w = lanczos_weights(min(shape[-3:-1]), size).double()
    exact = torch.einsum("...hwc,ho,wp->...opc", center_crop_square(x).double(), w, w)
    got_f = center_crop_resize(x.to(cuda).float(), size).cpu().double()
    assert float((got_f - exact).abs().max()) <= 2e-4


@pytest.mark.cuda
def test_native_loader_gives_the_batch_pil_gives(cuda, tmp_path):
    """On the card machine the native IO library builds and loads, and the
    mapper's frames read through it equal those read with PIL."""
    import numpy as np
    from PIL import Image

    from lvt_tpu_torch import native
    from lvt_tpu_torch.config import get_cfg
    from lvt_tpu_torch.data.mapper import DatasetMapper

    assert native.available(), "native lvt_io did not build or load (g++, zlib)"
    rng = np.random.default_rng(1)
    for f in range(4):
        Image.fromarray(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)).save(
            tmp_path / f"{f}.png")
    cfg = get_cfg()
    cfg.INPUT.FORMAT = "RGB"
    cfg.INPUT.N_FRAMES_PER_VIDEO_TEST = 4
    video = {"video_root": str(tmp_path), "image_names": [f"{f}.png" for f in range(4)],
             "video_idx": 0}
    mapper = DatasetMapper(cfg, is_train=False)
    got = mapper(dict(video))["image_sequence"]

    class NoLibrary:
        def get(self):
            return None

    saved, native.LIBRARY = native.LIBRARY, NoLibrary()
    try:
        want = mapper(dict(video))["image_sequence"]
    finally:
        native.LIBRARY = saved
    assert got.shape == (4, 64, 64, 3)
    np.testing.assert_array_equal(got, want)
