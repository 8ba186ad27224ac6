"""The launch plans that the port's kernel wrappers compute on the host, on
the CPU: kernel 2's cluster size and the live rows of each rank of a cluster
(ops/cache_attention.py ``decode_plan``), the row
ranges whose partial weight gradients kernels 8 and 9 add in a fixed order
(ops/fused_layer.py ``_splits``), and the scratch that kernels 7 and 8 take
(``fwd_y_shape``, ``ffn_bwd_scratch``). The wrappers' refusals of CPU tensors are
held here too; everything that needs the card is in test_torch_kernels.py."""

import pytest
import torch

import lvt_tpu_torch.ops.cache_attention as tca
import lvt_tpu_torch.ops.fused_layer as tfl


def _row_ranges(live, c):
    """Each rank's [begin, end) live rows as csrc/decode_attention.cu cuts
    them from decode_plan's chunk (empty ranks as (live, live))."""
    chunk = -(-live // c)
    return [(min(r * chunk, live), min((r + 1) * chunk, live)) for r in range(c)]


@pytest.mark.parametrize("live", [64, 128, 129, 256])
@pytest.mark.parametrize("b,short,long", [(1, 16, 16), (2, 16, 16), (4, 8, 16), (8, 4, 8),
                                          (16, 2, 4), (17, 1, 2), (64, 1, 1)])
def test_decode_plan_puts_a_block_on_every_sm(b, short, long, live):
    """DSFVT's 8 heads: the least power of two up to 16 with at least one
    block per SM of the H100 (132), two once live exceeds 128 rows: the
    rollout's b = 1, 8, 16 at 16, 4, 2 blocks per (batch row, head), then
    16, 8, 4."""
    c, chunk = tca.decode_plan(b, 8, live)
    assert c == (long if live > tca.LONG_LIVE else short)
    assert chunk == -(-live // c)
    blocks = tca.CARD_SMS * (2 if live > tca.LONG_LIVE else 1)
    assert b * 8 * c >= blocks or c == tca.MAX_CLUSTER
    assert c == 1 or b * 8 * (c // 2) < blocks


@pytest.mark.parametrize("c", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("live", [1, 2, 3, 15, 16, 17, 100, 255, 256, 1000, 32768])
def test_decode_row_ranges_hold_each_live_row_once(c, live):
    ranges = _row_ranges(live, c)
    assert len(ranges) == c
    rows = [j for begin, end in ranges for j in range(begin, end)]
    assert rows == list(range(live))  # every live row once, ranks in order
    chunk = -(-live // c)
    assert all(0 <= end - begin <= chunk for begin, end in ranges)
    assert all(begin <= end <= live for begin, end in ranges)


@pytest.mark.parametrize("b,live,empty", [(1, 1, 15), (1, 3, 13), (1, 100, 1), (8, 1, 3),
                                          (8, 3, 1), (16, 1, 1), (16, 256, 0), (8, 129, 0),
                                          (16, 130, 0)])
def test_decode_plan_leaves_ranks_empty_at_small_live(b, live, empty):
    """Up to 128 live rows the cluster size depends on b * na alone, so the
    early pixels of a block run leave ranks with no rows, which the kernel
    must take."""
    c, _ = tca.decode_plan(b, 8, live)
    assert sum(begin == end for begin, end in _row_ranges(live, c)) == empty


@pytest.mark.parametrize("rows,want", [(1, 1), (256, 1), (257, 2), (1280, 5), (3840, 15),
                                       (16384, 16), (10 ** 6, 16)])
def test_fused_splits(rows, want):
    """Row ranges of the weight gradients' fixed-order sums: one per 256 rows,
    at most 16."""
    assert tfl._splits(rows) == want


@pytest.mark.parametrize("rows,d,dtype,tiles", [
    (16384, 512, torch.bfloat16, 128), (60, 64, torch.bfloat16, 1),
    (125, 512, torch.bfloat16, 1), (129, 256, torch.bfloat16, 2), (288, 512, torch.bfloat16, 3),
    (16384, 512, torch.float32, 1024), (60, 64, torch.float32, 4)])
def test_ffn_bwd_scratch(rows, d, dtype, tiles):
    """Kernel 8's fp32 scratch part_r: the row tiles' column sums (tiles, 4,
    d), a tile being 128 rows in bf16 (the rows of gemm_nt_wgmma's tiles over
    one plane, which ln_bwd_rows follows) and 16 in fp32 (TileF32); in bf16
    then dy2 (rows, d), the rows' mean and rstd and the gate bytes, where
    csrc/fused_layer.cu ffn_bwd_rows_bf16 puts them: dy2 16-byte aligned (its
    epilogue stores float pairs), the gate after whole floats."""
    got_tiles, length = tfl.ffn_bwd_scratch(rows, d, dtype)
    assert got_tiles == tiles == -(-rows // tfl._TILE_ROWS[dtype])
    if dtype == torch.float32:
        assert length == tiles * 4 * d
        return
    dy2 = tiles * 4 * d
    mean, rstd, gate = dy2 + rows * d, dy2 + rows * d + rows, dy2 + rows * d + 2 * rows
    assert dy2 % 4 == 0
    assert length == gate + rows * d // 4  # one byte per gate
    assert (rows * d) % 4 == 0 and rstd - mean == rows


def test_ffn_bwd_scratch_at_dsfvt():
    """At DSFVT b64 (16,384 rows, d = 512) in bf16: 128 row tiles; the new
    scratch beside the partials is 40 MB (fp32 dy2 32 MB, the gate 8 MB, the
    row statistics 128 KB)."""
    tiles, length = tfl.ffn_bwd_scratch(16384, 512, torch.bfloat16)
    assert tiles == 128
    extra = 4 * (length - tiles * 4 * 512)
    assert extra == 16384 * 512 * 4 + 16384 * 512 + 2 * 16384 * 4


@pytest.mark.parametrize("nb,n,d", [(64, 256, 512), (3, 20, 64), (2, 144, 512)])
def test_fused_fwd_scratch(nb, n, d):
    """Kernel 7's scratch y: none in fp32; in bf16 four (nb, n, d) planes:
    LN(x), then y2 in its place, f, and x2 in fp32 over planes 2 and 3 (64 MB
    at DSFVT b64)."""
    assert tfl.fwd_y_shape(nb, n, d, torch.float32) is None
    shape = tfl.fwd_y_shape(nb, n, d, torch.bfloat16)
    assert shape == (4, nb, n, d)
    assert 2 * (shape[0] - 2) * nb * n * d == 4 * nb * n * d  # two bf16 planes hold fp32 x2


def test_cuda_wrappers_refuse_cpu_tensors():
    q = torch.zeros((1, 8, 128))
    kc = torch.zeros((1, 8, 256, 128))
    with pytest.raises(ValueError):
        tca.decode_attention_cuda(q, kc, kc, 1, torch.zeros((8, 256)), 0.1)
    from lvt_tpu_torch.models.vt import init_block_attn

    p = init_block_attn(torch.Generator().manual_seed(0), (1, 4, 4), 2, 64, 64)
    tok = torch.zeros((2, 16, 64))
    bias = torch.zeros((2, 16, 16))
    with pytest.raises(ValueError):
        tfl.attn_half_bwd_cuda(tok, tok, p, bias, False, 0, 2)
    with pytest.raises(ValueError):
        tfl.fused_layer_fwd_cuda(tok, p, bias, False)
    with pytest.raises(ValueError):
        tfl.ffn_half_bwd_cuda(tok, tok, p)
