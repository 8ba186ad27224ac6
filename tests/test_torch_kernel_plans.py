"""The launch plans that the port's kernel wrappers compute on the host, on
the CPU: kernel 2's cluster size and the live rows of each rank of a cluster
(ops/cache_attention.py ``decode_plan``), and the row
ranges whose partial weight gradients kernels 8 and 9 add in a fixed order
(ops/fused_layer.py ``_splits``). The wrappers' refusals of CPU tensors are
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
