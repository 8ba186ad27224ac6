"""The launch plans that the port's kernel wrappers compute on the host, on
the CPU: kernel 2's cluster size and the live rows of each rank of a cluster
(ops/cache_attention.py ``decode_plan``), kernels 3 and 4's clusters over
the live rows and row tiles (``decode_i8_plan``, ``decode_i8_live_plan``)
with a torch model of kernel 4's decomposition, the row
ranges whose partial weight gradients kernels 8 and 9 add in a fixed order
(ops/fused_layer.py ``_splits``), the scratch that kernels 7 and 8 take
(``fwd_y_shape``, ``ffn_bwd_scratch``), kernel 6's split of the codes over a
cluster (ops/vq.py ``nearest_plan``) and kernel 11's columns per block
(ops/quant.py ``matmul_i8w_plan``). The wrappers' refusals of CPU tensors are
held here too; everything that needs the card is in test_torch_kernels.py."""

import pytest
import torch

import lvt_tpu_torch.ops.cache_attention as tca
import lvt_tpu_torch.ops.fused_layer as tfl
import lvt_tpu_torch.ops.quant as tq
import lvt_tpu_torch.ops.vq as tvq

torch.set_num_threads(1)  # one intra-op thread: the test workers share the cores

# Shared memory of the H100: per block at most 232,448 bytes; per SM
# 233,472, each resident block also holding 1 KB for the system
SMEM_BLOCK, SMEM_SM = 232448, 233472
I8W_THREADS = 256  # kernel 11's block (csrc/matmul_i8w.cu NTHREADS)


def _code_ranges(K, ksplit):
    """[begin, end) of the codes each rank of a kernel-6 cluster walks, as
    csrc/nearest_indices.cu cuts them: whole chunks of 128 codes, split
    evenly; ranks past the last chunk walk none."""
    chunks = -(-K // tvq.NI_CODES)
    per = -(-chunks // ksplit)
    return [(min(K, r * per * tvq.NI_CODES), min(K, (r + 1) * per * tvq.NI_CODES))
            for r in range(ksplit)]


def _nearest_smem_bytes(z_bf16):
    """Dynamic shared memory of one kernel-6 block (csrc/nearest_indices.cu
    smem_bytes): three stages of 32 columns of the row tile (rows of 144
    bytes, 80 for bf16 z) and of a chunk's codes (144 bytes), the codes' and
    rows' squared norms, each row's two half-row minima (distance, index)."""
    stage = tvq.NI_ROWS * (80 if z_bf16 else 144) + tvq.NI_CODES * 144
    return 3 * stage + 4 * (tvq.NI_ROWS + tvq.NI_CODES) + 16 * tvq.NI_ROWS


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


# --------------------------------------------------------------------------
# Kernels 3 and 4: decode_i8_plan, decode_i8_live_plan
# --------------------------------------------------------------------------

LIVES = [1, 2, 7, 15, 16, 17, 63, 64, 65, 100, 128, 129, 200, 255, 256, 1000, 4096, 32768]


@pytest.mark.parametrize("da", [64, 128])
def test_decode_i8_plan_holds_each_live_row_once(da):
    """Kernel 3: rank r owns rows [r * chunk, (r + 1) * chunk) cut at live
    (csrc/decode_attention_i8.cu); every live row once, ranks in order, a
    power-of-two cluster of at most 16, chunks of whole 8-row groups (16
    bytes of bf16 scales) and a rank's shared memory within a block's."""
    for live in LIVES:
        c, chunk, direct = tca.decode_i8_plan(live, da)
        assert direct == (chunk * da <= 8 * tca.I8_WARP_BYTES)
        assert 1 <= c <= tca.MAX_CLUSTER and c & (c - 1) == 0
        assert chunk % tca.I8_ROW_ALIGN == 0 and 2 * chunk % 16 == 0 and 4 * chunk % 16 == 0
        ranges = [(min(r * chunk, live), min((r + 1) * chunk, live)) for r in range(c)]
        assert [j for lo, hi in ranges for j in range(lo, hi)] == list(range(live))
        smem = tca.i8_smem_bytes(da, c, chunk, tca.I8_TILE_BYTES // da, c, False, direct)
        assert smem + 1024 <= SMEM_BLOCK


@pytest.mark.parametrize("rtile", [1, 16, 24, 64, 96, 256])
@pytest.mark.parametrize("da", [64, 128])
def test_decode_i8_live_plan_holds_each_tile_once(rtile, da):
    """Kernel 4: rank r owns whole tiles [r * chunk / rtile, (r + 1) * chunk
    / rtile) of the live ones; every live tile once, ranks in order; a bulk
    copy holds whole tiles or a tile whole copies, at most 8 KB; a rank's
    shared memory (every tile's maximum, sum p, scale and column sums of its
    columns among it) within a block's up to 2,048 live tiles."""
    for live in LIVES:
        c, chunk, ring, direct = tca.decode_i8_live_plan(live, rtile, da)
        tiles = -(-live // rtile)
        assert 1 <= c <= tca.MAX_CLUSTER and c & (c - 1) == 0
        assert chunk % rtile == 0 and chunk * c >= live
        per = chunk // rtile
        owned = [t for r in range(c) for t in range(min(r * per, tiles), min((r + 1) * per, tiles))]
        assert owned == list(range(tiles))
        assert ring * da <= tca.I8_TILE_BYTES and (ring % rtile == 0 or rtile % ring == 0)
        if tiles <= 2048:
            assert tca.i8_smem_bytes(da, c, chunk, ring, tiles, True, direct) + 1024 <= SMEM_BLOCK


@pytest.mark.parametrize("live,k3,k4", [(1, 1, 1), (16, 1, 1), (64, 1, 1), (65, 1, 1),
                                        (128, 1, 1), (129, 4, 4), (200, 4, 4), (256, 4, 4)])
def test_decode_i8_plans_at_the_rollouts_shapes(live, k3, k4):
    """The clusters that the sweep on the H100 chose (tools/
    time_decode_i8_torch.py; ops/cache_attention.py), the same at every
    batch size of the rollout (1, 8, 16): one rank while 8 warps hold its
    rows in registers (128 rows at da = 128), else ranks of 4 warps that
    hold theirs (64 rows): one block per (batch row, head) up to 128 live
    rows, four past it (32, 256 and 512 blocks at b = 1, 8, 16)."""
    c3, chunk3, direct3 = tca.decode_i8_plan(live)
    c4, chunk4, _, direct4 = tca.decode_i8_live_plan(live, 64)
    assert (c3, c4) == (k3, k4) and direct3 and direct4
    assert chunk3 <= (128 if k3 == 1 else 64) and chunk4 <= (128 if k4 == 1 else 64)


def test_decode_i8_live_plan_refuses_what_does_not_fit():
    """32,768 live tiles of one row hold no cluster's shared memory: the
    wrapper refuses them (before it looks for a card)."""
    c, chunk, ring, _ = tca.decode_i8_live_plan(32768, 1)
    assert tca.i8_smem_bytes(128, c, chunk, ring, 32768, True) > tca.I8_MAX_SMEM
    with pytest.raises(ValueError, match="do not fit"):
        tca._live_plan("test", 32768, 128, 32768, 1)


def _live_decomposition(q8, sq, k8, ks, v8, vs, live, bias, scale, rtile, c):
    """Kernel 4's decomposition in torch, as csrc/decode_attention_i8.cu
    cuts the work: each rank's tiles' maxima; the prefix maxima; each tile on
    its own (p, sum p, p * vs, sw_t, w8, the integer column sums), rank by
    rank; then the replay of l and acc in tile order, one division."""
    logits = tca._i8_logits(q8, sq, k8, ks, live, bias, scale)
    tiles = -(-live // rtile)
    cut = [(t * rtile, min((t + 1) * rtile, live)) for t in range(tiles)]
    tmax = [logits[:, :, lo:hi].amax(dim=-1, keepdim=True) for lo, hi in cut]
    m = [torch.full_like(tmax[0], -1e30)]
    for t in range(tiles):
        m.append(torch.maximum(m[-1], tmax[t]))
    per = -(-tiles // c)
    work = {}
    for r in range(c):  # independent tiles, in any order
        for t in range(min(r * per, tiles), min((r + 1) * per, tiles)):
            lo, hi = cut[t]
            p = torch.exp(logits[:, :, lo:hi] - m[t + 1])
            pw = p * vs[:, :, lo:hi].float()
            sw = tq.absmax_scale(pw.abs().amax(dim=-1, keepdim=True))
            w8 = torch.clamp(torch.round(pw / (sw + 1e-8)), -127.0, 127.0)
            work[t] = (p.sum(dim=-1, keepdim=True), sw,
                       tca._i8_weighted_rows(w8, v8[:, :, lo:hi]))
    l = torch.zeros_like(tmax[0])
    acc = torch.zeros(q8.shape, dtype=torch.float32)
    for t in range(tiles):  # the owners' replay, in tile order
        alpha = torch.exp(m[t] - m[t + 1])
        psum, sw, ints = work[t]
        l = l * alpha + psum
        acc = acc * alpha + ints * sw
    return (acc / (l + 1e-30)).to(ks.dtype).reshape(q8.shape[0], -1)


@pytest.mark.parametrize("live", [1, 63, 64, 65, 200, 256])
@pytest.mark.parametrize("rtile", [16, 64, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel4_decomposition_equals_the_plain_version(live, rtile, dtype):
    """Tile maxima, prefix maxima, independent tiles and a replay in tile
    order compute decode_attention_i8_live_plain bit for bit, at the
    cluster the plan gives and at every other, since the running maximum is
    all that the recurrence carries from tile to tile."""
    g = torch.Generator().manual_seed(live * 7 + rtile)
    b, na, R, da = 3, 2, 256, 64
    q8 = torch.randint(-127, 128, (b, na, da), generator=g, dtype=torch.int8)
    sq = 0.01 * torch.rand((b, na), generator=g) + 1e-3
    k8, v8 = (torch.randint(-127, 128, (b, na, R, da), generator=g, dtype=torch.int8)
              for _ in range(2))
    ks, vs = ((0.02 * torch.rand((b, na, R), generator=g) + 1e-3).to(dtype) for _ in range(2))
    bias = 2.0 * torch.randn((na, R), generator=g)  # maxima that move from tile to tile
    want = tca.decode_attention_i8_live_plain(q8, sq, k8, ks, v8, vs, live, bias, 0.125,
                                              rtile=rtile)
    plan = tca.decode_i8_live_plan(live, rtile, da)[0]
    for c in sorted({1, 2, 4, plan}):
        got = _live_decomposition(q8, sq, k8, ks, v8, vs, live, bias, 0.125, rtile, c)
        assert torch.equal(got, want), (c, float((got.float() - want.float()).abs().max()))


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


# --------------------------------------------------------------------------
# Kernel 6: nearest_plan
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,N,G,K,ksplit", [
    ("PR-DVQVAE2 step", 8192, 4, 512, 1), ("Base-VQVAE step", 8192, 1, 512, 2),
    ("PR-DVQVAE2, one sub-codebook", 8192, 1, 512, 2), ("PR-DVQVAE2 eval b4", 1024, 4, 512, 4),
    ("N past a tile", 8192 + 37, 4, 512, 1), ("one row", 1, 1, 512, 4), ("few codes", 1, 1, 7, 1),
    ("three chunks", 300, 2, 300, 2), ("two waves of tiles", 16384, 1, 512, 1)])
def test_nearest_plan_fills_the_card(name, N, G, K, ksplit):
    """One block of 256 threads an SM: the split is the one with the least
    waves x (chunks a block walks + its fixed cost of one chunk). At the
    training shapes every SM of the H100 but at most 8 holds a block in each
    wave: PR-DVQVAE2's four sub-codebooks give 256 row tiles unsplit (two
    waves of 132 and 124), Base-VQVAE's one codebook 64, split 2 ways (128
    blocks; split 4 ways, 256 blocks read 1.5x slower on the card)."""
    got, blocks = tvq.nearest_plan(N, G, K)
    assert got == ksplit, name
    tiles, chunks = -(-N // tvq.NI_ROWS), -(-K // tvq.NI_CODES)
    assert blocks == G * tiles * ksplit
    assert ksplit <= min(tvq.NI_MAX_SPLIT, chunks) and ksplit & (ksplit - 1) == 0

    def cost(s):
        return -(-(G * tiles * s) // tvq.CARD_SMS) * (-(-chunks // s) + 1)
    assert all(cost(ksplit) <= cost(s) for s in (1, 2, 4) if s <= min(tvq.NI_MAX_SPLIT, chunks))
    if (N, K) == (8192, 512):  # the training shapes: each wave fills all but 8 SMs
        assert blocks % tvq.CARD_SMS == 0 or blocks % tvq.CARD_SMS >= tvq.CARD_SMS - 8


@pytest.mark.parametrize("K", [1, 7, 128, 129, 300, 512, 513, 4096])
@pytest.mark.parametrize("ksplit", [1, 2, 4])
def test_nearest_code_ranges_hold_each_code_once(K, ksplit):
    """The ranks' code ranges, in rank order, hold each code once; each is
    whole 128-code chunks but for the last code."""
    ranges = _code_ranges(K, ksplit)
    assert len(ranges) == ksplit
    assert [k for a, b in ranges for k in range(a, b)] == list(range(K))
    assert all(a % tvq.NI_CODES == 0 or a == K for a, _ in ranges)


@pytest.mark.parametrize("z_bf16", [False, True])
def test_nearest_smem_fits_a_block(z_bf16):
    """Dynamic shared memory within the H100's 227 KB a block at every Dc up
    to 256: the stages stream Dc, so the size does not depend on it."""
    smem = _nearest_smem_bytes(z_bf16)
    assert smem == (89088 if z_bf16 else 113664)
    assert smem + 1024 <= min(SMEM_BLOCK, SMEM_SM)


# --------------------------------------------------------------------------
# Kernel 11: matmul_i8w_plan
# --------------------------------------------------------------------------

DSFVT_I8 = [(512, 3072), (1024, 512), (512, 512)]  # (K, N) of QKV, projection, FFN


@pytest.mark.parametrize("b", [1, 8, 16])
@pytest.mark.parametrize("K,N", DSFVT_I8)
def test_matmul_i8w_plan_fills_the_card(b, K, N):
    """DSFVT's three int8 products at the rollout's batch sizes: every block
    quantizes its rows itself, so the plan takes the most blocks that one
    wave of one block an SM of the H100 (132) holds, the fewest where none
    fits: 128 blocks for N = 512 (4 columns a block; 8 at b = 16), 192 for
    N = 3,072 (16 columns; 384 at b = 16). The SMs are all but 4 filled or
    more than filled."""
    cpb, nx, ny = tq.matmul_i8w_plan(b, K, N)
    assert cpb in tq.I8W_CPB
    assert nx == -(-N // cpb) and ny == -(-b // tq.I8W_ROWS)
    narrower = [c for c in tq.I8W_CPB if c < cpb]
    assert nx * ny <= tq.CARD_SMS or cpb == max(tq.I8W_CPB)
    assert all(-(-N // c) * ny > tq.CARD_SMS for c in narrower)
    assert nx * ny >= tq.CARD_SMS - 4
    assert (cpb, nx * ny) == ((16, 192 * ny) if N == 3072 else (8, 128) if b == 16 else (4, 128))


@pytest.mark.parametrize("b,K,N", [(1, 512, 3072), (8, 1024, 512), (16, 512, 512), (5, 64, 40),
                                   (19, 2048, 33), (3, 16384, 7), (1, 16, 1)])
def test_matmul_i8w_plan_covers_each_output_and_word_once(b, K, N):
    """The grid covers every (row, column) once, and the threads of a column
    every 16-byte word of its K once (K a multiple of 16, each a multiple of
    16 bytes of the weight row), in the order csrc/matmul_i8w.cu walks them:
    thread j of a column takes words j, j + 256 / cpb, ..."""
    cpb, nx, ny = tq.matmul_i8w_plan(b, K, N)
    cols = [bx * cpb + c for bx in range(nx) for c in range(cpb) if bx * cpb + c < N]
    assert cols == list(range(N))
    rows = [by * tq.I8W_ROWS + r for by in range(ny) for r in range(tq.I8W_ROWS)
            if by * tq.I8W_ROWS + r < b]
    assert rows == list(range(b))
    tpc, words = I8W_THREADS // cpb, K // 16
    taken = sorted(w for j in range(tpc) for w in range(j, words, tpc))
    assert taken == list(range(words)) and K % 16 == 0
    # shared memory: the block's int8 rows, their scales and the column sums
    warps_a_column = max(1, tpc // 32)
    smem = tq.I8W_ROWS * K + 4 * tq.I8W_ROWS + 4 * cpb * tq.I8W_ROWS * warps_a_column
    assert smem <= SMEM_BLOCK


# --------------------------------------------------------------------------
# Kernels 5 and 12: cache_attention_plan
# --------------------------------------------------------------------------

@pytest.mark.parametrize("b,na", [(1, 8), (16, 8), (64, 8), (256, 8), (3, 2)])
@pytest.mark.parametrize("da", [16, 64, 128])
def test_cache_attention_plan_holds_each_live_row_once(b, na, da):
    """Rank r owns rows [r * chunk, (r + 1) * chunk) cut at live; every live
    row once, ranks in order, a power-of-two cluster of at most 16 with a
    block an SM, ranks of 4 warps of 4 row loads or of 8 warps of 4 or 8
    (one warp a head only at da 16 up to 256 rows, and only past
    CACHE_WARP_HEADS heads), one pass of register loads wherever such a
    cluster holds the rows in passes of 8 loads, and a rank's shared memory
    within a block's."""
    heads = b * na
    for live in LIVES:
        c, chunk, warps, loads = tca.cache_attention_plan(b, na, live, da)
        assert 1 <= c <= tca.MAX_CLUSTER and c & (c - 1) == 0
        assert c == 1 or heads * c <= tca.CARD_SMS
        ranges = [(min(r * chunk, live), min((r + 1) * chunk, live)) for r in range(c)]
        assert [j for lo, hi in ranges for j in range(lo, hi)] == list(range(live))
        warp_heads = da == 16 and live <= tca.CACHE_WARP_ROWS and heads > tca.CACHE_WARP_HEADS
        assert (warps == 1) == warp_heads
        if warps == 1:
            assert c == 1 and chunk == live and loads == 8
            continue
        assert (warps, loads) in ((4, 4), (8, 4), (8, 8))
        assert loads == 4 or chunk > tca.cache_pass_rows(da, 8, 4)  # 8 loads only if needed
        most = min(tca.MAX_CLUSTER, max(1, tca.CARD_SMS // heads))
        if live * da <= most * 8 * tca.I8_WARP_BYTES:
            assert chunk <= tca.cache_pass_rows(da, warps, loads)
        assert tca.cache_smem_bytes(da, warps, loads, chunk) + 1024 <= SMEM_BLOCK


@pytest.mark.parametrize("b,live,da,plan", [
    (16, 1, 128, (1, 1, 4, 4)), (16, 64, 128, (1, 64, 4, 4)), (16, 128, 128, (1, 128, 8, 4)),
    (16, 200, 128, (1, 200, 8, 8)), (16, 256, 128, (1, 256, 8, 8)), (1, 256, 128, (4, 64, 4, 4)),
    (8, 256, 128, (2, 128, 8, 4)),
    (256, 256, 128, (1, 256, 8, 8)), (256, 64, 128, (1, 64, 4, 4)),
    (16, 256, 64, (1, 256, 8, 4)), (256, 256, 16, (1, 256, 1, 8)), (256, 1, 16, (1, 1, 1, 8)),
    (16, 256, 16, (1, 256, 4, 4)), (256, 257, 16, (1, 257, 4, 4))])
def test_cache_attention_plans_at_the_probe_and_rollout_shapes(b, live, da, plan):
    """Kernel 3's rule at DSFVT's width and 8 heads (one rank while 8 warps
    hold its rows in registers, else ranks of 4 warps that hold theirs: four
    at 256 live rows for b = 1), the cluster only while each block has an SM
    of its own (b = 8: two ranks; b = 16 and 256: one rank a head of 8 warps
    and 8 row loads a thread); one warp a head at the probe tool's shape
    (b 256, da 16)."""
    assert tca.cache_attention_plan(b, 8, live, da) == plan
