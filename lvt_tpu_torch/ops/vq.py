"""Vector quantization: nearest-code lookup, straight-through estimator and
the EMA codebook update (counterpart of lvt_tpu/ops/vq.py).

Nearest code by the expansion ``(||c||^2 + ||z||^2) - 2 z.c`` in fp32, summed
in the JAX package's order; ties go to the lowest index, as ``jnp.argmin``
and ``torch.argmin`` do. ``nearest_indices_grouped`` launches kernel 6
(``csrc/nearest_indices.cu``: the product on fp32 FMAs fused with the
arg-reduction, no (N, K) matrix in device memory) once for all sub-codebooks
on a CUDA tensor and runs the plain PyTorch version
(``nearest_indices_plain`` per sub-codebook, TF32 off, see
``lvt_tpu_torch/__init__.py``) on a CPU tensor; ``nearest_indices`` is the
one-codebook call of the same kernel. VQ-VAE training reaches the kernel
through ``quantize_st``, one launch a step, and the generation and
code-extraction path through ``encode_indices``, one launch an encode: on
the trained codebooks of tools/e2e_demo_torch.py (PR-DVQVAE2 and K-DVQVAE,
300 steps, every frame of their sets encoded) at most 1 of ~1.06 million
indices differed from the plain version's, a float64 near-tie (the rule
below allows 1 in 1,000).

Update order of ``quantize_st``, as the reference: the straight-through
output uses the embedding *before* the EMA update, the returned
differentiable ``z_q`` the embedding *after* it.

A codebook is a dict with the fields of lvt_tpu's ``EmaCodebookState``:
``embedding`` (num, K, Dc), ``running_size`` (num, K), ``running_sum``
(num, K, Dc).

Under tensor parallelism (inside ``parallel.mesh.tensor_parallel``, the
whole codebook's K given) the codebook is split over its K codes
(parallel/sharding.py): each rank of the model group searches its K/M codes
with kernel 6 and recomputes its winner's fp32 distance by ``_distances``'
formula; across the group the least distance wins, on exact ties the lowest
global index (``nearest_indices_sharded``). The EMA counts the rank's codes
only, summed over the data group; its normaliser ``n`` is summed over the
model group and its K is the whole codebook's. A lookup reads the owner's
row, zeros on the other ranks, summed over the group. Indices may differ
from the whole codebook's search only at near-ties (``index_differences``).

Where the frames are also split by rows over the model group
(``parallel.mesh.spatial_parallel``, TPU.SHARD_SPATIAL), the ranks hold
different rows of z and the split search above would compare distances of
different rows. So the group's rows are gathered first (``_group_rows``),
every rank searches its codes on all of them and the least distance wins as
above; each rank keeps its band's indices. The lookups are formed for all
the group's rows, summed over the group (a sum whose backward is the sum of
the ranks' gradients, so that a code's owner gets the gradient of every
rank's rows) and cut to the band. The EMA statistics count a rank's codes
over the group's gathered rows; with a whole codebook, over the band's rows,
summed over the rows' group. Both are summed over the data group as before.
"""

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from ..parallel.collectives import _all_gather, _all_reduce, all_reduce, reduce_from_model
from ..parallel.mesh import global_batch_group, model_parallel_group, spatial_group
from ..parallel.spatial import exchange
from ..parallel.sharding import tp_dim
from ._lib import CARD_SMS, LIBRARY, check_launch, counted
from .embedding import take_rows

Codebook = Dict[str, torch.Tensor]


def init_codebook(gen: torch.Generator, num: int, K: int, D: int) -> Codebook:
    """Uniform(-1/K, 1/K) embedding; running_sum starts as a copy of it,
    running_size as zeros (reference vq_embedding.py:12-21)."""
    emb = torch.empty(num, K, D // num).uniform_(-1.0 / K, 1.0 / K, generator=gen)
    return {"embedding": emb, "running_size": torch.zeros(num, K), "running_sum": emb.clone()}


# --------------------------------------------------------------------------
# Nearest-neighbor core: kernel 6 and its plain version
# --------------------------------------------------------------------------

def _distances(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """(N, Dc) x (K, Dc) -> (N, K) squared-distance surrogate in fp32."""
    z = z.float()
    codebook = codebook.float()
    c_sqr = (codebook ** 2).sum(dim=1)
    z_sqr = (z ** 2).sum(dim=1, keepdim=True)
    cross = z @ codebook.T
    return c_sqr[None, :] + z_sqr - 2.0 * cross


def nearest_indices_plain(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel 6: argmin_k ||z - c_k||^2, ties to the
    lowest index. z: (N, Dc) -> (N,) int32."""
    return torch.argmin(_distances(z, codebook), dim=1).to(torch.int32)


# Kernel 6's grid: (split, row tile, sub-codebook), NI_ROWS rows a tile, one
# block of 256 threads an SM (up to 255 registers a thread). The K codes of a
# row tile may be split over the blocks of a cluster (powers of two up to
# NI_MAX_SPLIT, never more splits than NI_CODES-code chunks). The split taken
# is the one with the least waves x (chunks a block walks + 1), the 1 being
# a block's fixed cost (staging, norms of the first chunk, the reductions):
# on the H100 at Base-VQVAE's N = 8,192, Dc = 256, splits 1 / 2 / 4 read
# 0.124 / 0.063 / 0.097 ms (64 blocks; 128 in one wave; 256 in two;
# tools/time_i8w_vq_parts_torch.py).
NI_ROWS = 128
NI_CODES = 128
NI_MAX_SPLIT = 4


def nearest_plan(N: int, G: int, K: int):
    """(ksplit, blocks) of kernel 6 for z (N, G, Dc) and codebooks (G, K,
    Dc): the blocks of a cluster that share one row tile's codes, and the
    grid's size (csrc/nearest_indices.cu cuts the codes from ksplit)."""
    tiles, chunks = -(-N // NI_ROWS), -(-K // NI_CODES)

    def cost(s):  # waves x (chunks a block walks + its fixed cost)
        return -(-(G * tiles * s) // CARD_SMS) * (-(-chunks // s) + 1)
    ksplit = min((s for s in (1, 2, 4) if s <= min(NI_MAX_SPLIT, chunks)),
                 key=lambda s: (cost(s), s))
    return ksplit, G * tiles * ksplit


@counted
def nearest_indices_grouped_cuda(z: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Kernel 6 (csrc/nearest_indices.cu) on CUDA tensors, all sub-codebooks
    in one launch. z (N, G, Dc) fp32 or bf16 with unit column stride, read in
    place (the ``z_e.reshape(-1, G, Dc)`` view of a training step); rows must
    start on 16-byte boundaries (8 for bf16); codebooks (G, K, Dc)
    contiguous fp32; N >= 1, K >= 1, Dc a multiple of 4 up to 256. Returns
    (N, G) int32.

    On finite inputs it returns what the plain version returns, up to the
    order of the fp32 sums (a choice between two codes whose distances lie
    within rounding of each other). A NaN in a z row makes every distance of
    the row NaN and both return 0; a NaN in a codebook row is skipped by the
    kernel, where ``argmin`` would return that row."""
    if not (z.is_cuda and codebooks.device == z.device):
        raise ValueError("nearest_indices_cuda: z and codebook must be on one CUDA device")
    if z.device.index != torch.cuda.current_device():
        raise ValueError("nearest_indices_cuda: inputs must lie on the current CUDA device")
    if z.dtype not in (torch.float32, torch.bfloat16) or codebooks.dtype != torch.float32:
        raise ValueError(f"nearest_indices_cuda: z must be float32 or bfloat16 and the codebook "
                         f"float32, got {z.dtype}, {codebooks.dtype}")
    if z.dim() != 3 or codebooks.dim() != 3 or z.shape[1] != codebooks.shape[0] \
            or z.shape[2] != codebooks.shape[2]:
        raise ValueError(f"nearest_indices_cuda: want z (N, G, Dc) and codebooks (G, K, Dc), got "
                         f"{tuple(z.shape)}, {tuple(codebooks.shape)}")
    (N, G, Dc), K = z.shape, codebooks.shape[1]
    if N < 1 or K < 1 or Dc % 4 or not 4 <= Dc <= 256:
        raise ValueError(f"nearest_indices_cuda: needs N >= 1, K >= 1 and Dc a multiple of 4 up "
                         f"to 256, got N={N}, K={K}, Dc={Dc}")
    # strides of a size-1 dimension are never used: take them as 0
    sn = z.stride(0) if N > 1 else 0
    sg = z.stride(1) if G > 1 else 0
    align = 8 if z.dtype == torch.bfloat16 else 16
    if z.stride(2) != 1 or not codebooks.is_contiguous() or sn % 4 or sg % 4 \
            or z.data_ptr() % align or codebooks.data_ptr() % 16:
        raise ValueError(f"nearest_indices_cuda: z needs unit column stride and rows on "
                         f"{align}-byte boundaries, the codebook must be contiguous and 16-byte "
                         f"aligned; got z strides {z.stride()}")
    lib = LIBRARY.get()
    out = torch.empty((N, G), dtype=torch.int32, device=z.device)
    err = lib.lvt_nearest_indices_grouped(
        z.data_ptr(), codebooks.data_ptr(), out.data_ptr(), N, G, K, Dc, sn, sg,
        int(z.dtype == torch.bfloat16), nearest_plan(N, G, K)[0],
        torch.cuda.current_stream().cuda_stream)
    check_launch("nearest_indices", err)
    nearest_indices_grouped_cuda.launches += 1
    return out


def nearest_indices_cuda(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Kernel 6 for one codebook: z (N, Dc), codebook (K, Dc) -> (N,) int32,
    as ``nearest_indices_grouped_cuda`` with G = 1 (a ``z[:, i, :]`` view of
    (N, num, Dc) is read in place)."""
    if z.dim() != 2 or codebook.dim() != 2:
        raise ValueError(f"nearest_indices_cuda: want z (N, Dc) and codebook (K, Dc), got "
                         f"{tuple(z.shape)}, {tuple(codebook.shape)}")
    return nearest_indices_grouped_cuda(z[:, None, :], codebook[None])[:, 0]


def nearest_indices_grouped_plain(z: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Plain version of the grouped kernel: ``nearest_indices_plain`` per
    sub-codebook. z (N, G, Dc), codebooks (G, K, Dc) -> (N, G) int32."""
    return torch.stack([nearest_indices_plain(z[:, i, :], codebooks[i])
                        for i in range(codebooks.shape[0])], dim=1)


def _use_kernel(z: torch.Tensor, use_kernel: Optional[bool]) -> bool:
    if use_kernel is None:
        if z.device.type not in ("cuda", "cpu"):
            raise ValueError(f"nearest_indices: no kernel for device {z.device}")
        return z.device.type == "cuda"
    return use_kernel


def nearest_indices(z: torch.Tensor, codebook: torch.Tensor,
                    use_kernel: Optional[bool] = None) -> torch.Tensor:
    """z (N, Dc) -> (N,) int32 nearest codes; no gradient. Kernel 6 on a CUDA
    tensor, its plain version on a CPU tensor; ``use_kernel=False`` takes the
    plain version on either, ``True`` the kernel (CUDA tensors only)."""
    z, codebook = z.detach(), codebook.detach()
    if _use_kernel(z, use_kernel):
        return nearest_indices_cuda(z, codebook.float().contiguous())
    return nearest_indices_plain(z, codebook)


def nearest_indices_grouped(z: torch.Tensor, codebooks: torch.Tensor,
                            use_kernel: Optional[bool] = None) -> torch.Tensor:
    """z (N, G, Dc) -> (N, G) int32 nearest codes of each sub-codebook of
    codebooks (G, K, Dc); no gradient. One launch of kernel 6 on a CUDA
    tensor, the plain version per sub-codebook on a CPU tensor;
    ``use_kernel`` as in ``nearest_indices``."""
    z, codebooks = z.detach(), codebooks.detach()
    if _use_kernel(z, use_kernel):
        return nearest_indices_grouped_cuda(z, codebooks.float().contiguous())
    return nearest_indices_grouped_plain(z, codebooks)


class CodebookShard(NamedTuple):
    """A codebook split over the K codes of a model group: this rank holds
    codes [lo, lo + K / size) of the whole ``K``."""
    group: dist.ProcessGroup
    size: int
    K: int
    lo: int

    def local(self, idx: torch.Tensor):
        """(index into this rank's codes, clamped; whether this rank owns it)
        for global indices ``idx``."""
        k_local = self.K // self.size
        local = idx.long() - self.lo
        own = (local >= 0) & (local < k_local)
        return local.clamp(0, k_local - 1), own


def codebook_shard(embedding: torch.Tensor, K: Optional[int]) -> Optional[CodebookShard]:
    """The split of a codebook whose embedding (num, K', Dc) is this rank's
    part of a whole codebook of ``K`` codes, inside ``tensor_parallel``;
    None where the codebook is whole (no model group, K not given, or a K
    the group's size does not divide). Raises where the rules split it and
    the embedding is not the rank's part."""
    group = model_parallel_group()
    if group is None or K is None:
        return None
    size = dist.get_world_size(group)
    num, k_here, dc = embedding.shape
    if tp_dim("embedding", (num, K, dc), size) is None:
        return None
    if k_here * size != K:
        raise ValueError(f"codebook of {k_here} codes under a model group of {size}: the "
                         f"rank's part of a codebook of K = {K} holds {K // size}")
    return CodebookShard(group, size, K, dist.get_rank(group) * k_here)


def nearest_indices_sharded(z: torch.Tensor, codebooks: torch.Tensor, shard: CodebookShard,
                            use_kernel: Optional[bool] = None) -> torch.Tensor:
    """z (N, G, Dc) -> (N, G) int32 global nearest codes of a codebook split
    over the model group: this rank's part codebooks (G, K/M, Dc) searched
    by ``nearest_indices_grouped`` (kernel 6 on a CUDA tensor), the winner's
    fp32 distance recomputed by ``_distances``' formula, and across the
    group the least distance, the lowest global index on exact ties."""
    local = nearest_indices_grouped(z, codebooks, use_kernel).long()  # (N, G)
    zf, c = z.detach().float(), codebooks.detach().float()
    cw = c[torch.arange(c.shape[0], device=c.device)[None, :], local]  # (N, G, Dc)
    dist_w = ((cw ** 2).sum(-1) + (zf ** 2).sum(-1)) - 2.0 * (zf * cw).sum(-1)
    both = _all_gather(torch.stack([dist_w, (local + shard.lo).float()])[None], shard.group)
    best = torch.argmin(both[:, 0], dim=0)  # the first least: the lowest rank, the lowest index
    return both[:, 1].gather(0, best[None])[0].to(torch.int32)


def _group_rows(x: torch.Tensor, shard: CodebookShard):
    """(x's rows (N, ...) of every rank of the model group, (M N, ...) in
    rank order, and the slice of them that is this rank's) where the frames
    are split by rows over that group; (x, None) where every rank holds the
    same rows. No gradient."""
    rows = spatial_group()
    if rows is None:
        return x, None
    if dist.get_process_group_ranks(rows) != dist.get_process_group_ranks(shard.group):
        raise ValueError("a codebook split over one group of ranks and frames split by rows "
                         "over another")
    n = x.shape[0]
    rank = dist.get_rank(rows)
    return exchange(x.detach(), rows).reshape((-1,) + tuple(x.shape[1:])), \
        slice(rank * n, (rank + 1) * n)


def _search_rows(z: torch.Tensor, codebooks: torch.Tensor, shard: CodebookShard,
                 use_kernel: Optional[bool]):
    """(the global nearest codes of the rows ``_group_rows`` gives, those
    rows, the slice of them that is this rank's)."""
    z_rows, band = _group_rows(z, shard)
    return nearest_indices_sharded(z_rows, codebooks, shard, use_kernel), z_rows, band


def _sum_owned(x: torch.Tensor, shard: CodebookShard, band: Optional[slice]) -> torch.Tensor:
    """The owners' lookups x (zeros elsewhere) summed over the model group:
    with the same rows on every rank, a sum whose gradient passes as it is;
    with the group's rows (``band``: this rank's), a sum whose gradient is
    summed over the ranks, cut to the band."""
    if band is None:
        return reduce_from_model(x, shard.group)
    return all_reduce(x.float(), shard.group)[band].to(x.dtype)


def _owned_rows(emb: torch.Tensor, idx: torch.Tensor, shard: CodebookShard) -> torch.Tensor:
    """Rows of this rank's embedding (num, K/M, Dc) at global indices idx
    (N, num), zero where another rank owns the code: (N, num, Dc)."""
    local, own = shard.local(idx)
    rows = emb[torch.arange(emb.shape[0], device=emb.device)[None, :], local]
    return rows * own[..., None].to(rows.dtype)


# --------------------------------------------------------------------------
# Straight-through quantization + EMA update
# --------------------------------------------------------------------------

def _ema_stats(z: torch.Tensor, indices: torch.Tensor, K: int,
               owned: Optional[torch.Tensor] = None,
               rows: Optional[dist.ProcessGroup] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-batch cluster size (K,) and vector sum (K, Dc), fp32, no gradient.
    A one-hot product as in the JAX package, not a scatter-add: atomics would
    sum in another order on every call on the card. Inside the trainer's
    global batch both are summed over its ranks (the data group) in one
    all-reduce (lvt_tpu/ops/vq.py:181-183), and over ``rows``, the group
    whose ranks hold the other bands of rows of the same frames; kernel 6's
    indices stay per rank. ``owned`` (N,) bool: count only those rows (a
    split codebook's own codes; its rows are then every band's, and
    ``rows`` None)."""
    z = z.detach().float()
    one_hot = torch.nn.functional.one_hot(indices.long(), K).to(torch.float32)  # (N, K)
    if owned is not None:
        one_hot = one_hot * owned[:, None].to(torch.float32)
    size, vec_sum = one_hot.sum(dim=0), one_hot.T @ z
    for group in (global_batch_group(), rows):
        if group is not None:
            both = torch.cat([size[:, None], vec_sum], dim=1)
            dist.all_reduce(both, group=group)
            size, vec_sum = both[:, 0], both[:, 1:]
    return size, vec_sum


def _ema_update(running_size, running_sum, size, vec_sum, decay: float, eps: float,
                shard: Optional[CodebookShard] = None):
    """The EMA embedding follows from the running sums alone; the current
    embedding takes no part (reference vq_embedding.py:56-59). With a split
    codebook, K is the whole codebook's and n the sum over every rank's
    codes."""
    K = running_size.shape[0] if shard is None else shard.K
    new_size = running_size * decay + (1.0 - decay) * size
    new_sum = running_sum * decay + (1.0 - decay) * vec_sum
    n = new_size.sum()
    if shard is not None:
        n = _all_reduce(n.reshape(1), shard.group)[0]
    denom = (new_size + eps) / (n + K * eps) * n
    new_emb = new_sum / denom[:, None]
    return new_emb, new_size, new_sum


def quantize_st(z_e: torch.Tensor, codebook: Codebook, *, ema: bool, train: bool,
                decay: float = 0.99, eps: float = 1e-5, use_kernel: Optional[bool] = None,
                K: Optional[int] = None):
    """Straight-through quantization of decomposed codes.

    z_e: (..., D) with D = num * Dc. Returns (z_q_st, z_q, indices,
    new_codebook): z_q_st carries the identity gradient to z_e; z_q is the
    lookup in the embedding after the EMA update and carries the codebook's
    gradient (the non-EMA loss term); the new codebook holds no graph when
    ``ema and train`` (else it is the old one's tensors). K: the whole
    codebook's size; under tensor parallelism the codebook given is the
    rank's part of it (``codebook_shard``), and the indices are global.
    """
    emb = codebook["embedding"]
    num, K_here, Dc = emb.shape
    shard = codebook_shard(emb, K)
    lead = z_e.shape[:-1]
    z = z_e.reshape(-1, num, Dc)
    # every sub-codebook's indices from the embedding before the update, at once
    if shard is None:
        idx_all = nearest_indices_grouped(z, emb, use_kernel)
        # the rows the lookups and the EMA statistics read (their codes, whether
        # this rank owns them), and the group holding the frames' other rows
        q_local, q_own = idx_all, None
        stats_z, stats_rows = z, spatial_group()
    else:  # global indices; this rank's codes among them, and their rows summed over the group
        idx_rows, stats_z, band = _search_rows(z, emb, shard, use_kernel)
        idx_all = idx_rows if band is None else idx_rows[band]
        q_local, q_own = shard.local(idx_rows)
        stats_rows = None  # a rank's codes, counted over the group's rows
        pre_all = _sum_owned(_owned_rows(emb.detach(), idx_rows, shard), shard, band)

    st_parts, q_parts = [], []
    new_emb, new_rs, new_rsum = [], [], []
    for i in range(num):
        zi = z[:, i, :]
        emb_i = emb[i]
        # straight-through uses the embedding before the update
        z_q_pre = emb_i.detach()[idx_all[:, i].long()] if shard is None else pre_all[:, i]
        st = zi + (z_q_pre - zi.detach().to(z_q_pre.dtype)).to(zi.dtype)

        if ema and train:
            size, vec_sum = _ema_stats(stats_z[:, i, :], q_local[:, i], K_here,
                                       None if q_own is None else q_own[:, i], stats_rows)
            e, rs, rsum = _ema_update(codebook["running_size"][i], codebook["running_sum"][i],
                                      size, vec_sum, decay, eps, shard)
        else:
            e, rs, rsum = emb_i, codebook["running_size"][i], codebook["running_sum"][i]

        # the differentiable lookup uses the embedding after the update (with a
        # split codebook the owner's row, summed over the group after the loop)
        q = take_rows(e, q_local[:, i])
        if q_own is not None:
            q = q * q_own[:, i, None].to(q.dtype)

        st_parts.append(st)
        q_parts.append(q)
        new_emb.append(e)
        new_rs.append(rs)
        new_rsum.append(rsum)

    z_q_st = torch.stack(st_parts, dim=1).reshape(z_e.shape)
    z_q = torch.stack(q_parts, dim=1)
    if shard is not None:
        z_q = _sum_owned(z_q, shard, band)
    z_q = z_q.reshape(lead + (num * Dc,)).to(z_e.dtype)
    indices = idx_all.reshape(lead + (num,))
    new_codebook = {"embedding": torch.stack(new_emb), "running_size": torch.stack(new_rs),
                    "running_sum": torch.stack(new_rsum)}
    return z_q_st, z_q, indices, new_codebook


# Two nearest-code answers may differ only at near-ties: where the float64
# distances of the two codes to z lie within NEAR_TIE_ULPS fp32 ulps of |z|^2 +
# |c|^2 (the scale of the expansion's sums), and at most NEAR_TIE_SHARE of the
# indices may differ (ROADMAP queue 3). A difference beyond that is a fault.
NEAR_TIE_ULPS, NEAR_TIE_SHARE = 8, 1e-3


def index_differences(got: torch.Tensor, want: torch.Tensor, z: torch.Tensor,
                      codebooks: torch.Tensor) -> Tuple[int, int]:
    """(indices that differ, those among them that are no near-tie) of two
    (N, G) index tensors for z (N, G, Dc) and codebooks (G, K, Dc), by float64
    distances on the CPU. ``want`` is the reference answer."""
    got, want = got.cpu().long(), want.cpu().long()
    rows, groups = torch.nonzero(got != want, as_tuple=True)
    if not len(rows):
        return 0, 0

    def take(t, *idx):  # the differing rows only, to the CPU in float64
        return t.detach()[tuple(i.to(t.device) for i in idx)].cpu().double()

    z64 = take(z, rows, groups)
    cg = take(codebooks, groups, got[rows, groups])
    cw = take(codebooks, groups, want[rows, groups])
    dg, dw = ((z64 - cg) ** 2).sum(1), ((z64 - cw) ** 2).sum(1)
    size = (z64 ** 2).sum(1) + (cw ** 2).sum(1)
    return len(rows), int(((dg - dw).abs() > NEAR_TIE_ULPS * 2 ** -23 * size).sum())


def encode_indices(z_e: torch.Tensor, codebook: Codebook,
                   use_kernel: Optional[bool] = None, K: Optional[int] = None) -> torch.Tensor:
    """(..., D) -> (..., num) int32 codebook indices: kernel 6 on a CUDA
    tensor, the plain fp32 version on a CPU tensor; ``use_kernel`` as in
    ``nearest_indices``; ``K`` as in ``quantize_st``."""
    emb = codebook["embedding"]
    num, _, Dc = emb.shape
    z = z_e.reshape(-1, num, Dc)
    shard = codebook_shard(emb, K)
    if shard is None:
        idx = nearest_indices_grouped(z, emb, use_kernel)
    else:
        idx, _, band = _search_rows(z, emb, shard, use_kernel)
        idx = idx if band is None else idx[band]
    return idx.reshape(z_e.shape[:-1] + (num,))


def embed_indices(indices: torch.Tensor, codebook: Codebook,
                  K: Optional[int] = None) -> torch.Tensor:
    """(..., num) int -> (..., D) embeddings, chunk-concatenated; ``K`` as in
    ``quantize_st``."""
    emb = codebook["embedding"]
    shard = codebook_shard(emb, K)
    if shard is not None:
        flat, band = _group_rows(indices.reshape(-1, emb.shape[0]), shard)
        rows = _sum_owned(_owned_rows(emb, flat, shard), shard, band)
        return rows.reshape(indices.shape[:-1] + (-1,))
    parts = [emb[i][indices[..., i].long()] for i in range(emb.shape[0])]
    return torch.cat(parts, dim=-1)
