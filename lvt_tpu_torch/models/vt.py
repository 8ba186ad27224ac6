"""Subscale Video Transformer (counterpart of lvt_tpu/models/vt.py; reference
vidgen/modeling/autoregressive/videotransformer.py, meta_arch/vt.py).

* VTEncoder: context one-hot Conv3d as an embedding gather-sum
  (ops.conv.subscale_context_encode), + slice-index embedding, optional class
  embedding concat, projector, stack of unmasked BlockLocalAttention.
* VTDecoder: summed per-channel embeddings, causal MaskedConv3d, 3-D
  sinusoidal posenc, projected context add, masked BlockLocalAttention.
* ChannelPredictor: within-pixel autoregression over the nc codebook
  channels with U_k MLPs and shared / per-channel / tied output heads.

Parameters are the JAX package's netG tree as torch tensors: nested dicts
and lists, each attention layer a dict with the fields of ``BlockAttnParams``.
Layouts: codes (b, nc, T, H, W) int at the API boundary, activations
channels-last (b, t, h, w, d). Randomness comes from a ``torch.Generator``.

Under tensor parallelism (inside ``parallel.mesh.tensor_parallel``) the
netG tree holds the rank's part of each leaf that parallel/sharding.py
splits, and the passes put the model group's collectives where the splits
need them: the feature-split lookups (the encoder's context table, the slice
and class embeddings, ``ch_embed``) are gathered before the replicated
projector and conv; attention and FFN run on the rank's heads and columns
(ops/attention.py ``LayerShard``), unfused; the predictor's ``U`` is
column-parallel and ``P`` row-parallel, summed over the group before its
bias. A TP run computes what the whole model computes, up to the order of
the sums.
"""

import functools
import logging
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.utils.checkpoint

from ..ops import subscale as ss
from ..ops.attention import (LayerShard, _layer_norm, block_local_attention,
                             current_checkpoint_name, merge_blocks, relative_bias, split_blocks)
from ..ops.conv import masked_conv3d, subscale_context_encode
from ..ops.embedding import take_rows
from ..ops.fused_layer import fused_block_layer, fused_layer_supported
from ..ops.posenc import add_positional_encoding
from ..parallel.collectives import (all_reduce, copy_to_model, gather_features, local_features,
                                    reduce_from_model)
from ..parallel.mesh import batch_rows, global_batch_group, model_parallel_group
from ..parallel.sharding import tp_dim
from . import to_device

logger = logging.getLogger(__name__)


class VTConfig(NamedTuple):
    nc: int
    nv: int
    kernel: Tuple[int, int, int]
    stride: Tuple[int, int, int]
    d: int
    da: int
    de: int
    blocks_e: Tuple[Tuple[int, int, int], ...]
    n_head_e: Tuple[int, ...]
    blocks_d: Tuple[Tuple[int, int, int], ...]
    n_head_d: Tuple[int, ...]
    n_prime: int
    pad_value: int
    share_p: bool
    share_embeddings: bool
    class_num: int

    @staticmethod
    def from_cfg(cfg) -> "VTConfig":
        v = cfg.MODEL.AUTOREGRESSIVE.VT
        return VTConfig(
            nc=v.NC, nv=v.NV, kernel=tuple(v.KERNEL), stride=tuple(v.STRIDE),
            d=v.D, da=v.DA, de=v.DE,
            blocks_e=tuple(tuple(b) for b in v.BLOCKS_E), n_head_e=tuple(v.N_HEAD_E),
            blocks_d=tuple(tuple(b) for b in v.BLOCKS_D), n_head_d=tuple(v.N_HEAD_D),
            n_prime=v.N_PRIME, pad_value=v.PAD_VALUE,
            share_p=v.SHARE_P, share_embeddings=v.SHARE_EMBEDDINGS,
            class_num=v.CLASS_NUM,
        )


class VTShard(NamedTuple):
    """The model group of a tensor-parallel VT and which of its leaves are
    split there (the guards of parallel/sharding.py on the whole model's
    shapes): ``d`` the predictor's U (columns) and P (rows), ``de`` the
    embeddings' features."""
    group: Any
    size: int
    d: bool
    de: bool


def vt_shard(c: VTConfig) -> Optional[VTShard]:
    """The VT's shard inside ``tensor_parallel``, else None."""
    group = model_parallel_group()
    if group is None:
        return None
    size = dist.get_world_size(group)
    return VTShard(group, size, tp_dim("U_b", (c.d,), size) is not None,
                   tp_dim("ch_embed", (c.nc, c.nv, c.de), size) is not None)


def _layer_shards(c: VTConfig, heads) -> Optional[list]:
    """Each layer's ``LayerShard`` inside ``tensor_parallel``, else None."""
    sh = vt_shard(c)
    if sh is None:
        return None
    return [LayerShard.of(sh.group, sh.size, na, c.d, c.da) for na in heads]


def _gathered(x, sh: Optional[VTShard]):
    """A feature-split lookup's rows made whole."""
    return gather_features(x, sh.group) if sh is not None and sh.de else x


# --------------------------------------------------------------------------
# Parameter init (random, seeded; real weights come through checkpoint/)
# --------------------------------------------------------------------------

def _xavier_uniform(gen, shape, fan_in, fan_out):
    lim = float(np.sqrt(6.0 / (fan_in + fan_out)))
    return torch.empty(shape).uniform_(-lim, lim, generator=gen)


def _xavier_normal(gen, shape, fan_in, fan_out):
    return torch.empty(shape).normal_(0.0, float(np.sqrt(2.0 / (fan_in + fan_out))),
                                      generator=gen)


def init_block_attn(gen, block_size, na: int, d: int, da: int) -> Dict[str, torch.Tensor]:
    """Xavier-normal head weights, zero bias banks, xavier-uniform FFN."""
    t, h, w = block_size
    return {
        "ln_scale": torch.ones(d), "ln_bias": torch.zeros(d),
        "wq": _xavier_normal(gen, (na, d, da), d, da),
        "wk": _xavier_normal(gen, (na, d, da), d, da),
        "wv": _xavier_normal(gen, (na, d, da), d, da),
        "proj": _xavier_normal(gen, (na * da, d), na * da, d),
        "ffn_ln_scale": torch.ones(d), "ffn_ln_bias": torch.zeros(d),
        "ffn_w1": _xavier_uniform(gen, (d, d), d, d), "ffn_b1": torch.zeros(d),
        "ffn_w2": _xavier_uniform(gen, (d, d), d, d), "ffn_b2": torch.zeros(d),
        "dt_bank": torch.zeros(na, 2 * t - 1),
        "dh_bank": torch.zeros(na, 2 * h - 1),
        "dw_bank": torch.zeros(na, 2 * w - 1),
    }


def init_vt_params(gen: torch.Generator, c: VTConfig) -> Dict[str, Any]:
    """The netG tree with the JAX package's names and shapes, on the CPU."""
    st, sh, sw = c.stride
    kt, kh, kw = c.kernel
    cin = 2 * c.de if c.class_num > 0 else c.de
    enc = {
        "ctx_table": _xavier_uniform(gen, (c.nc, kt, kh, kw, c.nv, c.de),
                                     c.nc * c.nv * kt * kh * kw, c.de * kt * kh * kw),
        "ctx_bias": torch.zeros(c.de),
        "slice_embedding": torch.randn((st * sh * sw, c.de), generator=gen),
        "projector": _xavier_uniform(gen, (cin, c.d), cin, c.d),
        "layers": [init_block_attn(gen, b, n, c.d, c.da)
                   for b, n in zip(c.blocks_e, c.n_head_e)],
    }
    if c.class_num > 0:
        enc["class_embedding"] = torch.randn((c.class_num, c.de), generator=gen)
    dec = {
        "ch_embed": torch.randn((c.nc, c.nv, c.de), generator=gen),
        "conv_w": _xavier_uniform(gen, (3, 3, 3, c.de, c.d), c.de * 27, c.d * 27),
        "conv_b": torch.zeros(c.d),
        "projector": _xavier_uniform(gen, (c.d, c.d), c.d, c.d),
        "layers": [init_block_attn(gen, b, n, c.d, c.da)
                   for b, n in zip(c.blocks_d, c.n_head_d)],
    }
    pred: Dict[str, Any] = {
        "ln_scale": torch.ones(c.d), "ln_bias": torch.zeros(c.d),
        "U_w": [_xavier_uniform(gen, (c.d + k * c.nv, c.d), c.d + k * c.nv, c.d)
                for k in range(c.nc)],
        "U_b": [torch.zeros(c.d) for _ in range(c.nc)],
    }
    if c.share_p:
        assert not c.share_embeddings, "share_p and share_embeddings conflict"
        pred["P_w"] = _xavier_uniform(gen, (c.d, c.nv), c.d, c.nv)
        pred["P_b"] = torch.zeros(c.nv)
    elif c.share_embeddings:
        pred["P_w"] = _xavier_uniform(gen, (c.d, c.de), c.d, c.de)
        pred["P_b"] = torch.zeros(c.de)
    else:
        pred["P_w"] = [_xavier_uniform(gen, (c.d, c.nv), c.d, c.nv) for _ in range(c.nc)]
        pred["P_b"] = [torch.zeros(c.nv) for _ in range(c.nc)]
    return {"encoder": enc, "decoder": dec, "predictor": pred}


# --------------------------------------------------------------------------
# Forward passes
# --------------------------------------------------------------------------

def _checkpoint_policy(remat):
    """The ``context_fn`` of ``torch.utils.checkpoint`` for a remat policy
    (lvt_tpu's ``_checkpoint_policy``), or None: True saves nothing but the
    layer's input. "dots" saves the products (jax's checkpoint_dots) and
    recomputes the rest; the attention core is a custom Function whose
    forward runs without grad, so its output (kernel 1's) is recomputed, as
    the Pallas call's is. "qkv" saves only the q/k/v projections, the
    products ``ops.attention.mha_tokens`` tags with ``checkpoint_name``."""
    if remat not in ("dots", "qkv"):
        return None
    from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

    dots = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)

    def policy(ctx, op, *args, **kwargs):
        save = (op in dots and torch.is_grad_enabled()
                and (remat == "dots" or current_checkpoint_name() == "qkv"))
        return CheckpointPolicy.MUST_SAVE if save else CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(create_selective_checkpoint_contexts, policy)


_LOGGED = set()


def _log_once(msg: str):
    if msg not in _LOGGED:
        _LOGGED.add(msg)
        logger.info(msg)


def _apply_attn_stack(x, layers, blocks, causal: bool, remat=False, fused: bool = False,
                      shards=None):
    """Run a stack of BlockLocalAttention layers. remat (TPU.REMAT and
    TPU.REMAT_POLICY: False, True, "dots" or "qkv") checkpoints each layer:
    True keeps only its input for the backward and recomputes the layer
    there, as jax.checkpoint with no saved names does; the policies save
    what ``_checkpoint_policy`` says. fused=True (TPU.FUSED_LAYER) runs each
    layer as the fused layer of ops/fused_layer.py when the stack has more
    than one layer and its geometry passes ``fused_layer_supported``, as
    lvt_tpu does: the token form round-trips once for the whole stack, and
    the fused layer is its own remat unit, so ``remat`` (any policy) adds no
    checkpoint around it. Any other stack runs the unfused layers.

    shards: each layer's ``LayerShard`` under tensor parallelism (None: the
    layers are whole). Then the unfused layers run: kernels 7-9 fuse across
    the point where a row-parallel product's sum over the group must come.
    A remat recompute runs the layer's collectives again in the backward,
    on every rank in the same order."""
    if shards is not None:
        if fused:
            _log_once("tensor parallel: the fused layer (TPU.FUSED_LAYER) does not run under a "
                      "model group; the unfused layers (kernels 1 and 10) do")
        fused = False
    else:
        shards = [None] * len(layers)
    if fused and len(layers) > 1 and fused_layer_supported(layers, blocks):
        blk = tuple(blocks[0])
        tokens, geom = split_blocks(x, blk)
        for p in layers:
            bias = relative_bias(p["dt_bank"], p["dh_bank"], p["dw_bank"], blk)
            tokens = fused_block_layer(tokens, p, bias, causal)
        return merge_blocks(tokens, geom)
    policy = _checkpoint_policy(remat) if remat else None
    for p, blk, shard in zip(layers, blocks, shards):
        if remat and torch.is_grad_enabled():
            kw = {} if policy is None else {"context_fn": policy}
            x = torch.utils.checkpoint.checkpoint(block_local_attention, x, p, tuple(blk),
                                                  causal, shard, use_reentrant=False, **kw)
        else:
            x = block_local_attention(x, p, tuple(blk), causal, shard)
    return x


def vt_encode(params, c: VTConfig, ctx, slice_idx, class_idx=None, remat=False,
              fused: bool = False):
    """Context branch. ctx: (b, nc, T', H', W') codes with pad_value at
    invisible positions; slice_idx: (b,). Returns zl (b, t, h, w, d)."""
    enc = params["encoder"]
    sh = vt_shard(c)
    if sh is not None and sh.de:  # the rank's features of each lookup, made whole
        x = _gathered(subscale_context_encode(ctx, enc["ctx_table"], None, c.stride, c.nv), sh)
        x = x + enc["ctx_bias"]
    else:
        x = subscale_context_encode(ctx, enc["ctx_table"], enc["ctx_bias"], c.stride, c.nv)
    x = x + _gathered(enc["slice_embedding"][slice_idx.long()][:, None, None, None, :], sh)
    if c.class_num > 0 and class_idx is not None:
        cls = _gathered(enc["class_embedding"][class_idx.long()][:, None, None, None, :], sh)
        x = torch.cat([x, cls.expand(x.shape)], dim=-1)
    x = x @ enc["projector"]
    return _apply_attn_stack(x, enc["layers"], c.blocks_e, False, remat, fused,
                             _layer_shards(c, c.n_head_e))


def _embed_sum_codes(dec, c: VTConfig, codes):
    """Summed per-channel embeddings: codes (..., nc) -> (..., de)."""
    out = take_rows(dec["ch_embed"][0], codes[..., 0])
    for k in range(1, c.nc):
        out = out + take_rows(dec["ch_embed"][k], codes[..., k])
    return _gathered(out, vt_shard(c))


def vt_decode(params, c: VTConfig, slice_codes, zl, remat=False, fused: bool = False):
    """Slice branch. slice_codes: (b, nc, t, h, w) int; zl: (b, t, h, w, d).
    Returns yl (b, t, h, w, d)."""
    dec = params["decoder"]
    emb = _embed_sum_codes(dec, c, slice_codes.movedim(1, -1))
    x = masked_conv3d(emb, dec["conv_w"], dec["conv_b"])
    x = add_positional_encoding(x)
    x = x + zl @ dec["projector"]
    return _apply_attn_stack(x, dec["layers"], c.blocks_d, True, remat, fused,
                             _layer_shards(c, c.n_head_d))


def _predictor_in(y, c: VTConfig):
    """The predictor's (layer-normed) input as the U products take it: under
    a split U, its gradient summed over the model group (one sum for all nc
    channels)."""
    sh = vt_shard(c)
    return copy_to_model(y, sh.group) if sh is not None and sh.d else y


def _predictor_head(pred, c: VTConfig, k: int, u, dec_params):
    """relu(u) -> nv logits via shared / per-channel / tied head. Under a
    split P the rank's rows' partial product is summed over the model group
    before the bias; a tied head reads the rank's ch_embed features, so its
    product is summed too."""
    r = torch.relu(u)
    sh = vt_shard(c)

    def rows(w):
        return reduce_from_model(r @ w, sh.group) if sh is not None and sh.d else r @ w

    if c.share_p:
        return rows(pred["P_w"]) + pred["P_b"]
    if c.share_embeddings:
        e = rows(pred["P_w"]) + pred["P_b"]
        ch = dec_params["ch_embed"][k]
        if sh is not None and sh.de:
            return reduce_from_model(local_features(e, sh.group) @ ch.T, sh.group)
        return e @ ch.T
    return rows(pred["P_w"][k]) + pred["P_b"][k]


def _predictor_u(pred, c: VTConfig, k: int, y, codes):
    """u_k = U_k([y; onehot(codes_<k)]), the one-hot block as row gathers
    (codes: (..., nc) int; only channels < k are read). Under a split U,
    the rank's columns of u_k (y as ``_predictor_in`` gives it)."""
    w = pred["U_w"][k]
    d, nv = y.shape[-1], c.nv
    u = y @ w[:d] + pred["U_b"][k]
    for j in range(k):
        u = u + take_rows(w[d + j * nv: d + (j + 1) * nv], codes[..., j])
    return u


def vt_logits(params, c: VTConfig, ctx, slice_codes, slice_idx, class_idx=None,
              remat=False, fused: bool = False):
    """Teacher-forced logits for all positions/channels: (b, t, h, w, nc, nv)
    in the parameter dtype."""
    zl = vt_encode(params, c, ctx, slice_idx, class_idx, remat, fused)
    yl = vt_decode(params, c, slice_codes, zl, remat, fused)
    pred = params["predictor"]
    y = _predictor_in(_layer_norm(yl, pred["ln_scale"], pred["ln_bias"]), c)
    codes = slice_codes.movedim(1, -1)
    outs = [_predictor_head(pred, c, k, _predictor_u(pred, c, k, y, codes), params["decoder"])
            for k in range(c.nc)]
    return torch.stack(outs, dim=-2)


def vt_sample_pixel_channels(params, c: VTConfig, y_pix, gen: Optional[torch.Generator],
                             temp: float, greedy: bool = False):
    """Sample the nc channel codes of one pixel autoregressively. y_pix:
    (b, d), already layer-normed. Returns (b, nc) int32. Greedy takes the
    first maximum, as jnp.argmax; otherwise a categorical draw at
    ``temp`` from ``gen``: argmax(probs / E) with E ~ Exp(1), the draw of
    ``torch.multinomial(probs, 1, generator=gen)`` (the same numbers from
    the same generator state) without its host-side checks of probs, which
    read the device and could not be captured in a CUDA graph."""
    pred = params["predictor"]
    codes = torch.zeros((y_pix.shape[0], c.nc), dtype=torch.int32, device=y_pix.device)
    for k in range(c.nc):
        u = _predictor_u(pred, c, k, y_pix, codes)
        logits = _predictor_head(pred, c, k, u, params["decoder"]).float()
        if greedy:
            sk = torch.argmax(logits, dim=-1)
        else:
            probs = torch.softmax(logits / temp, dim=-1)
            sk = torch.argmax(probs / torch.empty_like(probs).exponential_(1, generator=gen),
                              dim=-1)
        codes[:, k] = sk.to(torch.int32)
    return codes


# --------------------------------------------------------------------------
# Meta-arch: whole-video sampling over the SubscalePlan
# --------------------------------------------------------------------------

class VideoTransformer:
    """Meta-arch wrapper (counterpart of lvt_tpu's VideoTransformer)."""

    def __init__(self, cfg, T: int = 16, H: int = 16, W: int = 16):
        self.cfg = cfg
        self.c = VTConfig.from_cfg(cfg)
        self.T, self.H, self.W = T, H, W
        self.plan = self._plan_for(T, H, W)
        self._maps = {}
        # False | True (per-layer remat) | "dots" | "qkv", as lvt_tpu reads
        # TPU.REMAT / TPU.REMAT_POLICY
        policy = getattr(cfg.TPU, "REMAT_POLICY", "")
        if policy not in ("", "dots", "qkv"):
            raise ValueError(f"TPU.REMAT_POLICY must be '' (full remat), 'dots' or 'qkv', "
                             f"got {policy!r}")
        self.remat = (policy or True) if cfg.TPU.REMAT else False
        self.fused = bool(getattr(cfg.TPU, "FUSED_LAYER", False))
        self._slice_graph_slot = None  # the rollout's CUDA graph (models/rollout_graph.py)

    def _plan_for(self, T: int, H: int, W: int):
        return ss.build_plan(*self.c.stride, T, H, W, *self.c.kernel)

    def _device_maps(self, plan, device):
        """The plan's per-slice maps as tensors on ``device``, made once."""
        key = (plan.T, plan.H, plan.W, str(device))
        if key not in self._maps:
            def t(a):
                return None if a is None else torch.as_tensor(np.asarray(a, np.int64),
                                                              device=device)
            self._maps[key] = {"slice_src": t(plan.slice_src), "ctx_src": t(plan.ctx_src),
                               "ctx_frame_src": t(plan.ctx_frame_src)}
        return self._maps[key]

    def init(self, gen: torch.Generator, device="cpu"):
        """Returns (params, model_state); the VT keeps no mutable state."""
        return {"netG": to_device(init_vt_params(gen, self.c), device)}, {}

    # -- training ------------------------------------------------------------
    def prepare_slices(self, video, slice_idx):
        """Per-sample slice preparation. video: (b, nc, T, H, W) codes;
        slice_idx: (b,) int tensor on video's device. Returns (context
        (b, nc, T', H', W'), slice codes (b, nc, t, h, w), ignore (b, t, h, w)
        bool: positions in primed frames)."""
        b, nc, T, H, W = video.shape
        plan = self._plan_for(T, H, W)
        maps = self._device_maps(plan, video.device)
        vflat = video.reshape(b, nc, -1)
        slice_idx = slice_idx.to(video.device).long()
        src = maps["slice_src"][slice_idx]  # (b, t, h, w)
        sl = ss.gather_slice(vflat, src)
        ignore = src // (H * W) < self.c.n_prime
        if plan.ctx_frame_src is not None:
            fmap = maps["ctx_frame_src"][slice_idx]  # (b, T')
            ctx = ss.gather_context_frames(vflat.reshape(b, nc, T, H * W), fmap, self.c.pad_value)
            ctx = ctx.reshape(b, nc, fmap.shape[-1], H, W)
        else:
            ctx = ss.gather_context(vflat, maps["ctx_src"][slice_idx], self.c.pad_value)
        return ctx, sl, ignore

    def sample_train_slice_idx(self, gen: Optional[torch.Generator], batch: int,
                               T: Optional[int] = None) -> torch.Tensor:
        """Random slice index per sample, on the CPU, from ``gen``. For the
        single-frame geometry (t == 1, sh == sw == 1) the draw starts at
        n_prime, so fully-primed slices are never trained."""
        st, sh, sw = self.c.stride
        t = (self.T if T is None else T) // st
        lo = self.c.n_prime if (t == 1 and sh == 1 and sw == 1) else 0
        return torch.randint(lo, st * sh * sw, (batch,), generator=gen)

    def loss(self, params, batch, gen: Optional[torch.Generator] = None, *, slice_idx=None):
        """Cross-entropy over one random slice per video, as lvt_tpu's
        VideoTransformer.loss. batch: {"video": (b, nc, T, H, W) int, optional
        "class": (b,)}; slice_idx: optional fixed (b,) slice indices instead
        of the draw from ``gen``. Returns (loss, {"loss_cross_entropy": loss}).

        Inside the trainer's global batch (``parallel.global_batch``) the
        batch is this rank's rows of it: the slice indices are drawn for the
        global batch, of which the rank takes its rows, and the loss is the
        global batch's (its per-channel sums and counts all-reduced), the
        same value on every rank."""
        video = batch["video"]
        b = video.shape[0]
        group = global_batch_group()
        if slice_idx is None:
            total, first = batch_rows(group, b)
            slice_idx = self.sample_train_slice_idx(gen, total, T=video.shape[2])[first:first + b]
        slice_idx = torch.as_tensor(slice_idx).to(video.device).long()
        ctx, slice_codes, ignore = self.prepare_slices(video, slice_idx)
        class_idx = batch.get("class") if self.c.class_num > 0 else None
        logits = vt_logits(params["netG"], self.c, ctx, slice_codes, slice_idx, class_idx,
                           remat=self.remat, fused=self.fused)  # (b, t, h, w, nc, nv)
        targets = slice_codes.movedim(1, -1).long()  # (b, t, h, w, nc)
        # CE as logsumexp minus the true logit: the one-hot contraction of
        # lvt_tpu read as the gather of the one logit it keeps (the same
        # value: the other terms are exact zeros)
        logits32 = logits.float()
        lse = torch.logsumexp(logits32, dim=-1)
        true_logit = torch.gather(logits32, -1, targets[..., None])[..., 0]
        ce = lse - true_logit
        valid = (~ignore)[..., None].expand(ce.shape).float()
        # per-channel mean over non-primed positions, then mean over channels
        num = (ce * valid).sum(dim=(0, 1, 2, 3))
        den = valid.sum(dim=(0, 1, 2, 3))
        if group is not None:
            num, den = all_reduce(torch.stack([num, den]), group)
        loss = (num / den.clamp(min=1.0)).mean()
        return loss, {"loss_cross_entropy": loss}

    def train_loss(self, params, model_state, batch, gen=None):
        """Uniform trainer interface; the VT has no mutable model state."""
        loss, metrics = self.loss(params, batch, gen)
        return loss, (metrics, model_state)

    # -- evaluation ----------------------------------------------------------
    def logits_for_entire_video(self, params, video, class_idx=None):
        """Teacher-forced logits of all S slices, scattered to the full-video
        layout, without grad (lvt_tpu's logits_for_entire_video). video:
        (b, nc, T, H, W) -> float32 logits (b, T, H, W, nc, nv); the caller
        applies its own mask over the primed frames."""
        b, nc, T, H, W = video.shape
        plan = self._plan_for(T, H, W)
        src = self._device_maps(plan, video.device)["slice_src"]
        out = torch.zeros((b, T * H * W, nc, self.c.nv), dtype=torch.float32,
                          device=video.device)
        with torch.no_grad():
            for s in range(plan.num_slices):
                sidx = torch.full((b,), s, dtype=torch.int64, device=video.device)
                ctx, sl, _ = self.prepare_slices(video, sidx)
                lg = vt_logits(params["netG"], self.c, ctx, sl, sidx, class_idx,
                               fused=self.fused)
                out[:, src[s].reshape(-1)] = lg.reshape(b, -1, nc, self.c.nv).float()
        return out.reshape(b, T, H, W, nc, self.c.nv)

    def logits_for_entire_video_incremental(self, params, video, class_idx=None, *,
                                            kv_cache_dtype: str = "native",
                                            kv_seg_size: int = 0):
        """Teacher-forced logits computed through the KV-cached decoder
        (``SliceDecoder.teacher``), eagerly: the contract of
        ``logits_for_entire_video``, (b, T, H, W, nc, nv) fp32. With
        kv_cache_dtype "native" the result is that function's up to
        accumulation order; with "int8" or "int4" it carries the logit error
        the quantized cache injects. Under tensor parallelism every rank of
        the model group calls it on the same rows, in every kv_cache_dtype,
        and each gets the whole logits.
        kv_seg_size is accepted and ignored, as in ``sample_video``.

        Given the video every slice's inputs are known, so the S slices run
        as S x b rows of one teacher pass (each row computes what a pass of
        its slice alone computes) and are scattered by ``slice_src``. The
        caches hold S x b rows: at DSFVT's geometry and b = 1 in fp32, 2 x
        128 MiB."""
        from .vt_incremental import SliceDecoder

        b, nc, T, H, W = video.shape
        plan = self._plan_for(T, H, W)
        S = plan.num_slices
        src = self._device_maps(plan, video.device)["slice_src"]  # (S, t, h, w)
        sidx = torch.arange(S, device=video.device).repeat_interleave(b)  # row s * b + i
        rows = video.repeat(S, 1, 1, 1, 1)
        cls = None if class_idx is None else torch.as_tensor(class_idx).to(video.device).repeat(S)
        with torch.no_grad():
            ctx, sl, _ = self.prepare_slices(rows, sidx)
            zl = vt_encode(params["netG"], self.c, ctx, sidx, cls)
            dec = SliceDecoder(params["netG"], self.c, plan.slice_shape, S * b, video.device,
                               kv_dtype=kv_cache_dtype)
            lg = dec.teacher(*dec.inputs(zl, sl))  # (S * b, thw, nc, nv)
        lg = lg.reshape(S, b, -1, nc, self.c.nv).transpose(0, 1).reshape(b, -1, nc, self.c.nv)
        out = torch.zeros_like(lg)
        out[:, src.reshape(-1)] = lg
        return out.reshape(b, T, H, W, nc, self.c.nv)

    def visualize_training(self, params, state, batch):
        """Sample one slice given its context and show the ground-truth and
        sampled code maps as grayscale grids (lvt_tpu's visualize_training)."""
        from ..utils.image import array2im
        from .vt_incremental import sample_slice_incremental

        device = params["netG"]["decoder"]["conv_w"].device
        video = torch.as_tensor(np.asarray(batch["video"][:1])).to(device)
        plan = self._plan_for(*video.shape[2:])
        s = min(self.c.n_prime, plan.num_slices - 1)
        slice_idx = torch.full((1,), s, dtype=torch.int64, device=device)
        ctx, gt_slice, _ = self.prepare_slices(video, slice_idx)
        class_idx = batch.get("class") if self.c.class_num > 0 else None
        if class_idx is not None:
            class_idx = torch.as_tensor(np.asarray(class_idx[:1])).to(device)
        with torch.no_grad():
            zl = vt_encode(params["netG"], self.c, ctx, slice_idx, class_idx)
            t, h, w = plan.slice_shape
            gen = torch.Generator(device=device).manual_seed(0)
            sampled = sample_slice_incremental(params["netG"], self.c, (t, h, w), zl,
                                               torch.zeros_like(gt_slice), gen,
                                               np.zeros(t * h * w, bool), 0.9)

        def to_img(sl):  # (1, nc, t, h, w) codes -> (C, H, W) uint8 grid
            x = sl[0].cpu().numpy().astype(np.float32) / self.c.nv  # (nc, t, h, w)
            img = array2im(x.transpose(1, 0, 2, 3), normalize=False, tile=True)
            if img.ndim == 2:
                img = img[:, :, None]
            return img.transpose(2, 0, 1)

        return {"gt_slice": to_img(gt_slice), "sampled_slice": to_img(sampled)}

    def sample_video(self, params, video, gen: Optional[torch.Generator] = None, *,
                     temp: float = 1.0, n_prime: Optional[int] = None, class_idx=None,
                     incremental: bool = True, greedy: bool = False,
                     kv_cache_dtype: str = "native", kv_seg_size: int = 0,
                     weight_dtype: str = "native", mm_dtype: str = "native",
                     attn_impl: str = "xla", streams: int = 1, _eager: bool = False):
        """AR-sample all non-primed positions, slice by slice.

        video: (b, nc, T, H, W) with primed frames filled, others arbitrary.
        incremental=True uses the KV-cached decoder; False re-runs the full
        decoder per pixel (the reference's formulation, the test oracle).
        Slices whose every position is primed are skipped. kv_seg_size is
        accepted and ignored: the port's cache is preallocated, and greedy
        output does not depend on the JAX package's segment size.

        On the card each sampled slice is one replay of a CUDA graph of the
        whole slice (``models/rollout_graph.py``), captured at the first
        slice of a configuration; on the CPU, and with ``_eager`` (the check
        the graph is held against), the same pixel loop runs eagerly.

        Under tensor parallelism (inside ``parallel.mesh.tensor_parallel``,
        params the rank's part of the netG tree) every rank of the model
        group calls this on the same rows: the slice runs the eager
        ``SliceDecoder`` loop on the card too, because gloo's collectives
        cannot be captured in a CUDA graph. Every mode below runs there, on
        the rank's heads and rows (``models/vt_incremental.py`` says where
        the group's scales come in). The logits are summed over the group
        into the same values on every rank, so ranks whose generators are
        seeded alike (by their data rank) sample the same codes; with
        ``streams`` they draw the same stream seeds from them.

        kv_cache_dtype ("native", "int8", "int4"), weight_dtype ("native",
        "int8", "int8-pallas"), mm_dtype ("native", "int8") and attn_impl
        ("xla", "pallas", "pallas-live") choose the quantized sampler, and
        ``streams`` splits the batch into independent rollouts (on the card
        the parallel branches of each slice's graph, eagerly in turn under
        tensor parallelism), as ``sample_slice_incremental`` documents them.
        """
        if not incremental:
            # the full-recompute path has no KV cache: refuse the knobs it
            # would silently ignore (kv_cache_dtype and kv_seg_size describe
            # the cache and mean nothing here)
            for name, val, default in (("weight_dtype", weight_dtype, "native"),
                                       ("mm_dtype", mm_dtype, "native"),
                                       ("attn_impl", attn_impl, "xla"),
                                       ("streams", streams, 1)):
                if val != default:
                    raise ValueError(
                        f"sample_video(incremental=False) ignores {name}; got {name}={val!r}: "
                        "a comparison against the baseline would compare the wrong "
                        "configuration")
        if n_prime is None:
            n_prime = self.c.n_prime
        c = self.c
        b, nc, T, H, W = video.shape
        plan = self._plan_for(T, H, W)
        knobs = dict(kv_dtype=kv_cache_dtype, weight_dtype=weight_dtype, mm_dtype=mm_dtype,
                     attn_impl=attn_impl, streams=streams)
        on_graph = incremental and video.is_cuda and not _eager
        if on_graph and model_parallel_group() is not None:
            _log_once("tensor parallel: sample_video runs each slice's eager loop (the CUDA "
                      "graph of a slice cannot capture the model group's gloo collectives)")
            on_graph = False
        decoder = None
        vflat = video.reshape(b, nc, -1)
        for s in range(plan.num_slices):
            primed = plan.slice_src[s].reshape(-1) // (H * W) < n_prime  # host (thw,)
            if primed.all():
                continue
            sidx = torch.full((b,), s, dtype=torch.int64, device=video.device)
            ctx, sl, _ = self.prepare_slices(vflat.reshape(b, nc, T, H, W), sidx)
            zl = vt_encode(params["netG"], c, ctx, sidx, class_idx)
            if on_graph:
                primed_t = torch.as_tensor(primed, device=video.device)
                graph = self._slice_graph(params, zl, sl, primed_t, knobs, temp, greedy)
                sl = graph(zl, sl, primed_t, gen)
            elif incremental:
                from .vt_incremental import SliceDecoder

                if decoder is None:  # the set-up every slice shares
                    decoder = SliceDecoder(params["netG"], c, plan.slice_shape, b,
                                           video.device, **knobs)
                sl = decoder.run(zl, sl, torch.as_tensor(primed, device=video.device), gen,
                                 temp, greedy)
            else:
                sl = self._sample_slice_pixels(params, zl, sl, gen, primed, temp,
                                               greedy=greedy)
            vflat = ss.scatter_slice(vflat, plan.slice_src[s], sl)
        return vflat.reshape(b, nc, T, H, W)

    def _slice_graph(self, params, zl, sl, primed, knobs, temp, greedy):
        """The CUDA graph that samples one slice of this configuration
        (``rollout_graph.SliceGraphSlot.get``); primed: (thw,) bool on the card."""
        from .rollout_graph import SliceGraphSlot

        if self._slice_graph_slot is None:
            self._slice_graph_slot = SliceGraphSlot()
        return self._slice_graph_slot.get(params["netG"], self.c, tuple(sl.shape[2:]), zl, sl,
                                          primed, knobs, temp, greedy)

    def _sample_slice_pixels(self, params, zl, sl, gen, primed, temp, greedy=False):
        """Raster positions of one slice, each pixel's nc channels sampled
        with the full decoder recomputed over the slice (exact AR
        factorization; the oracle of the incremental sampler)."""
        c = self.c
        b, nc, t, h, w = sl.shape
        thw = t * h * w
        pred = params["netG"]["predictor"]
        sl_flat = sl.reshape(b, nc, thw).clone()
        for p in range(thw):
            if primed[p]:
                continue
            yl = vt_decode(params["netG"], c, sl_flat.reshape(b, nc, t, h, w), zl)
            y_pix = _layer_norm(yl.reshape(b, thw, c.d)[:, p], pred["ln_scale"], pred["ln_bias"])
            sl_flat[:, :, p] = vt_sample_pixel_channels(params["netG"], c, y_pix, gen, temp,
                                                        greedy=greedy).to(sl_flat.dtype)
        return sl_flat.reshape(b, nc, t, h, w)
