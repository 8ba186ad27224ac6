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
"""

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from ..ops import subscale as ss
from ..ops.attention import (_layer_norm, block_local_attention, merge_blocks, relative_bias,
                             split_blocks)
from ..ops.conv import masked_conv3d, subscale_context_encode
from ..ops.embedding import take_rows
from ..ops.fused_layer import fused_block_layer, fused_layer_supported
from ..ops.posenc import add_positional_encoding
from . import to_device


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

def _apply_attn_stack(x, layers, blocks, causal: bool, remat: bool = False,
                      fused: bool = False):
    """Run a stack of BlockLocalAttention layers. remat=True (TPU.REMAT with
    the policy "") keeps only each layer's input for the backward and
    recomputes the layer there, as jax.checkpoint with no saved names does.
    fused=True (TPU.FUSED_LAYER) runs each layer as the fused layer of
    ops/fused_layer.py when the stack has more than one layer and its
    geometry passes ``fused_layer_supported``, as lvt_tpu does: the token
    form round-trips once for the whole stack, and the fused layer is its own
    remat unit, so ``remat`` adds no checkpoint around it. Any other stack
    runs the unfused layers."""
    if fused and len(layers) > 1 and fused_layer_supported(layers, blocks):
        blk = tuple(blocks[0])
        tokens, geom = split_blocks(x, blk)
        for p in layers:
            bias = relative_bias(p["dt_bank"], p["dh_bank"], p["dw_bank"], blk)
            tokens = fused_block_layer(tokens, p, bias, causal)
        return merge_blocks(tokens, geom)
    for p, blk in zip(layers, blocks):
        if remat and torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(block_local_attention, x, p, tuple(blk),
                                                  causal, use_reentrant=False)
        else:
            x = block_local_attention(x, p, tuple(blk), causal)
    return x


def vt_encode(params, c: VTConfig, ctx, slice_idx, class_idx=None, remat: bool = False,
              fused: bool = False):
    """Context branch. ctx: (b, nc, T', H', W') codes with pad_value at
    invisible positions; slice_idx: (b,). Returns zl (b, t, h, w, d)."""
    enc = params["encoder"]
    x = subscale_context_encode(ctx, enc["ctx_table"], enc["ctx_bias"], c.stride, c.nv)
    x = x + enc["slice_embedding"][slice_idx.long()][:, None, None, None, :]
    if c.class_num > 0 and class_idx is not None:
        cls = enc["class_embedding"][class_idx.long()][:, None, None, None, :]
        x = torch.cat([x, cls.expand(x.shape)], dim=-1)
    x = x @ enc["projector"]
    return _apply_attn_stack(x, enc["layers"], c.blocks_e, False, remat, fused)


def _embed_sum_codes(dec, c: VTConfig, codes):
    """Summed per-channel embeddings: codes (..., nc) -> (..., de)."""
    out = take_rows(dec["ch_embed"][0], codes[..., 0])
    for k in range(1, c.nc):
        out = out + take_rows(dec["ch_embed"][k], codes[..., k])
    return out


def vt_decode(params, c: VTConfig, slice_codes, zl, remat: bool = False, fused: bool = False):
    """Slice branch. slice_codes: (b, nc, t, h, w) int; zl: (b, t, h, w, d).
    Returns yl (b, t, h, w, d)."""
    dec = params["decoder"]
    emb = _embed_sum_codes(dec, c, slice_codes.movedim(1, -1))
    x = masked_conv3d(emb, dec["conv_w"], dec["conv_b"])
    x = add_positional_encoding(x)
    x = x + zl @ dec["projector"]
    return _apply_attn_stack(x, dec["layers"], c.blocks_d, True, remat, fused)


def _predictor_head(pred, c: VTConfig, k: int, u, dec_params):
    """relu(u) -> nv logits via shared / per-channel / tied head."""
    r = torch.relu(u)
    if c.share_p:
        return r @ pred["P_w"] + pred["P_b"]
    if c.share_embeddings:
        e = r @ pred["P_w"] + pred["P_b"]
        return e @ dec_params["ch_embed"][k].T
    return r @ pred["P_w"][k] + pred["P_b"][k]


def _predictor_u(pred, c: VTConfig, k: int, y, codes):
    """u_k = U_k([y; onehot(codes_<k)]), the one-hot block as row gathers
    (codes: (..., nc) int; only channels < k are read)."""
    w = pred["U_w"][k]
    d, nv = y.shape[-1], c.nv
    u = y @ w[:d] + pred["U_b"][k]
    for j in range(k):
        u = u + take_rows(w[d + j * nv: d + (j + 1) * nv], codes[..., j])
    return u


def vt_logits(params, c: VTConfig, ctx, slice_codes, slice_idx, class_idx=None,
              remat: bool = False, fused: bool = False):
    """Teacher-forced logits for all positions/channels: (b, t, h, w, nc, nv)
    in the parameter dtype."""
    zl = vt_encode(params, c, ctx, slice_idx, class_idx, remat, fused)
    yl = vt_decode(params, c, slice_codes, zl, remat, fused)
    pred = params["predictor"]
    y = _layer_norm(yl, pred["ln_scale"], pred["ln_bias"])
    codes = slice_codes.movedim(1, -1)
    outs = [_predictor_head(pred, c, k, _predictor_u(pred, c, k, y, codes), params["decoder"])
            for k in range(c.nc)]
    return torch.stack(outs, dim=-2)


def vt_sample_pixel_channels(params, c: VTConfig, y_pix, gen: Optional[torch.Generator],
                             temp: float, greedy: bool = False):
    """Sample the nc channel codes of one pixel autoregressively. y_pix:
    (b, d), already layer-normed. Returns (b, nc) int32. Greedy takes the
    first maximum, as jnp.argmax; otherwise a categorical draw at
    ``temp`` from ``gen``."""
    pred = params["predictor"]
    codes = torch.zeros((y_pix.shape[0], c.nc), dtype=torch.int32, device=y_pix.device)
    for k in range(c.nc):
        u = _predictor_u(pred, c, k, y_pix, codes)
        logits = _predictor_head(pred, c, k, u, params["decoder"]).float()
        if greedy:
            sk = torch.argmax(logits, dim=-1)
        else:
            probs = torch.softmax(logits / temp, dim=-1)
            sk = torch.multinomial(probs, 1, generator=gen)[:, 0]
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
        # TPU.REMAT / TPU.REMAT_POLICY; the port runs only True
        policy = getattr(cfg.TPU, "REMAT_POLICY", "")
        if policy not in ("", "dots", "qkv"):
            raise ValueError(f"TPU.REMAT_POLICY must be '' (full remat), 'dots' or 'qkv', "
                             f"got {policy!r}")
        self.remat = (policy or True) if cfg.TPU.REMAT else False
        self.fused = bool(getattr(cfg.TPU, "FUSED_LAYER", False))

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

    def _check_trainable(self):
        if self.remat not in (False, True):
            raise NotImplementedError(
                f"TPU.REMAT_POLICY {self.remat!r} is not ported to lvt_tpu_torch yet; "
                "use '' (per-layer remat) or TPU.REMAT False")

    def loss(self, params, batch, gen: Optional[torch.Generator] = None, *, slice_idx=None):
        """Cross-entropy over one random slice per video, as lvt_tpu's
        VideoTransformer.loss. batch: {"video": (b, nc, T, H, W) int, optional
        "class": (b,)}; slice_idx: optional fixed (b,) slice indices instead
        of the draw from ``gen``. Returns (loss, {"loss_cross_entropy": loss})."""
        self._check_trainable()
        video = batch["video"]
        b = video.shape[0]
        if slice_idx is None:
            slice_idx = self.sample_train_slice_idx(gen, b, T=video.shape[2])
        slice_idx = torch.as_tensor(slice_idx).to(video.device).long()
        ctx, slice_codes, ignore = self.prepare_slices(video, slice_idx)
        class_idx = batch.get("class") if self.c.class_num > 0 else None
        logits = vt_logits(params["netG"], self.c, ctx, slice_codes, slice_idx, class_idx,
                           remat=bool(self.remat), fused=self.fused)  # (b, t, h, w, nc, nv)
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
        den = valid.sum(dim=(0, 1, 2, 3)).clamp(min=1.0)
        loss = (num / den).mean()
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
                     kv_cache_dtype: str = "native", kv_seg_size: int = 0):
        """AR-sample all non-primed positions, slice by slice.

        video: (b, nc, T, H, W) with primed frames filled, others arbitrary.
        incremental=True uses the KV-cached decoder; False re-runs the full
        decoder per pixel (the reference's formulation, the test oracle).
        Slices whose every position is primed are skipped. kv_seg_size is
        accepted and ignored: the port's cache is preallocated, and greedy
        output does not depend on the JAX package's segment size.
        """
        if kv_cache_dtype != "native":
            raise NotImplementedError(
                f"kv_cache_dtype={kv_cache_dtype!r} is not ported to lvt_tpu_torch yet")
        if n_prime is None:
            n_prime = self.c.n_prime
        c = self.c
        b, nc, T, H, W = video.shape
        plan = self._plan_for(T, H, W)
        vflat = video.reshape(b, nc, -1)
        for s in range(plan.num_slices):
            primed = plan.slice_src[s].reshape(-1) // (H * W) < n_prime  # host (thw,)
            if primed.all():
                continue
            sidx = torch.full((b,), s, dtype=torch.int64, device=video.device)
            ctx, sl, _ = self.prepare_slices(vflat.reshape(b, nc, T, H, W), sidx)
            zl = vt_encode(params["netG"], c, ctx, sidx, class_idx)
            if incremental:
                from .vt_incremental import sample_slice_incremental

                sl = sample_slice_incremental(params["netG"], c, plan.slice_shape, zl, sl,
                                              gen, primed, temp, greedy=greedy)
            else:
                sl = self._sample_slice_pixels(params, zl, sl, gen, primed, temp,
                                               greedy=greedy)
            vflat = ss.scatter_slice(vflat, plan.slice_src[s], sl)
        return vflat.reshape(b, nc, T, H, W)

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
