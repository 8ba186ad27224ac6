"""Reference ``.pth`` state dicts -> the port's parameter trees (counterpart
of lvt_tpu/checkpoint/torch_convert.py, with the same functions and layout
transposes).

Converts reference checkpoints (per-subnet state dicts saved by fvcore's
Checkpointer under netE/netG/netC, reference meta_arch/ae.py:231-238) into
the trees that ``checkpoint/convert.py`` ``from_jax_*`` produce: the JAX
package's layouts, torch leaves.

  Conv2d          (out, in, kh, kw)      -> HWIO (kh, kw, in, out)
  ConvTranspose2d (in, out, kh, kw)      -> (kh, kw, out, in)
  Conv3d          (out, in, kt, kh, kw)  -> DHWIO (kt, kh, kw, in, out)
  Linear          (out, in)              -> (in, out)
  VT context conv (de, nc*nv, kt,kh,kw)  -> embedding table (nc,kt,kh,kw,nv,de)
  MHA proj        (d, na*da)             -> (na*da, d)

Leaves are the arrays' values in 32-bit types where the file holds 64-bit
ones (as the JAX package's arrays are), on the CPU; the samplers place them
on the device and dtype of the model's initialised params
(``evaluation/vt_sampler.py``). Reference quirks handled as there: the
``norm_layer`` wrapper deletes conv biases when a norm follows
(wrappers.py:48-50), so the spec walker takes exactly the keys torch saved;
MaskedConv3d weights already carry the causal zeros, and are masked again
in the forward anyway.
"""

from typing import Any, Dict, List

import numpy as np
import torch

from ..utils.strings import natural_keys

_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
           np.dtype(np.uint64): np.uint32}


def _np(x) -> np.ndarray:
    """A state-dict value as a numpy array (bf16 tensors as fp32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _t(x) -> torch.Tensor:
    """One leaf: a contiguous CPU tensor, 64-bit types narrowed to 32."""
    a = _np(x)
    return torch.from_numpy(np.ascontiguousarray(a.astype(_NARROW.get(a.dtype, a.dtype))))


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """The tensors of a ``.pth`` file as numpy arrays, unwrapped from fvcore's
    ``{"model": state_dict}``."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "model" in obj:
        obj = obj["model"]
    return {k: _np(v) for k, v in obj.items() if isinstance(v, torch.Tensor)}


def _ordered_conv_entries(sd: Dict[str, np.ndarray]) -> List[Dict[str, np.ndarray]]:
    """Group the state dict's conv/norm tensors by module prefix in natural
    key order: [{'weight':..., 'bias':...?, ...}, ...]."""
    groups: Dict[str, Dict[str, np.ndarray]] = {}
    for k, v in sd.items():
        prefix, leaf = k.rsplit(".", 1)
        groups.setdefault(prefix, {})[leaf] = _np(v)
    return [groups[k] for k in sorted(groups, key=natural_keys)]


def convert_seqnet(sd: Dict[str, np.ndarray], spec):
    """A torch Sequential conv-net state dict -> ``init_seq``'s (params,
    state) lists, by walking the port's descriptor spec and consuming torch
    conv entries in module order. State carries BatchNorm running statistics
    (mean/var) for norm layers. Raises ValueError on an architecture
    mismatch (too few or leftover conv entries)."""
    entries = _ordered_conv_entries(sd)
    it = iter(entries)
    ctx = {"i": -1, "layer": None}

    def next_entry():
        try:
            return next(it)
        except StopIteration:
            raise ValueError(
                f"checkpoint has fewer layers than the spec needs (exhausted at spec layer "
                f"{ctx['i']}: {ctx['layer']}) — architecture mismatch (wrong "
                f"N_LAYERS/RES_CHANNELS, or the wrong .pth for this sub-net?)") from None

    def next_conv():
        while True:
            e = next_entry()
            if "weight" in e and e["weight"].ndim >= 2:
                return e

    def hwio(e):  # OIHW -> HWIO; (in, out, kh, kw) -> (kh, kw, out, in) for convT
        return _t(e["weight"].transpose(2, 3, 1, 0))

    params: List[Dict[str, Any]] = []
    state: List[Dict[str, Any]] = []
    for i, layer in enumerate(spec):
        ctx["i"], ctx["layer"] = i, layer
        kind = layer[0]
        p: Dict[str, Any] = {}
        s: Dict[str, Any] = {}
        if kind in ("conv", "convT"):
            e = next_conv()
            p["w"] = hwio(e)
            if "bias" in e:
                p["b"] = _t(e["bias"])
        elif kind == "resblock":
            e1, e2 = next_conv(), next_conv()
            p["w1"], p["w2"] = hwio(e1), hwio(e2)
            if "bias" in e1:
                p["b1"] = _t(e1["bias"])
            if "bias" in e2:
                p["b2"] = _t(e2["bias"])
        elif kind == "norm":
            e = next_entry()
            p = {"scale": _t(e["weight"]), "bias": _t(e["bias"])}
            if "running_mean" in e:
                s = {"mean": _t(e["running_mean"]), "var": _t(e["running_var"])}
        params.append(p)
        state.append(s)
    leftover = sum(1 for e in it if "weight" in e and e["weight"].ndim >= 2)
    if leftover:
        raise ValueError(
            f"checkpoint has {leftover} conv layer(s) the spec never consumed — architecture "
            f"mismatch; a silent prefix-graft would misalign the weights")
    return params, state


def convert_codebook(sd: Dict[str, np.ndarray], num: int) -> Dict[str, torch.Tensor]:
    """DVQEmbedding/VQEmbedding state -> the stacked codebook dict
    (embedding, running_size, running_sum; reference vq_embedding.py:9-99).
    Without running statistics in the file: running_size zeros and
    running_sum the embedding, the EMA's defaults."""
    sd = {k: _np(v) for k, v in sd.items()}
    if num == 1 and "embedding.weight" in sd:
        emb = sd["embedding.weight"][None]
        rs = sd.get("running_size", np.zeros(emb.shape[1], np.float32))[None]
        rsum = sd.get("running_sum", emb[0])[None]
    else:
        emb = np.stack([sd[f"ve.{i}.embedding.weight"] for i in range(num)])
        if "ve.0.running_size" in sd:
            rs = np.stack([sd[f"ve.{i}.running_size"] for i in range(num)])
            rsum = np.stack([sd[f"ve.{i}.running_sum"] for i in range(num)])
        else:
            rs = np.zeros(emb.shape[:2], np.float32)
            rsum = emb.copy()
    return {"embedding": _t(emb.astype(np.float32)), "running_size": _t(rs.astype(np.float32)),
            "running_sum": _t(rsum.astype(np.float32))}


def _convert_block_attn(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, torch.Tensor]:
    g = lambda k: _t(sd[f"{prefix}.{k}"])
    gt = lambda k: _t(_np(sd[f"{prefix}.{k}"]).T)
    return {
        "ln_scale": g("mha.layer_norm.weight"), "ln_bias": g("mha.layer_norm.bias"),
        "wq": g("mha.w_q"), "wk": g("mha.w_k"), "wv": g("mha.w_v"),
        "proj": gt("mha.proj.weight"),
        "ffn_ln_scale": g("ffn.0.weight"), "ffn_ln_bias": g("ffn.0.bias"),
        "ffn_w1": gt("ffn.1.weight"), "ffn_b1": g("ffn.1.bias"),
        "ffn_w2": gt("ffn.3.weight"), "ffn_b2": g("ffn.3.bias"),
        "dt_bank": g("dt_bank"), "dh_bank": g("dh_bank"), "dw_bank": g("dw_bank"),
    }


def convert_video_transformer(sd: Dict[str, np.ndarray], c) -> Dict[str, Any]:
    """A whole VideoTransformer state dict -> the port's netG tree.

    c: models.vt.VTConfig. Torch module paths from videotransformer.py:
    encoder.conv, encoder.slice_embedding, encoder.linear_projector,
    encoder.block_local_attention.<i>, decoder.ch_embedder.<k>,
    decoder.conv.conv, decoder.linear_projector,
    decoder.block_local_attention.<i>, ch_predictor.{layer_norm,U.<k>,P[.k]};
    a ``module.`` prefix (DistributedDataParallel) is stripped.
    """
    sd = {k.removeprefix("module."): _np(v) for k, v in sd.items()}
    nc, nv, de, d = c.nc, c.nv, c.de, c.d
    kt, kh, kw = c.kernel

    # encoder conv (de, nc*nv, kt, kh, kw) -> table (nc, kt, kh, kw, nv, de)
    table = sd["encoder.conv.weight"].reshape(de, nc, nv, kt, kh, kw).transpose(1, 3, 4, 5, 2, 0)
    enc = {
        "ctx_table": _t(table),
        "ctx_bias": _t(sd["encoder.conv.bias"]),
        "slice_embedding": _t(sd["encoder.slice_embedding.weight"]),
        # 1x1x1 Conv3d (d, de[, *1s]) -> (de, d)
        "projector": _t(sd["encoder.linear_projector.weight"].reshape(d, -1).T),
        "layers": [_convert_block_attn(sd, f"encoder.block_local_attention.{i}")
                   for i in range(len(c.blocks_e))],
    }
    if c.class_num > 0 and "encoder.class_embedding.weight" in sd:
        enc["class_embedding"] = _t(sd["encoder.class_embedding.weight"])

    dec = {
        "ch_embed": _t(np.stack([sd[f"decoder.ch_embedder.{k}.weight"] for k in range(nc)])),
        "conv_w": _t(sd["decoder.conv.conv.weight"].transpose(2, 3, 4, 1, 0)),
        "conv_b": _t(sd["decoder.conv.conv.bias"]),
        "projector": _t(sd["decoder.linear_projector.weight"].reshape(d, d).T),
        "layers": [_convert_block_attn(sd, f"decoder.block_local_attention.{i}")
                   for i in range(len(c.blocks_d))],
    }

    pred: Dict[str, Any] = {
        "ln_scale": _t(sd["ch_predictor.layer_norm.weight"]),
        "ln_bias": _t(sd["ch_predictor.layer_norm.bias"]),
        "U_w": [_t(sd[f"ch_predictor.U.{k}.weight"].T) for k in range(nc)],
        "U_b": [_t(sd[f"ch_predictor.U.{k}.bias"]) for k in range(nc)],
    }
    if c.share_p or c.share_embeddings:
        pred["P_w"] = _t(sd["ch_predictor.P.weight"].T)
        pred["P_b"] = _t(sd["ch_predictor.P.bias"])
    else:
        pred["P_w"] = [_t(sd[f"ch_predictor.P.{k}.weight"].T) for k in range(nc)]
        pred["P_b"] = [_t(sd[f"ch_predictor.P.{k}.bias"]) for k in range(nc)]

    return {"encoder": enc, "decoder": dec, "predictor": pred}


def load_pretrained_vqvae(model, params, state, *, encoder_path="", generator_path="",
                          codebook_path=""):
    """Graft reference ``.pth`` weights into a VQ-VAE (params, state) pair
    (the reference's per-subnet 'pretrained' slots, TEST.VT_SAMPLER.VQ_VAE):
    each given sub-net replaces its subtree; BatchNorm running statistics
    are laid over the state's entries (spectral ``u`` vectors kept); an EMA
    codebook goes into the state, a non-EMA one's embedding into the params
    (its state keeps the running buffers and an empty embedding)."""
    def _graft(net_key, spec, path):
        nonlocal params, state
        pe, se = convert_seqnet(load_torch_state_dict(path), spec)
        params = dict(params, **{net_key: pe})
        if any(se) and net_key in state:
            merged = [dict(o, **n) for o, n in zip(state[net_key], se)]
            state = dict(state, **{net_key: merged})

    if encoder_path:
        _graft("netE", list(model.encoder.spec), encoder_path)
    if generator_path:
        _graft("netG", list(model.generator.spec), generator_path)
    if codebook_path:
        cb = convert_codebook(load_torch_state_dict(codebook_path), model.num)
        if model.ema:
            state = dict(state, netC=cb)
        else:
            params = dict(params, netC={"embedding": cb["embedding"]})
            state = dict(state, netC=dict(cb, embedding=torch.zeros(0)))
    return params, state
