"""Weights carried across from the JAX package.

``from_jax_vt``, ``from_jax_vqvae``, ``from_jax_autoencoder``,
``from_jax_unet`` and ``from_jax_i3d`` take the JAX package's parameter
trees with numpy leaves (``jax.tree_util.tree_map(np.asarray, tree)``) and
return the port's trees: the same nested dicts and lists, NamedTuples
(``BlockAttnParams``, ``EmaCodebookState``) as dicts of their fields, and
torch tensors of the same dtype and shape. Nothing here imports JAX; with
them both packages compute the same function on the same weights.
"""

from typing import Any, Dict, Tuple

import numpy as np
import torch


def _leaf(x, path: str) -> torch.Tensor:
    if x is None:
        raise ValueError(f"{path}: empty leaf in the JAX tree")
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":  # ml_dtypes: torch.from_numpy cannot read it
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    if a.dtype.kind not in "fiub":
        raise ValueError(f"{path}: leaf of dtype {a.dtype} is not an array of numbers")
    return torch.from_numpy(np.array(a, copy=True))


def _convert(tree, path: str = ""):
    if hasattr(tree, "_asdict"):  # NamedTuple
        tree = tree._asdict()
    if isinstance(tree, dict):
        return {k: _convert(v, f"{path}.{k}" if path else k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, f"{path}.{i}") for i, v in enumerate(tree)]
    return _leaf(tree, path)


def flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Dotted-name view of a port tree: {"decoder.layers.0.wq": tensor}."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}.{k}" if prefix else k))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}.{i}"))
        return out
    return {prefix: tree}


def from_jax_vt(netG_tree) -> Dict[str, Any]:
    """The JAX VT's netG tree (encoder / decoder / predictor) -> the port's."""
    out = _convert(netG_tree)
    missing = {"encoder", "decoder", "predictor"} - set(out)
    if missing:
        raise ValueError(f"from_jax_vt: netG tree lacks {sorted(missing)}")
    return out


def from_jax_layer(layer) -> Dict[str, torch.Tensor]:
    """One attention layer of the JAX VT (a ``BlockAttnParams`` with numpy
    leaves) -> the port's layer dict."""
    out = _convert(layer)
    if not isinstance(out, dict) or "wq" not in out:
        raise ValueError("from_jax_layer: not a BlockAttnParams")
    return out


def from_jax_vqvae(params, state) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The JAX VQ-VAE's (params, state) -> the port's, norm statistics and
    spectral-norm ``u`` included. state["netC"] holds embedding /
    running_size / running_sum; for a non-EMA codebook its embedding is
    empty and the trained one is params["netC"]["embedding"]."""
    p, s = _convert(params), _convert(state)
    if set(s.get("netC", {})) != {"embedding", "running_size", "running_sum"}:
        raise ValueError("from_jax_vqvae: state['netC'] is not a codebook state")
    if s["netC"]["embedding"].numel() == 0 and "embedding" not in p.get("netC", {}):
        raise ValueError("from_jax_vqvae: a non-EMA codebook needs params['netC']['embedding']")
    return p, s


def from_jax_autoencoder(params, state) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The JAX AutoEncoder's (params, state), netE and netG each -> the port's."""
    p, s = _convert(params), _convert(state)
    if set(p) != {"netE", "netG"} or set(s) != {"netE", "netG"}:
        raise ValueError(f"from_jax_autoencoder: want netE and netG, got {sorted(p)}, {sorted(s)}")
    return p, s


_UNET_BLOCKS = {"emb", "inc", "down1", "down2", "down3", "down4", "up1", "up2", "up3", "up4",
                "outc"}


def from_jax_unet(params, state) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """lvt_tpu's UNet (``models/unet.py``) (params, batch-norm state) -> the
    port's: the same blocks, weights HWIO as in both packages."""
    p, s = _convert(params), _convert(state)
    if set(p) != _UNET_BLOCKS or set(s) != _UNET_BLOCKS - {"emb", "outc"}:
        raise ValueError(f"from_jax_unet: not a UNet's (params, state): {sorted(p)}, {sorted(s)}")
    return p, s


def from_jax_i3d(tree) -> Dict[str, Any]:
    """lvt_tpu's I3D param tree (``init_i3d``, or ``load_i3d_npz``'s nested
    tree) -> the port's: the same unit paths, each convolution weight ``w``
    from (t, h, w, in, out) to PyTorch's (out, in, t, h, w)."""
    out = _convert(tree)
    if "Logits" not in out or "Conv3d_1a_7x7" not in out:
        raise ValueError(f"from_jax_i3d: not an I3D tree (keys {sorted(out)[:4]}...)")

    def turn(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                turn(v, f"{path}/{k}")
            elif k == "w":
                if v.ndim != 5:
                    raise ValueError(f"from_jax_i3d: {path}/w has shape {tuple(v.shape)}")
                node[k] = v.permute(4, 3, 0, 1, 2).contiguous()

    turn(out, "")
    return out
