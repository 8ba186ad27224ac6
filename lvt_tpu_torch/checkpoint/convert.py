"""Weights carried across from the JAX package.

``from_jax_vt`` and ``from_jax_vqvae`` take the JAX package's parameter
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
    """The JAX VQ-VAE's (params, state) -> the port's. The EMA codebook is
    state["netC"], with embedding / running_size / running_sum."""
    p, s = _convert(params), _convert(state)
    if set(s.get("netC", {})) != {"embedding", "running_size", "running_sum"}:
        raise ValueError("from_jax_vqvae: state['netC'] is not an EMA codebook state")
    return p, s
