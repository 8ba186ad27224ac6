"""Normalization layers, functional form (counterpart of
lvt_tpu/models/norms.py; reference vidgen/layers/batch_norm.py).

  ""        -> identity
  "BN"      -> batch norm with running statistics
  "SyncBN"  -> batch norm whose batch statistics are averaged over the
               training processes; in one process it is "BN" (the
               reference's NaiveSyncBatchNorm falls back to nn.BatchNorm2d at
               world size 1)
  "nnSyncBN"-> nn.SyncBatchNorm; in one process it is "BN" too
  "FrozenBN"-> batch norm on its stored statistics; scale and bias get no
               gradient
  "IN"      -> instance norm without affine parameters
  "GN"      -> group norm (32 groups)
  "StdN"    -> x / sqrt(var + eps) with the unbiased spatial variance and no
               parameters
  "StdNV2"  -> x * rsqrt(mean(x^2) + 1e-8), no parameters

State (running mean/var) is threaded explicitly: ``apply_norm`` returns
(y, new_state), and the new state's tensors hold no autograd graph.
Channels-last layouts: x is (..., C). The statistics synced across training
processes wait for multi-GPU training (ROADMAP.md queue 1 item 10).
"""

from typing import Tuple

import torch

from ..utils import comm

VALID_NORMS = ("", "BN", "SyncBN", "nnSyncBN", "FrozenBN", "IN", "GN", "StdN", "StdNV2")
_BATCH_NORMS = ("BN", "SyncBN", "nnSyncBN", "FrozenBN")


def init_norm(norm: str, num_features: int):
    """(params, state) of a norm layer ('' -> ({}, {}))."""
    if norm not in VALID_NORMS:
        raise ValueError(f"Unknown norm: {norm}")
    if norm in ("", "IN", "StdN", "StdNV2"):
        return {}, {}
    params = {"scale": torch.ones(num_features), "bias": torch.zeros(num_features)}
    if norm in _BATCH_NORMS:
        state = {"mean": torch.zeros(num_features), "var": torch.ones(num_features)}
    else:
        state = {}
    return params, state


def apply_norm(norm: str, params: dict, state: dict, x: torch.Tensor, train: bool,
               momentum: float = 0.1, eps: float = 1e-5) -> Tuple[torch.Tensor, dict]:
    if norm == "":
        return x, state
    spatial = tuple(range(1, x.dim() - 1))

    if norm == "IN":
        mean = x.mean(dim=spatial, keepdim=True)
        var = x.var(dim=spatial, keepdim=True, unbiased=False)
        return (x - mean) * torch.rsqrt(var + eps), state

    if norm == "StdN":
        var = x.var(dim=spatial, keepdim=True, unbiased=True)
        return x * torch.rsqrt(var + eps), state

    if norm == "StdNV2":
        ms = (x * x).mean(dim=spatial, keepdim=True)
        return x * torch.rsqrt(ms + 1e-8), state

    if norm not in VALID_NORMS:
        raise ValueError(f"Unknown norm: {norm}")
    scale, bias = params["scale"], params["bias"]
    if norm == "FrozenBN":
        scale, bias = scale.detach(), bias.detach()
    reduce_axes = tuple(range(x.dim() - 1))  # all but channel

    if norm in _BATCH_NORMS:
        if train and norm != "FrozenBN":
            if norm != "BN" and comm.get_world_size() > 1:
                raise NotImplementedError(
                    f"norm {norm!r} across training processes is not ported to lvt_tpu_torch "
                    "yet (ROADMAP.md queue 1 item 10, multi-GPU)")
            mean = x.mean(dim=reduce_axes)
            meansqr = (x * x).mean(dim=reduce_axes)
            n = x.numel() // x.shape[-1]  # elements per channel
            var = meansqr - mean * mean
            # the running variance takes the unbiased batch variance
            # (n / (n - 1)) while the batch is normalized with the biased one
            var_upd = var * (n / (n - 1)) if n > 1 else var
            new_state = {
                "mean": (1 - momentum) * state["mean"] + momentum * mean.detach(),
                "var": (1 - momentum) * state["var"] + momentum * var_upd.detach(),
            }
        else:
            mean, var = state["mean"], state["var"]
            new_state = state
        y = (x - mean) * torch.rsqrt(var + eps) * scale + bias
        return y, new_state

    # GN
    c = x.shape[-1]
    g = min(32, c)
    while c % g != 0:
        g -= 1
    xs = x.reshape(x.shape[:-1] + (g, c // g))
    axes = spatial + (x.dim(),)
    mean = xs.mean(dim=axes, keepdim=True)
    var = xs.var(dim=axes, keepdim=True, unbiased=False)
    y = ((xs - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    return y * scale + bias, state
