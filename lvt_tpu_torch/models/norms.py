"""Normalization layers, functional form (counterpart of
lvt_tpu/models/norms.py; reference vidgen/layers/batch_norm.py).

  ""        -> identity
  "BN"      -> batch norm with running statistics
  "SyncBN"  -> batch norm whose batch statistics are averaged over the
               ranks of ``group``; with no group it is "BN" (the
               reference's NaiveSyncBatchNorm falls back to nn.BatchNorm2d at
               world size 1)
  "nnSyncBN"-> nn.SyncBatchNorm; with no group it is "BN" too
  "FrozenBN"-> batch norm on its stored statistics; scale and bias get no
               gradient
  "IN"      -> instance norm without affine parameters
  "GN"      -> group norm (32 groups)
  "StdN"    -> x / sqrt(var + eps) with the unbiased spatial variance and no
               parameters
  "StdNV2"  -> x * rsqrt(mean(x^2) + 1e-8), no parameters

State (running mean/var) is threaded explicitly: ``apply_norm`` returns
(y, new_state), and the new state's tensors hold no autograd graph.
Channels-last layouts: x is (..., C).

Statistics across processes follow three rules, all of ``lvt_tpu``, all
differentiable (``parallel.collectives.all_reduce``):
  * ``group=g`` is ``lvt_tpu``'s ``axis_name`` under ``shard_map``: "SyncBN"
    and "nnSyncBN" average their statistics over g's ranks (n is the global
    count; "SyncBN" then keeps the biased running variance), and "BN" stays
    per rank.
  * The trainer's global batch (``parallel.global_batch``), as ``lvt_tpu``'s
    step jitted over its data mesh sees it: every train-mode batch norm
    reduces over the whole global batch and takes the n / (n - 1) running
    variance of a batch norm of one process.
  * Frames split by rows over a group (``parallel.spatial_parallel``): every
    moment over H x W is summed over the group too. A train-mode batch norm
    reduces over the rows of every rank (n counts them all), and "IN",
    "StdN", "StdNV2" and "GN" take each sample's moments over its whole
    frame: the mean first, then the centred second moment.
"""

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..parallel.collectives import all_reduce
from ..parallel.mesh import global_batch_group, spatial_group

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
               momentum: float = 0.1, eps: float = 1e-5,
               group: Optional[dist.ProcessGroup] = None) -> Tuple[torch.Tensor, dict]:
    if norm == "":
        return x, state
    spatial = tuple(range(1, x.dim() - 1))
    rows = spatial_group()
    if rows is not None and norm in ("IN", "StdN", "StdNV2", "GN"):
        return _frame_norm(norm, params, state, x, eps, rows)

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
            mean = x.mean(dim=reduce_axes)
            meansqr = (x * x).mean(dim=reduce_axes)
            n = x.numel() // x.shape[-1]  # elements per channel, this rank
            if group is not None:  # lvt_tpu's axis_name: "BN" stays per rank
                over = group if norm in ("SyncBN", "nnSyncBN") else None
                synced = over is not None
            else:  # the trainer's global batch, one batch to lvt_tpu's jit
                over, synced = global_batch_group(), False
            for g in (over, rows):  # the data group's batch, the rows of the frames
                if g is not None:
                    w = dist.get_world_size(g)
                    stats = all_reduce(torch.stack([mean, meansqr]), g) / w
                    mean, meansqr, n = stats[0], stats[1], n * w
            var = meansqr - mean * mean
            # the running variance takes the unbiased batch variance
            # (n / (n - 1)) while the batch is normalized with the biased
            # one; a synced "SyncBN" keeps the biased one (reference
            # batch_norm.py:225-232)
            unbiased = norm != "SyncBN" or not synced
            var_upd = var * (n / (n - 1)) if unbiased and n > 1 else var
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
    xs = _channel_groups(x)
    axes = spatial + (x.dim(),)
    mean = xs.mean(dim=axes, keepdim=True)
    var = xs.var(dim=axes, keepdim=True, unbiased=False)
    y = ((xs - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    return y * scale + bias, state


def _channel_groups(x: torch.Tensor) -> torch.Tensor:
    """x (..., C) as (..., g, C / g): GN's groups, the most up to 32 that
    divide C."""
    c = x.shape[-1]
    g = min(32, c)
    while c % g != 0:
        g -= 1
    return x.reshape(x.shape[:-1] + (g, c // g))


def _frame_norm(norm: str, params: dict, state: dict, x: torch.Tensor, eps: float,
                group: dist.ProcessGroup) -> Tuple[torch.Tensor, dict]:
    """"IN", "StdN", "StdNV2" or "GN" on a band of rows x (b, h, W, C),
    with each sample's moments over the whole frame, summed over ``group``
    (equal bands: the mean of the ranks' means)."""
    size = dist.get_world_size(group)
    xs = _channel_groups(x) if norm == "GN" else x
    axes = tuple(range(1, x.dim() - 1)) + ((x.dim(),) if norm == "GN" else ())

    def frame_mean(v):
        return all_reduce(v.mean(dim=axes, keepdim=True), group) / size

    if norm == "StdNV2":
        return x * torch.rsqrt(frame_mean(x * x) + 1e-8), state
    mean = frame_mean(xs)
    var = frame_mean((xs - mean) ** 2)
    if norm == "StdN":  # the unbiased variance of the frame's n elements
        n = size * xs[0].numel() // x.shape[-1]
        return x * torch.rsqrt(var * (n / (n - 1)) + eps), state
    y = (xs - mean) * torch.rsqrt(var + eps)
    if norm == "IN":
        return y, state
    return y.reshape(x.shape) * params["scale"] + params["bias"], state
