"""A small sequential-conv framework for the 2-D VQ-VAE nets (counterpart of
lvt_tpu/models/layers2d.py), inference only.

Architectures are static descriptor lists built from the config;
``init_seq`` makes a params/state list, ``apply_seq`` runs it. Channels-last
(NHWC), weights in the JAX package's layouts (HWIO, convT (kh, kw, out, in)).

Ported descriptor forms (what ResEncoder/ResDecoder use):
  ("conv", cin, cout, k, stride, pad)
  ("convT", cin, cout, k, stride, pad)
  ("relu",) ("tanh",)
  ("resblock", dim, dim_res)                  # ReLU-conv3-ReLU-conv1 residual

Every conv has a bias: with ``NORM: ""`` (the one ported norm) no conv is
followed by a norm layer.
"""

from typing import List, Tuple

import numpy as np
import torch

from ..ops.conv import conv2d, conv_transpose2d
from .norms import check_norm


def _xavier_uniform(gen, shape, fan_in, fan_out):
    lim = float(np.sqrt(6.0 / (fan_in + fan_out)))
    return torch.empty(shape).uniform_(-lim, lim, generator=gen)


def _normal_init(gen, shape, flat_in):
    std = 1.0 / float(np.sqrt((1 + 0.2 ** 2) * flat_in))
    return torch.empty(shape).normal_(0.0, std, generator=gen)


def init_conv_weight(gen, k, cin, cout, init_type: str, transposed=False):
    """HWIO (or HW-out-in for convT) weight with torch's fan computation."""
    shape = (k, k, cout, cin) if transposed else (k, k, cin, cout)
    if init_type == "xavier_uniform":
        fan_in, fan_out = (cout * k * k, cin * k * k) if transposed else (cin * k * k, cout * k * k)
        return _xavier_uniform(gen, shape, fan_in, fan_out)
    if init_type == "normal":
        flat = (cin * cout * k) if transposed else (cout * cin * k)
        return _normal_init(gen, shape, flat)
    raise ValueError(init_type)


def init_seq(gen: torch.Generator, spec: List[Tuple], init_type: str, norm: str,
             use_spectral: bool):
    """Build (params, state) lists for a descriptor list, on the CPU."""
    if use_spectral:
        raise NotImplementedError("spectral norm is not ported to lvt_tpu_torch yet")
    check_norm(norm)
    params, state = [], []
    for layer in spec:
        kind = layer[0]
        p = {}
        if kind in ("conv", "convT"):
            _, cin, cout, k, _, _ = layer
            p["w"] = init_conv_weight(gen, k, cin, cout, init_type, transposed=kind == "convT")
            p["b"] = torch.zeros(cout)
        elif kind == "resblock":
            _, dim, dim_res = layer
            p["w1"] = init_conv_weight(gen, 3, dim, dim_res, init_type)
            p["w2"] = init_conv_weight(gen, 1, dim_res, dim, init_type)
            p["b1"] = torch.zeros(dim_res)
            p["b2"] = torch.zeros(dim)
        elif kind not in ("relu", "tanh"):
            raise NotImplementedError(f"layer kind {kind!r} is not ported to lvt_tpu_torch yet")
        params.append(p)
        state.append({})
    return params, state


def apply_seq(spec, params, state, x, *, norm: str, use_spectral: bool = False):
    """Run a descriptor list on NHWC x (inference). ``state`` holds one empty
    dict per layer: no ported layer keeps state."""
    if use_spectral:
        raise NotImplementedError("spectral norm is not ported to lvt_tpu_torch yet")
    check_norm(norm)
    for layer, p in zip(spec, params):
        kind = layer[0]
        if kind == "conv":
            _, _, _, _, stride, pad = layer
            x = conv2d(x, p["w"], p["b"], stride=stride, padding=pad)
        elif kind == "convT":
            _, _, _, _, stride, pad = layer
            x = conv_transpose2d(x, p["w"], p["b"], stride=stride, padding=pad)
        elif kind == "resblock":
            # the reference ResBlock is `x + block(x)` with an in-place ReLU
            # first, which mutates x before the add: relu(x) + f(relu(x)).
            # Computed explicitly, nothing in place.
            r = torch.relu(x)
            y = torch.relu(conv2d(r, p["w1"], p["b1"], stride=1, padding=1))
            x = r + conv2d(y, p["w2"], p["b2"], stride=1, padding=0)
        elif kind == "relu":
            x = torch.relu(x)
        elif kind == "tanh":
            x = torch.tanh(x)
        else:
            raise NotImplementedError(f"layer kind {kind!r} is not ported to lvt_tpu_torch yet")
    return x


def out_activation_spec(name: str) -> List[Tuple]:
    if name == "":
        return []
    if name in ("relu", "tanh"):
        return [(name,)]
    raise NotImplementedError(f"out_activation {name!r} is not ported to lvt_tpu_torch yet")
