"""A small sequential-conv framework for the 2-D VQ-VAE nets (counterpart of
lvt_tpu/models/layers2d.py).

Architectures are static descriptor lists built from the config;
``init_seq`` makes a params/state list, ``apply_seq`` runs it and returns
(y, new_state). Channels-last (NHWC), weights in the JAX package's layouts
(HWIO, convT (kh, kw, out, in)). The new state's tensors (norm statistics,
spectral-norm ``u``) hold no autograd graph.

Descriptor forms:
  ("conv", cin, cout, k, stride, pad)
  ("convT", cin, cout, k, stride, pad)       # transposed conv
  ("relu",) ("lrelu", slope) ("tanh",) ("sigmoid",)
  ("avgpool", k) ("upsample", factor) ("pixelshuffle", factor)
  ("resblock", dim, dim_res)                  # ReLU-conv3-ReLU-conv1 residual
  ("norm",)                                   # attached to preceding conv

Reference quirk preserved: a conv followed by a norm is created without a
bias (vidgen/layers/wrappers.py:48-50).

Inside ``parallel.mesh.spatial_parallel`` x is this rank's band of rows:
the convolutions take their halos (``ops/conv.py``), the norms sum their
moments over the group (``norms.py``), and "avgpool", "upsample" and
"pixelshuffle" stay within the band, which "avgpool" checks its height
divides into. Spectral norm works on the replicated weights, unchanged.
"""

from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.conv import conv2d, conv_transpose2d
from ..parallel.mesh import spatial_group
from ..parallel.spatial import check_rows
from .norms import apply_norm, init_norm


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


def _avg_pool(x, k):
    return F.avg_pool2d(x.permute(0, 3, 1, 2), k).permute(0, 2, 3, 1)


def _upsample_nearest(x, f):
    b, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(b, h, f, w, f, c)
    return x.reshape(b, h * f, w * f, c)


def _pixel_shuffle(x, r):
    """(b, h, w, c*r*r) -> (b, h*r, w*r, c), in torch.nn.PixelShuffle's
    channel order (c, r, r)."""
    b, h, w, crr = x.shape
    c = crr // (r * r)
    x = x.reshape(b, h, w, c, r, r)
    x = x.permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * r, w * r, c)


def _spectral_normalize(w, u, train, out_axis: int = -1):
    """One power-iteration spectral norm (torch.nn.utils.spectral_norm
    semantics). w is viewed as (out, rest): out is the last axis of an HWIO
    conv weight and axis 2 of a convT weight (kh, kw, out, in). When
    training, sigma uses the new ``u`` (detached) and the new ``u`` is
    returned; otherwise the old one. ``v`` never carries a gradient."""
    # bf16 weights against the fp32 state promote to fp32, as in the JAX package
    w = w.to(torch.promote_types(w.dtype, u.dtype))
    u = u.to(w.dtype)
    w_view = w if out_axis in (-1, w.dim() - 1) else torch.movedim(w, out_axis, -1)
    wm = w_view.reshape(-1, w_view.shape[-1]).T  # (out, rest)
    v = wm.T @ u
    v = v / (torch.linalg.vector_norm(v) + 1e-12)
    u_new = wm @ v
    u_new = u_new / (torch.linalg.vector_norm(u_new) + 1e-12)
    u_used = u_new.detach() if train else u
    sigma = u_used @ (wm @ v.detach())
    return w / sigma, (u_new.detach() if train else u)


_STATELESS = ("relu", "lrelu", "tanh", "sigmoid", "avgpool", "upsample", "pixelshuffle")


def init_seq(gen: torch.Generator, spec: List[Tuple], init_type: str, norm: str,
             use_spectral: bool):
    """Build (params, state) lists for a descriptor list, on the CPU."""
    params: List[Dict[str, Any]] = []
    state: List[Dict[str, Any]] = []
    spec = list(spec)
    for i, layer in enumerate(spec):
        kind = layer[0]
        p: Dict[str, Any] = {}
        s: Dict[str, Any] = {}
        if kind in ("conv", "convT"):
            _, cin, cout, k, _, _ = layer
            followed_by_norm = i + 1 < len(spec) and spec[i + 1][0] == "norm"
            p["w"] = init_conv_weight(gen, k, cin, cout, init_type, transposed=kind == "convT")
            if not followed_by_norm:
                p["b"] = torch.zeros(cout)
            if use_spectral:
                s["u"] = torch.empty(cout).normal_(generator=gen)
        elif kind == "norm":
            p, s = init_norm(norm, _prev_out_channels(spec, i))
        elif kind == "resblock":
            _, dim, dim_res = layer
            p["w1"] = init_conv_weight(gen, 3, dim, dim_res, init_type)
            p["w2"] = init_conv_weight(gen, 1, dim_res, dim, init_type)
            if norm == "":
                p["b1"] = torch.zeros(dim_res)
                p["b2"] = torch.zeros(dim)
            else:
                p["n1"], s["n1"] = init_norm(norm, dim_res)
                p["n2"], s["n2"] = init_norm(norm, dim)
            if use_spectral:
                s["u1"] = torch.empty(dim_res).normal_(generator=gen)
                s["u2"] = torch.empty(dim).normal_(generator=gen)
        elif kind not in _STATELESS:
            raise ValueError(f"Unknown layer kind {kind}")
        params.append(p)
        state.append(s)
    return params, state


def _prev_out_channels(spec, i):
    for j in range(i - 1, -1, -1):
        if spec[j][0] in ("conv", "convT"):
            return spec[j][2]
        if spec[j][0] == "resblock":
            return spec[j][1]
    raise ValueError("norm with no preceding conv")


def apply_seq(spec, params, state, x, *, norm: str, use_spectral: bool = False,
              train: bool = False):
    """Run a descriptor list on NHWC x; returns (y, new_state)."""
    new_state = []
    for layer, p, s in zip(spec, params, state):
        kind = layer[0]
        ns = s
        if kind in ("conv", "convT"):
            _, _, _, _, stride, pad = layer
            w = p["w"]
            if use_spectral:
                w, u = _spectral_normalize(w, s["u"], train,
                                           out_axis=2 if kind == "convT" else -1)
                ns = dict(s, u=u)
            conv = conv2d if kind == "conv" else conv_transpose2d
            x = conv(x, w, p.get("b"), stride=stride, padding=pad)
        elif kind == "norm":
            x, ns = apply_norm(norm, p, s, x, train)
        elif kind == "resblock":
            # the reference ResBlock is `x + block(x)` with an in-place ReLU
            # first, which mutates x before the add: relu(x) + f(relu(x)).
            # Computed explicitly, nothing in place.
            r = torch.relu(x)
            w1, w2 = p["w1"], p["w2"]
            ns = dict(s)
            if use_spectral:
                w1, ns["u1"] = _spectral_normalize(w1, s["u1"], train)
                w2, ns["u2"] = _spectral_normalize(w2, s["u2"], train)
            y = conv2d(r, w1, p.get("b1"), stride=1, padding=1)
            if "n1" in p:
                y, ns["n1"] = apply_norm(norm, p["n1"], s["n1"], y, train)
            y = torch.relu(y)
            y = conv2d(y, w2, p.get("b2"), stride=1, padding=0)
            if "n2" in p:
                y, ns["n2"] = apply_norm(norm, p["n2"], s["n2"], y, train)
            x = r + y
        elif kind == "relu":
            x = torch.relu(x)
        elif kind == "lrelu":
            x = F.leaky_relu(x, layer[1])
        elif kind == "tanh":
            x = torch.tanh(x)
        elif kind == "sigmoid":
            x = torch.sigmoid(x)
        elif kind == "avgpool":
            if spatial_group() is not None:
                check_rows(x, layer[1], "avgpool")
            x = _avg_pool(x, layer[1])
        elif kind == "upsample":
            x = _upsample_nearest(x, layer[1])
        elif kind == "pixelshuffle":
            x = _pixel_shuffle(x, layer[1])
        else:
            raise ValueError(f"Unknown layer kind {kind}")
        new_state.append(ns)
    return x, new_state


def out_activation_spec(name: str) -> List[Tuple]:
    if name == "":
        return []
    if name in ("sigmoid", "relu", "tanh"):
        return [(name,)]
    raise ValueError(f"Unknown out_activation {name}")
