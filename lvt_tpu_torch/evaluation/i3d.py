"""Inflated-3D Inception (I3D, Carreira & Zisserman 2017) — the standard FVD
feature network, as plain functions over a param tree (counterpart of
lvt_tpu/evaluation/i3d.py).

The tree keeps lvt_tpu's schema, the unit paths of the TF-Hub / sonnet
Kinetics-400 RGB checkpoint (``Mixed_3b/Branch_1/Conv3d_0b_3x3/w``...), with
the convolution weights in PyTorch's (out, in, t, h, w) layout. Weights are
read from the same flat ``.npz`` as lvt_tpu reads (its (t, h, w, in, out)
layout), so one file drives both packages.

Every unit is conv3d (no bias) -> batchnorm (frozen statistics, beta only, as
in the original) -> relu. Convolutions and max pools pad as TensorFlow's
"SAME" does: the extra row of an odd padding goes at the end, which
PyTorch's symmetric ``padding=`` cannot express, so the pads are explicit
(zeros for convolutions, -inf for max pools). Input: (b, T, 224, 224, 3) in
[-1, 1], channels last; output: (b, 400) logits.
"""

import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

# (name, out_channels, kernel (t,h,w), stride) for the stem;
# inception mixes are (name, in_ch, (b0, b1a, b1b, b2a, b2b, b3))
STEM = [
    ("Conv3d_1a_7x7", 64, (7, 7, 7), (2, 2, 2)),
    ("MaxPool3d_2a_3x3",),
    ("Conv3d_2b_1x1", 64, (1, 1, 1), (1, 1, 1)),
    ("Conv3d_2c_3x3", 192, (3, 3, 3), (1, 1, 1)),
    ("MaxPool3d_3a_3x3",),
]

MIXES = [
    ("Mixed_3b", 192, (64, 96, 128, 16, 32, 32)),
    ("Mixed_3c", 256, (128, 128, 192, 32, 96, 64)),
    ("MaxPool3d_4a_3x3", None, None),
    ("Mixed_4b", 480, (192, 96, 208, 16, 48, 64)),
    ("Mixed_4c", 512, (160, 112, 224, 24, 64, 64)),
    ("Mixed_4d", 512, (128, 128, 256, 24, 64, 64)),
    ("Mixed_4e", 512, (112, 144, 288, 32, 64, 64)),
    ("Mixed_4f", 528, (256, 160, 320, 32, 128, 128)),
    ("MaxPool3d_5a_2x2", None, None),
    ("Mixed_5b", 832, (256, 160, 320, 32, 128, 128)),
    ("Mixed_5c", 832, (384, 192, 384, 48, 128, 128)),
]

NUM_CLASSES = 400


def _unit_params(gen, in_ch, out_ch, kernel):
    w = torch.empty((out_ch, in_ch) + tuple(kernel))
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return {
        "w": w / math.sqrt(in_ch * math.prod(kernel)),
        "beta": torch.zeros(out_ch),
        "mean": torch.zeros(out_ch),
        "var": torch.ones(out_ch),
    }


def _mix_params(gen, in_ch, spec):
    b0, b1a, b1b, b2a, b2b, b3 = spec
    return {
        "Branch_0": {"Conv3d_0a_1x1": _unit_params(gen, in_ch, b0, (1, 1, 1))},
        "Branch_1": {
            "Conv3d_0a_1x1": _unit_params(gen, in_ch, b1a, (1, 1, 1)),
            "Conv3d_0b_3x3": _unit_params(gen, b1a, b1b, (3, 3, 3)),
        },
        "Branch_2": {
            "Conv3d_0a_1x1": _unit_params(gen, in_ch, b2a, (1, 1, 1)),
            "Conv3d_0b_3x3": _unit_params(gen, b2a, b2b, (3, 3, 3)),
        },
        "Branch_3": {"Conv3d_0b_1x1": _unit_params(gen, in_ch, b3, (1, 1, 1))},
    }


def init_i3d(gen: torch.Generator, device="cpu") -> Dict[str, Any]:
    """Random-init params in the canonical schema, drawn from ``gen`` (tests,
    shape contract)."""
    from ..models import to_device

    params: Dict[str, Any] = {}
    in_ch = 3
    for entry in STEM:
        if len(entry) == 1:
            continue
        name, out_ch, kernel, _ = entry
        params[name] = _unit_params(gen, in_ch, out_ch, kernel)
        in_ch = out_ch
    for name, mix_in, spec in MIXES:
        if spec is None:
            continue
        params[name] = _mix_params(gen, mix_in, spec)
    params["Logits"] = {
        "w": torch.randn((NUM_CLASSES, 1024, 1, 1, 1), generator=gen) * 0.01,
        "b": torch.zeros(NUM_CLASSES),
    }
    return to_device(params, device)


def load_i3d_npz(path: str, device="cpu") -> Dict[str, Any]:
    """Converted I3D weights from an .npz keyed 'Mixed_3b/Branch_1/
    Conv3d_0b_3x3/w' etc., lvt_tpu's layout (flat keys -> nested tree,
    weights turned to (out, in, t, h, w) by ``from_jax_i3d``)."""
    from ..checkpoint.convert import from_jax_i3d
    from ..models import to_device

    tree: Dict[str, Any] = {}
    with np.load(path) as flat:
        for key in flat.files:
            node = tree
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = flat[key]
    return to_device(from_jax_i3d(tree), device)


def same_pad(x, window, stride, value: float = 0.0):
    """x (b, c, t, h, w) padded as TensorFlow's "SAME" pads for ``window``
    and ``stride``: out = ceil(in / stride), the odd row at the end."""
    pads = []
    for n, k, s in reversed(list(zip(x.shape[2:], window, stride))):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value) if any(pads) else x


def _conv_bn_relu(x, p, stride, *, relu=True):
    y = F.conv3d(same_pad(x, p["w"].shape[2:], stride), p["w"], stride=stride)
    # batchnorm with frozen statistics, beta only (original has no gamma)
    c = (1, -1, 1, 1, 1)
    y = (y - p["mean"].view(c)) * torch.rsqrt(p["var"].view(c) + 1e-3) + p["beta"].view(c)
    return F.relu(y) if relu else y


def _maxpool(x, window, stride):
    return F.max_pool3d(same_pad(x, window, stride, -math.inf), window, stride)


def _mix(x, p):
    one = (1, 1, 1)
    b0 = _conv_bn_relu(x, p["Branch_0"]["Conv3d_0a_1x1"], one)
    b1 = _conv_bn_relu(x, p["Branch_1"]["Conv3d_0a_1x1"], one)
    b1 = _conv_bn_relu(b1, p["Branch_1"]["Conv3d_0b_3x3"], one)
    b2 = _conv_bn_relu(x, p["Branch_2"]["Conv3d_0a_1x1"], one)
    b2 = _conv_bn_relu(b2, p["Branch_2"]["Conv3d_0b_3x3"], one)
    b3 = _maxpool(x, (3, 3, 3), one)
    b3 = _conv_bn_relu(b3, p["Branch_3"]["Conv3d_0b_1x1"], one)
    return torch.cat([b0, b1, b2, b3], dim=1)


def i3d_apply(params: Dict[str, Any], video: torch.Tensor) -> torch.Tensor:
    """(b, T, 224, 224, 3) in [-1, 1] -> (b, 400) logits (FVD features)."""
    x = video.permute(0, 4, 1, 2, 3)
    x = _conv_bn_relu(x, params["Conv3d_1a_7x7"], (2, 2, 2))
    x = _maxpool(x, (1, 3, 3), (1, 2, 2))
    x = _conv_bn_relu(x, params["Conv3d_2b_1x1"], (1, 1, 1))
    x = _conv_bn_relu(x, params["Conv3d_2c_3x3"], (1, 1, 1))
    x = _maxpool(x, (1, 3, 3), (1, 2, 2))
    x = _mix(x, params["Mixed_3b"])
    x = _mix(x, params["Mixed_3c"])
    x = _maxpool(x, (3, 3, 3), (2, 2, 2))
    for name in ("Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e", "Mixed_4f"):
        x = _mix(x, params[name])
    x = _maxpool(x, (2, 2, 2), (2, 2, 2))
    x = _mix(x, params["Mixed_5b"])
    x = _mix(x, params["Mixed_5c"])
    # canonical I3D head: avg_pool3d (2, 7, 7) VALID stride 1 (not a plain
    # temporal mean: the window-2 average weights the end frames 1/2), then
    # the 1x1x1 logits conv, then the mean over the remaining positions
    window = (min(2, x.shape[2]), min(7, x.shape[3]), min(7, x.shape[4]))
    x = F.avg_pool3d(x, window, stride=1)
    logits = F.conv3d(x, params["Logits"]["w"]) + params["Logits"]["b"].view(1, -1, 1, 1, 1)
    return logits.mean(dim=(2, 3, 4))  # (b, 400)
