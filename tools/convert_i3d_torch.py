#!/usr/bin/env python
"""Convert a pretrained I3D checkpoint into the .npz schema that
``lvt_tpu_torch.evaluation.i3d.load_i3d_npz`` reads (flat '/'-joined keys,
convolution weights (t, h, w, in, out)), enabling real FVD numbers via
``TEST.FVD.I3D_WEIGHTS``; the counterpart of tools/convert_i3d.py, whose
files it writes array for array (one file drives both packages).

Two source formats (auto-detected by extension, override with --format):

* ``tf-npz`` — an .npz dump of the canonical TF-Hub / sonnet Kinetics-400
  RGB checkpoint's variable tree (deepmind/kinetics-i3d). Dump the
  variables in any TensorFlow environment with::

      import tensorflow.compat.v1 as tf, numpy as np
      r = tf.train.NewCheckpointReader("data/checkpoints/rgb_scratch/model.ckpt")
      np.savez("i3d_tf_dump.npz",
               **{n: r.get_tensor(n) for n in r.get_variable_to_shape_map()})

  Variable names look like ``RGB/inception_i3d/Mixed_3b/Branch_1/
  Conv3d_0b_3x3/conv_3d/w``; conv weights are already (t, h, w, in, out);
  batch-norm beta/moving_mean/moving_variance are stored (1, 1, 1, 1, C).

* ``torch`` — a piergiaj/pytorch-i3d style ``.pt``/``.pth`` state dict
  (e.g. ``models/rgb_imagenet.pt``, 400 classes). Conv weights are OIDHW
  and are transposed to (t, h, w, in, out); the BatchNorm3d gamma (absent
  from the original sonnet model, where scale=False) is folded exactly into
  the emitted variance:

      (x - m) / sqrt(v + eps_src) * gamma + beta
        == (x - m) / sqrt(v' + EPS_I3D) + beta,
      v' = (v + eps_src) / gamma^2 - EPS_I3D

  so i3d_apply's fixed-eps normalization reproduces the torch output up to
  fp32 rounding.

The output tree is validated key by key and shape by shape against the
port's ``init_i3d`` schema before writing: a converted file either loads
into ``make_i3d_features`` or the converter errors out. Runs on the CPU.

Usage: python tools/convert_i3d_torch.py --src i3d_tf_dump.npz --out i3d.npz
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

# i3d_apply normalizes with this fixed epsilon (lvt_tpu_torch/evaluation/i3d.py);
# matches sonnet BatchNorm's and pytorch-i3d's 1e-3 default.
EPS_I3D = 1e-3

TF_PREFIX = "RGB/inception_i3d/"

# pytorch-i3d branch-unit names -> canonical sonnet paths
TORCH_BRANCHES = {
    "b0": ("Branch_0", "Conv3d_0a_1x1"),
    "b1a": ("Branch_1", "Conv3d_0a_1x1"),
    "b1b": ("Branch_1", "Conv3d_0b_3x3"),
    "b2a": ("Branch_2", "Conv3d_0a_1x1"),
    "b2b": ("Branch_2", "Conv3d_0b_3x3"),
    "b3b": ("Branch_3", "Conv3d_0b_1x1"),
}


def expected_schema():
    """{'Mixed_3b/Branch_0/Conv3d_0a_1x1/w': shape, ...} from the port's
    init_i3d, in the file's layout: its (out, in, t, h, w) convolution
    weights are (t, h, w, in, out) there."""
    import torch

    from lvt_tpu_torch.evaluation.i3d import init_i3d

    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
            else:
                shape = tuple(v.shape)
                if k == "w":
                    o, i, t, h, w = shape
                    shape = (t, h, w, i, o)
                flat[prefix + k] = shape

    walk(init_i3d(torch.Generator().manual_seed(0)), "")
    return flat


def convert_tf_npz(src: dict) -> dict:
    """TF variable-name dump -> flat canonical tree."""
    out = {}
    for name, arr in src.items():
        arr = np.asarray(arr)
        key = name[len(TF_PREFIX):] if name.startswith(TF_PREFIX) else name
        # the canonical sonnet model names Mixed_5b's SECOND Branch_2 conv
        # 'Conv3d_0a_3x3' (an original-code naming quirk kept for checkpoint
        # compatibility; every other Mixed block uses 0b) — our schema uses
        # the regular name, so alias it or the genuine deepmind dump fails
        # validation
        key = key.replace("Mixed_5b/Branch_2/Conv3d_0a_3x3/",
                          "Mixed_5b/Branch_2/Conv3d_0b_3x3/")
        if key.startswith("Logits/"):
            if key.endswith("conv_3d/w"):
                out["Logits/w"] = arr.astype(np.float32)
            elif key.endswith("conv_3d/b"):
                out["Logits/b"] = arr.reshape(-1).astype(np.float32)
            continue
        if key.endswith("/conv_3d/w"):
            out[key[:-len("/conv_3d/w")] + "/w"] = arr.astype(np.float32)
        elif key.endswith("/batch_norm/beta"):
            out[key[:-len("/batch_norm/beta")] + "/beta"] = \
                arr.reshape(-1).astype(np.float32)
        elif key.endswith("/batch_norm/moving_mean"):
            out[key[:-len("/batch_norm/moving_mean")] + "/mean"] = \
                arr.reshape(-1).astype(np.float32)
        elif key.endswith("/batch_norm/moving_variance"):
            out[key[:-len("/batch_norm/moving_variance")] + "/var"] = \
                arr.reshape(-1).astype(np.float32)
        # anything else (global_step, Momentum slots, ...) is ignored
    return out


def _fold_bn(gamma, beta, mean, var, eps_src):
    """Fold a gamma-bearing BN into i3d_apply's fixed-eps, beta-only form."""
    gamma = np.asarray(gamma, np.float64)
    if not np.all(gamma > 0):
        # the fold squares gamma: a non-positive gamma would silently
        # sign-flip (or inf out) that channel's activations. Pretrained
        # I3D BN gammas are strictly positive; anything else needs a
        # different fold (into the conv weights), so refuse loudly.
        bad = int(np.sum(gamma <= 0))
        raise ValueError(
            f"{bad} BN gamma(s) <= 0: the variance fold discards gamma's "
            f"sign, so this checkpoint cannot be converted bit-exactly — "
            f"fold gamma into the conv weights instead")
    var_eff = (np.asarray(var, np.float64) + eps_src) / (gamma * gamma) - EPS_I3D
    return (np.asarray(beta, np.float32), np.asarray(mean, np.float32),
            var_eff.astype(np.float32))


def convert_torch(state: dict, eps_src: float = EPS_I3D) -> dict:
    """pytorch-i3d state dict -> flat canonical tree."""
    out = {}
    units = {}  # canonical unit path -> {weight, bn.weight, ...}
    for name, tensor in state.items():
        arr = tensor.detach().cpu().numpy() if hasattr(tensor, "detach") \
            else np.asarray(tensor)
        parts = name.split(".")
        top = parts[0]
        if top == "logits":
            if name.endswith("conv3d.weight"):
                out["Logits/w"] = arr.transpose(2, 3, 4, 1, 0).astype(np.float32)
            elif name.endswith("conv3d.bias"):
                out["Logits/b"] = arr.reshape(-1).astype(np.float32)
            continue
        if top.startswith("Mixed"):
            branch, unit = TORCH_BRANCHES[parts[1]]
            path = f"{top}/{branch}/{unit}"
            leaf = ".".join(parts[2:])
        else:  # stem: Conv3d_1a_7x7.conv3d.weight etc.
            path = top
            leaf = ".".join(parts[1:])
        units.setdefault(path, {})[leaf] = arr
    for path, u in units.items():
        w = u["conv3d.weight"].transpose(2, 3, 4, 1, 0).astype(np.float32)
        gamma = u.get("bn.weight", np.ones(w.shape[-1], np.float32))
        beta, mean, var = _fold_bn(
            gamma, u.get("bn.bias", np.zeros(w.shape[-1])),
            u.get("bn.running_mean", np.zeros(w.shape[-1])),
            u.get("bn.running_var", np.ones(w.shape[-1])), eps_src)
        out[path + "/w"] = w
        out[path + "/beta"] = beta
        out[path + "/mean"] = mean
        out[path + "/var"] = var
    return out


def validate(flat: dict) -> None:
    """Exact key + shape check against init_i3d's schema; raises on drift."""
    want = expected_schema()
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise ValueError(
            f"converted tree does not match the I3D schema: "
            f"missing={missing[:8]}{'...' if len(missing) > 8 else ''} "
            f"extra={extra[:8]}{'...' if len(extra) > 8 else ''}")
    bad = [(k, tuple(flat[k].shape), want[k]) for k in want
           if tuple(flat[k].shape) != want[k]]
    if bad:
        raise ValueError(f"shape mismatches (key, got, want): {bad[:8]}")


def load_source(path: str, fmt: str) -> dict:
    if fmt == "tf-npz":
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    import torch

    state = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    return state


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--src", required=True, help="source checkpoint "
                   "(.npz TF-variable dump or pytorch-i3d .pt/.pth)")
    p.add_argument("--out", required=True,
                   help="output .npz for TEST.FVD.I3D_WEIGHTS")
    p.add_argument("--format", choices=["auto", "tf-npz", "torch"],
                   default="auto")
    p.add_argument("--eps", type=float, default=EPS_I3D,
                   help="source BN epsilon (torch format; pytorch-i3d uses 1e-3)")
    args = p.parse_args(argv)

    fmt = args.format
    if fmt == "auto":
        fmt = "tf-npz" if args.src.endswith(".npz") else "torch"
    src = load_source(args.src, fmt)
    flat = convert_tf_npz(src) if fmt == "tf-npz" \
        else convert_torch(src, args.eps)
    validate(flat)
    np.savez(args.out, **flat)
    print(f"wrote {args.out}: {len(flat)} arrays, "
          f"{sum(a.nbytes for a in flat.values()) / 1e6:.1f} MB "
          f"(set TEST.FVD.I3D_WEIGHTS to this path)")
    return flat


if __name__ == "__main__":
    main()
