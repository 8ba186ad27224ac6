"""Models of the port: the PR-DVQVAE2 VQ-VAE and the subscale Video
Transformer with its KV-cached sampler."""

import torch


def to_device(tree, device):
    """Move every tensor of a nested dict/list tree to ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree.to(device)


def cast_floats(tree, dtype):
    """Cast the floating tensors of a nested dict/list tree (bf16 inference
    weights); integer tensors untouched."""
    if isinstance(tree, dict):
        return {k: cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floats(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree
