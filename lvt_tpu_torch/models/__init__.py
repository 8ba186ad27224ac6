"""Models of the port: the PR-DVQVAE2 VQ-VAE and the subscale Video
Transformer with its KV-cached sampler (counterpart of lvt_tpu/models)."""

import logging

import torch


def build_model(cfg, **kwargs):
    """The meta-architecture MODEL.META_ARCHITECTURE names."""
    from .vqvae import VQVAE
    from .vt import VideoTransformer

    registry = {"VQVAEModel": VQVAE, "VideoTransformerModel": VideoTransformer}
    name = cfg.MODEL.META_ARCHITECTURE
    if name not in registry:
        raise NotImplementedError(f"meta-architecture {name!r} is not ported to "
                                  f"lvt_tpu_torch; ported: {sorted(registry)}")
    model = registry[name](cfg, **kwargs)
    logging.getLogger(__name__).info(f"Built meta-architecture {name}")
    return model


def tree_leaves(tree):
    """The tensors of a nested dict/list tree, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def param_count(params) -> int:
    return sum(int(x.numel()) for x in tree_leaves(params))


def to_device(tree, device):
    """Move every tensor of a nested dict/list tree to ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree.to(device)


def cast_floats(tree, dtype):
    """Cast the floating tensors of a nested dict/list tree; integer tensors
    untouched. The cast is differentiable: inside a train step the bf16
    compute copies of fp32 master weights send fp32 gradients back, as
    lvt_tpu's mixed precision does."""
    if isinstance(tree, dict):
        return {k: cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floats(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree
