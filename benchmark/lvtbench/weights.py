"""Seed-made weights and the seeds of a run's random streams.

A tree's leaves are listed by a reference's ``param_specs``: (path, shape,
init) with init ("uniform", a) for U(-a, a), ("normal", s) for N(0, s^2) or
("one", a) for 1 + U(-a, a). They are drawn on the device from one
generator in two calls, one uniform and one normal draw for all leaves, then
cut and scaled leaf by leaf, in float32. The same seed on the same device
gives the same values, so the benchmark makes the tree again for the
reference instead of keeping a copy.
"""

from typing import Dict, List, Tuple

import torch

# the run's random streams, each seeded by stream_seed(seed, tag)
VT_WEIGHTS, VQ_WEIGHTS, FRAMES, SAMPLING, CLIPS, CHECK = 1, 2, 3, 4, 5, 6


def stream_seed(seed: int, tag: int, index: int = 0) -> int:
    """The seed of stream ``tag`` (item ``index`` of it) of run seed ``seed``
    (any whole number)."""
    return (int(seed) * 1_000_003 + tag * 7_919 + index * 104_729) % (2 ** 62)


def _set(tree, path, value):
    node = tree
    for i, key in enumerate(path[:-1]):
        nxt = path[i + 1]
        if isinstance(node, list):
            while len(node) <= key:
                node.append([] if isinstance(nxt, int) else {})
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    last = path[-1]
    if isinstance(node, list):
        while len(node) <= last:
            node.append(None)
        node[last] = value
    else:
        node[last] = value


def make_tree(specs: List[Tuple], seed: int, device, tree=None) -> Dict:
    """The leaves of ``specs`` from ``seed`` as a nested dict / list tree
    (filled into ``tree`` where given), float32 on ``device``."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    n_uni = sum(_numel(s) for _, s, (kind, _) in specs if kind != "normal")
    n_nor = sum(_numel(s) for _, s, (kind, _) in specs if kind == "normal")
    uni = torch.rand(n_uni, generator=gen, device=device)
    nor = torch.randn(n_nor, generator=gen, device=device)
    tree = {} if tree is None else tree
    ou = on = 0
    for path, shape, (kind, a) in specs:
        n = _numel(shape)
        if kind == "normal":
            leaf = nor[on:on + n] * a
            on += n
        else:
            leaf = (uni[ou:ou + n] * 2.0 - 1.0) * a
            ou += n
            if kind == "one":
                leaf = leaf + 1.0
        _set(tree, path, leaf.reshape(shape).clone())
    return tree


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def cast(tree, dtype):
    """The tree with its floating leaves in ``dtype``."""
    if isinstance(tree, dict):
        return {k: cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree in the order of its keys as made."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves(v)]
    return [tree]
