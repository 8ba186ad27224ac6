"""Weights carried across: from_jax_vt / from_jax_vqvae take every leaf of the
JAX trees and fill every parameter of the port, at the full width of every
shipped configuration (four VTs, three VQ-VAEs)."""

import os

import jax
import numpy as np
import pytest
import torch

from lvt_tpu.config import get_cfg
from lvt_tpu.models.vqvae import VQVAE as JaxVQVAE
from lvt_tpu.models.vt import VideoTransformer as JaxVT
from lvt_tpu_torch.checkpoint import from_jax_vqvae, from_jax_vt
from lvt_tpu_torch.checkpoint.convert import flatten
from lvt_tpu_torch.models.vqvae import VQVAE
from lvt_tpu_torch.models.vt import VideoTransformer

torch.set_num_threads(1)  # one intra-op thread: the test workers share the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(rel):
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(ROOT, rel))
    return cfg


def _zeros_like_shapes(tree):
    """Leaves of a jax.eval_shape tree as numpy zeros (shapes only)."""
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), tree)


def _jax_leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def _assert_same_layout(got, want):
    fg, fw = flatten(got), flatten(want)
    assert sorted(fg) == sorted(fw)
    for k in fw:
        assert tuple(fg[k].shape) == tuple(fw[k].shape), k
        assert fg[k].dtype == fw[k].dtype, k


VT_CONFIGS = ["configs/vt/DSFVT.yaml", "configs/vt/DSSVT.yaml", "configs/vt/DSTSVT.yaml",
              "configs/vt/KDSFVT.yaml"]
VQ_CONFIGS = ["configs/vqvae/PR-DVQVAE2.yaml", "configs/vqvae/K-DVQVAE.yaml",
              "configs/vqvae/Base-VQVAE.yaml"]


@pytest.mark.parametrize("rel", VT_CONFIGS, ids=lambda r: os.path.basename(r)[:-5])
def test_vt_full_dsfvt_every_leaf_carried(rel):
    """Every shipped VT config at full width (DSFVT first)."""
    cfg = _cfg(rel)
    shapes = jax.eval_shape(JaxVT(cfg).init, jax.random.key(0))[0]["netG"]
    jtree = _zeros_like_shapes(shapes)
    got = from_jax_vt(jtree)
    assert len(flatten(got)) == len(_jax_leaves(jtree))  # no JAX leaf left unused
    port, _ = VideoTransformer(cfg).init(torch.Generator().manual_seed(0))
    _assert_same_layout(got, port["netG"])  # every port parameter filled
    assert sum(t.numel() for t in flatten(got).values()) == \
        sum(int(np.prod(x.shape)) for x in _jax_leaves(jtree))


@pytest.mark.parametrize("rel", VQ_CONFIGS, ids=lambda r: os.path.basename(r)[:-5])
def test_vqvae_full_prdvqvae2_every_leaf_carried(rel):
    """Every shipped VQ-VAE config at full width (PR-DVQVAE2 first);
    Base-VQVAE with the RGB channels of tests/test_configs_build.py."""
    cfg = _cfg(rel)
    if rel.endswith("Base-VQVAE.yaml"):
        cfg.MODEL.ENCODER.IN_CHANNELS = 3
        cfg.MODEL.GENERATOR.OUT_CHANNELS = 3
    p_shapes, s_shapes = jax.eval_shape(JaxVQVAE(cfg).init, jax.random.key(0))
    jp, js = _zeros_like_shapes(p_shapes), _zeros_like_shapes(s_shapes)
    p, s = from_jax_vqvae(jp, js)
    assert len(flatten(p)) + len(flatten(s)) == len(_jax_leaves(jp)) + len(_jax_leaves(js))
    port_p, port_s = VQVAE(cfg).init(torch.Generator().manual_seed(0))
    _assert_same_layout(p, port_p)
    _assert_same_layout(s, port_s)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_values_round_trip_exactly(dtype):
    """Every converted leaf holds the JAX leaf's values bit for bit (bf16
    leaves included, which torch.from_numpy cannot read directly)."""
    import jax.numpy as jnp

    from lvt_tpu.models import cast_floats

    cfg = get_cfg()
    v = cfg.MODEL.AUTOREGRESSIVE.VT
    v.NC, v.NV, v.D, v.DA, v.DE = 2, 8, 32, 16, 16
    v.KERNEL, v.STRIDE = (3, 1, 1), (4, 1, 1)
    v.BLOCKS_E = v.BLOCKS_D = ((1, 4, 4),) * 2
    v.N_HEAD_E = v.N_HEAD_D = (2, 2)
    params = JaxVT(cfg, T=4, H=4, W=4).init(jax.random.key(0))[0]["netG"]
    if dtype == "bfloat16":
        params = cast_floats(params, jnp.bfloat16)
    jtree = jax.tree_util.tree_map(np.asarray, params)
    got = from_jax_vt(jtree)
    paths = [".".join(_key(k) for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(jtree)[0]]
    flat = flatten(got)
    for path, leaf in zip(paths, _jax_leaves(jtree)):
        t = flat[path]
        assert np.array_equal(t.float().numpy(), np.asarray(leaf, np.float32)), path


def _key(k):
    """A jax tree path entry as one part of the port's dotted name."""
    if isinstance(k, jax.tree_util.DictKey):
        return str(k.key)
    if isinstance(k, jax.tree_util.SequenceKey):
        return str(k.idx)
    return k.name  # GetAttrKey of a NamedTuple field


def test_converter_rejects_empty_leaf():
    with pytest.raises(ValueError):
        from_jax_vt({"encoder": {"x": None}, "decoder": {}, "predictor": {}})
