"""The port's UNet over code indices (lvt_tpu_torch/models/unet.py) held to
lvt_tpu's on the same weights (carried across by ``from_jax_unet``) and the
same codes, made with numpy from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import lvt_tpu.models.unet as junet
import lvt_tpu_torch.models.unet as tunet
from lvt_tpu.config import get_cfg as jax_get_cfg
from lvt_tpu_torch.checkpoint import from_jax_unet
from lvt_tpu_torch.config import get_cfg
from lvt_tpu_torch.models.encoders import build_encoder

torch.set_num_threads(1)  # one intra-op thread: the test workers share the cores

OUT = 2


def _cfg(get):
    cfg = get()
    cfg.MODEL.ENCODER.NAME = "UNet"
    cfg.MODEL.ENCODER.OUT_CHANNELS = OUT
    return cfg


_TWINS = {}


def _twins():
    """(lvt_tpu's net, its params and state, the port's net, the same
    weights in the port), built once."""
    if not _TWINS:
        jnet = junet.UNetNet(_cfg(jax_get_cfg))
        jp, js = jnet.init(jax.random.key(0))
        jp, js = jax.tree_util.tree_map(np.asarray, (jp, js))
        tp, ts = from_jax_unet(jp, js)
        _TWINS.update(j=(jnet, jp, js), t=(build_encoder(_cfg(get_cfg)), tp, ts))
    return _TWINS["j"], _TWINS["t"]


def _flat(tree):
    return {k: np.asarray(v, np.float32) for k, v in _walk(tree)}


def _walk(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{prefix}.{k}" if prefix else k)
    else:
        yield prefix, tree.detach().numpy() if isinstance(tree, torch.Tensor) else tree


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("size", [16, 24])
def test_unet_matches_lvt_tpu(train, size):
    """Output and new batch-norm state within 1e-5 of lvt_tpu's, in train and
    eval mode; 24 x 24 codes pool to 3 x 3 and 1 x 1, so the upsampled maps
    take the centered pad before their concat. Batch 4: the bottleneck is
    1 x 1, and at batch 2 its train-mode batch norm normalizes over two
    values a channel, where fp32 rounding is amplified so far that each
    package lands 1e-5 to 3e-5 from a float64 evaluation of the same net."""
    (jnet, jp, js), (tnet, tp, ts) = _twins()
    codes = np.random.default_rng(size).integers(0, 512, size=(4, size, size)).astype(np.int32)
    jy, jns = jnet.apply(jax.tree_util.tree_map(jnp.asarray, jp),
                         jax.tree_util.tree_map(jnp.asarray, js), jnp.asarray(codes), train=train)
    with torch.no_grad():
        ty, tns = tnet.apply(tp, ts, torch.from_numpy(codes), train=train)
    assert ty.shape == (4, size, size, OUT) and ty.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5, rtol=0)
    want, got = _flat(jax.tree_util.tree_map(np.asarray, jns)), _flat(tns)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=1e-5, err_msg=k)
    if not train:  # eval mode leaves the running statistics as they were
        for k, v in _flat(ts).items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_unet_registered_init_and_range():
    """``UNet`` registers on import; its init from a torch.Generator has
    lvt_tpu's tree and shapes and PyTorch's default conv bounds; outputs
    lie in [0, 1]."""
    (_, jp, js), _ = _twins()
    net = build_encoder(_cfg(get_cfg))
    assert isinstance(net, tunet.UNetNet)
    p, s = net.init(torch.Generator().manual_seed(0))
    for tree, jtree in ((p, jp), (s, js)):
        shapes = {k: v.shape for k, v in _walk(tree)}
        assert shapes == {k: tuple(np.shape(v)) for k, v in _walk(jtree)}
    w = p["up1"]["w1"]
    bound = 1 / np.sqrt(9 * 1024)
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.9 * bound
    codes = torch.from_numpy(np.random.default_rng(3).integers(0, 512, size=(2, 16, 16)))
    with torch.no_grad():
        y, _ = net.apply(p, s, codes, train=True)
    assert 0.0 <= float(y.min()) and float(y.max()) <= 1.0


@pytest.mark.parametrize("shape", [(2, 5, 7, 3), (1, 1, 4, 2), (1, 3, 1, 2)])
def test_bilinear_up2_matches_interpolate_and_lvt_tpu(shape):
    x = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    got = tunet._bilinear_up2(torch.from_numpy(x)).numpy()
    ref = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), scale_factor=2,
                        mode="bilinear", align_corners=True).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(junet._bilinear_up2(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)


def test_from_jax_unet_refuses_other_trees():
    (_, jp, js), _ = _twins()
    with pytest.raises(ValueError, match="not a UNet"):
        from_jax_unet({k: v for k, v in jp.items() if k != "outc"}, js)
