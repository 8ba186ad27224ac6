"""VQ-VAE training in the port held to lvt_tpu on small models (NF 16, K 16,
16x16 frames), weights carried across with from_jax_vqvae /
from_jax_autoencoder, inputs from a numpy seed, on the CPU:

* every encoder and generator registry entry, forward in train mode with its
  new state (norm "" and BN with spectral norm): 1e-5 of the largest output;
* VQVAE.loss, its terms and every gradient leaf against jax.grad, EMA and
  non-EMA, with and without norms: fp32 within 1e-5 of each leaf's largest
  |grad| (floored at 1e-2 of the largest leaf's), the new state within 1e-5,
  indices bit-equal; bf16 compute held to the fp32 gradient within 5x what
  lvt_tpu's own bf16 gradient strays plus one bf16 rounding;
* the AutoEncoder's loss and gradients; from_jax_vqvae on both codebook
  kinds. The trainer-level tests are in tests/test_torch_vqvae_trainer.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lvt_tpu.ops.vq as jvq
from lvt_tpu.config import get_cfg as jax_get_cfg
from lvt_tpu.models import build_model as jax_build_model
from lvt_tpu.models import cast_floats as jax_cast_floats
from lvt_tpu.models.decoders import build_generator as jax_build_generator
from lvt_tpu.models.encoders import build_encoder as jax_build_encoder
from lvt_tpu_torch.checkpoint import from_jax_autoencoder, from_jax_vqvae
from lvt_tpu_torch.checkpoint.convert import flatten
from lvt_tpu_torch.config import get_cfg
from lvt_tpu_torch.models import build_model, cast_floats
from lvt_tpu_torch.models.decoders import build_generator
from lvt_tpu_torch.models.encoders import build_encoder
from lvt_tpu_torch.ops import vq as tvq

torch.set_num_threads(1)  # one intra-op thread: the test workers share the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = {"plain": ("", False), "bn-spectral": ("BN", True), "gn": ("GN", False)}


def _cfg(get=get_cfg, ema=True, variant="plain", encoder="ResEncoder", generator="ResDecoder",
         arch="VQVAEModel", **solver):
    cfg = get()
    cfg.merge_from_file(os.path.join(ROOT, "configs", "vqvae", "PR-DVQVAE2.yaml"))
    m = cfg.MODEL
    m.META_ARCHITECTURE = arch
    norm, spectral = VARIANTS[variant]
    m.ENCODER.NAME, m.GENERATOR.NAME = encoder, generator
    for net in (m.ENCODER, m.GENERATOR):
        net.NF, net.RES_CHANNELS, net.N_LAYERS = 16, 8, 2
        net.NORM, net.SPECTRAL = norm, spectral
    m.ENCODER.OUT_CHANNELS = m.GENERATOR.IN_CHANNELS = 16
    m.CODEBOOK.NUM, m.CODEBOOK.SIZE, m.CODEBOOK.DIM, m.CODEBOOK.EMA = 4, 16, 16, ema
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.SEED = 3
    cfg.SOLVER.IMS_PER_BATCH = 4
    for k, val in solver.items():
        node, key = cfg.SOLVER, k
        if "." in k:
            sub, key = k.split(".")
            node = getattr(cfg.SOLVER, sub)
        setattr(node, key, val)
    return cfg


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _frames(rng, b=4, hw=16):
    return rng.uniform(0.0, 1.0, (b, hw, hw, 3)).astype(np.float32)


def _leaf_close(name, got, want, rel, floor=1e-30):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, f"{name}: shape {got.shape} vs {want.shape}"
    if not want.size:
        return
    bound = rel * max(float(np.abs(want).max()), floor)
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{name}: max abs err {err:.3g} > {bound:.3g}"


def _state_close(got, want_jax, rel=1e-5):
    want = flatten(from_jax_autoencoder({"netE": {}, "netG": {}},
                                        {"netE": _np_tree(want_jax), "netG": {}})[1]["netE"])
    got = flatten(got)
    assert set(got) == set(want)
    for k, w in want.items():
        assert not got[k].requires_grad and got[k].grad_fn is None, k
        _leaf_close(f"state {k}", got[k], w.numpy(), rel)


# --------------------------------------------------------------------------
# Encoder and generator registries
# --------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["plain", "bn-spectral"])
@pytest.mark.parametrize("name", ["ResEncoder", "ConvEncoder"])
def test_encoder_registry_entries_match_jax(rng, name, variant):
    jnet, tnet = (b(_cfg(g, variant=variant, encoder=name))
                  for b, g in ((jax_build_encoder, jax_get_cfg), (build_encoder, get_cfg)))
    assert tuple(tnet.spec) == tuple(jnet.spec)
    jp, js = jnet.init(jax.random.key(0))
    tp, ts = from_jax_autoencoder({"netE": _np_tree(jp), "netG": {}},
                                  {"netE": _np_tree(js), "netG": {}})
    ip, istate = tnet.init(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in flatten(ip).items()} == \
        {k: tuple(v.shape) for k, v in flatten(tp["netE"]).items()}
    assert set(flatten(istate)) == set(flatten(ts["netE"]))
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    for train in (True, False):
        want, wstate = jax.jit(lambda p, s, a, t=train: jnet.apply(p, s, a, train=t))(
            jp, js, jnp.asarray(x))
        got, gstate = tnet.apply(tp["netE"], ts["netE"], torch.from_numpy(x), train=train)
        _leaf_close(f"{name} train={train}", got, np.asarray(want), 1e-5)
        _state_close(gstate, wstate)


@pytest.mark.parametrize("variant", ["plain", "bn-spectral"])
@pytest.mark.parametrize("name", ["ResDecoder", "ResShuffleDecoder", "ConvDecoder"])
def test_generator_registry_entries_match_jax(rng, name, variant):
    jnet, tnet = (b(_cfg(g, variant=variant, generator=name))
                  for b, g in ((jax_build_generator, jax_get_cfg), (build_generator, get_cfg)))
    assert tuple(tnet.spec) == tuple(jnet.spec)
    jp, js = jnet.init(jax.random.key(1))
    tp, ts = from_jax_autoencoder({"netE": {}, "netG": _np_tree(jp)},
                                  {"netE": {}, "netG": _np_tree(js)})
    z = rng.standard_normal((2, 4, 4, 16)).astype(np.float32)
    want, wstate = jax.jit(lambda p, s, a: jnet.apply(p, s, a, train=True))(
        jp, js, jnp.asarray(z))
    got, gstate = tnet.apply(tp["netG"], ts["netG"], torch.from_numpy(z), train=True)
    _leaf_close(name, got, np.asarray(want), 1e-5)
    _state_close(gstate, wstate)


@pytest.mark.parametrize("variant", ["plain", "bn-spectral"])
def test_vqvae2_encoder_and_decoder_match_jax(rng, variant):
    jcfg, tcfg = (_cfg(g, variant=variant, encoder="VQVAE2Encoder", generator="VQVAE2Decoder")
                  for g in (jax_get_cfg, get_cfg))
    jenc, tenc = jax_build_encoder(jcfg), build_encoder(tcfg)
    jdec, tdec = jax_build_generator(jcfg), build_generator(tcfg)
    assert tenc._fields == jenc._fields and tdec._fields == jdec._fields
    (jpe, jse), (jpg, jsg) = jenc.init(jax.random.key(0)), jdec.init(jax.random.key(1))
    tp, ts = from_jax_autoencoder({"netE": _np_tree(jpe), "netG": _np_tree(jpg)},
                                  {"netE": _np_tree(jse), "netG": _np_tree(jsg)})
    ip, _ = tenc.init(torch.Generator().manual_seed(0))
    assert set(flatten(ip)) == set(flatten(tp["netE"]))
    ip, _ = tdec.init(torch.Generator().manual_seed(0))
    assert set(flatten(ip)) == set(flatten(tp["netG"]))
    inputs = {"enc_b": (2, 16, 16, 3), "enc_t": (2, 4, 4, 16), "quantize_conv_t": (2, 2, 2, 16),
              "dec_t": (2, 2, 2, 16), "quantize_conv_b": (2, 4, 4, 32)}
    for mode, shape in inputs.items():
        x = rng.standard_normal(shape).astype(np.float32)
        want, wstate = jax.jit(lambda p, s, a, m=mode: jenc.apply(p, s, a, m, train=True))(
            jpe, jse, jnp.asarray(x))
        got, gstate = tenc.apply(tp["netE"], ts["netE"], torch.from_numpy(x), mode, train=True)
        _leaf_close(mode, got, np.asarray(want), 1e-5)
        assert set(gstate) == set(wstate)
        _state_close(gstate[mode], wstate[mode])
    qt, qb = (rng.standard_normal(s).astype(np.float32) for s in ((2, 2, 2, 16), (2, 4, 4, 16)))
    want, wstate = jax.jit(lambda p, s, a, b: jdec.apply(p, s, a, b, train=True))(
        jpg, jsg, jnp.asarray(qt), jnp.asarray(qb))
    got, gstate = tdec.apply(tp["netG"], ts["netG"], torch.from_numpy(qt), torch.from_numpy(qb),
                             train=True)
    _leaf_close("VQVAE2Decoder", got, np.asarray(want), 1e-5)
    _state_close(gstate, wstate)


# --------------------------------------------------------------------------
# Loss and gradients against jax.grad
# --------------------------------------------------------------------------

def _models(ema, variant, seed=0, **solver):
    jm = jax_build_model(_cfg(jax_get_cfg, ema, variant, **solver))
    jp, js = jm.init(jax.random.key(seed))
    tm = build_model(_cfg(get_cfg, ema, variant, **solver))
    return jm, jp, js, tm


def _port_trees(jp, js):
    return from_jax_vqvae(_np_tree(jp), _np_tree(js))


def _jax_loss_and_grads(jm, jp, js, batch, dtype=None):
    def loss_fn(p):
        pp = p if dtype is None else jax_cast_floats(p, dtype)
        return jm.train_loss(pp, js, batch, jax.random.key(0))

    (jl, (jd, jns)), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jp)
    return float(jl), jd, jns, flatten(_port_trees(jg, js)[0])


def _port_loss_and_grads(tm, tp, ts, batch, dtype=None):
    for leaf in flatten(tp).values():
        leaf.requires_grad_(True)
    p = tp if dtype is None else cast_floats(tp, dtype)
    loss, (metrics, new_state) = tm.train_loss(p, ts, batch, None)
    loss.float().backward()
    return loss, metrics, new_state, {k: v.grad for k, v in flatten(tp).items()}


@pytest.mark.parametrize("variant", ["plain", "bn-spectral", "gn"])
@pytest.mark.parametrize("ema", [True, False], ids=["ema", "no-ema"])
def test_loss_and_every_grad_match_jax_fp32(rng, ema, variant):
    jm, jp, js, tm = _models(ema, variant)
    x = _frames(rng)
    jl, jd, jns, want = _jax_loss_and_grads(jm, jp, js, {"image": jnp.asarray(x)})
    tp, ts = _port_trees(jp, js)
    loss, metrics, new_state, grads = _port_loss_and_grads(tm, tp, ts,
                                                           {"image": torch.from_numpy(x)})
    np.testing.assert_allclose(float(loss.detach()), jl, rtol=2e-6)
    assert set(metrics) == set(jd) == ({"loss_reconstruction", "loss_commitment"}
                                       | (set() if ema else {"loss_dict"}))
    for k in jd:
        assert metrics[k].dtype == torch.float32
        np.testing.assert_allclose(float(metrics[k]), float(jd[k]), rtol=2e-6, err_msg=k)
    assert set(grads) == set(want) and ("netC.embedding" in grads) == (not ema)
    floor = 1e-2 * max(float(w.abs().max()) for w in want.values())
    for name, g in grads.items():
        assert g is not None and g.dtype == torch.float32, name
        _leaf_close(name, g, want[name].numpy(), 1e-5, floor)
    # the new state: same tree, no graph, lvt_tpu's values
    want_state = flatten(_port_trees(jp, jns)[1])
    got_state = flatten(new_state)
    assert set(got_state) == set(want_state)
    for k, w in want_state.items():
        assert got_state[k].grad_fn is None and not got_state[k].requires_grad, k
        _leaf_close(f"state {k}", got_state[k], w.numpy(), 1e-5)
    assert (not torch.equal(new_state["netC"]["running_size"], ts["netC"]["running_size"])) == ema


def test_indices_and_image_sequence_batches_match_jax(rng):
    """An image_sequence batch is flattened over (b, t); the train step's
    indices equal lvt_tpu's."""
    jm, jp, js, tm = _models(True, "plain")
    x = rng.uniform(0.0, 1.0, (2, 3, 16, 16, 3)).astype(np.float32)
    jl, _, jns, _ = _jax_loss_and_grads(jm, jp, js, {"image_sequence": jnp.asarray(x)})
    tp, ts = _port_trees(jp, js)
    taken = []
    inner = tvq.quantize_st
    tvq.quantize_st = lambda *a, **k: taken.append(inner(*a, **k)) or taken[-1]
    try:
        loss, _ = tm.train_loss(tp, ts, {"image_sequence": torch.from_numpy(x)}, None)
    finally:
        tvq.quantize_st = inner
    np.testing.assert_allclose(float(loss), jl, rtol=2e-6)
    z_e = jm.encode_features(jp, js, jm.normalize(jnp.asarray(x.reshape(6, 16, 16, 3))),
                             train=True)[0]
    want = jvq.quantize_st(z_e, js["netC"], ema=True, train=True, use_pallas=False)[2]
    assert tuple(taken[0][2].shape) == (6, 4, 4, 4)
    np.testing.assert_array_equal(taken[0][2].numpy(), np.asarray(want))


def test_loss_and_every_grad_match_jax_bf16_compute(rng):
    """bf16 compute over fp32 masters and an fp32 state (TPU.COMPUTE_DTYPE
    bfloat16, the config's default): fp32 loss terms, fp32 gradients, an fp32
    new state. Both packages' bf16 gradients are held to the fp32 gradient:
    the port's may stray by 5x what lvt_tpu's strays plus one bf16 rounding of
    the leaf's largest gradient. The indices feeding both are lvt_tpu's own
    (a bf16 z_e sits at near-ties far more often than an fp32 one)."""
    jm, jp, js, tm = _models(True, "bn-spectral")
    x = _frames(rng)
    _, _, _, w32 = _jax_loss_and_grads(jm, jp, js, {"image": jnp.asarray(x)})
    jl, _, jns, w16 = _jax_loss_and_grads(jm, jp, js, {"image": jnp.asarray(x)}, jnp.bfloat16)
    tp, ts = _port_trees(jp, js)
    loss, metrics, new_state, grads = _port_loss_and_grads(
        tm, tp, ts, {"image": torch.from_numpy(x)}, torch.bfloat16)
    assert all(v.dtype == torch.float32 for v in metrics.values())
    np.testing.assert_allclose(float(loss), jl, rtol=2e-2)
    for k, v in flatten(new_state).items():
        assert v.dtype == torch.float32 and v.grad_fn is None, k
    for name, g in grads.items():
        assert g.dtype == torch.float32, name
        ref = w32[name].numpy()
        err = float(np.abs(g.numpy() - ref).max())
        jax_err = float(np.abs(w16[name].numpy() - ref).max())
        bound = 5 * jax_err + 2 ** -8 * float(np.abs(ref).max())
        assert err <= bound, f"{name}: bf16 error {err:.3g}, lvt_tpu's {jax_err:.3g}"


def test_encode_decode_reconstruct_and_visualize(rng):
    jm, jp, js, tm = _models(False, "bn-spectral")
    tp, ts = _port_trees(jp, js)
    x = np.array(jm.normalize(jnp.asarray(_frames(rng))))
    want_y, want_idx = jm.reconstruct(jp, js, jnp.asarray(x))
    with torch.no_grad():
        got_y, got_idx = tm.reconstruct(tp, ts, torch.from_numpy(x))
        np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
        np.testing.assert_array_equal(tm.encode(tp, ts, torch.from_numpy(x)).numpy(),
                                      np.asarray(want_idx))
        _leaf_close("reconstruction", got_y, np.asarray(want_y), 1e-5)
        _leaf_close("decode", tm.decode(tp, ts, got_idx),
                    np.asarray(jm.decode(jp, js, want_idx)), 1e-5)
    batch = _frames(rng)
    for leaf in flatten(tp).values():
        leaf.requires_grad_(True)
    got = tm.visualize_training(tp, ts, {"image": torch.from_numpy(batch)})["reconstruction"]
    want = jm.visualize_training(jp, js, {"image": batch})["reconstruction"]
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_autoencoder_loss_and_grads_match_jax(rng):
    jcfg, tcfg = (_cfg(g, variant="bn-spectral", encoder="ConvEncoder", generator="ConvDecoder",
                       arch="AutoEncoderModel") for g in (jax_get_cfg, get_cfg))
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    jp, js = jm.init(jax.random.key(0))
    x = _frames(rng)
    (jl, (jd, jns)), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.train_loss(p, js, {"image": jnp.asarray(x)}, None), has_aux=True))(jp)
    tp, ts = from_jax_autoencoder(_np_tree(jp), _np_tree(js))
    ip, istate = tm.init(torch.Generator().manual_seed(0))
    assert set(flatten(ip)) == set(flatten(tp)) and set(flatten(istate)) == set(flatten(ts))
    loss, metrics, new_state, grads = _port_loss_and_grads(tm, tp, ts,
                                                           {"image": torch.from_numpy(x)})
    np.testing.assert_allclose(float(loss), float(jl), rtol=2e-6)
    assert set(metrics) == {"loss_ae_mse"}
    want = flatten(from_jax_autoencoder(_np_tree(jg), _np_tree(js))[0])
    floor = 1e-2 * max(float(w.abs().max()) for w in want.values())
    for name, g in grads.items():
        _leaf_close(name, g, want[name].numpy(), 1e-5, floor)
    want_state = flatten(from_jax_autoencoder(_np_tree(jp), _np_tree(jns))[1])
    for k, v in flatten(new_state).items():
        _leaf_close(f"state {k}", v, want_state[k].numpy(), 1e-5)
    with torch.no_grad():
        y = tm.interpolate_first_last(tp, ts, torch.from_numpy(x))
    _leaf_close("interpolate", y, np.asarray(jm.interpolate_first_last(jp, js, jnp.asarray(x))),
                1e-5)
    with pytest.raises(ValueError):
        from_jax_autoencoder({"netE": {}}, {"netE": {}})


def test_from_jax_vqvae_takes_both_codebook_kinds(rng):
    for ema in (True, False):
        jm, jp, js, tm = _models(ema, "bn-spectral")
        tp, ts = _port_trees(jp, js)
        ip, istate = tm.init(torch.Generator().manual_seed(0))
        for got, want in ((tp, ip), (ts, istate)):
            assert {k: (tuple(v.shape), v.dtype) for k, v in flatten(got).items()} == \
                {k: (tuple(v.shape), v.dtype) for k, v in flatten(want).items()}
        assert (ts["netC"]["embedding"].numel() == 0) == (not ema)
    with pytest.raises(ValueError, match="non-EMA"):
        from_jax_vqvae({"netE": [], "netG": [], "netC": {}}, _np_tree(js))
    with pytest.raises(ValueError, match="codebook state"):
        from_jax_vqvae(_np_tree(jp), {"netE": [], "netG": [], "netC": {}})
