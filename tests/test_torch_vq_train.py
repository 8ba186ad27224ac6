"""The ops and layers of VQ-VAE training in the port held to lvt_tpu on the
same inputs, drawn from a numpy seed, on the CPU (so every kernel wrapper of
the port runs its plain version, and lvt_tpu's Pallas kernels run in interpret
mode or through their XLA reference).

Tolerances:
* nearest_indices (kernel 6's plain version): indices bit-equal to
  nearest_indices_xla and to nearest_indices_pallas(interpret=True), ties
  included;
* quantize_st in all four (ema, train) modes: indices bit-equal; z_q_st, z_q
  and the new state within 1e-6 of each tensor's largest value (fp32 sums of
  the EMA statistics in another order); the gradient to z_e and to a non-EMA
  embedding within 1e-6;
* norms and spectral norm, train and eval, outputs and new state: 2e-6 of the
  largest value (5e-6 for a norm's output: its variance is a difference of
  two means), bf16 activations at 2^-7;
* kernel 12's plain version against the probe tool's Pallas kernel in
  interpret mode and its XLA form: fp32 1e-5, bf16 the tool's own bound
  (0.05, tools/probe_decode_kernel.py:140) and tighter, 2^-6 of the largest
  output.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lvt_tpu.models.layers2d as jl2d
import lvt_tpu.ops.vq as jvq
from lvt_tpu.models.norms import VALID_NORMS, apply_norm as jax_apply_norm
from lvt_tpu.models.norms import init_norm as jax_init_norm
from lvt_tpu_torch.models import layers2d as tl2d
from lvt_tpu_torch.models import norms as tnorms
from lvt_tpu_torch.ops import cache_attention as tca
from lvt_tpu_torch.ops import vq as tvq

torch.set_num_threads(1)  # one intra-op thread: the test workers share the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _close(name, got, want, rel, floor=1e-30):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, f"{name}: shape {got.shape} vs {want.shape}"
    bound = rel * max(float(np.abs(want).max()) if want.size else 0.0, floor)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= bound, f"{name}: max abs err {err:.3g} > {bound:.3g}"


# --------------------------------------------------------------------------
# nearest_indices: kernel 6's plain version
# --------------------------------------------------------------------------

@pytest.mark.parametrize("N,K,Dc", [(512, 512, 64), (300, 16, 8), (1, 64, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nearest_indices_plain_equals_xla_and_pallas_interpret(rng, N, K, Dc, dtype):
    z = rng.standard_normal((N, Dc)).astype(np.float32)
    cb = rng.standard_normal((K, Dc)).astype(np.float32)
    jz, tz = jnp.asarray(z), torch.from_numpy(z)
    if dtype == "bfloat16":
        jz, tz = jz.astype(jnp.bfloat16), tz.to(torch.bfloat16)
    got = tvq.nearest_indices(tz, torch.from_numpy(cb))
    assert got.dtype == torch.int32 and tuple(got.shape) == (N,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jvq.nearest_indices_xla(jz, jnp.asarray(cb))))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jvq.nearest_indices_pallas(jz, jnp.asarray(cb), interpret=True)))


def test_nearest_indices_ties_go_to_the_lowest_index(rng):
    """The tie case of tests/test_vq.py: identical codebook rows; and a
    codebook with duplicated rows where z equals a code."""
    cb = np.stack([np.ones(8), np.ones(8)]).astype(np.float32)
    z = rng.standard_normal((16, 8)).astype(np.float32)
    assert (tvq.nearest_indices(torch.from_numpy(z), torch.from_numpy(cb)) == 0).all()
    base = rng.standard_normal((20, 8)).astype(np.float32)
    cb = np.concatenate([base, base, base])
    got = tvq.nearest_indices(torch.from_numpy(base), torch.from_numpy(cb)).numpy()
    np.testing.assert_array_equal(got, np.arange(20))
    for fn in (jvq.nearest_indices_xla,
               lambda a, b: jvq.nearest_indices_pallas(a, b, interpret=True)):
        np.testing.assert_array_equal(np.asarray(fn(jnp.asarray(base), jnp.asarray(cb))), got)


def test_nearest_indices_dispatch_and_no_gradient():
    z = torch.randn(6, 8, requires_grad=True)
    cb = torch.randn(5, 8, requires_grad=True)
    idx = tvq.nearest_indices(z, cb)
    assert not idx.requires_grad
    assert torch.equal(idx, tvq.nearest_indices(z, cb, use_kernel=False))
    with pytest.raises(ValueError):  # the kernel takes CUDA tensors only: no quiet fallback
        tvq.nearest_indices(z, cb, use_kernel=True)
    with pytest.raises(ValueError):
        tvq.nearest_indices_grouped(z[:, None, :], cb[None], use_kernel=True)
    assert tvq.nearest_indices_grouped_cuda.launches == 0


@pytest.mark.parametrize("N,G,K,Dc", [(512, 4, 512, 64), (37, 3, 16, 8), (1, 1, 64, 256),
                                      (300, 2, 129, 4)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("strided", [False, True], ids=["contiguous", "strided"])
def test_nearest_indices_grouped_plain_equals_jax_per_sub_codebook(rng, N, G, K, Dc, dtype,
                                                                   strided):
    """The grouped plain version (kernel 6's, all sub-codebooks at once) is
    lvt_tpu's nearest_indices on each sub-codebook, bit for bit, on the
    (N, G, Dc) view quantize_st builds or on a strided view (every other
    sub-codebook of a wider z)."""
    zw = rng.standard_normal((N, 2 * G if strided else G, Dc)).astype(np.float32)
    cbs = rng.standard_normal((G, K, Dc)).astype(np.float32)
    z = zw[:, ::2, :] if strided else zw
    tz = torch.from_numpy(zw)[:, ::2, :] if strided else torch.from_numpy(zw)
    jz = jnp.asarray(z)
    if dtype == "bfloat16":
        jz, tz = jz.astype(jnp.bfloat16), tz.to(torch.bfloat16)
    got = tvq.nearest_indices_grouped(tz, torch.from_numpy(cbs))
    assert got.dtype == torch.int32 and tuple(got.shape) == (N, G)
    for i in range(G):
        want = jvq.nearest_indices(jz[:, i, :], jnp.asarray(cbs[i]), use_pallas=False)
        np.testing.assert_array_equal(got[:, i].numpy(), np.asarray(want))
    assert torch.equal(got, tvq.nearest_indices_grouped(tz, torch.from_numpy(cbs),
                                                        use_kernel=False))


def test_nearest_indices_grouped_plain_equals_pallas_interpret_with_ties(rng):
    """One small case through lvt_tpu's Pallas kernel in interpret mode, per
    sub-codebook: codebooks with duplicated rows and rows of z that equal a
    code, so every sub-codebook has planted ties (the lowest index wins)."""
    G, Dc = 3, 16
    base = rng.standard_normal((G, 20, Dc)).astype(np.float32)
    cbs = np.concatenate([base, base, base], axis=1)  # rows k, k + 20, k + 40 equal
    z = rng.standard_normal((40, G, Dc)).astype(np.float32)
    z[:20] = base.transpose(1, 0, 2)  # row n of sub-codebook g equals code n
    got = tvq.nearest_indices_grouped(torch.from_numpy(z), torch.from_numpy(cbs)).numpy()
    np.testing.assert_array_equal(got[:20], np.repeat(np.arange(20)[:, None], G, axis=1))
    assert int(got.max()) < 20
    for i in range(G):
        want = jvq.nearest_indices_pallas(jnp.asarray(z[:, i, :]), jnp.asarray(cbs[i]),
                                          interpret=True)
        np.testing.assert_array_equal(got[:, i], np.asarray(want))


def test_quantize_st_takes_all_indices_from_one_grouped_call(rng, monkeypatch):
    """quantize_st asks for every sub-codebook's indices once, from the
    embedding before the update: on the card that is one kernel-6 launch."""
    _, tstate = _codebooks(rng)
    z = torch.from_numpy(rng.standard_normal((2, 5, 6, 32)).astype(np.float32))
    calls = []
    inner = tvq.nearest_indices_grouped

    def counted(zz, emb, use_kernel=None):
        calls.append((tuple(zz.shape), emb.data_ptr()))
        return inner(zz, emb, use_kernel)

    monkeypatch.setattr(tvq, "nearest_indices_grouped", counted)
    tvq.quantize_st(z, tstate, ema=True, train=True)
    assert calls == [((60, 4, 8), tstate["embedding"].data_ptr())]


# --------------------------------------------------------------------------
# quantize_st and the EMA update
# --------------------------------------------------------------------------

def _codebooks(rng, num=4, K=16, D=32):
    emb = rng.standard_normal((num, K, D // num)).astype(np.float32)
    rs = rng.uniform(0.0, 3.0, (num, K)).astype(np.float32)
    rsum = rng.standard_normal((num, K, D // num)).astype(np.float32)
    jstate = jvq.EmaCodebookState(jnp.asarray(emb), jnp.asarray(rs), jnp.asarray(rsum))
    tstate = {"embedding": torch.from_numpy(emb), "running_size": torch.from_numpy(rs),
              "running_sum": torch.from_numpy(rsum)}
    return jstate, tstate


@pytest.mark.parametrize("ema", [True, False], ids=["ema", "no-ema"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_st_matches_jax(rng, ema, train, dtype):
    jstate, tstate = _codebooks(rng)
    z = rng.standard_normal((2, 5, 6, 32)).astype(np.float32)
    jz, tz = jnp.asarray(z), torch.from_numpy(z)
    if dtype == "bfloat16":
        jz, tz = jz.astype(jnp.bfloat16), tz.to(torch.bfloat16)
    want = jvq.quantize_st(jz, jstate, ema=ema, train=train, use_pallas=False)
    got = tvq.quantize_st(tz, tstate, ema=ema, train=train)
    rel = 1e-6 if dtype == "float32" else 2 ** -8
    assert got[0].dtype == got[1].dtype == tz.dtype
    _close("z_q_st", got[0], np.asarray(want[0], np.float32), rel)
    _close("z_q", got[1], np.asarray(want[1], np.float32), rel)
    assert got[2].dtype == torch.int32 and tuple(got[2].shape) == (2, 5, 6, 4)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for field in ("embedding", "running_size", "running_sum"):
        assert got[3][field].dtype == torch.float32 and not got[3][field].requires_grad
        _close(field, got[3][field], np.asarray(getattr(want[3], field)), 1e-6)
    changed = not torch.equal(got[3]["running_size"], tstate["running_size"])
    assert changed == (ema and train)


def test_ema_update_keeps_the_mass_and_the_pre_post_order(rng):
    """The straight-through output looks up the embedding before the update,
    z_q the one after it; running_size moves toward the batch's counts, whose
    sum is N."""
    _, tstate = _codebooks(rng, num=2, K=8, D=8)
    z = torch.from_numpy(rng.standard_normal((50, 8)).astype(np.float32))
    st, zq, idx, new = tvq.quantize_st(z, tstate, ema=True, train=True, decay=0.9)
    for i in range(2):
        np.testing.assert_array_equal(st[:, 4 * i:4 * i + 4].numpy(),
                                      (z[:, 4 * i:4 * i + 4] + (
                                          tstate["embedding"][i][idx[:, i].long()]
                                          - z[:, 4 * i:4 * i + 4])).numpy())
        assert torch.equal(zq[:, 4 * i:4 * i + 4], new["embedding"][i][idx[:, i].long()])
        mass = 0.9 * tstate["running_size"][i].sum() + 0.1 * 50
        np.testing.assert_allclose(float(new["running_size"][i].sum()), float(mass), rtol=1e-6)
    assert not torch.equal(new["embedding"], tstate["embedding"])


@pytest.mark.parametrize("ema", [True, False], ids=["ema", "no-ema"])
def test_quantize_st_gradients_match_jax_grad(rng, ema):
    jstate, tstate = _codebooks(rng)
    z = rng.standard_normal((3, 4, 32)).astype(np.float32)
    w1, w2 = (rng.standard_normal((3, 4, 32)).astype(np.float32) for _ in range(2))

    def jloss(zz, emb):
        st, zq, _, _ = jvq.quantize_st(zz, jstate._replace(embedding=emb), ema=ema, train=True,
                                       use_pallas=False)
        return jnp.sum(st * w1) + jnp.sum((zq * w2) ** 2) + jnp.sum(zq * zz)

    gz, gemb = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(z), jstate.embedding)
    tz = torch.from_numpy(z).requires_grad_(True)
    temb = tstate["embedding"].clone().requires_grad_(True)
    st, zq, _, _ = tvq.quantize_st(tz, dict(tstate, embedding=temb), ema=ema, train=True)
    loss = (st * torch.from_numpy(w1)).sum() + ((zq * torch.from_numpy(w2)) ** 2).sum() \
        + (zq * tz).sum()
    loss.backward()
    _close("dz", tz.grad, np.asarray(gz), 1e-6)
    if ema:  # the EMA embedding is rebuilt from the running sums: no gradient reaches it
        assert temb.grad is None and float(jnp.abs(gemb).max()) == 0.0
    else:
        _close("dembedding", temb.grad, np.asarray(gemb), 1e-6)


def test_init_codebook_layout():
    cb = tvq.init_codebook(torch.Generator().manual_seed(0), 4, 16, 32)
    want = jvq.init_codebook(jax.random.key(0), 4, 16, 32)
    for field in ("embedding", "running_size", "running_sum"):
        assert tuple(cb[field].shape) == getattr(want, field).shape and cb[field].dtype == torch.float32
    assert float(cb["embedding"].abs().max()) <= 1 / 16
    assert torch.equal(cb["running_sum"], cb["embedding"])
    assert cb["running_sum"].data_ptr() != cb["embedding"].data_ptr()
    assert float(cb["running_size"].abs().max()) == 0.0


def test_encode_indices_defaults_to_the_plain_version(rng):
    jstate, tstate = _codebooks(rng)
    z = rng.standard_normal((2, 3, 3, 32)).astype(np.float32)
    got = tvq.encode_indices(torch.from_numpy(z), tstate)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jvq.encode_indices(jnp.asarray(z), jstate)))
    emb = tvq.embed_indices(got, tstate)
    np.testing.assert_array_equal(emb.numpy(), np.asarray(jvq.embed_indices(jnp.asarray(got.numpy()), jstate)))


# --------------------------------------------------------------------------
# Norms and spectral norm
# --------------------------------------------------------------------------

def _norm_trees(rng, norm, c):
    jp, js = jax_init_norm(norm, c)
    jp = {k: jnp.asarray(rng.uniform(0.5, 1.5, v.shape).astype(np.float32)) for k, v in jp.items()}
    js = {k: jnp.asarray(rng.uniform(0.5, 1.5, v.shape).astype(np.float32)) for k, v in js.items()}
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    ts = {k: torch.from_numpy(np.array(v)) for k, v in js.items()}
    return jp, js, tp, ts


@pytest.mark.parametrize("norm", VALID_NORMS)
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_every_norm_matches_jax(rng, norm, train):
    assert tnorms.VALID_NORMS == VALID_NORMS
    c = 48  # GN: 32 groups do not divide 48, the search takes 24
    jp, js, tp, ts = _norm_trees(rng, norm, c)
    ip, istate = tnorms.init_norm(norm, c)
    assert set(ip) == set(jp) and set(istate) == set(js)
    x = rng.standard_normal((3, 5, 7, c)).astype(np.float32) * 2 + 0.5
    want, wstate = jax_apply_norm(norm, jp, js, jnp.asarray(x), train)
    tx = torch.from_numpy(x).requires_grad_(True)
    for leaf in tp.values():
        leaf.requires_grad_(True)
    got, gstate = tnorms.apply_norm(norm, tp, ts, tx, train)
    _close(norm, got, np.asarray(want), 5e-6)
    assert set(gstate) == set(wstate)
    for k in wstate:
        assert not gstate[k].requires_grad
        _close(f"{norm} state {k}", gstate[k], np.asarray(wstate[k]), 2e-6)
    # the gradient to x and to the affine parameters
    w = rng.standard_normal(x.shape).astype(np.float32)
    jg = jax.grad(lambda p, xx: jnp.sum(jax_apply_norm(norm, p, js, xx, train)[0] * w),
                  argnums=(0, 1))(jp, jnp.asarray(x))
    (got * torch.from_numpy(w)).sum().backward()
    if norm == "":
        return
    _close(f"{norm} dx", tx.grad, np.asarray(jg[1]), 2e-5)
    for k in jp:
        if norm == "FrozenBN":  # scale and bias are frozen at the gradient
            assert tp[k].grad is None and float(jnp.abs(jg[0][k]).max()) == 0.0
        else:
            _close(f"{norm} d{k}", tp[k].grad, np.asarray(jg[0][k]), 2e-5)


def test_bn_on_a_bf16_activation_promotes_as_jax_does(rng):
    """bf16 compute: params bf16, running statistics fp32. In train mode the
    output stays bf16 and the new statistics are fp32; in eval mode the fp32
    statistics promote the output to fp32, in both packages."""
    jp, js, tp, ts = _norm_trees(rng, "BN", 8)
    x = rng.standard_normal((4, 6, 6, 8)).astype(np.float32)
    jx, tx = jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    jp16 = {k: v.astype(jnp.bfloat16) for k, v in jp.items()}
    tp16 = {k: v.to(torch.bfloat16) for k, v in tp.items()}
    for train, out_dtype in ((True, torch.bfloat16), (False, torch.float32)):
        want, wstate = jax_apply_norm("BN", jp16, js, jx, train)
        got, gstate = tnorms.apply_norm("BN", tp16, ts, tx, train)
        assert got.dtype == out_dtype and str(want.dtype) == str(out_dtype).split(".")[1]
        _close(f"bf16 BN train={train}", got, np.asarray(want, np.float32), 2 ** -7)
        for k in wstate:
            assert gstate[k].dtype == torch.float32 and str(wstate[k].dtype) == "float32"
            _close(f"bf16 BN state {k}", gstate[k], np.asarray(wstate[k]), 2 ** -8)


def test_sync_norms_raise_across_processes(monkeypatch):
    """SyncBN and nnSyncBN across processes raised until their statistics
    were ported (apply_norm's ``group``, the trainer's global batch: held to
    lvt_tpu in tests/test_torch_comm.py and tests/test_torch_data_parallel.py).
    With neither, in a world of any size, they are BN on the process's batch,
    and an unknown norm still raises."""
    from lvt_tpu_torch.utils import comm

    monkeypatch.setattr(comm, "get_world_size", lambda: 2)
    p, s = tnorms.init_norm("SyncBN", 4)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 3, 3, 4)).astype(np.float32))
    want, want_state = tnorms.apply_norm("BN", p, s, x, True)
    for norm in ("SyncBN", "nnSyncBN"):
        got, state = tnorms.apply_norm(norm, p, s, x, True)
        assert torch.equal(got, want), norm
        assert all(torch.equal(state[k], want_state[k]) for k in want_state), norm
    with pytest.raises(ValueError):
        tnorms.init_norm("LN", 4)


@pytest.mark.parametrize("kind,shape,out_axis", [("conv", (3, 3, 4, 8), -1),
                                                 ("convT", (4, 4, 6, 8), 2)])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_spectral_normalize_matches_jax(rng, kind, shape, out_axis, train):
    w = rng.standard_normal(shape).astype(np.float32)
    u = rng.standard_normal((shape[out_axis],)).astype(np.float32)
    want_w, want_u = jl2d._spectral_normalize(jnp.asarray(w), jnp.asarray(u), train, out_axis)
    tw = torch.from_numpy(w).requires_grad_(True)
    got_w, got_u = tl2d._spectral_normalize(tw, torch.from_numpy(u), train, out_axis)
    _close("w / sigma", got_w, np.asarray(want_w), 2e-6)
    _close("u", got_u, np.asarray(want_u), 2e-6)
    assert not got_u.requires_grad and (train or torch.equal(got_u, torch.from_numpy(u)))
    g = rng.standard_normal(shape).astype(np.float32)
    want_g = jax.grad(lambda ww: jnp.sum(
        jl2d._spectral_normalize(ww, jnp.asarray(u), train, out_axis)[0] * g))(jnp.asarray(w))
    (got_w * torch.from_numpy(g)).sum().backward()
    _close("dw", tw.grad, np.asarray(want_g), 2e-5)


@pytest.mark.parametrize("kind,arg", [("avgpool", 2), ("upsample", 2), ("pixelshuffle", 2),
                                      ("lrelu", 0.2), ("sigmoid", None)])
def test_stateless_layers_match_jax(rng, kind, arg):
    x = rng.standard_normal((2, 4, 6, 8)).astype(np.float32)
    spec = [(kind,) if arg is None else (kind, arg)]
    want, _ = jl2d.apply_seq(spec, [{}], [{}], jnp.asarray(x), norm="", use_spectral=False,
                             train=True)
    got, state = tl2d.apply_seq(spec, [{}], [{}], torch.from_numpy(x), norm="", train=True)
    assert state == [{}]
    _close(kind, got, np.asarray(want), 1e-6)
    if kind == "pixelshuffle":  # torch's own channel order
        ref = torch.nn.PixelShuffle(2)(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        assert torch.equal(got, ref)


# --------------------------------------------------------------------------
# Losses
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["l1", "l2"])
def test_pixel_loss_matches_jax(rng, mode):
    from lvt_tpu.config import get_cfg as jax_get_cfg
    from lvt_tpu.models.loss import pixel_loss as jax_pixel_loss
    from lvt_tpu_torch.config import get_cfg
    from lvt_tpu_torch.models.loss import pixel_loss

    a, b = (rng.standard_normal((2, 8, 8, 3)).astype(np.float32) for _ in range(2))
    jc, tc = jax_get_cfg(), get_cfg()
    for c in (jc, tc):
        c.LOSS.PIXEL.MODE, c.LOSS.PIXEL.LAMBDA = mode, 0.7
    want = float(jax_pixel_loss(jc, jnp.asarray(a).astype(jnp.bfloat16), jnp.asarray(b)))
    got = pixel_loss(tc, torch.from_numpy(a).to(torch.bfloat16), torch.from_numpy(b))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


@pytest.mark.parametrize("mode", ["wgan", "lsgan", "vanilla"])
@pytest.mark.parametrize("real", [True, False])
def test_gan_loss_matches_jax(rng, mode, real):
    from lvt_tpu.config import get_cfg as jax_get_cfg
    from lvt_tpu.models.loss import gan_loss as jax_gan_loss
    from lvt_tpu_torch.config import get_cfg
    from lvt_tpu_torch.models.loss import gan_loss

    logits = 3 * rng.standard_normal((4, 5)).astype(np.float32)
    jc, tc = jax_get_cfg(), get_cfg()
    for c in (jc, tc):
        c.LOSS.GAN.MODE = mode
    want = float(jax_gan_loss(jc, jnp.asarray(logits), real))
    np.testing.assert_allclose(float(gan_loss(tc, torch.from_numpy(logits), real)), want,
                               rtol=2e-6)


# --------------------------------------------------------------------------
# Kernel 12's plain version against the probe tool's kernel
# --------------------------------------------------------------------------

def _probe_tool():
    """tools/probe_decode_kernel.py, imported by path; nothing in it changes."""
    spec = importlib.util.spec_from_file_location(
        "probe_decode_kernel", os.path.join(ROOT, "tools", "probe_decode_kernel.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_i8kv_plain_matches_the_probe_kernel(dtype):
    probe = _probe_tool()
    b, cl, na, da = 16, 128, probe.NA, probe.DA
    qbd, k4, ks, v4, vs, extra = probe.make_inputs(jax.random.key(0), b=b, cl=cl)
    if dtype == "float32":
        qbd = qbd.astype(jnp.float32)
    scale = 1.0 / np.sqrt(da)
    want_pallas = np.asarray(probe.decode_attn_pallas(qbd, k4, ks, v4, vs, extra, scale, btile=4,
                                                      interpret=True), np.float32)
    want_xla = np.asarray(probe.decode_attn_xla(qbd, k4, ks, v4, vs, extra[0], scale), np.float32)

    # the fused-lane layout (b, cl, na*da) and block-diagonal q -> heads apart
    heads = lambda t: torch.from_numpy(np.array(t)).reshape(b, cl, na, da).permute(0, 2, 1, 3) \
        .contiguous()
    q = torch.from_numpy(np.array(qbd, np.float32)).reshape(b, na, na, da)
    q = torch.stack([q[:, a, a] for a in range(na)], dim=1).to(getattr(torch, dtype))
    args = (q, heads(k4), torch.from_numpy(np.array(ks)), heads(v4),
            torch.from_numpy(np.array(vs)), torch.from_numpy(np.array(extra)), scale)
    got = tca.decode_attention_i8kv(*args)
    assert got.dtype == q.dtype and tuple(got.shape) == (b, na, da)
    got = got.float().reshape(b, na * da).numpy()
    top = float(np.abs(want_pallas).max())
    assert np.abs(got - want_xla).max() < 0.05  # the tool's own bound
    rel = 1e-5 if dtype == "float32" else 2 ** -6
    assert np.abs(got - want_pallas).max() <= rel * top
    # a live length reads the rows below it only: the rows past cl // 2 are masked
    live = cl // 2 + 1
    poisoned = [t.clone() for t in args[:5]]
    poisoned[1][:, :, live:], poisoned[3][:, :, live:] = 127, -128
    again = tca.decode_attention_i8kv(*poisoned, args[5], scale, live)
    assert np.abs(again.float().reshape(b, na * da).numpy() - got).max() <= rel * top


def test_probe_tool_check_passes_on_the_cpu():
    spec = importlib.util.spec_from_file_location(
        "probe_decode_kernel_torch", os.path.join(ROOT, "tools", "probe_decode_kernel_torch.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    err, err8 = tool.check()
    assert err < 0.05 and err8 < 0.1
    assert tca.decode_attention_i8kv_cuda.launches == 0  # CPU tensors: the plain version
    with pytest.raises(SystemExit):
        tool.bench()  # timing needs the card
