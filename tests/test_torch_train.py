"""VT training in the port held to lvt_tpu on small geometries, weights
carried across with from_jax_vt (the shapes of tests/test_trajectory_parity.py):

* kernel 10's plain version against lvt_tpu's Pallas backward run in
  interpret mode (fp32: 2e-5 absolute, sums in another order);
* the attention Function's explicit CPU backward against autograd of the
  plain forward (fp32: 1e-5);
* the loss and every gradient leaf against jax.grad of VideoTransformer.loss
  with a fixed slice_idx: fp32 within 1e-5 of each leaf's largest |grad|
  (16-term fp32 sums taken in other orders), bf16 compute within 4% of it
  (bf16 rounds at other points in the two frameworks);
* 5 composed train steps (RMSprop and Adam, nonzero BASE/BIAS decay,
  ACCUMULATION_STEPS 2, a warmup schedule) against lvt_tpu's build_optimizer
  from the same state at each step (the synced scheme of
  tests/test_trajectory_parity.py and its tolerances);
* the LR schedules against build_lr_schedule; a save and resume that
  continues bit-identically; the refusals of what is not ported; the
  training CLI's main on the CPU;
* TPU.FUSED_LAYER True on a geometry the fused layer takes (d = da = 128,
  blocks of 32 tokens, 2 + 2 layers): loss and every gradient against the
  port's unfused path (2e-4, the bound of tests/test_fused_layer.py) and
  against lvt_tpu taking its own fused branch, a 5-step trajectory, and
  logits_for_entire_video. For lvt_tpu to take that branch on the CPU its
  model gets use_pallas=True and lvt_tpu.ops.fused_layer._FORCE_INTERPRET
  (the hook of tests/test_fused_layer.py); d and da are multiples of 128
  because its gate, written for its chip, asks for that.
"""

import contextlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lvt_tpu.ops.attention as jatt
import lvt_tpu.ops.fused_layer as jfl
from lvt_tpu.config import get_cfg as jax_get_cfg
from lvt_tpu.models import cast_floats as jax_cast_floats
from lvt_tpu.models.vt import VideoTransformer as JaxVT
from lvt_tpu.solver.build import build_lr_schedule as jax_build_lr_schedule
from lvt_tpu.solver.build import build_optimizer as jax_build_optimizer
from lvt_tpu_torch.checkpoint import from_jax_vt
from lvt_tpu_torch.checkpoint.convert import flatten
from lvt_tpu_torch.config import get_cfg
from lvt_tpu_torch.engine.trainer import Trainer
from lvt_tpu_torch.models import cast_floats
from lvt_tpu_torch.models.vt import VideoTransformer
from lvt_tpu_torch.ops import attention as tatt
from lvt_tpu_torch.solver.build import build_lr_schedule, decay_group

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, H, W = 8, 4, 4
BATCH = 2


def _cfg(get=get_cfg, fused=False, **solver):
    cfg = get()
    cfg.MODEL.META_ARCHITECTURE = "VideoTransformerModel"
    cfg.MODEL.AUTOREGRESSIVE.NAME = "VideoTransformer"
    v = cfg.MODEL.AUTOREGRESSIVE.VT
    v.NC, v.NV = 2, 8
    v.KERNEL, v.STRIDE = (3, 1, 1), (4, 1, 1)
    v.D, v.DA, v.DE = 24, 12, 12
    # (2, 4, 4): a one-frame block's dt bank has one entry, whose gradient
    # sums a softmax gradient row to zero (fp32 noise that RMSprop and Adam
    # turn into sign-like updates)
    v.BLOCKS_E = ((2, 4, 4),) * 2
    v.N_HEAD_E = (2, 2)
    v.BLOCKS_D = ((2, 4, 4),)
    v.N_HEAD_D = (2,)
    v.N_PRIME = 1
    v.SHARE_P = False
    cfg.TPU.FUSED_LAYER = False
    if fused:  # a geometry both packages' fused layers take
        v.D, v.DA, v.DE = 128, 128, 12
        v.BLOCKS_D, v.N_HEAD_D = ((2, 4, 4),) * 2, (2, 2)
        cfg.TPU.FUSED_LAYER = True
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.SEED = 3
    for k, val in solver.items():
        node, key = cfg.SOLVER, k
        if "." in k:
            sub, key = k.split(".")
            node = getattr(cfg.SOLVER, sub)
        setattr(node, key, val)
    return cfg


def _models(cfg_kwargs=None, seed=0, fused=False):
    cfg_kwargs = cfg_kwargs or {}
    jm = JaxVT(_cfg(jax_get_cfg, fused, **cfg_kwargs), T=T, H=H, W=W)
    jm.use_pallas = True if fused else None
    jp, _ = jm.init(jax.random.key(seed))
    tm = VideoTransformer(_cfg(fused=fused, **cfg_kwargs), T=T, H=H, W=W)
    return jm, jp, tm


@contextlib.contextmanager
def _jax_fused_on_cpu():
    """lvt_tpu's fused layer with every Pallas kernel in interpret mode;
    fails unless lvt_tpu traced its fused branch inside."""
    inner, calls = jfl.fused_block_layer, []
    jfl._FORCE_INTERPRET = True
    jfl._fused_layer_ad.cache_clear()
    jfl.fused_block_layer = lambda *a, **k: calls.append(1) or inner(*a, **k)
    try:
        yield
        assert calls, "lvt_tpu did not take its fused branch"
    finally:
        jfl.fused_block_layer = inner
        jfl._FORCE_INTERPRET = False
        jfl._fused_layer_ad.cache_clear()


@contextlib.contextmanager
def _count_fused_layers(counts):
    """Counts the port's fused_block_layer calls into counts[0]."""
    import lvt_tpu_torch.models.vt as tvt

    inner = tvt.fused_block_layer

    def counted(*a, **k):
        counts[0] += 1
        return inner(*a, **k)

    tvt.fused_block_layer = counted
    try:
        yield
    finally:
        tvt.fused_block_layer = inner


def _to_port(jtree):
    return from_jax_vt(jax.tree_util.tree_map(np.array, jtree))


def _leaf_close(name, got, want, rel, floor):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bound = rel * max(float(np.abs(want).max()), floor)
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{name}: max abs err {err:.3g} > {bound:.3g}"


# --------------------------------------------------------------------------
# Kernel 10's plain version and the autograd Function
# --------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
def test_attention_bwd_plain_matches_pallas_interpret(rng, causal):
    nb, na, n, da = 3, 2, 16, 8
    q, k, v, g = (rng.standard_normal((nb, na, n, da)).astype(np.float32) for _ in range(4))
    bias = rng.standard_normal((na, n, n)).astype(np.float32)
    want = jatt.attention_core_pallas_bwd(
        *(jnp.asarray(x) for x in (q, k, v, bias, g)),
        jatt.causal_mask(n) if causal else None, interpret=True)
    got = tatt.attention_core_bwd_plain(*(torch.from_numpy(x) for x in (q, k, v, bias, g)),
                                        causal)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5, rtol=0, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_function_cpu_backward_matches_autograd(rng, causal):
    nb, na, n, da = 2, 3, 12, 8
    leaves = [torch.tensor(rng.standard_normal(s), dtype=torch.float32, requires_grad=True)
              for s in [(nb, na, n, da)] * 3 + [(na, n, n)]]
    g = torch.from_numpy(rng.standard_normal((nb, na, n, da)).astype(np.float32))
    got = torch.autograd.grad(tatt.attention_core(*leaves, causal), leaves, g)
    want = torch.autograd.grad(tatt.attention_core_plain(*leaves, causal), leaves, g)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0, msg=name)
    # a bf16 bias (bf16 compute) gets its gradient back in bf16
    bias16 = leaves[3].detach().to(torch.bfloat16).requires_grad_(True)
    out = tatt.attention_core(*(x.detach().to(torch.bfloat16) for x in leaves[:3]), bias16,
                              causal)
    out.float().sum().backward()
    assert bias16.grad.dtype == torch.bfloat16


# --------------------------------------------------------------------------
# Loss and gradients against jax.grad
# --------------------------------------------------------------------------

def _jax_grads(jm, jp, video, si, dtype=None):
    def jloss(p):
        pp = p if dtype is None else jax_cast_floats(p, dtype)
        return jm.loss(pp, {"video": video}, jax.random.key(0), slice_idx=si)[0]

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jp)
    return float(jl), flatten(_to_port(jg["netG"]))


def _port_grads(jp, tm, video, si, dtype=None, remat=False):
    params = {"netG": _to_port(jp["netG"])}
    for leaf in flatten(params).values():
        leaf.requires_grad_(True)
    tm.remat = remat
    p = params if dtype is None else cast_floats(params, dtype)
    loss, metrics = tm.loss(p, {"video": torch.from_numpy(video)},
                            slice_idx=torch.from_numpy(si))
    loss.backward()
    grads = {k: v.grad for k, v in flatten(params["netG"]).items()}
    return float(loss.detach()), metrics, grads


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_loss_and_every_grad_match_jax_fp32(rng, remat):
    jm, jp, tm = _models()
    video = rng.integers(0, 8, size=(BATCH, 2, T, H, W)).astype(np.int32)
    si = np.asarray([0, 1], np.int32)  # slice 0 holds primed frame 0: the ignore mask runs
    jl, want = _jax_grads(jm, jp, video, si)
    tl, metrics, grads = _port_grads(jp, tm, video, si, remat=remat)
    np.testing.assert_allclose(tl, jl, rtol=2e-6)
    assert float(metrics["loss_cross_entropy"].detach()) == tl
    assert set(grads) == set(want) and len(grads) == 63
    # a leaf whose gradient cancels to zero (a one-entry bias bank sums a
    # softmax gradient row) reads fp32 noise: the floor is 1e-2 of the
    # largest gradient of all leaves
    floor = 1e-2 * max(float(w.abs().max()) for w in want.values())
    for name, g in grads.items():
        assert g is not None and g.dtype == torch.float32, name
        _leaf_close(name, g.numpy(), want[name].numpy(), 1e-5, floor)


def test_loss_and_every_grad_match_jax_bf16_compute(rng):
    """bf16 compute over fp32 masters: both packages' bf16 gradients are
    held to the fp32 gradient. The port's may stray from it by 5x what
    lvt_tpu's own bf16 gradient strays (the two round at other points:
    measured up to 3.4x, and as often 10x closer) plus one bf16 rounding
    (2^-8) of the leaf's largest gradient."""
    jm, jp, tm = _models()
    video = rng.integers(0, 8, size=(BATCH, 2, T, H, W)).astype(np.int32)
    si = np.asarray([1, 0], np.int32)
    _, w32 = _jax_grads(jm, jp, video, si)
    jl, w16 = _jax_grads(jm, jp, video, si, jnp.bfloat16)
    tl, _, grads = _port_grads(jp, tm, video, si, torch.bfloat16, remat=True)
    np.testing.assert_allclose(tl, jl, rtol=2e-3)
    for name, g in grads.items():
        assert g.dtype == torch.float32, name  # fp32 masters get fp32 gradients
        ref = w32[name].numpy()
        err = float(np.abs(g.numpy() - ref).max())
        jax_err = float(np.abs(w16[name].numpy() - ref).max())
        bound = 5 * jax_err + 2 ** -8 * float(np.abs(ref).max())
        assert err <= bound, f"{name}: bf16 error {err:.3g}, lvt_tpu's {jax_err:.3g}"


def test_fused_loss_and_every_grad_match_unfused_and_jax_fp32(rng):
    """TPU.FUSED_LAYER True, fp32: against the port's unfused layers (2e-4 of
    each leaf's largest gradient: the fused layer keeps x2 in fp32 and sums
    in other orders) and against lvt_tpu taking its fused branch (1e-5,
    floored as above)."""
    jm, jp, tm = _models(fused=True)
    video = rng.integers(0, 8, size=(BATCH, 2, T, H, W)).astype(np.int32)
    si = np.asarray([0, 1], np.int32)
    with _jax_fused_on_cpu():
        jl, want = _jax_grads(jm, jp, video, si)
    counts = [0]
    with _count_fused_layers(counts):
        tl, _, grads = _port_grads(jp, tm, video, si, remat=True)
    assert counts[0] == 4  # 2 + 2 layers, once: the fused layer is its own remat unit
    tm.fused = False
    ul, _, unfused = _port_grads(jp, tm, video, si)
    np.testing.assert_allclose(tl, jl, rtol=2e-6)
    np.testing.assert_allclose(tl, ul, rtol=2e-6)
    assert set(grads) == set(want) == set(unfused)
    floor = 1e-2 * max(float(w.abs().max()) for w in want.values())
    for name, g in grads.items():
        assert g is not None and g.dtype == torch.float32, name
        _leaf_close(name + " vs lvt_tpu", g.numpy(), want[name].numpy(), 1e-5, floor)
        _leaf_close(name + " vs unfused", g.numpy(), unfused[name].numpy(), 2e-4, floor)


def test_fused_bf16_compute_gradients_reach_the_fp32_masters(rng):
    """bf16 compute with the fused layer: fp32 masters get fp32 gradients
    within the bf16 bound of the unfused test above, against lvt_tpu's fused
    bf16 gradient (the port rounds dy once where lvt_tpu's two head groups
    round twice)."""
    jm, jp, tm = _models(fused=True)
    video = rng.integers(0, 8, size=(BATCH, 2, T, H, W)).astype(np.int32)
    si = np.asarray([1, 0], np.int32)
    with _jax_fused_on_cpu():
        _, w32 = _jax_grads(jm, jp, video, si)
        jl, w16 = _jax_grads(jm, jp, video, si, jnp.bfloat16)
    tl, _, grads = _port_grads(jp, tm, video, si, torch.bfloat16, remat=True)
    np.testing.assert_allclose(tl, jl, rtol=2e-3)
    for name, g in grads.items():
        assert g.dtype == torch.float32, name
        ref = w32[name].numpy()
        err = float(np.abs(g.numpy() - ref).max())
        jax_err = float(np.abs(w16[name].numpy() - ref).max())
        bound = 5 * jax_err + 2 ** -8 * float(np.abs(ref).max())
        assert err <= bound, f"{name}: bf16 error {err:.3g}, lvt_tpu's {jax_err:.3g}"


def test_logits_for_entire_video_match_jax(rng):
    """Teacher-forced logits of all slices, with the fused layer's no-grad
    forward in both packages: 1e-5 of the largest logit."""
    jm, jp, tm = _models(fused=True)
    video = rng.integers(0, 8, size=(BATCH, 2, T, H, W)).astype(np.int32)
    with _jax_fused_on_cpu():
        want = np.asarray(jm.logits_for_entire_video(jp, jnp.asarray(video)))
    params = {"netG": _to_port(jp["netG"])}
    for leaf in flatten(params).values():
        leaf.requires_grad_(True)  # the method itself runs without grad
    counts = [0]
    with _count_fused_layers(counts):
        got = tm.logits_for_entire_video(params, torch.from_numpy(video))
    assert counts[0] == 4 * tm.plan.num_slices and not got.requires_grad
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (BATCH, T, H, W, 2, 8)
    _leaf_close("logits", got.numpy(), want, 1e-5, 0.0)


def test_prepare_slices_matches_jax(rng):
    jm, _, tm = _models()
    video = rng.integers(0, 8, size=(3, 2, T, H, W)).astype(np.int32)
    si = np.asarray([0, 1, 1], np.int32)
    want = jm.prepare_slices(jnp.asarray(video), jnp.asarray(si))
    got = tm.prepare_slices(torch.from_numpy(video), torch.from_numpy(si))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_slice_draw_skips_fully_primed_slices():
    tm = VideoTransformer(_cfg(), T=4, H=H, W=W)  # t == 1: one frame per slice
    draws = tm.sample_train_slice_idx(torch.Generator().manual_seed(0), 4000)
    assert int(draws.min()) == 1 and int(draws.max()) == 3  # n_prime = 1, S = 4


# --------------------------------------------------------------------------
# Composed train steps against lvt_tpu's optimizer
# --------------------------------------------------------------------------

SOLVERS = {
    "rmsprop": dict(OPTIMIZER_NAME="rmsprop", LR_G=1e-3, **{
        "RMSPROP.ALPHA_G": 0.95, "RMSPROP.MOMENTUM_G": 0.9}),
    "adam": dict(OPTIMIZER_NAME="adam", LR_G=1e-3, **{
        "ADAM.BETA1_G": 0.9, "ADAM.BETA2_G": 0.99}),
}


def _solver(name):
    return dict(SOLVERS[name], ACCUMULATION_STEPS=2, LR_SCHEDULER_NAME="WarmupMultiStepLR",
                WARMUP_ITERS=3, WARMUP_FACTOR=0.1, STEPS=(4,), GAMMA=0.5, **{
                    "WEIGHT_DECAY.BASE_G": 0.01, "WEIGHT_DECAY.BIAS_G": 0.002,
                    "WEIGHT_DECAY.NORM_G": 0.0})


def _port_tree(trainer, name, jparams, jopt, jacc, step):
    """lvt_tpu's params, optimizer moments and accumulated gradients as the
    port's checkpoint tree. The learning rate, the scheduler and each
    parameter's update count stay the port's own; the count is held to
    lvt_tpu's."""
    _, inner, sched = jopt
    count = int(sched.count)
    if name == "rmsprop":
        fields = {"square_avg": inner.v, "momentum_buffer": inner.buf}
    else:
        fields = {"exp_avg": inner.mu, "exp_avg_sq": inner.nu}
    fields = {k: flatten(_to_port(v["netG"])) for k, v in fields.items()}
    st = trainer.state
    names = {id(p): f"netG.{n}" for n, p in flatten(st.params["netG"]).items()}
    opt_sd = st.optimizer.state_dict()
    state, i = {}, 0
    for group in st.optimizer.param_groups:
        for p in group["params"]:
            n = names[id(p)][len("netG."):]
            own = opt_sd["state"].get(i, {"step": torch.tensor(0.0)})["step"]
            assert float(own) == count, f"{n}: {float(own)} updates, lvt_tpu {count}"
            state[i] = {"step": own.clone(), **{k: v[n].clone() for k, v in fields.items()}}
            i += 1
    opt_sd["state"] = state
    return {"params": {"netG": _to_port(jparams["netG"])}, "model_state": {},
            "opt_state": {"optimizer": opt_sd, "scheduler": st.scheduler.state_dict()},
            "step": step, "accum_grads": {"netG": _to_port(jacc["netG"])}}


@pytest.mark.parametrize("name", ["rmsprop", "adam"])
def test_5_step_trajectory_matches_jax_optimizer(rng, name):
    _check_5_step_trajectory(rng, name, fused=False)


def test_5_step_trajectory_with_the_fused_layer_matches_jax(rng):
    """The same five steps with TPU.FUSED_LAYER True in both packages: every
    layer of both stacks runs fused (4 per forward), with no checkpoint."""
    counts = [0]
    with _jax_fused_on_cpu(), _count_fused_layers(counts):
        _check_5_step_trajectory(rng, "rmsprop", fused=True)
    assert counts[0] == 5 * 4


def _check_5_step_trajectory(rng, name, fused):
    jm, jp, _ = _models(_solver(name), fused=fused)
    jcfg = jm.cfg
    opt = jax_build_optimizer(jcfg)
    jax_schedule = jax_build_lr_schedule(jcfg)
    videos = [rng.integers(0, 8, size=(BATCH, 2, T, H, W)).astype(np.int32) for _ in range(5)]
    sis = [np.asarray([i % 2, (i + 1) % 2], np.int32) for i in range(5)]

    @jax.jit
    def grads_of(params, video, si):
        return jax.value_and_grad(
            lambda p: jm.loss(p, {"video": video}, jax.random.key(0), slice_idx=si)[0])(params)

    trainer = Trainer(_cfg(fused=fused, **_solver(name)), iter(()), device="cpu")
    params, opt_state = jp, opt.init(jp)
    acc = jax.tree_util.tree_map(jnp.zeros_like, jp)
    for i in range(5):
        trainer.load_tree(_port_tree(trainer, name, params, opt_state, acc, i))
        jl, g = grads_of(params, jnp.asarray(videos[i]), jnp.asarray(sis[i]))
        acc = jax.tree_util.tree_map(jnp.add, acc, g)
        if (i + 1) % 2 == 0:
            updates, opt_state = opt.update(acc, opt_state, params)
            params = jax.tree_util.tree_map(jnp.add, params, updates)
            acc = jax.tree_util.tree_map(jnp.zeros_like, acc)

        trainer.model.sample_train_slice_idx = lambda gen, b, T=None, si=sis[i]: \
            torch.from_numpy(si)
        metrics = trainer.train_step({"video": torch.from_numpy(videos[i])})
        np.testing.assert_allclose(float(metrics["loss_cross_entropy"]), float(jl), rtol=2e-6,
                                   err_msg=f"loss at step {i}")
        assert trainer.state.step == i + 1
        # the port's scheduler sets the next update's lr: LR_G times the
        # schedule at lvt_tpu's update count times ACCUMULATION_STEPS
        lr = jcfg.SOLVER.LR_G * float(jax_schedule(
            int(opt_state[-1].count) * jcfg.SOLVER.ACCUMULATION_STEPS))
        for group in trainer.state.optimizer.param_groups:
            np.testing.assert_allclose(group["lr"], lr, rtol=1e-6, err_msg=f"lr after step {i}")
        got = flatten(trainer.state.params["netG"])
        acc_got = flatten(trainer.state.accum_grads()["netG"])
        for n, want in flatten(_to_port(params["netG"])).items():
            # tolerances of tests/test_trajectory_parity.py (sign-like
            # RMSprop updates at float-noise gradients)
            np.testing.assert_allclose(got[n].detach().numpy(), want.numpy(), rtol=1e-4,
                                       atol=2e-5, err_msg=f"step {i} param {n}")
        acc_want = flatten(_to_port(acc["netG"]))
        floor = 1e-2 * max(float(w.abs().max()) for w in acc_want.values())
        for n, want in acc_want.items():
            _leaf_close(f"step {i} accum {n}", acc_got[n].numpy(), want.numpy(), 1e-5, floor)


@pytest.mark.parametrize("sched", [
    dict(LR_SCHEDULER_NAME="Identity"),
    dict(LR_SCHEDULER_NAME="WarmupMultiStepLR", STEPS=(5, 12), GAMMA=0.3, WARMUP_ITERS=4,
         WARMUP_METHOD="linear", WARMUP_FACTOR=0.01),
    dict(LR_SCHEDULER_NAME="WarmupMultiStepLR", STEPS=(), WARMUP_ITERS=6,
         WARMUP_METHOD="constant", WARMUP_FACTOR=0.2),
    dict(LR_SCHEDULER_NAME="WarmupCosineLR", MAX_ITER=20, WARMUP_ITERS=5,
         WARMUP_METHOD="linear", WARMUP_FACTOR=0.1),
], ids=["identity", "multistep-linear", "multistep-constant", "cosine"])
def test_lr_schedules_match_jax(sched):
    want = jax_build_lr_schedule(_cfg(jax_get_cfg, **sched))
    got = build_lr_schedule(_cfg(**sched))
    for step in range(25):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=1e-7,
                                   err_msg=f"step {step}")


def test_decay_groups_follow_lvt_tpu_rules():
    names = ["encoder.layers.0.ln_scale", "encoder.layers.0.ffn_b1", "predictor.U_b.1",
             "decoder.conv_b", "decoder.conv_w", "x.norm.scale", "x.norm.bias", "y.bias",
             "predictor.P_w.0"]
    assert [decay_group(n, names) for n in names] == [
        "norm", "bias", "bias", "bias", "base", "norm", "norm", "bias", "base"]


# --------------------------------------------------------------------------
# Resume, refusals, the CLI
# --------------------------------------------------------------------------

def _batches(rng, n):
    return [{"video": rng.integers(0, 8, size=(BATCH, 2, T, H, W)).astype(np.int32),
             "video_idx": [0, 1]} for _ in range(n)]


def test_resume_continues_the_same_trajectory(rng, tmp_path):
    """A run broken at step 3 (inside an accumulation window of 2) and
    resumed from its checkpoint ends bit-identical to an unbroken one."""
    from lvt_tpu_torch.checkpoint import save_checkpoint

    batches = _batches(rng, 5)
    cfg = _cfg(**_solver("rmsprop"))
    cfg.OUTPUT_DIR = str(tmp_path)
    full = Trainer(cfg, iter(batches), device="cpu")
    full.train(0, 5)
    first = Trainer(cfg, iter(batches), device="cpu")
    first.train(0, 3)
    save_checkpoint(cfg.OUTPUT_DIR, 3, first.checkpoint_tree())
    second = Trainer(cfg, iter(batches[3:]), device="cpu")
    assert second.resume_or_load(resume=True) == 3
    second.train(max_iter=5)
    for n, p in flatten(full.state.params).items():
        assert torch.equal(p, flatten(second.state.params)[n]), n
    assert second.state.step == 5


def test_checkpoint_files_latest_placement_and_pruning(tmp_path):
    """The checkpoint contract of lvt_tpu/checkpoint/orbax_io.py: one file
    per step, the latest by step number, loads placed into a target's
    structure and dtype (partial or whole), pruning, and a
    PeriodicCheckpointer that keeps the newest max_to_keep."""
    from types import SimpleNamespace

    from lvt_tpu_torch import checkpoint as ck
    from lvt_tpu_torch.checkpoint.io import checkpoint_dir
    from lvt_tpu_torch.engine.hooks import PeriodicCheckpointer

    out = str(tmp_path / "run")
    target = {"w": torch.zeros(3, dtype=torch.bfloat16), "opt": None, "step": None}
    assert ck.latest_checkpoint(out) is None
    assert ck.resume_or_load(out, target) is target
    for step in (2, 10, 9):
        ck.save_checkpoint(out, step, {"w": torch.full((3,), float(step)), "opt": {"m": [step]},
                                       "step": step})
    assert ck.latest_checkpoint(out).endswith("ckpt_10.pt")
    got = ck.resume_or_load(out, target)
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"].float(), torch.full((3,), 10.))
    assert got["opt"] == {"m": [10]} and got["step"] == 10
    assert ck.resume_or_load(out, target, resume=False) is target
    latest = ck.latest_checkpoint(out)
    assert ck.load_checkpoint(latest, {"step": None}, partial=True) == {"step": 10}
    with pytest.raises(ValueError, match="keys differ"):
        ck.load_checkpoint(latest, {"step": None})
    with pytest.raises(ValueError, match="shape"):
        ck.load_checkpoint(latest, dict(target, w=torch.zeros(4)))
    ck.prune_checkpoints(out, keep=2)
    assert sorted(os.listdir(checkpoint_dir(out))) == ["ckpt_10.pt", "ckpt_9.pt"]

    hook_out = str(tmp_path / "hook")
    hook = PeriodicCheckpointer(hook_out, period=2, max_to_keep=2)
    for it in range(7):
        hook.trainer = SimpleNamespace(iter=it, max_iter=7, checkpoint_tree=lambda: {"step": 0})
        hook.after_step()
    hook.after_train()
    assert sorted(os.listdir(checkpoint_dir(hook_out))) == ["ckpt_6.pt", "ckpt_7.pt"]


def test_untaken_configurations_raise(rng):
    video = torch.from_numpy(rng.integers(0, 8, size=(BATCH, 2, T, H, W)))
    losses = {}
    for key, val, word in (("FUSED_LAYER", False, None), ("FUSED_LAYER", True, None),
                           ("REMAT_POLICY", "dots", "dots")):
        cfg = _cfg()
        setattr(cfg.TPU, key, val)
        m = VideoTransformer(cfg, T=T, H=H, W=W)
        params, _ = m.init(torch.Generator().manual_seed(0))
        if word is None:
            losses[val] = m.loss(params, {"video": video}, torch.Generator().manual_seed(0))[0]
            continue
        with pytest.raises(NotImplementedError, match=word):
            m.loss(params, {"video": video}, torch.Generator().manual_seed(0))
    # TPU.FUSED_LAYER True trains; this geometry (d = 24, da = 12) is outside
    # the fused layer's gate, so it runs the unfused layers: the same loss
    assert torch.isfinite(losses[True]) and torch.equal(losses[True], losses[False])
    with pytest.raises(NotImplementedError):
        Trainer(_cfg(OPT_STATE_DTYPE="bfloat16"), iter(()), device="cpu")


def test_batch_guard_refuses_codes_outside_the_vocabulary(rng):
    trainer = Trainer(_cfg(), iter(()), device="cpu")
    with pytest.raises(ValueError, match="mismatched dataset"):
        trainer._put_batch({"video": np.full((1, 2, T, H, W), 8, np.int32)})


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_train_net_torch_main_on_cpu(rng, tmp_path, fused):
    """tools/train_net_torch.py's main: a tiny DefaultTrainer run on
    latent videos from disk, then --resume continues from its checkpoint.
    "fused" passes no TPU.FUSED_LAYER override (DSFVT's default, True) on a
    geometry the fused layer takes; "unfused" overrides it to False."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import train_net_torch
    from lvt_tpu_torch.data.catalog import DatasetCatalog
    from lvt_tpu_torch.data.datasets.latents import register_latents
    from lvt_tpu_torch.engine.defaults import default_argument_parser

    root = tmp_path / "latents"
    for v in range(3):
        (root / f"video_{v}").mkdir(parents=True)
        for f in range(T):
            np.save(root / f"video_{v}" / f"{f}.npy", rng.integers(0, 8, (2, H, W)))
    if "toy_train_latents" not in DatasetCatalog.list():
        register_latents("toy_train_latents", str(root))
    else:  # a second run in one process: point the name at this run's files
        DatasetCatalog._REGISTERED["toy_train_latents"] = \
            lambda: __import__("lvt_tpu_torch.data.datasets.latents", fromlist=["x"]) \
            .get_latent_video_paths(str(root), use_cache=False)
    vt = "MODEL.AUTOREGRESSIVE.VT."
    geometry = [vt + "D", "64", vt + "DA", "64", vt + "BLOCKS_E", "((2,4,4),(2,4,4))",
                vt + "N_HEAD_E", "(2,2)", vt + "BLOCKS_D", "((2,4,4),(2,4,4))",
                vt + "N_HEAD_D", "(2,2)"] if fused else [
        vt + "D", "24", vt + "DA", "12", vt + "BLOCKS_E", "((2,4,4),)", vt + "N_HEAD_E", "(2,)",
        vt + "BLOCKS_D", "((2,4,4),)", vt + "N_HEAD_D", "(2,)", "TPU.FUSED_LAYER", "False"]
    opts = [vt + "NC", "2", vt + "NV", "8", vt + "DE", "12", *geometry,
            vt + "STRIDE", "(4,1,1)",
            vt + "KERNEL", "(3,1,1)", "INPUT.N_FRAMES_PER_VIDEO_TRAIN", str(T),
            "SOLVER.IMS_PER_BATCH", "2",
            "SOLVER.CHECKPOINT_PERIOD", "2", "DATASETS.TRAIN", "('toy_train_latents',)",
            "DATALOADER.NUM_WORKERS", "0", "OUTPUT_DIR", str(tmp_path / "out")]
    cfg_file = os.path.join(ROOT, "configs", "vt", "DSFVT.yaml")
    parse = default_argument_parser().parse_args
    counts = [0]
    with _count_fused_layers(counts):
        tr = train_net_torch.main(
            parse(["--config-file", cfg_file, "SOLVER.MAX_ITER", "3"] + opts), device="cpu")
    assert tr.state.step == 3
    assert tr.model.fused == fused and counts[0] == (3 * 4 if fused else 0)
    ckpts = sorted(os.listdir(tmp_path / "out" / "checkpoints"))
    assert ckpts == ["ckpt_2.pt", "ckpt_3.pt"]
    assert os.path.exists(tmp_path / "out" / "metrics.json")
    tr = train_net_torch.main(
        parse(["--config-file", cfg_file, "--resume", "SOLVER.MAX_ITER", "4"] + opts),
        device="cpu")
    assert tr.start_iter == 3 and tr.state.step == 4
    with pytest.raises(NotImplementedError):
        train_net_torch.main(parse(["--config-file", cfg_file, "--eval-only"] + opts),
                             device="cpu")
