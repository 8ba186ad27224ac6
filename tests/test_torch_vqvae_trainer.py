"""VQ-VAE training through the port's Trainer held to lvt_tpu on small models
(the configurations and helpers of tests/test_torch_vqvae_train.py), on the
CPU:

* 5 train steps through the port's Trainer against lvt_tpu's optimizer from
  the same state at each step (the synced scheme and tolerances of
  tests/test_torch_train.py), the codebook indices equal at every step.
  Seed: the shared ``rng`` fixture's 0, the first tried; the states are set
  equal before each step, so a near-tie would show at its own step only;
* the model state (EMA codebook, BN statistics, spectral u) holds no graph
  and follows a checkpoint and --resume bit for bit;
* tools/train_net_torch.py's main on PNG frames on disk, EMA and non-EMA.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import lvt_tpu.ops.vq as jvq
from lvt_tpu.solver.build import build_optimizer as jax_build_optimizer
from lvt_tpu_torch.checkpoint.convert import flatten
from lvt_tpu_torch.config import get_cfg
from lvt_tpu_torch.engine.trainer import Trainer
from lvt_tpu_torch.ops import vq as tvq
from test_torch_vqvae_train import ROOT, _cfg, _frames, _leaf_close, _models, _port_trees

torch.set_num_threads(1)  # one intra-op thread: the test workers share the cores


# --------------------------------------------------------------------------
# Composed train steps against lvt_tpu's optimizer
# --------------------------------------------------------------------------

SOLVERS = {
    "adam": dict(OPTIMIZER_NAME="adam", LR_G=3e-4, **{"ADAM.BETA1_G": 0.9, "ADAM.BETA2_G": 0.99}),
    "rmsprop": dict(OPTIMIZER_NAME="rmsprop", LR_G=1e-3, **{
        "RMSPROP.ALPHA_G": 0.95, "RMSPROP.MOMENTUM_G": 0.9}),
}


def _solver(name):
    return dict(SOLVERS[name], ACCUMULATION_STEPS=2, LR_SCHEDULER_NAME="WarmupMultiStepLR",
                WARMUP_ITERS=3, WARMUP_FACTOR=0.1, STEPS=(4,), GAMMA=0.5, **{
                    "WEIGHT_DECAY.BASE_G": 0.01, "WEIGHT_DECAY.BIAS_G": 0.002,
                    "WEIGHT_DECAY.NORM_G": 0.0})


def _port_tree(trainer, name, jparams, jstate, jopt, jacc, step):
    """lvt_tpu's params, model state, optimizer moments and accumulated
    gradients as the port's checkpoint tree; each parameter's update count
    stays the port's own and is held to lvt_tpu's."""
    _, inner, sched = jopt
    count = int(sched.count)
    fields = {"square_avg": inner.v, "momentum_buffer": inner.buf} if name == "rmsprop" \
        else {"exp_avg": inner.mu, "exp_avg_sq": inner.nu}
    fields = {k: flatten(_port_trees(v, jstate)[0]) for k, v in fields.items()}
    st = trainer.state
    names = {id(p): n for n, p in flatten(st.params).items()}
    opt_sd = st.optimizer.state_dict()
    state, i = {}, 0
    for group in st.optimizer.param_groups:
        for p in group["params"]:
            own = opt_sd["state"].get(i, {"step": torch.tensor(0.0)})["step"]
            assert float(own) == count, f"{names[id(p)]}: {float(own)} updates, lvt_tpu {count}"
            state[i] = {"step": own.clone(),
                        **{k: v[names[id(p)]].clone() for k, v in fields.items()}}
            i += 1
    opt_sd["state"] = state
    params, mstate = _port_trees(jparams, jstate)
    return {"params": params, "model_state": mstate,
            "opt_state": {"optimizer": opt_sd, "scheduler": st.scheduler.state_dict()},
            "step": step, "accum_grads": _port_trees(jacc, jstate)[0]}


@pytest.mark.parametrize("name,ema,variant", [("adam", True, "plain"),
                                              ("rmsprop", False, "bn-spectral")])
def test_5_step_trajectory_matches_jax_optimizer(rng, name, ema, variant):
    jm, jp, js, _ = _models(ema, variant, **_solver(name))
    opt = jax_build_optimizer(jm.cfg)
    batches = [_frames(rng) for _ in range(5)]

    @jax.jit
    def grads_of(params, mstate, x):
        return jax.value_and_grad(
            lambda p: jm.train_loss(p, mstate, {"image": x}, None), has_aux=True)(params)

    @jax.jit
    def indices_of(params, mstate, x):
        z_e = jm.encode_features(params, mstate, jm.normalize(x), train=True)[0]
        return jvq.quantize_st(z_e, jm._codebook_state(params, mstate), ema=ema, train=True,
                               use_pallas=False)[2]

    trainer = Trainer(_cfg(get_cfg, ema, variant, **_solver(name)), iter(()), device="cpu")
    taken = []
    inner = tvq.quantize_st
    tvq.quantize_st = lambda *a, **k: taken.append(inner(*a, **k)) or taken[-1]
    params, mstate, opt_state = jp, js, opt.init(jp)
    acc = jax.tree_util.tree_map(jnp.zeros_like, jp)
    try:
        for i in range(5):
            trainer.load_tree(_port_tree(trainer, name, params, mstate, opt_state, acc, i))
            want_idx = indices_of(params, mstate, jnp.asarray(batches[i]))
            (jl, (_, new_mstate)), g = grads_of(params, mstate, jnp.asarray(batches[i]))
            acc = jax.tree_util.tree_map(jnp.add, acc, g)
            if (i + 1) % 2 == 0:
                updates, opt_state = jax.jit(opt.update)(acc, opt_state, params)
                params = jax.tree_util.tree_map(jnp.add, params, updates)
                acc = jax.tree_util.tree_map(jnp.zeros_like, acc)
            mstate = new_mstate

            metrics = trainer.train_step({"image": torch.from_numpy(batches[i])})
            np.testing.assert_array_equal(taken[-1][2].numpy(), np.asarray(want_idx),
                                          err_msg=f"indices at step {i}")
            np.testing.assert_allclose(float(sum(metrics.values())), float(jl), rtol=2e-6,
                                       err_msg=f"loss at step {i}")
            assert trainer.state.step == i + 1
            want_p, want_s = _port_trees(params, mstate)
            got = flatten(trainer.state.params)
            for n, want in flatten(want_p).items():
                np.testing.assert_allclose(got[n].detach().numpy(), want.numpy(), rtol=1e-4,
                                           atol=2e-5, err_msg=f"step {i} param {n}")
            got_s = flatten(trainer.state.model_state)
            for n, want in flatten(want_s).items():
                assert got_s[n].grad_fn is None and not got_s[n].requires_grad, n
                _leaf_close(f"step {i} state {n}", got_s[n], want.numpy(), 1e-5)
    finally:
        tvq.quantize_st = inner
    assert len(taken) == 5


# --------------------------------------------------------------------------
# Resume and the CLI
# --------------------------------------------------------------------------

def test_resume_restores_the_ema_codebook_and_continues(rng, tmp_path):
    """A run broken at step 3 and resumed from its checkpoint ends with the
    parameters and the whole model state (EMA codebook, BN statistics,
    spectral u) bit-identical to an unbroken one."""
    from lvt_tpu_torch.checkpoint import save_checkpoint

    batches = [{"image": _frames(rng), "image_path": ["a"] * 4} for _ in range(5)]
    cfg = _cfg(get_cfg, True, "bn-spectral", **_solver("adam"))
    cfg.OUTPUT_DIR = str(tmp_path)
    full = Trainer(cfg, iter(batches), device="cpu")
    start = {k: v.clone() for k, v in flatten(full.state.model_state).items()}
    full.train(0, 5)
    first = Trainer(cfg, iter(batches), device="cpu")
    first.train(0, 3)
    save_checkpoint(cfg.OUTPUT_DIR, 3, first.checkpoint_tree())
    second = Trainer(cfg, iter(batches[3:]), device="cpu")
    assert second.resume_or_load(resume=True) == 3
    for n, v in flatten(first.state.model_state).items():
        assert torch.equal(v, flatten(second.state.model_state)[n]), n
    assert not torch.equal(flatten(second.state.model_state)["netC.embedding"],
                           start["netC.embedding"])
    second.train(max_iter=5)
    for n, p in flatten(full.state.params).items():
        assert torch.equal(p, flatten(second.state.params)[n]), n
    for n, v in flatten(full.state.model_state).items():
        assert torch.equal(v, flatten(second.state.model_state)[n]), n
        assert v.grad_fn is None and not v.requires_grad, n


@pytest.mark.parametrize("ema", [True, False], ids=["ema", "no-ema"])
def test_train_net_torch_main_trains_a_vqvae_on_the_cpu(rng, tmp_path, ema):
    """tools/train_net_torch.py's main on configs/vqvae/PR-DVQVAE2.yaml
    narrowed to NF 16: PNG frames on disk registered as an image dataset, the
    config's bf16 compute, then --resume from its checkpoint."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import train_net_torch
    from lvt_tpu_torch.data.catalog import DatasetCatalog
    from lvt_tpu_torch.data.datasets.bair import load_bair, register_bair
    from lvt_tpu_torch.engine.defaults import default_argument_parser

    root = tmp_path / "frames"
    for v in range(2):
        (root / "train" / f"video_{v}").mkdir(parents=True)
        for f in range(5):
            Image.fromarray(rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)).save(
                root / "train" / f"video_{v}" / f"{f}.png")
    if "toy_frames" not in DatasetCatalog.list():
        register_bair("toy_frames", str(root), "train", True)
    else:  # a second run in one process: point the name at this run's files
        DatasetCatalog._REGISTERED["toy_frames"] = lambda: load_bair(str(root), "train", True)
    m = "MODEL."
    opts = [m + "ENCODER.NF", "16", m + "ENCODER.RES_CHANNELS", "8", m + "GENERATOR.NF", "16",
            m + "GENERATOR.RES_CHANNELS", "8", m + "ENCODER.OUT_CHANNELS", "16",
            m + "GENERATOR.IN_CHANNELS", "16", m + "CODEBOOK.SIZE", "16", m + "CODEBOOK.DIM", "16",
            m + "CODEBOOK.EMA", str(ema), "SOLVER.IMS_PER_BATCH", "4",
            "SOLVER.CHECKPOINT_PERIOD", "2", "DATASETS.TRAIN", "('toy_frames',)",
            "DATALOADER.NUM_WORKERS", "0", "OUTPUT_DIR", str(tmp_path / "out")]
    cfg_file = os.path.join(ROOT, "configs", "vqvae", "PR-DVQVAE2.yaml")
    parse = default_argument_parser().parse_args
    tr = train_net_torch.main(
        parse(["--config-file", cfg_file, "SOLVER.MAX_ITER", "3"] + opts), device="cpu")
    assert tr.state.step == 3 and tr.compute_dtype == torch.bfloat16
    assert os.path.exists(root / "train" / "image_paths.npy")  # the walk's cache
    assert sorted(os.listdir(tmp_path / "out" / "checkpoints")) == ["ckpt_2.pt", "ckpt_3.pt"]
    with open(tmp_path / "out" / "metrics.json") as f:
        logged = f.read()
    assert "loss_reconstruction" in logged and "loss_commitment" in logged
    assert ("loss_dict" in logged) == (not ema)
    saved = {k: v.clone() for k, v in flatten(tr.state.model_state).items()}
    assert all(v.dtype == torch.float32 and v.grad_fn is None for v in saved.values())
    fresh = flatten(tr.model.init(torch.Generator().manual_seed(tr.seed))[1])
    assert (not torch.equal(saved["netC.running_size"], fresh["netC.running_size"])) == ema

    seen = {}
    inner = Trainer.load_tree
    Trainer.load_tree = lambda self, tree: seen.update(flatten(tree["model_state"])) or \
        inner(self, tree)
    try:
        tr = train_net_torch.main(
            parse(["--config-file", cfg_file, "--resume", "SOLVER.MAX_ITER", "4"] + opts),
            device="cpu")
    finally:
        Trainer.load_tree = inner
    assert tr.start_iter == 3 and tr.state.step == 4
    for k, v in saved.items():  # the resumed run starts from the saved state
        assert torch.equal(seen[k], v), k
