"""The port's GanTrainer (lvt_tpu_torch/engine/gan.py) on a toy 1-D GAN:
lvt_tpu's schedule over 400 iterations (tests/test_gan_trainer.py's
settings) with the toy learning, the losses and weights of 20 iterations
against lvt_tpu's GanTrainer on twins that read their noise from the batch,
the refusals, and the checkpoint tree with a --resume that restores D."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvt_tpu.config import get_cfg as jax_get_cfg
from lvt_tpu.engine.gan import GanTrainer as JaxGanTrainer
from lvt_tpu.models.loss import gan_loss as jax_gan_loss
from lvt_tpu.parallel.mesh import build_mesh
from lvt_tpu_torch.checkpoint import save_checkpoint
from lvt_tpu_torch.config import get_cfg
from lvt_tpu_torch.engine.gan import GanTrainer
from lvt_tpu_torch.models.loss import gan_loss

torch.set_num_threads(1)  # one intra-op thread: the test workers share the cores

TARGET = np.array([2.0, -1.0], np.float32)
G_KEYS, D_KEYS = ("w1", "w2", "b2"), ("w1", "w2")


def _cfg(get, tmp_path):
    """tests/test_gan_trainer.py's settings."""
    cfg = get()
    cfg.GAN_MODE_ON = True
    cfg.LOSS.GAN.MODE = "lsgan"
    cfg.SOLVER.OPTIMIZER_NAME = "adam"
    cfg.SOLVER.ADAM.BETA2_G = 0.999
    cfg.SOLVER.ADAM.BETA2_D = 0.999
    cfg.SOLVER.LR_G = 1e-2
    cfg.SOLVER.LR_D = 2e-2
    cfg.SOLVER.SUPERVISED_MAX_ITER = 5
    cfg.SOLVER.D_UPDATE_RATIO = 2
    cfg.SOLVER.D_INIT_ITERS = 7
    cfg.SOLVER.IMS_PER_BATCH = 64
    cfg.OUTPUT_DIR = str(tmp_path)
    cfg.SEED = 1
    cfg.TPU.COMPUTE_DTYPE = "float32"
    return cfg


def _weights(seed=5):
    r = np.random.default_rng(seed)
    g = {"w1": r.standard_normal((4, 16)) * 0.5, "w2": r.standard_normal((16, 2)) * 0.5,
         "b2": np.zeros(2)}
    d = {"w1": r.standard_normal((2, 16)) * 0.5, "w2": r.standard_normal((16, 1)) * 0.5}
    return ({k: v.astype(np.float32) for k, v in g.items()},
            {k: v.astype(np.float32) for k, v in d.items()})


class Loader:
    """Batch i: 64 samples around TARGET and, for the twins, 64 noise rows,
    from numpy seeded with i (a resumed loader starts at its iteration)."""

    def __init__(self, start=0, noise=True):
        self.start, self.noise = start, noise

    def __iter__(self):
        i = self.start
        while True:
            r = np.random.default_rng(i)
            batch = {"x": (r.standard_normal((64, 2)) * 0.3 + TARGET).astype(np.float32)}
            if self.noise:
                batch["z"] = r.standard_normal((64, 4)).astype(np.float32)
            yield batch
            i += 1


class ToyGan:
    """The port's toy: G a 2-layer MLP noise -> sample, D a 2-layer MLP
    sample -> logit. Noise from the batch's "z" where it has one, else
    drawn from the step's generator; weights from ``weights`` or drawn."""

    def __init__(self, cfg, weights=None):
        self.cfg, self.weights = cfg, weights

    def init(self, gen, device="cpu"):
        if self.weights is not None:
            return {k: torch.tensor(v, device=device) for k, v in self.weights[0].items()}, {}
        return {"w1": torch.randn(4, 16, generator=gen) * 0.5,
                "w2": torch.randn(16, 2, generator=gen) * 0.5, "b2": torch.zeros(2)}, {}

    def init_discriminator(self, gen, device="cpu"):
        if self.weights is not None:
            return {k: torch.tensor(v, device=device) for k, v in self.weights[1].items()}
        return {"w1": torch.randn(2, 16, generator=gen) * 0.5,
                "w2": torch.randn(16, 1, generator=gen) * 0.5}

    def gen_samples(self, params, z):
        return torch.tanh(z @ params["w1"]) @ params["w2"] + params["b2"]

    def _fake(self, params, batch, gen):
        z = batch.get("z")
        if z is None:
            z = torch.randn(batch["x"].shape[0], 4, generator=gen)
        return self.gen_samples(params, z)

    def _disc(self, d_params, x):
        return (torch.tanh(x @ d_params["w1"]) @ d_params["w2"])[:, 0]

    def train_loss(self, params, state, batch, gen):
        fake = self._fake(params, batch, gen)
        loss = ((fake.mean(0) - batch["x"].mean(0)) ** 2).mean()
        return loss, ({"loss_sup": loss}, state)

    def generator_loss(self, params, d_params, state, batch, gen):
        loss = gan_loss(self.cfg, self._disc(d_params, self._fake(params, batch, gen)), True)
        return loss, ({"loss_g": loss}, state)

    def discriminator_loss(self, params, d_params, state, batch, gen):
        fake = self._fake(params, batch, gen).detach()
        loss = (gan_loss(self.cfg, self._disc(d_params, batch["x"]), True)
                + gan_loss(self.cfg, self._disc(d_params, fake), False))
        return loss, {"loss_d": loss}


class JaxToyTwin:
    """lvt_tpu's side of the twins: tests/test_gan_trainer.py's ToyGan with
    its noise read from the batch and its weights given."""

    def __init__(self, cfg, weights):
        self.cfg, self.weights = cfg, weights

    def init(self, key):
        return {k: jnp.asarray(v) for k, v in self.weights[0].items()}, {}

    def init_discriminator(self, key):
        return {k: jnp.asarray(v) for k, v in self.weights[1].items()}

    def _gen(self, params, z):
        return jnp.tanh(z @ params["w1"]) @ params["w2"] + params["b2"]

    def _disc(self, d_params, x):
        return (jnp.tanh(x @ d_params["w1"]) @ d_params["w2"])[:, 0]

    def train_loss(self, params, state, batch, rng, **_):
        fake = self._gen(params, batch["z"])
        loss = jnp.mean((jnp.mean(fake, 0) - jnp.mean(batch["x"], 0)) ** 2)
        return loss, ({"loss_sup": loss}, state)

    def generator_loss(self, params, d_params, state, batch, rng):
        loss = jax_gan_loss(self.cfg, self._disc(d_params, self._gen(params, batch["z"])), True)
        return loss, ({"loss_g": loss}, state)

    def discriminator_loss(self, params, d_params, state, batch, rng):
        fake = jax.lax.stop_gradient(self._gen(params, batch["z"]))
        loss = (jax_gan_loss(self.cfg, self._disc(d_params, batch["x"]), True)
                + jax_gan_loss(self.cfg, self._disc(d_params, fake), False))
        return loss, {"loss_d": loss}


def _histories(trainer):
    h = trainer.storage.histories()
    return {k: np.array([v for v, _ in h[k].values()]) for k in ("loss_sup", "loss_d", "loss_g")}


def test_schedule_counts_and_learning(tmp_path):
    """400 iterations: 5 supervised, 395 D steps, G steps on the even
    iterations from D_INIT_ITERS on, as tests/test_gan_trainer.py counts
    them; the sample mean moves toward the target."""
    cfg = _cfg(get_cfg, tmp_path)
    tr = GanTrainer(cfg, Loader(noise=False), model=ToyGan(cfg), device="cpu")
    tr.metrics_period = 1
    probe = torch.Generator().manual_seed(123)
    z = torch.randn(512, 4, generator=probe)

    def dist():
        with torch.no_grad():
            return np.linalg.norm(tr.model.gen_samples(tr.state.params, z).mean(0).numpy() - TARGET)

    init_dist = dist()
    tr.train(0, 400)
    tr.flush_metrics()
    hists = tr.storage.histories()
    assert len(hists["loss_sup"].values()) == 5
    assert len(hists["loss_d"].values()) == 395
    assert len(hists["loss_g"].values()) == len([i for i in range(5, 400)
                                                 if i % 2 == 0 and i >= 7])
    assert tr.state.step == 400
    got_dist = dist()
    assert got_dist < init_dist * 0.9, (got_dist, init_dist)


def test_matches_lvt_tpu_gan_trainer(tmp_path):
    """20 iterations of the twins from the same weights on the same batches:
    every loss of the three histories and the final G and D weights within
    1e-4 relative of lvt_tpu's GanTrainer."""
    weights = _weights()
    jcfg = _cfg(jax_get_cfg, tmp_path / "jax")
    mesh = build_mesh(data=1, model=1, devices=jax.devices()[:1])
    jtr = JaxGanTrainer(jcfg, Loader(), model=JaxToyTwin(jcfg, weights), mesh=mesh)
    jtr.metrics_period = 1
    jtr.train(0, 20)
    jtr.flush_metrics()
    cfg = _cfg(get_cfg, tmp_path / "torch")
    tr = GanTrainer(cfg, Loader(), model=ToyGan(cfg, weights), device="cpu")
    tr.metrics_period = 1
    tr.train(0, 20)
    tr.flush_metrics()
    want, got = _histories(jtr), _histories(tr)
    assert [len(got[k]) for k in got] == [5, 15, 6]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    for mine, theirs, keys in ((tr.state.params, jtr.state.params, G_KEYS),
                               (tr.d_params, jtr.d_params, D_KEYS)):
        for k in keys:
            np.testing.assert_allclose(mine[k].detach().numpy(), np.asarray(theirs[k]),
                                       rtol=1e-4, atol=1e-6, err_msg=k)


class _NoDiscriminator(ToyGan):
    @property
    def discriminator_loss(self):
        raise AttributeError("discriminator_loss")


def test_refusals(tmp_path):
    """lvt_tpu's two asserts (a model with a discriminator; no gradient
    accumulation), and a model group (ROADMAP item 9)."""
    cfg = _cfg(get_cfg, tmp_path)
    model = ToyGan(cfg)
    with pytest.raises(AssertionError, match="discriminator"):
        GanTrainer(cfg, Loader(), model=_NoDiscriminator(cfg), device="cpu")
    cfg.SOLVER.ACCUMULATION_STEPS = 2
    with pytest.raises(AssertionError, match="accumulation"):
        GanTrainer(cfg, Loader(), model=model, device="cpu")
    cfg.SOLVER.ACCUMULATION_STEPS = 1
    cfg.TPU.MESH_MODEL = 2
    with pytest.raises(NotImplementedError, match="item 9"):
        GanTrainer(cfg, Loader(), model=model, device="cpu")


def test_checkpoint_tree_and_resume_restore_d(tmp_path):
    """checkpoint_tree adds d_params and D's optimizer and schedule; a run
    resumed from iteration 12 starts from the saved D (not a fresh init) and
    ends where an unbroken 20-iteration run ends, bit for bit."""
    weights = _weights()
    cfg = _cfg(get_cfg, tmp_path / "whole")
    whole = GanTrainer(cfg, Loader(), model=ToyGan(cfg, weights), device="cpu")
    whole.train(0, 20)

    cfg = _cfg(get_cfg, tmp_path / "split")
    first = GanTrainer(cfg, Loader(), model=ToyGan(cfg, weights), device="cpu")
    first.train(0, 12)
    tree = first.checkpoint_tree()
    assert {"params", "model_state", "opt_state", "step", "d_params", "d_opt_state"} == set(tree)
    assert set(tree["d_opt_state"]) == {"optimizer", "scheduler"}
    assert tree["d_opt_state"]["optimizer"]["state"], "D's Adam moments are saved"
    save_checkpoint(cfg.OUTPUT_DIR, first.state.step, tree)

    resumed = GanTrainer(cfg, Loader(start=12), model=ToyGan(cfg, weights), device="cpu")
    assert not torch.equal(resumed.d_params["w1"], first.d_params["w1"])
    assert resumed.resume_or_load(resume=True) == 12
    for k in D_KEYS:
        assert torch.equal(resumed.d_params[k], first.d_params[k])
    assert resumed.d_optimizer.state_dict()["state"].keys() == tree["d_opt_state"][
        "optimizer"]["state"].keys()
    resumed.train(12, 20)
    for mine, theirs, keys in ((resumed.state.params, whole.state.params, G_KEYS),
                               (resumed.d_params, whole.d_params, D_KEYS)):
        for k in keys:
            assert torch.equal(mine[k], theirs[k]), k
