"""The port's GanTrainer (lvt_tpu_torch/engine/gan.py) on a toy 1-D GAN:
lvt_tpu's schedule over 400 iterations (tests/test_gan_trainer.py's
settings) with the toy learning, the losses and weights of 20 iterations
against lvt_tpu's GanTrainer on twins that read their noise from the batch,
the refusals, the checkpoint tree with a --resume that restores D, and the
twins under a model group: a gloo world of data 2 x model 2 against lvt_tpu's
GanTrainer on its (2, 2) mesh, and its checkpoint resumed in a world of one."""

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
from torch_dp_worker import spawn_world
from torch_gan_worker import (D_KEYS, G_KEYS, ITERS, TARGET, Loader, ToyGan, gan_model_group,
                              histories)
from torch_gan_worker import gan_cfg as _cfg
from torch_gan_worker import toy_weights as _weights

torch.set_num_threads(1)  # one intra-op thread: the test workers share the cores


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
    want, got = histories(jtr), histories(tr)
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
    accumulation)."""
    cfg = _cfg(get_cfg, tmp_path)
    model = ToyGan(cfg)
    with pytest.raises(AssertionError, match="discriminator"):
        GanTrainer(cfg, Loader(), model=_NoDiscriminator(cfg), device="cpu")
    cfg.SOLVER.ACCUMULATION_STEPS = 2
    with pytest.raises(AssertionError, match="accumulation"):
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


def test_under_a_model_group_matches_lvt_tpu_and_resumes_in_a_world_of_one(tmp_path):
    """ITERS iterations of the twins in a gloo world of 4 (data 2 x model 2,
    TPU.MESH_MODEL 2: G through the base trainer's split machinery, D
    replicated over the model group) against lvt_tpu's GanTrainer on its
    (2, 2) mesh: the histories and the final G and D within
    test_matches_lvt_tpu_gan_trainer's bounds on every rank, every rank's G
    and D bit-equal. The checkpoint the world saved resumes in a world of
    one (TPU.MESH_MODEL 1) with G, D and D's optimizer as the world left
    them, and its next iteration equals lvt_tpu's."""
    weights = _weights()
    jcfg = _cfg(jax_get_cfg, tmp_path / "jax")
    jtr = JaxGanTrainer(jcfg, Loader(), model=JaxToyTwin(jcfg, weights),
                        mesh=build_mesh(data=2, model=2, devices=jax.devices()[:4]))
    jtr.metrics_period = 1
    jtr.train(0, ITERS + 1)
    jtr.flush_metrics()
    want = histories(jtr)
    out = str(tmp_path / "world")
    res = spawn_world(gan_model_group, {"out_dir": out, "model": 2, "weights": weights},
                      str(tmp_path / "ranks"), world=4)
    for r in res:
        assert r["model_group"] and r["step"] == ITERS
        assert [len(v) for v in r["histories"].values()] == [
            5, ITERS - 5, len([i for i in range(5, ITERS) if i % 2 == 0 and i >= 7])]
        for k, v in r["histories"].items():
            np.testing.assert_allclose(v, want[k][:len(v)], rtol=1e-4, err_msg=k)
        for mine, theirs in ((r["g"], res[0]["g"]), (r["d"], res[0]["d"])):
            for k in mine:
                np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)
    # lvt_tpu's weights after ITERS iterations: a second run stopped there
    jstop = JaxGanTrainer(jcfg, Loader(), model=JaxToyTwin(jcfg, weights),
                          mesh=build_mesh(data=2, model=2, devices=jax.devices()[:4]))
    jstop.train(0, ITERS)
    for mine, theirs, keys in ((res[0]["g"], jstop.state.params, G_KEYS),
                               (res[0]["d"], jstop.d_params, D_KEYS)):
        for k in keys:
            np.testing.assert_allclose(mine[k], np.asarray(theirs[k]), rtol=1e-4, atol=1e-6,
                                       err_msg=k)
    # the world's checkpoint in a world of one
    cfg = _cfg(get_cfg, out)
    one = GanTrainer(cfg, Loader(start=ITERS), model=ToyGan(cfg, weights), device="cpu")
    assert one.model_group is None
    assert one.resume_or_load(resume=True) == ITERS
    for mine, theirs in ((one.state.params, res[0]["g"]), (one.d_params, res[0]["d"])):
        for k in theirs:
            assert np.array_equal(mine[k].detach().numpy(), theirs[k]), k
    assert one.d_optimizer.state_dict()["state"], "D's Adam moments are restored"
    one.metrics_period = 1
    one.train(ITERS, ITERS + 1)
    one.flush_metrics()
    got = histories(one)
    np.testing.assert_allclose(got["loss_d"], want["loss_d"][-1:], rtol=1e-4)
    for mine, theirs, keys in ((one.state.params, jtr.state.params, G_KEYS),
                               (one.d_params, jtr.d_params, D_KEYS)):
        for k in keys:
            np.testing.assert_allclose(mine[k].detach().numpy(), np.asarray(theirs[k]),
                                       rtol=1e-4, atol=1e-6, err_msg=k)
