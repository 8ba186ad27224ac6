"""The port's toy GAN (tests/test_torch_gan.py) and the ranks' side of its
run under a model group. This module imports torch and the port only: the
ranks never import JAX.

The toy: G a 2-layer MLP noise -> sample, D a 2-layer MLP sample -> logit,
tests/test_gan_trainer.py's settings. Its supervised loss matches the
moments of the global batch: inside ``global_batch(data group)`` the rows of
every data rank are gathered for the means, whose gradient the trainer's
average over the data group makes the global batch's. Every other loss is a
mean over rows, which that average makes global by itself.
"""

import numpy as np
import torch

from torch_dp_worker import _np, rows

TARGET = np.array([2.0, -1.0], np.float32)
G_KEYS, D_KEYS = ("w1", "w2", "b2"), ("w1", "w2")
ITERS = 30  # the model-group run's iterations
BATCH = 64


def gan_cfg(get, out_dir, model=1):
    """tests/test_gan_trainer.py's settings; ``get`` is either package's
    get_cfg."""
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
    cfg.SOLVER.IMS_PER_BATCH = BATCH
    cfg.OUTPUT_DIR = str(out_dir)
    cfg.SEED = 1
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.MESH_MODEL = model
    return cfg


def toy_weights(seed=5):
    """G's and D's weights from numpy, for both packages' twins."""
    r = np.random.default_rng(seed)
    g = {"w1": r.standard_normal((4, 16)) * 0.5, "w2": r.standard_normal((16, 2)) * 0.5,
         "b2": np.zeros(2)}
    d = {"w1": r.standard_normal((2, 16)) * 0.5, "w2": r.standard_normal((16, 1)) * 0.5}
    return ({k: v.astype(np.float32) for k, v in g.items()},
            {k: v.astype(np.float32) for k, v in d.items()})


class Loader:
    """Batch i: BATCH samples around TARGET and, for the twins, BATCH noise
    rows, from numpy seeded with i (a resumed loader starts at its
    iteration); with ``part`` (data index, data ranks) that rank's rows."""

    def __init__(self, start=0, noise=True, part=None):
        self.start, self.noise, self.part = start, noise, part

    def __iter__(self):
        i = self.start
        while True:
            r = np.random.default_rng(i)
            batch = {"x": (r.standard_normal((BATCH, 2)) * 0.3 + TARGET).astype(np.float32)}
            if self.noise:
                batch["z"] = r.standard_normal((BATCH, 4)).astype(np.float32)
            yield batch if self.part is None else rows(batch, *self.part)
            i += 1


def _batch_mean(x):
    """The mean over the rows of the global batch (``global_batch_group``:
    every data rank's rows gathered), or over ``x``'s own rows."""
    from lvt_tpu_torch.parallel.collectives import all_gather
    from lvt_tpu_torch.parallel.mesh import global_batch_group

    group = global_batch_group()
    return x.mean(0) if group is None else all_gather(x, group).mean(0)


class ToyGan:
    """The port's toy. Noise from the batch's "z" where it has one, else
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
        loss = ((_batch_mean(fake) - _batch_mean(batch["x"])) ** 2).mean()
        return loss, ({"loss_sup": loss}, state)

    def generator_loss(self, params, d_params, state, batch, gen):
        from lvt_tpu_torch.models.loss import gan_loss

        loss = gan_loss(self.cfg, self._disc(d_params, self._fake(params, batch, gen)), True)
        return loss, ({"loss_g": loss}, state)

    def discriminator_loss(self, params, d_params, state, batch, gen):
        from lvt_tpu_torch.models.loss import gan_loss

        fake = self._fake(params, batch, gen).detach()
        loss = (gan_loss(self.cfg, self._disc(d_params, batch["x"]), True)
                + gan_loss(self.cfg, self._disc(d_params, fake), False))
        return loss, {"loss_d": loss}


def histories(trainer):
    h = trainer.storage.histories()
    return {k: np.array([v for v, _ in h[k].values()]) for k in ("loss_sup", "loss_d", "loss_g")}


def gan_model_group(payload):
    """ITERS iterations of the twins' GanTrainer in this world (TPU.MESH_MODEL
    2) on this data index's rows; the histories, G and D on this rank, and a
    checkpoint saved after the last iteration (every rank gathers and
    saves; rank 0 writes)."""
    from lvt_tpu_torch.checkpoint import save_checkpoint
    from lvt_tpu_torch.config import get_cfg
    from lvt_tpu_torch.engine.gan import GanTrainer
    from lvt_tpu_torch.parallel.mesh import data_rank
    from lvt_tpu_torch.utils import comm

    cfg = gan_cfg(get_cfg, payload["out_dir"], model=payload["model"])
    tr = GanTrainer(cfg, Loader(part=data_rank(cfg)), model=ToyGan(cfg, payload["weights"]),
                    device="cpu")
    tr.metrics_period = 1
    tr.train(0, ITERS)
    tr.flush_metrics()
    save_checkpoint(cfg.OUTPUT_DIR, tr.state.step, tr.checkpoint_tree())
    return {"rank": comm.get_rank(), "histories": histories(tr),
            "g": {k: _np(v) for k, v in tr.state.params.items()},
            "d": {k: _np(v) for k, v in tr.d_params.items()},
            "model_group": tr.model_group is not None, "step": tr.state.step}
