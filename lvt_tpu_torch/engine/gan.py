"""The GAN trainer (counterpart of lvt_tpu/engine/gan.py; reference
vidgen/engine/trainer.py:88-121).

Alternating generator / discriminator updates for a model that provides
both sides:

  model.train_loss(params, model_state, batch, gen)               -> (loss, (metrics, state))
  model.generator_loss(params, d_params, model_state, batch, gen) -> (loss, (metrics, state))
  model.discriminator_loss(params, d_params, model_state, batch, gen) -> (loss, metrics)
  model.init_discriminator(gen, device)                           -> d_params

``gen`` is the step's torch.Generator (``Trainer.step_generator``). The
schedule is lvt_tpu's:
  * iter < SOLVER.SUPERVISED_MAX_ITER (when >= 0): the base trainer's
    supervised step;
  * after that a D step every iteration, and a G step when iter %
    D_UPDATE_RATIO == 0 and iter >= D_INIT_ITERS; otherwise G's step count
    advances with no update.
G and D steps run on the fp32 masters, as lvt_tpu's ``_make_g_step`` and
``_make_d_step`` do (no compute-dtype copy); each side's gradient is
averaged over the data group before its update. D has its own optimizer and
LR schedule (the SOLVER keys with the "_D" suffix) and is saved and restored
with every checkpoint.

Under a model group (TPU.MESH_MODEL > 1) G is the base trainer's: its split
leaves are the rank's parts, every forward pass that reads G runs inside
``tensor_parallel(model group)``, and its checkpoints are whole. D is
replicated over the model group, as lvt_tpu leaves ``d_params`` unplaced:
every rank of a group holds all of it and computes the same gradient from
the same rows, so it too is averaged over the data group only, and it is
saved and restored as it is, whatever the layout.
"""

import time

import torch

from ..checkpoint.convert import flatten
from ..parallel.mesh import global_batch, tensor_parallel
from ..solver import build_optimizer
from .trainer import Trainer, _map_leaves, _zip_leaves


class GanTrainer(Trainer):
    """Alternating G/D trainer. ``model`` must provide generator_loss,
    discriminator_loss and init_discriminator."""

    def __init__(self, cfg, data_loader, model=None, device="cuda"):
        super().__init__(cfg, data_loader, model=model, device=device)
        assert hasattr(self.model, "discriminator_loss"), (
            "GAN_MODE_ON needs a model with a discriminator; the reference "
            "ships none (vidgen has no discriminator module)")
        assert cfg.SOLVER.ACCUMULATION_STEPS == 1, (
            "GanTrainer updates every iteration and does not implement "
            "gradient accumulation; its LR-schedule count scaling "
            "(solver/build.py) would also be wrong with A > 1")
        self.d_update_ratio = cfg.SOLVER.D_UPDATE_RATIO
        self.d_init_iters = cfg.SOLVER.D_INIT_ITERS
        self.supervised_max_iter = cfg.SOLVER.SUPERVISED_MAX_ITER
        # from the seed the base trainer used (drawn when cfg.SEED <= 0)
        d_params = self.model.init_discriminator(torch.Generator().manual_seed(self.seed + 7),
                                                 self.device)
        self.d_params = _map_leaves(lambda x: x.detach().float().requires_grad_(True), d_params)
        self.d_optimizer, self.d_scheduler = build_optimizer(cfg, flatten(self.d_params),
                                                             suffix="_D")

    def _g_step(self, batch):
        st = self.state
        d_params = _map_leaves(lambda x: x.detach(), self.d_params)
        with global_batch(self.group), tensor_parallel(self.model_group):
            loss, (metrics, ms) = self.model.generator_loss(
                st.params, d_params, st.model_state, batch, self.step_generator(st.step))
            loss.float().backward()
        st.model_state = _map_leaves(lambda x: x.detach(), ms)
        self._update(st.params, st.optimizer, st.scheduler)
        st.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    def _d_step(self, batch):
        st = self.state
        params = _map_leaves(lambda x: x.detach(), st.params)
        with global_batch(self.group), tensor_parallel(self.model_group):
            loss, metrics = self.model.discriminator_loss(
                params, self.d_params, st.model_state, batch, self.step_generator(st.step))
            loss.float().backward()
        self._update(self.d_params, self.d_optimizer, self.d_scheduler)
        return {k: v.detach() for k, v in metrics.items()}

    def _update(self, params, optimizer, scheduler):
        """One update of ``params`` from their gradients averaged over the
        data group."""
        self._average_grads(params)
        optimizer.step()
        scheduler.step()
        optimizer.zero_grad(set_to_none=True)

    def run_step(self):
        start = time.perf_counter()
        batch = self._put_batch(next(self._data_loader_iter))
        data_time = time.perf_counter() - start

        it = self.iter
        if 0 <= self.supervised_max_iter and it < self.supervised_max_iter:
            metrics = self.train_step(batch)
        else:
            metrics = self._d_step(batch)
            if it % self.d_update_ratio == 0 and it >= self.d_init_iters:
                metrics.update(self._g_step(batch))
            else:
                self.state.step += 1
        self._pending_metrics.append((self.iter, data_time, metrics))

    # -- checkpoint ---------------------------------------------------------
    def checkpoint_tree(self):
        tree = super().checkpoint_tree()
        tree["d_params"] = _map_leaves(lambda x: x.detach(), self.d_params)
        tree["d_opt_state"] = {"optimizer": self.d_optimizer.state_dict(),
                               "scheduler": self.d_scheduler.state_dict()}
        return tree

    def _checkpoint_target(self, params, mstate):
        return dict(super()._checkpoint_target(params, mstate), d_params=self.d_params,
                    d_opt_state=None)

    def load_tree(self, tree):
        """The base trainer's state and D's weights, optimizer and schedule
        (lvt_tpu's resume restores G's fields only). D is whole in every
        layout, so it loads as it was saved."""
        super().load_tree(tree)
        with torch.no_grad():
            _zip_leaves(lambda p, v: p.copy_(v), self.d_params, tree["d_params"])
        self.d_optimizer.load_state_dict(tree["d_opt_state"]["optimizer"])
        self.d_scheduler.load_state_dict(tree["d_opt_state"]["scheduler"])
        self.d_optimizer.zero_grad(set_to_none=True)
