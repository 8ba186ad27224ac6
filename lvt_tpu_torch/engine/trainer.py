"""The trainer (counterpart of lvt_tpu/engine/trainer.py; reference
vidgen/engine/trainer.py, defaults.py).

One process, one device. A step is: the batch onto the device, the loss of
the model's ``train_loss`` on the compute-dtype copy of the fp32 master
weights, ``backward()`` into the masters' ``.grad``, and every
ACCUMULATION_STEPS-th step the optimizer update and the LR schedule step.

* Mixed precision as lvt_tpu's ``make_train_step``: with TPU.COMPUTE_DTYPE
  bfloat16 the master leaves are cast with a differentiable ``.to()`` inside
  the step, so the forward and backward run in bf16 and the gradients land
  in fp32 (``torch.autocast`` would put its rounding points elsewhere).
* Gradient accumulation sums the gradients of A consecutive batches and
  applies them once (the reference calls backward every iteration and
  optimizer.step every A-th), which is what ``.grad`` does between two
  ``zero_grad`` calls.
* Randomness: step i draws its slice indices from a torch.Generator seeded
  from (seed, i), so a resumed run draws what an unbroken one would.
* Metrics stay on the device until a flush every ``metrics_period`` steps
  (and at the last), where the non-finite-loss guard runs.
"""

import logging
import time
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from ..checkpoint import resume_or_load as load_latest
from ..checkpoint.convert import flatten
from ..models import build_model, cast_floats, param_count
from ..solver import build_optimizer
from ..utils.env import seed_all_rng
from .train_loop import TrainerBase

logger = logging.getLogger(__name__)


@dataclass
class TrainState:
    params: Any  # the fp32 master tree; its leaves require grad
    model_state: Any
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    step: int

    def accum_grads(self):
        """The gradient sum of the open accumulation window, as a tree of
        the params' shape (zeros where nothing has been summed)."""
        return _map_leaves(lambda p: torch.zeros_like(p) if p.grad is None
                           else p.grad.detach().clone(), self.params)


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_leaves(fn, v) for v in tree]
    return fn(tree)


def _zip_leaves(fn, a, b):
    if isinstance(a, dict):
        for k in a:
            _zip_leaves(fn, a[k], b[k])
    elif isinstance(a, (list, tuple)):
        for x, y in zip(a, b):
            _zip_leaves(fn, x, y)
    else:
        fn(a, b)


def _compute_dtype(cfg):
    cdt = cfg.TPU.COMPUTE_DTYPE
    return None if cdt in ("", "float32") else getattr(torch, cdt)


class Trainer(TrainerBase):
    """End-to-end trainer for a model exposing init / train_loss
    (reference Trainer, engine/trainer.py:9-128), on ``device``."""

    def __init__(self, cfg, data_loader, model=None, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = model if model is not None else build_model(cfg)
        self.metrics_period = 20
        # SEED <= 0 draws a fresh seed (reference utils/env.seed_all_rng)
        self.seed = cfg.SEED if cfg.SEED > 0 else seed_all_rng(-1)
        params, mstate = self.model.init(torch.Generator().manual_seed(self.seed), self.device)
        params = _map_leaves(lambda x: x.detach().float().requires_grad_(True), params)
        optimizer, scheduler = build_optimizer(cfg, flatten(params), suffix="_G")
        self.state = TrainState(params, mstate, optimizer, scheduler, 0)
        self.accumulation = cfg.SOLVER.ACCUMULATION_STEPS
        self.compute_dtype = _compute_dtype(cfg)
        self._data_loader = data_loader
        self._data_loader_iter = iter(data_loader)
        self._pending_metrics = []
        vt = cfg.MODEL.AUTOREGRESSIVE.VT
        self._bounds = {k: b for k, b in (("video", vt.NV), ("class", vt.CLASS_NUM)) if b > 0}
        self._checked = set()
        logger.info(f"Model has {param_count(params) / 1e6:.2f}M parameters; device "
                    f"{self.device}; compute dtype {self.compute_dtype or torch.float32}; "
                    f"accumulation={self.accumulation}")

    # -- step ---------------------------------------------------------------
    def step_generator(self, step: int) -> torch.Generator:
        """The CPU generator of step ``step``'s random draws."""
        return torch.Generator().manual_seed(((self.seed + 1) * 1_000_003 + step) % 2 ** 63)

    def train_step(self, batch):
        """One step on a batch already on the device; returns the metrics
        (detached device tensors)."""
        st = self.state
        p = st.params if self.compute_dtype is None else cast_floats(st.params,
                                                                     self.compute_dtype)
        loss, (metrics, new_mstate) = self.model.train_loss(
            p, st.model_state, batch, self.step_generator(st.step))
        loss.float().backward()
        st.model_state = new_mstate
        st.step += 1
        if st.step % self.accumulation == 0:
            st.optimizer.step()
            st.scheduler.step()
            st.optimizer.zero_grad(set_to_none=True)
        return {k: v.detach() for k, v in metrics.items()}

    def run_step(self):
        start = time.perf_counter()
        batch = self._put_batch(next(self._data_loader_iter))
        data_time = time.perf_counter() - start

        vis_period = self.cfg.VIS_PERIOD
        if (vis_period > 0 and self.iter > 0 and self.iter % vis_period == 0
                and hasattr(self.model, "visualize_training")):
            try:  # periodic image dumps must never kill training
                images = self.model.visualize_training(self.state.params,
                                                       self.state.model_state, batch)
                for name, img in images.items():
                    self.storage.put_image(name, img)
            except Exception as e:
                logger.warning(f"visualize_training failed: {e}")

        metrics = self.train_step(batch)
        self._pending_metrics.append((self.iter, data_time, metrics))

    def _put_batch(self, batch):
        """Numeric batch fields onto the device; host metadata (file names,
        video indices) dropped. Code and class fields are checked once each
        against the config's vocabulary: a dataset made for another
        codebook size would otherwise index out of range."""
        out = {}
        for k, v in batch.items():
            arr = v if isinstance(v, torch.Tensor) else np.asarray(v)
            if not (isinstance(arr, torch.Tensor) or np.issubdtype(arr.dtype, np.number)):
                continue
            t = torch.as_tensor(arr)
            if k in self._bounds and k not in self._checked:
                lo, hi = int(t.min()), int(t.max())
                if lo < 0 or hi >= self._bounds[k]:
                    raise ValueError(
                        f"batch field '{k}' has values in [{lo}, {hi}] but the config bounds "
                        f"it to [0, {self._bounds[k]}): mismatched dataset and config")
                self._checked.add(k)
            out[k] = t.to(self.device, non_blocking=True)
        return out

    def flush_metrics(self):
        pending, self._pending_metrics = self._pending_metrics, []
        for it, data_time, metrics in pending:
            host = {k: float(v) for k, v in metrics.items()}
            total = sum(host.values())
            if not np.isfinite(total):
                raise FloatingPointError(
                    f"Loss became infinite or NaN at iteration={it}! loss_dict={host}")
            saved = self.storage.iter
            self.storage.iter = it
            self.storage.put_scalars(total_loss=total, **host)
            self.storage.put_scalar("data_time", data_time)
            self.storage.iter = saved

    def after_step(self):
        # make metrics current before periodic writers run
        if (self.iter + 1) % self.metrics_period == 0 or self.iter == self.max_iter - 1:
            self.flush_metrics()
        super().after_step()

    # -- checkpoint ---------------------------------------------------------
    def checkpoint_tree(self):
        st = self.state
        tree = {"params": _map_leaves(lambda x: x.detach(), st.params),
                "model_state": st.model_state,
                "opt_state": {"optimizer": st.optimizer.state_dict(),
                              "scheduler": st.scheduler.state_dict()},
                "step": st.step}
        if self.accumulation > 1:
            # a resume mid-window must keep the partial gradient sum
            tree["accum_grads"] = st.accum_grads()
        return tree

    def load_tree(self, tree):
        """Set the training state from a checkpoint tree (as
        ``checkpoint_tree`` makes, placed into the state's structure)."""
        st = self.state
        with torch.no_grad():
            _zip_leaves(lambda p, v: p.copy_(v), st.params, tree["params"])
        st.model_state = tree["model_state"]
        st.optimizer.load_state_dict(tree["opt_state"]["optimizer"])
        st.scheduler.load_state_dict(tree["opt_state"]["scheduler"])
        st.step = int(tree["step"])
        st.optimizer.zero_grad(set_to_none=True)
        if "accum_grads" in tree:
            def set_grad(p, g):
                p.grad = g.to(p.device, p.dtype).clone()
            _zip_leaves(set_grad, st.params, tree["accum_grads"])

    def resume_or_load(self, resume: bool = True) -> int:
        """Returns the start iteration: the latest checkpoint's step on
        resume, else the current one."""
        target = {"params": self.state.params, "model_state": self.state.model_state,
                  "opt_state": None, "step": None}
        if self.accumulation > 1:
            target["accum_grads"] = self.state.params
        tree = load_latest(self.cfg.OUTPUT_DIR, target, resume=resume)
        if tree is not target:
            self.load_tree(tree)
            logger.info(f"Resumed at iteration {self.state.step}")
        return self.state.step

    def train(self, start_iter: Optional[int] = None, max_iter: Optional[int] = None):
        if start_iter is None:
            start_iter = self.state.step
        if max_iter is None:
            max_iter = self.cfg.SOLVER.MAX_ITER
        super().train(start_iter, max_iter)
