"""The trainer (counterpart of lvt_tpu/engine/trainer.py; reference
vidgen/engine/trainer.py, defaults.py).

One device per process, for both model families: the Video Transformer on
latent-code videos and the VQ-VAE (or auto-encoder) on frames. A step is: the
batch onto the device, the loss of the model's ``train_loss`` on the
compute-dtype copy of the fp32 master weights, ``backward()`` into the
masters' ``.grad``, and every ACCUMULATION_STEPS-th step the optimizer update
and the LR schedule step.

* Data parallelism, one process per GPU (``engine/launch.py``): with a
  process group initialised, each rank's batch is its part of the global
  batch of SOLVER.IMS_PER_BATCH, and the step computes what ``lvt_tpu``'s
  step jitted over its data mesh computes. The forward runs inside
  ``parallel.global_batch``: batch norms and the EMA codebook reduce their
  statistics over the global batch, and the step's random draws are made
  for the global batch, of which each rank takes its rows. Before each
  optimizer update the masters' gradients are averaged over the ranks, one
  all-reduce per flat fp32 bucket. The metrics are averaged at each flush,
  so every rank sees the global batch's and the non-finite guard trips on
  every rank together. A mid-window checkpoint replaces each rank's partial
  gradient sum by the ranks' average and stores it: avg(partial) +
  avg(rest) = avg(whole window).

* Tensor parallelism (TPU.MESH_MODEL M > 1, ``parallel/mesh.py``): the world
  is data x model processes, and the data group above is the ranks of one
  model index. The weights are made whole, by the init from SEED, and each
  rank keeps its part of the leaves that ``parallel/sharding.py`` splits
  (params and model state; the optimizer is built over the parts, so its
  moments are parts too). The ranks of a model group hold the same batch
  rows and draw the same numbers; the forward runs inside
  ``parallel.tensor_parallel`` too, whose collectives make the step compute
  what the whole model's step computes. A checkpoint is layout-free: the
  split leaves (params, model state, optimizer moments, a gradient sum) are
  gathered whole before rank 0 writes, and a load splits them for the
  current layout, so a run saved at one M resumes at another.

* The model state (the VQ-VAE's EMA codebook, batch-norm statistics,
  spectral-norm ``u``; empty for the VT) stays fp32, is replaced by the one
  ``train_loss`` returns each step, holds no autograd graph, and is saved and
  restored with the checkpoints.

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
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..checkpoint import resume_or_load as load_latest
from ..checkpoint.convert import flatten
from ..models import build_model, cast_floats, param_count, tree_leaves
from ..parallel import sharding
from ..parallel.mesh import data_group, global_batch, model_group, tensor_parallel
from ..solver import build_optimizer
from ..utils import comm
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


class _Split(NamedTuple):
    """This rank's place in its model group and the split of each leaf of the
    whole params and model state (``parallel.sharding.tp_dims``)."""
    rank: int
    size: int
    params: Any
    model_state: Any


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


# the most fp32 gradient bytes one all-reduce carries (DDP's default bucket)
GRAD_BUCKET_BYTES = 25 * 2 ** 20


def average_over(tensors, group) -> None:
    """Replace each fp32 tensor by its mean over ``group``'s ranks, in place:
    one all-reduce per run of tensors of at most GRAD_BUCKET_BYTES, flat."""
    world = dist.get_world_size(group)
    bucket, size = [], 0
    for t in list(tensors) + [None]:
        if bucket and (t is None or size + 4 * t.numel() > GRAD_BUCKET_BYTES):
            flat = torch.cat([b.reshape(-1) for b in bucket])
            dist.all_reduce(flat, group=group)
            flat.div_(world)
            for b, part in zip(bucket, flat.split([b.numel() for b in bucket])):
                b.copy_(part.view_as(b))
            bucket, size = [], 0
        if t is not None:
            bucket.append(t)
            size += 4 * t.numel()


def _compute_dtype(cfg):
    cdt = cfg.TPU.COMPUTE_DTYPE
    return None if cdt in ("", "float32") else getattr(torch, cdt)


class Trainer(TrainerBase):
    """End-to-end trainer for a model exposing init / train_loss (the VT,
    the VQ-VAE, the auto-encoder; reference Trainer,
    engine/trainer.py:9-128), on ``device``."""

    def __init__(self, cfg, data_loader, model=None, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = model if model is not None else build_model(cfg)
        self.metrics_period = 20
        self.group = data_group(cfg)  # None: this process's batch is the whole batch
        self.model_group = model_group(cfg)  # None: every weight whole
        # SEED <= 0 draws a fresh seed (reference utils/env.seed_all_rng), rank 0's on every rank
        self.seed = cfg.SEED if cfg.SEED > 0 else comm.all_gather(seed_all_rng(-1))[0]
        params, mstate = self.model.init(torch.Generator().manual_seed(self.seed), self.device)
        self._tp = None  # a _Split under a model group
        if self.model_group is not None:
            rank, size = sharding.group_rank(self.model_group)
            self._tp = tp = _Split(rank, size, sharding.tp_dims(params, size),
                                   sharding.tp_dims(mstate, size))
            params = sharding.shard_tree(params, rank, size, tp.params)
            mstate = sharding.shard_tree(mstate, rank, size, tp.model_state)
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
        world = 1 if self.group is None else dist.get_world_size(self.group)
        model = 1 if self._tp is None else self._tp.size
        logger.info(f"Model has {param_count(params) / 1e6:.2f}M parameters on this rank; "
                    f"device {self.device}; compute dtype {self.compute_dtype or torch.float32}; "
                    f"accumulation={self.accumulation}; data-parallel ranks {world}, "
                    f"tensor-parallel ranks {model}")

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
        with global_batch(self.group), tensor_parallel(self.model_group):
            loss, (metrics, new_mstate) = self.model.train_loss(
                p, st.model_state, batch, self.step_generator(st.step))
            loss.float().backward()
        st.model_state = _map_leaves(lambda x: x.detach(), new_mstate)
        st.step += 1
        if st.step % self.accumulation == 0:
            self._average_grads()
            st.optimizer.step()
            st.scheduler.step()
            st.optimizer.zero_grad(set_to_none=True)
        return {k: v.detach() for k, v in metrics.items()}

    def _average_grads(self, params=None):
        """The gradients of ``params`` (default: the masters) averaged over
        the data group, in place (a leaf with no gradient counts as zeros);
        nothing without a group. Under a model group each rank averages its
        parts of the split leaves, and the replicated leaves' gradients are
        alike across it."""
        if self.group is None:
            return
        masters = tree_leaves(self.state.params if params is None else params)
        for m in masters:
            if m.grad is None:
                m.grad = torch.zeros_like(m)
        if dist.get_world_size(self.group) > 1:
            average_over([m.grad for m in masters], self.group)

    def run_step(self):
        start = time.perf_counter()
        batch = self._put_batch(next(self._data_loader_iter))
        data_time = time.perf_counter() - start

        vis_period = self.cfg.VIS_PERIOD
        if (vis_period > 0 and self.iter > 0 and self.iter % vis_period == 0
                and hasattr(self.model, "visualize_training")):
            try:  # periodic image dumps must never kill training
                with tensor_parallel(self.model_group):
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
        if self.group is not None and pending:
            # the global batch's metrics, every pending step's in one all-reduce
            flat = comm.reduce_dict({f"{i}/{k}": v for i, (_, _, m) in enumerate(pending)
                                     for k, v in m.items()})
            pending = [(it, dt, {k: flat[f"{i}/{k}"] for k in m})
                       for i, (it, dt, m) in enumerate(pending)]
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
            # a resume mid-window must keep the partial gradient sum. Across
            # ranks each rank's sum is first replaced by their average (which
            # leaves the window's final average as it was), so that every
            # rank resumes from the one saved sum and continues bit for bit
            self._average_grads()
            tree["accum_grads"] = st.accum_grads()
        return tree if self._tp is None else self._layout_free(tree)

    def _optimizer_dims(self):
        """(split dim, this rank's shape) of each optimizer parameter, in the
        optimizer's index order."""
        dims = flatten(self._tp.params)
        by_id = {id(p): dims[n] for n, p in flatten(self.state.params).items()}
        ps = [p for g in self.state.optimizer.param_groups for p in g["params"]]
        return [by_id[id(p)] for p in ps], [tuple(p.shape) for p in ps]

    def _layout_free(self, tree):
        """A checkpoint tree of this rank's parts made whole over the model
        group (every rank of it calls this)."""
        tp, g = self._tp, self.model_group
        out = dict(tree, params=sharding.gather_tree(tree["params"], g, tp.params),
                   model_state=sharding.gather_tree(tree["model_state"], g, tp.model_state))
        dims, shapes = self._optimizer_dims()
        out["opt_state"] = dict(tree["opt_state"], optimizer=sharding.gather_optimizer_state(
            tree["opt_state"]["optimizer"], dims, shapes, g))
        if "accum_grads" in tree:
            out["accum_grads"] = sharding.gather_tree(tree["accum_grads"], g, tp.params)
        return out

    def _layout_part(self, tree):
        """This rank's parts of a whole (layout-free) checkpoint tree."""
        rank, size, pdims, sdims = self._tp
        out = dict(tree, params=sharding.shard_tree(tree["params"], rank, size, pdims),
                   model_state=sharding.shard_tree(tree["model_state"], rank, size, sdims))
        dims, shapes = self._optimizer_dims()
        whole = [s if d is None else s[:d] + (s[d] * size,) + s[d + 1:]
                 for d, s in zip(dims, shapes)]
        out["opt_state"] = dict(tree["opt_state"], optimizer=sharding.shard_optimizer_state(
            tree["opt_state"]["optimizer"], dims, whole, rank, size))
        if "accum_grads" in tree:
            out["accum_grads"] = sharding.shard_tree(tree["accum_grads"], rank, size, pdims)
        return out

    def load_tree(self, tree):
        """Set the training state from a checkpoint tree (as
        ``checkpoint_tree`` makes, placed into the state's structure; whole
        under a model group too, where each rank keeps its parts)."""
        if self._tp is not None:
            tree = self._layout_part(tree)
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

    def _checkpoint_target(self, params, mstate):
        """The structure a checkpoint file is placed into (``checkpoint_tree``'s
        keys; None takes the saved value as it is)."""
        target = {"params": params, "model_state": mstate, "opt_state": None, "step": None}
        if self.accumulation > 1:
            target["accum_grads"] = params
        return target

    def resume_or_load(self, resume: bool = True) -> int:
        """Returns the start iteration: the latest checkpoint's step on
        resume, else the current one."""
        params, mstate = self.state.params, self.state.model_state
        if self._tp is not None:  # the file holds the whole leaves
            params = sharding.full_like(params, self._tp.params, self._tp.size)
            mstate = sharding.full_like(mstate, self._tp.model_state, self._tp.size)
        target = self._checkpoint_target(params, mstate)
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
