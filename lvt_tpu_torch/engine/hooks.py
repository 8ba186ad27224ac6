"""Training hooks (counterpart of lvt_tpu/engine/hooks.py; reference
vidgen/engine/hooks.py:21-228). EvalHook and the profiler hook come with the
port of evaluation."""

import datetime
import logging
import time

from ..checkpoint import prune_checkpoints, save_checkpoint
from ..utils import comm
from .train_loop import HookBase

logger = logging.getLogger(__name__)

__all__ = [
    "CallbackHook",
    "IterationTimer",
    "PeriodicWriter",
    "PeriodicCheckpointer",
    "LRSchedulerHook",
]


class CallbackHook(HookBase):
    """Hook from arbitrary callables (reference hooks.py:36-68)."""

    def __init__(self, *, before_train=None, after_train=None,
                 before_step=None, after_step=None):
        self._before_train = before_train
        self._after_train = after_train
        self._before_step = before_step
        self._after_step = after_step

    def before_train(self):
        if self._before_train:
            self._before_train(self.trainer)

    def after_train(self):
        if self._after_train:
            self._after_train(self.trainer)

    def before_step(self):
        if self._before_step:
            self._before_step(self.trainer)

    def after_step(self):
        if self._after_step:
            self._after_step(self.trainer)


class IterationTimer(HookBase):
    """Track seconds/iteration, excluding warmup; logs an overall speed
    summary at the end (reference hooks.py:71-139)."""

    def __init__(self, warmup_iter=3):
        self._warmup_iter = warmup_iter
        self._step_timer = None
        self._start_time = None
        self._total_timer = 0.0

    def before_train(self):
        self._start_time = time.perf_counter()

    def after_train(self):
        total_time = time.perf_counter() - self._start_time
        num_iter = self.trainer.iter + 1 - self.trainer.start_iter - self._warmup_iter
        if num_iter > 0 and self._total_timer > 0:
            logger.info(
                "Overall training speed: {} iterations in {} ({:.4f} s / it)".format(
                    num_iter, str(datetime.timedelta(seconds=int(self._total_timer))),
                    self._total_timer / num_iter))
        logger.info("Total training time: {}".format(
            str(datetime.timedelta(seconds=int(total_time)))))

    def before_step(self):
        self._step_timer = time.perf_counter()

    def after_step(self):
        sec = time.perf_counter() - self._step_timer
        iter_done = self.trainer.iter - self.trainer.start_iter + 1
        if iter_done > self._warmup_iter:
            self.trainer.storage.put_scalar("time", sec, smoothing_hint=True)
            self._total_timer += sec


class PeriodicWriter(HookBase):
    """Flush EventWriters every ``period`` iterations (reference
    hooks.py:142-169)."""

    def __init__(self, writers, period=20):
        self._writers = writers
        self._period = period

    def after_step(self):
        if (self.trainer.iter + 1) % self._period == 0 or (
                self.trainer.iter == self.trainer.max_iter - 1):
            for writer in self._writers:
                writer.write()

    def after_train(self):
        for writer in self._writers:
            # flush whatever accumulated since the last period boundary —
            # including the final-eval scalars EvalHook.after_train just
            # stored (they'd otherwise never reach metrics.json/TB)
            writer.write()
            writer.close()


class PeriodicCheckpointer(HookBase):
    """Checkpoint every ``period`` iterations + final (reference
    hooks.py:172-188); prunes to the newest ``max_to_keep`` when > 0."""

    def __init__(self, output_dir, period, max_to_keep=0):
        self._output_dir = output_dir
        self._period = period
        self._max_to_keep = max_to_keep

    def _save(self):
        tree = self.trainer.checkpoint_tree()
        save_checkpoint(self._output_dir, self.trainer.iter + 1, tree)
        if self._max_to_keep > 0 and comm.is_main_process():
            prune_checkpoints(self._output_dir, keep=self._max_to_keep)

    def after_step(self):
        it = self.trainer.iter + 1
        if self._period > 0 and it % self._period == 0 and it != self.trainer.max_iter:
            self._save()

    def after_train(self):
        if self.trainer.iter + 1 >= self.trainer.max_iter:
            self._save()


class LRSchedulerHook(HookBase):
    """Log the lr of each step (the trainer steps the LambdaLR with each
    optimizer update; reference hooks.py:191-228)."""

    def __init__(self, base_lr, schedule):
        self._base_lr = base_lr
        self._schedule = schedule

    def after_step(self):
        lr = float(self._base_lr * self._schedule(self.trainer.iter))
        self.trainer.storage.put_scalar("lr", lr, smoothing_hint=False)
