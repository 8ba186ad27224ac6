"""Hook lifecycle + base training loop (reference: vidgen/engine/train_loop.py).

Differences from the reference, on purpose:
* exceptions propagate — the reference logs and swallows them
  (train_loop.py:130-131), which hides real failures;
* `storage.step()` ordering (after after_step hooks) is preserved.
"""

import logging
import weakref

from ..utils.events import EventStorage

logger = logging.getLogger(__name__)


class HookBase:
    """Hooks get a weak reference to the trainer as ``self.trainer``
    (reference train_loop.py:12-69)."""

    def before_train(self):
        pass

    def after_train(self):
        pass

    def before_step(self):
        pass

    def after_step(self):
        pass


class TrainerBase:
    def __init__(self):
        self._hooks = []
        self.iter = 0
        self.start_iter = 0
        self.max_iter = 0
        self.storage = None

    def register_hooks(self, hooks):
        hooks = [h for h in hooks if h is not None]
        for h in hooks:
            assert isinstance(h, HookBase)
            h.trainer = weakref.proxy(self)
        self._hooks.extend(hooks)

    def train(self, start_iter: int, max_iter: int):
        logger.info(f"Starting training from iteration {start_iter}")
        self.iter = self.start_iter = start_iter
        self.max_iter = max_iter

        with EventStorage(start_iter) as self.storage:
            try:
                self.before_train()
                for self.iter in range(start_iter, max_iter):
                    self.before_step()
                    self.run_step()
                    self.after_step()
                    self.storage.step()
            finally:
                self.after_train()

    def before_train(self):
        for h in self._hooks:
            h.before_train()

    def after_train(self):
        for h in self._hooks:
            h.after_train()

    def before_step(self):
        self.storage.iter = self.iter
        for h in self._hooks:
            h.before_step()

    def after_step(self):
        for h in self._hooks:
            h.after_step()

    def run_step(self):
        raise NotImplementedError
