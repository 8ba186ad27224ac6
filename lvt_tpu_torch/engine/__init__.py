from .hooks import (
    CallbackHook,
    IterationTimer,
    LRSchedulerHook,
    PeriodicCheckpointer,
    PeriodicWriter,
)
from .train_loop import HookBase, TrainerBase
from .trainer import TrainState, Trainer

__all__ = [
    "CallbackHook",
    "HookBase",
    "IterationTimer",
    "LRSchedulerHook",
    "PeriodicCheckpointer",
    "PeriodicWriter",
    "TrainState",
    "Trainer",
    "TrainerBase",
]
