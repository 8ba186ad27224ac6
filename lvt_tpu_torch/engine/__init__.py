from .hooks import (
    CallbackHook,
    EvalHook,
    IterationTimer,
    LRSchedulerHook,
    PeriodicCheckpointer,
    PeriodicWriter,
    TorchProfiler,
)
from .train_loop import HookBase, TrainerBase
from .trainer import TrainState, Trainer

__all__ = [
    "CallbackHook",
    "EvalHook",
    "HookBase",
    "IterationTimer",
    "LRSchedulerHook",
    "PeriodicCheckpointer",
    "PeriodicWriter",
    "TorchProfiler",
    "TrainState",
    "Trainer",
    "TrainerBase",
]
