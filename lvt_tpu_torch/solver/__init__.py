from .build import build_lr_schedule, build_optimizer, decay_group

__all__ = ["build_lr_schedule", "build_optimizer", "decay_group"]
