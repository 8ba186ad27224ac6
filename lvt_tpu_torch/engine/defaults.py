"""Default CLI plumbing, setup and the DefaultTrainer (counterpart of
lvt_tpu/engine/defaults.py:50-93, :274-314; reference
vidgen/engine/defaults.py:37-310). Evaluation (run_test, the evaluators,
EvalHook) comes with the port of evaluation."""

import argparse
import logging
import os

import torch

from ..config import set_global_cfg
from ..data import build_train_loader
from ..utils import comm
from ..utils.env import seed_all_rng
from ..utils.events import CommonMetricPrinter, JSONWriter, TensorboardWriter
from ..utils.logger import setup_logger
from .hooks import IterationTimer, LRSchedulerHook, PeriodicCheckpointer, PeriodicWriter
from .trainer import Trainer

logger = logging.getLogger(__name__)


def default_argument_parser():
    """reference defaults.py:37-69 minus the multi-process options (the
    port trains on one card)."""
    parser = argparse.ArgumentParser(description="lvt_tpu_torch training")
    parser.add_argument("--config-file", default="", metavar="FILE",
                        help="path to config file")
    parser.add_argument("--resume", action="store_true",
                        help="resume from OUTPUT_DIR checkpoints")
    parser.add_argument("--eval-only", action="store_true", help="evaluate only")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER,
                        help="config overrides: KEY VALUE pairs")
    return parser


def default_setup(cfg, args):
    """Logging, seeding, config dump (reference defaults.py:72-121)."""
    output_dir = cfg.OUTPUT_DIR
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
    log = setup_logger(output_dir, distributed_rank=comm.get_rank(), name="lvt_tpu_torch")
    log.info(f"torch {torch.__version__}, cuda "
             f"{torch.cuda.get_device_name(0) if torch.cuda.is_available() else 'none'}")
    if getattr(args, "config_file", ""):
        log.info(f"Loaded config file {args.config_file}")
    if output_dir:
        path = os.path.join(output_dir, "config.yaml")
        with open(path, "w") as f:
            f.write(cfg.dump())
        log.info(f"Full config saved to {path}")
    seed_all_rng(None if cfg.SEED < 0 else cfg.SEED)
    set_global_cfg(cfg)


class DefaultTrainer(Trainer):
    """Trainer + default hooks and writers (reference defaults.py:124-310)."""

    def __init__(self, cfg, device="cuda"):
        if cfg.TEST.EVAL_PERIOD > 0:
            raise NotImplementedError(
                "TEST.EVAL_PERIOD > 0 needs EvalHook and the evaluators, which are not "
                "ported to lvt_tpu_torch yet (ROADMAP.md queue 1)")
        loader, _ = build_train_loader(cfg)
        super().__init__(cfg, loader, device=device)
        self.register_hooks(self.build_hooks())

    def build_writers(self):
        out = self.cfg.OUTPUT_DIR
        writers = [CommonMetricPrinter(self.cfg.SOLVER.MAX_ITER),
                   JSONWriter(os.path.join(out, "metrics.json"))]
        try:
            writers.append(TensorboardWriter(out))
        except ImportError:
            pass
        return writers

    def build_hooks(self):
        from ..solver.build import build_lr_schedule

        cfg = self.cfg
        return [
            IterationTimer(),
            LRSchedulerHook(cfg.SOLVER.LR_G, build_lr_schedule(cfg)),
            PeriodicCheckpointer(cfg.OUTPUT_DIR, cfg.SOLVER.CHECKPOINT_PERIOD),
            PeriodicWriter(self.build_writers()),
        ]
