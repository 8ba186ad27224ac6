"""Evaluator harness (counterpart of lvt_tpu/evaluation/evaluator.py;
reference vidgen/evaluation/evaluator.py:14-180).

``inference_on_dataset`` drives an inference callable over a test loader:
warm-up-aware timing (the first batches, which build kernels and capture the
rollout's graph, excluded), pure-compute vs wall split, ETA logging. The
card runs asynchronously, so the clock is read only after the card has
finished what the batch launched: a pure-compute time is the batch's device
work, not its launch time.
"""

import datetime
import logging
import time
from collections import OrderedDict
from typing import Callable, List, Optional

import torch

logger = logging.getLogger(__name__)


class DatasetEvaluator:
    """reset / process(inputs, outputs) / evaluate lifecycle."""

    def reset(self):
        pass

    def process(self, inputs: List[dict], outputs: List[dict]):
        pass

    def evaluate(self) -> Optional[dict]:
        pass


class DatasetEvaluators(DatasetEvaluator):
    """Composite fan-out (reference evaluator.py:58-82)."""

    def __init__(self, evaluators: List[DatasetEvaluator]):
        self._evaluators = evaluators

    def reset(self):
        for e in self._evaluators:
            e.reset()

    def process(self, inputs, outputs):
        for e in self._evaluators:
            e.process(inputs, outputs)

    def evaluate(self):
        results = OrderedDict()
        for e in self._evaluators:
            r = e.evaluate()
            if r is not None:
                for k, v in r.items():
                    assert k not in results, f"Duplicate evaluation key {k}"
                    results[k] = v
        return results


def _clock() -> float:
    """Host seconds, read after the card (where one is in use) has finished
    the work launched so far."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return time.perf_counter()


def inference_on_dataset(infer_fn: Callable[[dict], List[dict]], data_loader,
                         evaluator: DatasetEvaluator) -> dict:
    """Run infer_fn over every batch; feed (inputs, outputs) pairs to the
    evaluator. infer_fn maps a collated batch dict to a list of per-sample
    output dicts (host numpy).
    """
    try:
        total = len(data_loader)
    except TypeError:
        total = None
    logger.info(f"Start inference on {total if total is not None else '?'} batches")

    num_warmup = 5 if total is None else min(5, max(total - 1, 1))
    evaluator.reset()

    start_time = 0.0
    total_compute_time = 0.0
    idx = -1
    for idx, batch in enumerate(data_loader):
        if idx == num_warmup:
            start_time = _clock()
            total_compute_time = 0.0

        t0 = _clock()
        outputs = infer_fn(batch)
        total_compute_time += _clock() - t0

        inputs = _uncollate(batch)
        evaluator.process(inputs, outputs)

        if total is not None and (idx + 1) % 50 == 0 and idx >= num_warmup:
            seconds_per_batch = (_clock() - start_time) / (idx + 1 - num_warmup)
            eta = datetime.timedelta(seconds=int(seconds_per_batch * (total - idx - 1)))
            logger.info(f"Inference done {idx + 1}/{total}. "
                        f"{seconds_per_batch:.4f} s / batch. ETA={eta}")

    n_done = idx + 1
    if n_done > num_warmup and start_time:
        total_time = _clock() - start_time
        logger.info(
            "Total inference time: {} ({:.6f} s / batch per device)".format(
                datetime.timedelta(seconds=int(total_time)),
                total_time / (n_done - num_warmup)))
        logger.info(
            "Total inference pure compute time: {} ({:.6f} s / batch per device)".format(
                datetime.timedelta(seconds=int(total_compute_time)),
                total_compute_time / (n_done - num_warmup)))

    results = evaluator.evaluate()
    return results if results is not None else {}


def _uncollate(batch: dict) -> List[dict]:
    """Invert data.build.collate: dict of stacked arrays/lists -> per-sample
    dicts (evaluators speak the reference's list-of-dicts protocol)."""
    n = None
    for v in batch.values():
        n = len(v)
        break
    return [{k: v[i] for k, v in batch.items()} for i in range(n)]
