"""Scalar evaluators: reconstruction MSE and bits/dim
(reference: vidgen/evaluation/mse_evaluation.py, bits_evaluation.py)."""

import logging
from collections import OrderedDict

import numpy as np

from ..utils import comm
from .evaluator import DatasetEvaluator

logger = logging.getLogger(__name__)


class MSEEvaluator(DatasetEvaluator):
    """Sum of squared error / total pixels over reconstructions
    (reference mse_evaluation.py:12-55)."""

    def __init__(self, dataset_name, distributed=True, output_dir=None):
        self._dataset_name = dataset_name
        self._distributed = distributed
        self.reset()

    def reset(self):
        self._mse = 0.0
        self._n_pixels = 0

    def process(self, inputs, outputs):
        for inp, out in zip(inputs, outputs):
            target = inp.get("image", inp.get("image_sequence"))
            rec = np.asarray(out["reconstruction"], np.float64)
            target = np.asarray(target, np.float64)
            self._mse += float(((rec - target) ** 2).sum())
            self._n_pixels += int(np.prod(target.shape))

    def evaluate(self):
        mse, n = self._mse, self._n_pixels
        if self._distributed:
            comm.synchronize()
            mse = float(np.sum(comm.all_gather(mse)))
            n = int(np.sum(comm.all_gather(n)))
            if not comm.is_main_process():
                return None
        results = OrderedDict({"reconstruction": {"MSE": mse / max(n, 1)}})
        logger.info(results)
        return results


class BitsEvaluator(DatasetEvaluator):
    """bits/dim = CE / ln2 / n_pixels over teacher-forced whole-video logits,
    priming frames excluded (reference bits_evaluation.py:12-60)."""

    def __init__(self, dataset_name, distributed=True, output_dir=None):
        self._dataset_name = dataset_name
        self._distributed = distributed
        self.reset()

    def reset(self):
        self._ce = 0.0
        self._n_pixels = 0

    def process(self, inputs, outputs):
        for inp, out in zip(inputs, outputs):
            logits = np.asarray(out["logits"], np.float64)  # (T, H, W, nc, nv)
            video = np.asarray(inp["video"])  # (nc, T, H, W)
            ignore_t = np.asarray(out["ignore_t"])  # (T,) bool: prime frames
            target = np.transpose(video, (1, 2, 3, 0))  # (T, H, W, nc)

            # stable log-softmax CE
            m = logits.max(axis=-1, keepdims=True)
            lse = m[..., 0] + np.log(np.exp(logits - m).sum(axis=-1))
            picked = np.take_along_axis(logits, target[..., None], axis=-1)[..., 0]
            ce = lse - picked  # (T, H, W, nc)
            keep = ~ignore_t
            self._ce += float(ce[keep].sum())
            self._n_pixels += int(np.prod(ce[keep].shape))

    def evaluate(self):
        ce, n = self._ce, self._n_pixels
        if self._distributed:
            comm.synchronize()
            ce = float(np.sum(comm.all_gather(ce)))
            n = int(np.sum(comm.all_gather(n)))
            if not comm.is_main_process():
                return None
        results = OrderedDict(
            {"likelihood": {"bits_per_dim": (ce / np.log(2)) / max(n, 1)}})
        logger.info(results)
        return results
