"""Latent code dumper — the stage-1 -> stage-2 bridge
(reference: vidgen/evaluation/codes_extractor.py:14-62).

Directory layout preserved exactly so latent datasets are drop-in:
<output_dir>/<dataset>/[<class name>/]video_<idx>/<frame>.npy, each frame an
(nc, h, w) int array.
"""

import logging
import os
from collections import OrderedDict

import numpy as np

from ..utils import comm
from ..utils.labels import KINETICS_IDX_LABEL
from .evaluator import DatasetEvaluator

logger = logging.getLogger(__name__)


class CodesExtractor(DatasetEvaluator):
    def __init__(self, dataset_name, distributed=True, output_dir=None):
        self._dataset_name = dataset_name
        self._distributed = distributed
        self._output_dir = output_dir

    def process(self, inputs, outputs):
        for inp, out in zip(inputs, outputs):
            latent = np.asarray(out["latent"])  # (T, nc, h, w) or (T, h, w)
            if latent.ndim == 3:
                latent = latent[:, None]
            v_idx = inp["video_idx"]
            if "class" in inp:
                class_name = KINETICS_IDX_LABEL[int(inp["class"])]
                video_dir = os.path.join(self._output_dir, self._dataset_name,
                                         class_name, f"video_{v_idx}")
            else:
                video_dir = os.path.join(self._output_dir, self._dataset_name,
                                         f"video_{v_idx}")
            os.makedirs(video_dir, exist_ok=True)
            for frame_idx in range(latent.shape[0]):
                np.save(os.path.join(video_dir, f"{frame_idx}.npy"),
                        latent[frame_idx])

    def evaluate(self):
        if self._distributed:
            comm.synchronize()
            if not comm.is_main_process():
                return None
        return OrderedDict({"latents": {}})
