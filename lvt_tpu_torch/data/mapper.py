"""Per-sample transform: dataset dict -> model-ready numpy arrays
(counterpart of lvt_tpu/data/mapper.py; reference
vidgen/data/dataset_mapper.py:22-153), for latent-code videos: the dicts of
data/datasets/latents.py become (nc, T, h, w) int32 arrays under "video",
with a random temporal crop at train time and the head crop at test time.
The VT prepares its subscale slices from whole videos on the device
(models/vt.py:prepare_slices). Short videos return None and the loader
draws another sample. Image datasets (the VQ-VAE's) come with VQ-VAE
training.
"""

import os
import random
from typing import Optional

import numpy as np


class ShortVideoException(Exception):
    pass


class DatasetMapper:
    def __init__(self, cfg, is_train: bool = True):
        self.cfg = cfg
        self.is_train = is_train
        self.n_frames = (cfg.INPUT.N_FRAMES_PER_VIDEO_TRAIN if is_train
                         else cfg.INPUT.N_FRAMES_PER_VIDEO_TEST)
        assert self.n_frames > 0 or self.n_frames == -1

    def _start_end(self, n: int) -> slice:
        """Random temporal crop at train time, head crop at test
        (reference dataset_mapper.py:41-47)."""
        if self.n_frames != -1 and n < self.n_frames:
            raise ShortVideoException
        start = 0 if (self.n_frames == -1 or not self.is_train) else random.randint(0, n - self.n_frames)
        end = n if self.n_frames == -1 else start + self.n_frames
        return slice(start, end)

    def __call__(self, dataset_dict: dict) -> Optional[dict]:
        try:
            out = dict(dataset_dict)

            if "latent_names" in out:
                n = len(out["latent_names"])
                sel = self._start_end(n)
                paths = [os.path.join(out["video_root"], f)
                         for f in out["latent_names"][sel]]
                seq = np.stack([np.load(p) for p in paths], axis=0)
                if seq.ndim == 3:
                    seq = seq[:, None]
                out["video"] = np.ascontiguousarray(
                    seq.transpose(1, 0, 2, 3)).astype(np.int32)  # (nc, T, h, w)

            else:
                raise NotImplementedError(
                    f"DatasetMapper: only latent-code videos ('latent_names') are ported to "
                    f"lvt_tpu_torch yet, got a dict with keys {sorted(out)}")

            if "class" in out:
                out["class"] = np.int32(out["class"])
            return out
        except ShortVideoException:
            return None
