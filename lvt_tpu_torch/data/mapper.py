"""Per-sample transform: dataset dict -> model-ready numpy arrays
(counterpart of lvt_tpu/data/mapper.py; reference
vidgen/data/dataset_mapper.py:22-153).

* images and frame sequences come out channels-last, (H, W, C) and
  (T, H, W, C) float32, divided by 255 when INPUT.SCALE_TO_ZEROONE; RGB PNG
  frames on disk are decoded by the native library (``native.read_png_rgb``,
  the same pixels as PIL), other frames with PIL (``utils/image.read_image``);
* latent code videos come out as (nc, T, h, w) int32 under "video", a
  video's .npy files read in one native call
  (``native.load_npy_sequence_i32``; numpy where it cannot): the VT prepares
  its subscale slices from whole videos on the device
  (models/vt.py:prepare_slices);
* a random temporal crop at train time, the head crop at test time; short
  videos return None and the loader draws another sample.
"""

import os
import random
from typing import Optional

import numpy as np

from .. import native
from ..utils import image as image_utils


def _read_frame(path: str, img_format: str) -> np.ndarray:
    """PNG fast path through the native decoder (bit-equal to PIL for the
    formats the converters write); PIL otherwise."""
    if img_format == "RGB" and path.endswith(".png"):
        arr = native.read_png_rgb(path)
        if arr is not None:
            return arr
    return image_utils.read_image(path, img_format)


def _load_latents(paths) -> np.ndarray:
    """A video's latent files -> (T, ...) int32, in one native call where
    it can (int32 or int64 files of one shape), else numpy."""
    first = np.load(paths[0])
    seq = native.load_npy_sequence_i32(paths, first.shape)
    if seq is None:
        seq = np.stack([first] + [np.load(p) for p in paths[1:]], axis=0)
    return seq


class ShortVideoException(Exception):
    pass


class DatasetMapper:
    def __init__(self, cfg, is_train: bool = True):
        self.cfg = cfg
        self.is_train = is_train
        self.img_format = cfg.INPUT.FORMAT
        self.n_frames = (cfg.INPUT.N_FRAMES_PER_VIDEO_TRAIN if is_train
                         else cfg.INPUT.N_FRAMES_PER_VIDEO_TEST)
        self.scale_zeroone = cfg.INPUT.SCALE_TO_ZEROONE
        self.is_vt = cfg.MODEL.META_ARCHITECTURE == "VideoTransformerModel"
        assert self.n_frames > 0 or self.n_frames == -1

    def _start_end(self, n: int) -> slice:
        """Random temporal crop at train time, head crop at test
        (reference dataset_mapper.py:41-47)."""
        if self.n_frames != -1 and n < self.n_frames:
            raise ShortVideoException
        start = 0 if (self.n_frames == -1 or not self.is_train) else random.randint(0, n - self.n_frames)
        end = n if self.n_frames == -1 else start + self.n_frames
        return slice(start, end)

    def _scaled(self, frames) -> np.ndarray:
        frames = np.asarray(frames).astype(np.float32)
        if self.scale_zeroone:
            frames /= 255.0
        return frames

    @staticmethod
    def _code_video(seq) -> np.ndarray:
        """(T, [nc,] h, w) codes -> (nc, T, h, w) int32."""
        if seq.ndim == 3:
            seq = seq[:, None]
        return np.ascontiguousarray(seq.transpose(1, 0, 2, 3)).astype(np.int32)

    def __call__(self, dataset_dict: dict) -> Optional[dict]:
        try:
            out = dict(dataset_dict)

            if "image" in out:
                # raw array handed in directly (reference dataset_mapper.py:63-66)
                out["image"] = self._scaled(out["image"])

            elif "latent_names" in out:
                sel = self._start_end(len(out["latent_names"]))
                paths = [os.path.join(out["video_root"], f)
                         for f in out["latent_names"][sel]]
                out["video"] = self._code_video(_load_latents(paths))

            elif "image_path" in out:
                out["image"] = self._scaled(
                    _read_frame(out["image_path"], self.img_format))  # (H, W, C)

            elif "image_names" in out:
                sel = self._start_end(len(out["image_names"]))
                frames = [_read_frame(os.path.join(out["video_root"], f), self.img_format)
                          for f in out["image_names"][sel]]
                out["image_sequence"] = self._scaled(np.stack(frames, axis=0))  # (T, H, W, C)

            elif "image_sequence" in out:
                n = len(out["image_sequence"])
                seq = np.asarray(out["image_sequence"])[self._start_end(n)]
                if self.is_vt:
                    # pre-extracted codes handed in directly (generation
                    # path); they are not frames, so the key goes
                    out["video"] = self._code_video(seq)
                    del out["image_sequence"]
                else:
                    out["image_sequence"] = self._scaled(seq)

            if "class" in out:
                out["class"] = np.int32(out["class"])
            return out
        except ShortVideoException:
            return None
