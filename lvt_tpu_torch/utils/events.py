"""EventStorage + metric writers (reference: vidgen/utils/events.py).

Same responsibilities: a per-training-run scalar/image store with smoothing
hints, drained by writers — terminal printer with ETA, line-delimited
``metrics.json`` (same schema as the reference JSONWriter), and TensorBoard via
``torch.utils.tensorboard`` when available.
"""

import datetime
import json
import logging
import os
from collections import defaultdict
from contextlib import contextmanager

import numpy as np

_CURRENT_STORAGE_STACK = []


def get_event_storage():
    assert _CURRENT_STORAGE_STACK, "get_event_storage() must be called inside a 'with EventStorage(...)' context"
    return _CURRENT_STORAGE_STACK[-1]


class HistoryBuffer:
    """Track a series of scalars with windowed median/mean (fvcore-equivalent)."""

    def __init__(self, max_length: int = 1000000):
        self._max_length = max_length
        self._data = []  # (value, iteration)
        self._count = 0
        self._global_avg = 0.0

    def update(self, value: float, iteration: float = None):
        if iteration is None:
            iteration = self._count
        if len(self._data) == self._max_length:
            self._data.pop(0)
        self._data.append((value, iteration))
        self._count += 1
        self._global_avg += (value - self._global_avg) / self._count

    def latest(self):
        return self._data[-1][0]

    def median(self, window_size: int):
        return float(np.median([x[0] for x in self._data[-window_size:]]))

    def avg(self, window_size: int):
        return float(np.mean([x[0] for x in self._data[-window_size:]]))

    def global_avg(self):
        return self._global_avg

    def values(self):
        return self._data


class EventStorage:
    """Scalar/image store scoped to the training loop (events.py:210-376)."""

    def __init__(self, start_iter=0):
        self._history = defaultdict(HistoryBuffer)
        self._smoothing_hints = {}
        self._latest_scalars = {}
        self._iter = start_iter
        self._vis_data = []

    def put_image(self, img_name, img_tensor):
        self._vis_data.append((img_name, np.asarray(img_tensor), self._iter))

    def clear_images(self):
        self._vis_data = []

    def put_scalar(self, name, value, smoothing_hint=True):
        name = getattr(self, "_current_prefix", "") + name
        value = float(value)
        self._history[name].update(value, self._iter)
        self._latest_scalars[name] = value
        existing_hint = self._smoothing_hints.get(name)
        if existing_hint is not None:
            assert existing_hint == smoothing_hint, f"Scalar {name} was put with inconsistent smoothing_hint"
        else:
            self._smoothing_hints[name] = smoothing_hint

    def put_scalars(self, *, smoothing_hint=True, **kwargs):
        for k, v in kwargs.items():
            self.put_scalar(k, v, smoothing_hint=smoothing_hint)

    def history(self, name):
        ret = self._history.get(name, None)
        if ret is None:
            raise KeyError(f"No history metric available for {name}!")
        return ret

    def histories(self):
        return self._history

    def latest(self):
        return self._latest_scalars

    def latest_with_smoothing_hint(self, window_size=20):
        result = {}
        for k, v in self._latest_scalars.items():
            result[k] = self._history[k].median(window_size) if self._smoothing_hints[k] else v
        return result

    def smoothing_hints(self):
        return self._smoothing_hints

    def step(self):
        self._iter += 1
        self._latest_scalars = {}

    @property
    def vis_data(self):
        return self._vis_data

    @property
    def iter(self):
        return self._iter

    @iter.setter
    def iter(self, val):
        self._iter = val

    @property
    def iteration(self):
        return self._iter

    def __enter__(self):
        _CURRENT_STORAGE_STACK.append(self)
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        assert _CURRENT_STORAGE_STACK[-1] == self
        _CURRENT_STORAGE_STACK.pop()

    @contextmanager
    def name_scope(self, name):
        old = getattr(self, "_current_prefix", "")
        self._current_prefix = old + name.rstrip("/") + "/"
        try:
            yield
        finally:  # an exception inside the scope must not leak the prefix
            self._current_prefix = old


class EventWriter:
    def write(self):
        raise NotImplementedError

    def close(self):
        pass


class JSONWriter(EventWriter):
    """Append latest scalars as one JSON object per line (events.py:40-108)."""

    def __init__(self, json_file, window_size=20):
        self._file_handle = open(json_file, "a")
        self._window_size = window_size

    def write(self):
        storage = get_event_storage()
        to_save = {"iteration": storage.iter}
        to_save.update(storage.latest_with_smoothing_hint(self._window_size))
        self._file_handle.write(json.dumps(to_save, sort_keys=True) + "\n")
        self._file_handle.flush()
        try:
            os.fsync(self._file_handle.fileno())
        except OSError:
            pass

    def close(self):
        self._file_handle.close()


class TensorboardWriter(EventWriter):
    """TensorBoard writer via torch.utils.tensorboard (events.py:111-141)."""

    def __init__(self, log_dir: str, window_size: int = 20, **kwargs):
        self._window_size = window_size
        from torch.utils.tensorboard import SummaryWriter

        self._writer = SummaryWriter(log_dir, **kwargs)

    def write(self):
        storage = get_event_storage()
        for k, v in storage.latest_with_smoothing_hint(self._window_size).items():
            self._writer.add_scalar(k, v, storage.iter)
        if len(storage.vis_data) >= 1:
            for img_name, img, step_num in storage.vis_data:
                self._writer.add_image(img_name, img, step_num)
            storage.clear_images()

    def close(self):
        if hasattr(self, "_writer"):
            self._writer.close()


class CommonMetricPrinter(EventWriter):
    """Terminal printer with ETA / losses / lr / s-per-iter (events.py:144-207)."""

    def __init__(self, max_iter):
        self.logger = logging.getLogger(__name__)
        self._max_iter = max_iter

    def write(self):
        storage = get_event_storage()
        iteration = storage.iter

        data_time, time_str, eta_string = None, "", "N/A"
        try:
            data_time = storage.history("data_time").avg(20)
        except KeyError:
            pass
        try:
            iter_time = storage.history("time").global_avg()
            eta_seconds = iter_time * (self._max_iter - iteration)
            eta_string = str(datetime.timedelta(seconds=int(eta_seconds)))
            time_str = f"time: {iter_time:.4f}"
        except KeyError:
            pass

        try:
            lr = "{:.6g}".format(storage.history("lr").latest())
        except KeyError:
            lr = "N/A"

        losses = "  ".join(
            f"{k}: {v.median(20):.3f}"
            for k, v in storage.histories().items()
            if "loss" in k
        )
        mem = _device_memory_mb()
        self.logger.info(
            f"eta: {eta_string}  iter: {iteration}  {losses}  {time_str}"
            + (f"  data_time: {data_time:.4f}" if data_time is not None else "")
            + f"  lr: {lr}"
            + (f"  max_mem: {mem:.0f}M" if mem is not None else "")
        )


def _device_memory_mb():
    """Peak CUDA memory of this process in MB (the reference logs CUDA
    max_mem, events.py:199-204); None without a CUDA card."""
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return torch.cuda.max_memory_allocated() / (1024.0 * 1024.0)
    return None
