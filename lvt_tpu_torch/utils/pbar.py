"""Minimal terminal progress bar (reference: vidgen/utils/pbar.py:7-54)."""

import sys
import time


class ProgressBar:
    def __init__(self, total: int, width: int = 40, stream=None):
        self.total = max(total, 1)
        self.width = width
        self.stream = stream or sys.stderr
        self.n = 0
        self._start = time.perf_counter()

    def update(self, n: int = 1):
        self.n = min(self.n + n, self.total)
        frac = self.n / self.total
        filled = int(self.width * frac)
        elapsed = time.perf_counter() - self._start
        eta = elapsed / frac - elapsed if frac > 0 else 0
        self.stream.write(
            f"\r[{'#' * filled}{'-' * (self.width - filled)}] "
            f"{self.n}/{self.total} ({100 * frac:.0f}%) "
            f"elapsed {elapsed:.0f}s eta {eta:.0f}s")
        self.stream.flush()
        if self.n >= self.total:
            self.stream.write("\n")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.n < self.total:
            self.stream.write("\n")
