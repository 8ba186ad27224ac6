"""The measured window, on a clock the caller gives (the tests give a fake
one).

* Whole batches (generation): the window begins when the first timed batch
  starts and ends when the first batch that ends after ``seconds`` ends;
  every batch in it counts, and only whole batches.
* Steps (training): steps are issued until ``seconds`` has passed, then the
  device is synchronized; every step issued counts, and the time runs to the
  synchronization.
"""

import time
from typing import Callable, List, NamedTuple


class Window(NamedTuple):
    start: float
    end: float
    units: int  # batches or steps in the window
    ends: List[float]  # each batch's end (batches only)

    @property
    def seconds(self) -> float:
        return self.end - self.start


def run_batches(do_batch: Callable[[int], None], seconds: float,
                clock: Callable[[], float] = time.perf_counter) -> Window:
    """do_batch(i) runs batch i to its end (synchronized)."""
    start = clock()
    ends = []
    while True:
        do_batch(len(ends))
        ends.append(clock())
        if ends[-1] - start >= seconds:
            return Window(start, ends[-1], len(ends), ends)


def run_steps(do_step: Callable[[int], None], sync: Callable[[], None], seconds: float,
              clock: Callable[[], float] = time.perf_counter) -> Window:
    """do_step(i) issues step i; sync() waits for the device."""
    start = clock()
    n = 0
    while clock() - start < seconds:
        do_step(n)
        n += 1
    sync()
    return Window(start, clock(), n, [])
