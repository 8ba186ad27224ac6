"""The window's arithmetic on a fake clock."""

from lvtbench import window


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_whole_batches():
    clock = Clock()
    took = [4.0, 4.0, 4.0, 4.0]

    def batch(i):
        clock.t += took[i]

    w = window.run_batches(batch, 10.0, clock)
    # the third batch is the first to end after 10 s: it counts, whole
    assert (w.units, w.seconds, w.ends) == (3, 12.0, [104.0, 108.0, 112.0])


def test_one_long_batch_is_the_window():
    clock = Clock()

    def batch(i):
        clock.t += 25.0

    w = window.run_batches(batch, 10.0, clock)
    assert (w.units, w.seconds) == (1, 25.0)


def test_every_issued_step_counts_and_the_sync_is_timed():
    clock = Clock()
    issued = []

    def step(i):
        issued.append(i)
        clock.t += 0.3

    def sync():
        clock.t += 2.0  # the queue drains after the last issue

    w = window.run_steps(step, sync, 1.0, clock)
    assert issued == [0, 1, 2, 3] and w.units == 4
    assert abs(w.seconds - (4 * 0.3 + 2.0)) < 1e-9
