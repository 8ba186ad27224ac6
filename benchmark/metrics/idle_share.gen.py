"""The device's idle share of the window (layer: device): 1 - the device's
busy time a batch over the window's time a batch. The busy time is the
union of the device's activity intervals in the traced batch (encode,
rollout, decode), which the profiler leaves as they are; the time a batch is
the unprofiled window's (its seconds over its batches), since the profiler
slows the host and would lengthen the traced batch's gaps."""

from lvtbench import timeline


def read(r):
    w = r.layer.get("window")
    if r.timeline is None or w is None or not w.units:
        return None
    return 100.0 * (1.0 - timeline.busy_seconds(r.timeline) / (w.seconds / w.units))
