"""The device's idle share of the window (layer: device): 1 - the device's
busy time a step over the window's time a step. The busy time is the union
of the device's activity intervals over the traced steps (each run_step
and after_step), which the profiler leaves as they are; the time a step is
the unprofiled window's (its seconds over its steps), since the profiler
slows the host and would lengthen the traced steps' gaps."""

from lvtbench import timeline


def read(r):
    w = r.layer.get("window")
    if r.timeline is None or w is None or not w.units:
        return None
    busy = timeline.busy_seconds(r.timeline) / r.stretch["steps"]
    return 100.0 * (1.0 - busy / (w.seconds / w.units))
