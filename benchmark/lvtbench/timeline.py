"""Reading the profiler's trace of the traced stretch.

The stretch runs inside the benchmark's spans (``torch.profiler.
record_function`` ranges named ``SPAN_PREFIX + name``; the outermost is
``stretch``), each ended by a synchronization, under ``torch.profiler`` with
CPU and CUDA activities. The device's activities (kernels, copies, sets)
and the spans come from the profiler's raw records
(``prof.profiler.kineto_results.events()``), on one clock.

* busy: the union of the device's activity intervals, so that activities
  that overlap on several streams count once (``chip_smoke.py``
  ``_busy_profile``'s arithmetic);
* idle gaps: the stretch's time outside that union, each named by the
  innermost benchmark span open at its midpoint;
* activities by name: how many of each the trace holds (``_profiled``'s
  count of one profile).
"""

from typing import Dict, Iterable, List, NamedTuple, Tuple

SPAN_PREFIX = "lvtbench."
STRETCH = "stretch"


class Trace(NamedTuple):
    device: List[Tuple[str, int, int]]  # (name, start ns, end ns)
    spans: List[Tuple[str, int, int]]  # the benchmark's spans, prefix removed
    start: int  # the stretch, ns
    end: int

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9


def from_profile(prof) -> Trace:
    """The trace of a ``torch.profiler.profile`` whose run holds one
    ``stretch`` span."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, spans, host_names = [], [], set()
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cuda:
            if not _annotation(e):
                device.append((name, e.start_ns(), e.start_ns() + e.duration_ns()))
            continue
        host_names.add(name)
        if name.startswith(SPAN_PREFIX):
            spans.append((name[len(SPAN_PREFIX):], e.start_ns(), e.start_ns() + e.duration_ns()))
    # a host range (record_function) also shows as a device "annotation"
    # under its own name; no kernel, copy or set is named as a host event
    device = [d for d in device if d[0] not in host_names]
    stretch = [s for s in spans if s[0] == STRETCH]
    if len(stretch) != 1:
        raise RuntimeError(f"the profile holds {len(stretch)} '{STRETCH}' spans, not one")
    return Trace(sorted(device, key=lambda d: d[1]), spans, stretch[0][1], stretch[0][2])


def _annotation(e) -> bool:
    """Whether a device record is a range annotation, where this version of
    the profiler says so."""
    if getattr(e, "is_user_annotation", None) is not None and e.is_user_annotation():
        return True
    return getattr(e, "activity_type", None) is not None and "annotation" in e.activity_type()


def merged(intervals: Iterable[Tuple[int, int]], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The union of the intervals, clipped to [lo, hi], as disjoint sorted
    intervals."""
    out = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if a >= b:
            continue
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def busy_seconds(trace: Trace) -> float:
    return sum(b - a for a, b in merged(((s, e) for _, s, e in trace.device),
                                        trace.start, trace.end)) / 1e9


def idle_gaps(trace: Trace) -> List[Tuple[int, int]]:
    """The stretch's intervals in which no device activity runs."""
    gaps, t = [], trace.start
    for a, b in merged(((s, e) for _, s, e in trace.device), trace.start, trace.end):
        if a > t:
            gaps.append((t, a))
        t = b
    if trace.end > t:
        gaps.append((t, trace.end))
    return gaps


def span_at(trace: Trace, t: int) -> str:
    """The innermost benchmark span open at t (the shortest that holds it)."""
    best = None
    for name, a, b in trace.spans:
        if a <= t < b and (best is None or b - a < best[1]):
            best = (name, b - a)
    return best[0] if best else "outside"


def named_gaps(trace: Trace, most: int = 10) -> List[List]:
    """[[span name, idle seconds]]: each span's idle time in all, largest
    first, then the longest single gaps, ``most`` entries at the most."""
    gaps = idle_gaps(trace)
    total: Dict[str, int] = {}
    named = []
    for a, b in gaps:
        name = span_at(trace, (a + b) // 2)
        total[name] = total.get(name, 0) + (b - a)
        named.append((name, b - a))
    out = [[f"{n} (all gaps)", ns / 1e9] for n, ns in sorted(total.items(), key=lambda kv: -kv[1])]
    out += [[f"{n} (one gap)", ns / 1e9] for n, ns in sorted(named, key=lambda x: -x[1])]
    return out[:most]


def device_ops(trace: Trace, most: int = 10, width: int = 160) -> List[List]:
    """[[device function, seconds]]: the functions with the most device time
    in the stretch, names cut to ``width`` characters."""
    total: Dict[str, int] = {}
    for name, a, b in trace.device:
        total[name] = total.get(name, 0) + (b - a)
    top = sorted(total.items(), key=lambda kv: -kv[1])[:most]
    return [[n[:width], ns / 1e9] for n, ns in top]


def seconds_of(trace: Trace, keys: Iterable[str]) -> Tuple[float, int]:
    """(device seconds, activities) of the device functions whose name holds
    one of ``keys``."""
    keys = tuple(keys)
    hits = [(a, b) for name, a, b in trace.device if any(k in name for k in keys)]
    return sum(b - a for a, b in hits) / 1e9, len(hits)


def activities_after(trace: Trace, t: int) -> int:
    """Device activities that start at or after t."""
    return sum(1 for _, a, _ in trace.device if a >= t)


def span(trace: Trace, name: str) -> List[Tuple[int, int]]:
    return [(a, b) for n, a, b in trace.spans if n == name]
