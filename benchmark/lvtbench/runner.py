"""One run of one cell: the kind's module fills a ``Run``, and ``result``
turns it into the run's result line and the check's lines.

The kind (``benchmark/kinds/<kind>.py`` ``run(r)``) does the set-up and
calls ``r.setup_done()`` when the window is about to begin, runs the window,
sets ``r.attempted``, ``r.failed`` and its end-to-end numbers ``r.e2e``,
leaves what the per-layer readers need in ``r.layer`` (and a traced run's
profile through ``r.trace_of``), calls ``r.read_peak()`` once the window
and the traced stretch are over, frees the program's state and reports each
number of the correctness check through ``r.check``.
"""

import sys
import time
from typing import Dict, Optional

from . import cells, guard, timeline


class Run:
    def __init__(self, cell: cells.Cell, seed: int, seconds: float, trace: bool, device,
                 t0: float, rank: int = 0, world: int = 1):
        self.cell, self.seed, self.seconds, self.trace = cell, int(seed), float(seconds), trace
        self.device, self.t0, self.rank, self.world = device, t0, rank, world
        self.setup_s: Optional[float] = None
        self.attempted = 0
        self.failed = 0
        self.e2e: Dict[str, float] = {}
        self.layer: Dict = {}
        self.timeline: Optional[timeline.Trace] = None
        self.stretch: Dict = {}
        self.peak_bytes = 0
        self.numbers: Dict[str, float] = {}

    def log(self, msg: str) -> None:
        print(f"[{self.cell.name}] {msg}", file=sys.stderr, flush=True)

    def setup_done(self) -> None:
        self.setup_s = time.perf_counter() - self.t0

    def read_peak(self) -> None:
        import torch

        if self.device.type == "cuda":
            self.peak_bytes = int(torch.cuda.max_memory_allocated(self.device))

    def trace_of(self, prof, **stretch) -> None:
        self.timeline = timeline.from_profile(prof)
        self.stretch = stretch

    def check(self, name: str, value: float) -> None:
        self.numbers[name] = float(value)


def _device(r: Run) -> Dict:
    import torch

    if r.device.type == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(r.device), "count": r.world}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": r.world}
    dev["memory_peak_bytes"] = r.peak_bytes
    if r.trace and r.timeline is not None:
        dev["busy_s"] = timeline.busy_seconds(r.timeline)
        dev["window_s"] = r.timeline.seconds
    return dev


def checks_of(r: Run):
    """({name: {value, limit}}, all within their limits): every number the
    cell's limits file names, and any other the run reported (an unknown
    number, or one missing, is not correct)."""
    out, ok = {}, True
    for name, limit in r.cell.limits["limits"].items():
        value = r.numbers.get(name)
        out[name] = {"value": value, "limit": limit}
        ok = ok and value is not None and value <= limit
    for name, value in r.numbers.items():
        if name not in out:
            out[name] = {"value": value, "limit": None}
            ok = False
    return out, ok


def result(r: Run):
    """(the result's dict, the check's lines for standard error)."""
    metrics = {}
    if r.trace:
        for m in r.cell.per_layer:
            value = cells.module("metrics", m["name"]).read(r)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in r.cell.end_to_end:
            if m["name"] == "setup_s":
                value = r.setup_s
            elif m["name"] == "peak_mem_gib":
                value = r.peak_bytes / 2 ** 30 if r.peak_bytes else None
            else:
                value = r.e2e.get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    checks, ok = checks_of(r)
    out = {"correct": bool(ok and r.attempted > 0), "attempted": r.attempted, "failed": r.failed,
           "metrics": metrics, "device": _device(r)}
    if r.trace and r.timeline is not None:
        out["breakdown"] = {"device_ops": timeline.device_ops(r.timeline),
                            "idle_gaps": timeline.named_gaps(r.timeline)}
    out["checks"] = checks
    lines = [f"check {k}: {v['value']!r} (limit {v['limit']!r})" for k, v in checks.items()]
    return out, lines


def _build_seconds() -> float:
    lib = sys.modules.get("lvt_tpu_torch.ops._lib")
    return lib.LIBRARY.build_seconds if lib is not None else 0.0


def run_cell(cell: cells.Cell, seed: int, seconds: float, trace: bool, device, t0: float,
             rank: int = 0, world: int = 1):
    """The cell once in this process: (result dict, check lines, forbidden
    modules loaded here)."""
    if cells.REPO not in sys.path:  # the port, at the checkout's root
        sys.path.append(cells.REPO)
    r = Run(cell, seed, seconds, trace, device, t0, rank, world)
    built = _build_seconds()
    cells.module("kinds", cell.traffic["kind"]).run(r)
    if _build_seconds() != built:
        r.log(f"set-up built the port's kernels in {_build_seconds():.3f} s, which setup_s "
              "holds: the checkout's first run")
    out, lines = result(r)
    return out, lines, guard.forbidden_loaded()
