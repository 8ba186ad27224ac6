#!/usr/bin/env python
"""Summarize a torch.profiler chrome trace: per-op self-time on the card;
the counterpart of tools/trace_summary.py (which reads jax.profiler's).

Usage:
  python tools/trace_summary_torch.py <trace.json[.gz] or a directory> [--top 30] [--like gemm]
  python tools/trace_summary_torch.py <trace> --lanes host     # the host's operator lanes

A directory stands for the newest ``*.json`` / ``*.json.gz`` under it (as
``TorchProfiler`` and ``prof.export_chrome_trace`` write them). The tool
keeps the complete events ('X') of the device lanes (the processes named
"GPU ..." and any process carrying kernel, memcpy or memset events),
subtracts nested child time by per-thread timestamp containment (a
``record_function`` span mirrored onto a stream holds the kernels it
launched), and prints self-time per name, grouped by the name with a
trailing ``.N`` index stripped. ``--lanes host`` summarizes the other
processes instead (operators, annotations): a trace of a CPU run has only
those.
"""

import argparse
import collections
import glob
import gzip
import json
import os
import re
import sys

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_path(path):
    """``path`` itself, or the newest .json / .json.gz under the directory."""
    if not os.path.isdir(path):
        return path
    paths = [p for pat in ("*.json", "*.json.gz")
             for p in glob.glob(os.path.join(path, "**", pat), recursive=True)]
    if not paths:
        sys.exit(f"no .json or .json.gz trace under {path}")
    return max(paths, key=os.path.getmtime)


def load_events(path):
    path = trace_path(path)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def device_lane_pids(events):
    """pids of the card's lanes: named "GPU ..." by a process_name record,
    or carrying kernel / memcpy / memset events."""
    pids = set()
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            if str(e.get("args", {}).get("name", "")).startswith("GPU"):
                pids.add(e["pid"])
        elif e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            pids.add(e["pid"])
    return pids


def self_times(events, pids):
    """(name, dur, self_dur) per complete event on the lanes ``pids``, with
    child time removed by per-thread timestamp containment."""
    rows = [e for e in events
            if e.get("ph") == "X" and e.get("pid") in pids and "ts" in e and "dur" in e]
    out = []
    bythread = collections.defaultdict(list)
    for e in rows:
        bythread[(e["pid"], e.get("tid"))].append(e)
    for evs in bythread.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack = []
        child = collections.defaultdict(float)
        for e in evs:
            while stack and stack[-1]["ts"] + stack[-1]["dur"] <= e["ts"]:
                done = stack.pop()
                out.append((done["name"], done["dur"], done["dur"] - child.pop(id(done), 0.0)))
            if stack:
                child[id(stack[-1])] += e["dur"]
            stack.append(e)
        while stack:
            done = stack.pop()
            out.append((done["name"], done["dur"], done["dur"] - child.pop(id(done), 0.0)))
    return out


def summarize(events, lanes="device", like=""):
    """{name with its trailing index stripped: [self us, count]} and the
    total self us, over the chosen lanes (names containing ``like``)."""
    device = device_lane_pids(events)
    if lanes == "device":
        pids = device
    else:
        pids = {e["pid"] for e in events if e.get("ph") == "X" and "pid" in e} - device
    if not pids:
        sys.exit(f"no {lanes} lanes found in the trace")
    strip = re.compile(r"\.\d+$")
    agg = collections.defaultdict(lambda: [0.0, 0])  # us, count
    total = 0.0
    for name, _, self_dur in self_times(events, pids):
        key = strip.sub("", name)
        if like and like not in key:
            continue
        agg[key][0] += self_dur
        agg[key][1] += 1
        total += self_dur
    return dict(agg), total


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("trace", help="a chrome trace (.json or .json.gz) or a directory holding them")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--like", default="", help="only ops whose name matches")
    ap.add_argument("--lanes", default="device", choices=["device", "host"])
    args = ap.parse_args(argv)

    agg, total = summarize(load_events(args.trace), args.lanes, args.like)
    print(f"{'self ms':>10} {'count':>7}  op")
    for key, (us, n) in sorted(agg.items(), key=lambda kv: -kv[1][0])[:args.top]:
        print(f"{us / 1000:>10.3f} {n:>7}  {key}")
    print(f"{total / 1000:>10.3f} {'':>7}  TOTAL (self, {args.lanes} lanes)")
    return agg, total


if __name__ == "__main__":
    main()
