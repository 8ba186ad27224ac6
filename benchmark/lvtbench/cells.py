"""A cell's files, found by the names in ``BENCHMARK.json``:

* the configuration ``c``: the file its ``configs`` entry names
  (``benchmark/configs/<c>.json``);
* the traffic mix ``t``: ``benchmark/traffic/<t>.json``; its ``kind`` names
  the module ``benchmark/kinds/<kind>.py``;
* the cell ``w``'s limits of the correctness check:
  ``benchmark/limits/<w>.json``;
* a per-layer metric ``m``: its reader ``benchmark/metrics/<m>.py``;
* a kernel's or a whole step's count of bytes and operations ``k``:
  ``benchmark/kernels/<k>.py``.
"""

import importlib.util
import json
import os
import re
from typing import Dict, List, NamedTuple

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # benchmark/
REPO = os.path.dirname(HERE)  # the checkout's root


class Cell(NamedTuple):
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict
    end_to_end: List[Dict]  # the end-to-end metrics the cell reports
    per_layer: List[Dict]  # the per-layer metrics read in its traced runs


def read_json(path):
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str = REPO) -> Dict:
    return read_json(os.path.join(root, "BENCHMARK.json"))


def _applies(metric: Dict, cell: str, reported=None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric["moves"] in reported


def cell(bench: Dict, name: str, root: str = REPO) -> Cell:
    """The cell ``name`` of ``bench`` with its files read."""
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                       f"{[w['name'] for w in bench['workloads']]}")
    w = found[0]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    here = os.path.join(root, "benchmark")
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, reported)]
    return Cell(name, int(w["chips"]), read_json(os.path.join(root, conf["file"])),
                read_json(os.path.join(here, "traffic", w["traffic"] + ".json")),
                read_json(os.path.join(here, "limits", name + ".json")), e2e, per_layer)


def module(kind: str, name: str, root: str = REPO):
    """benchmark/<kind>/<name>.py, loaded under a module name of its own."""
    path = os.path.join(root, "benchmark", kind, name + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no file {path} for the name {name!r}")
    spec = importlib.util.spec_from_file_location(
        "lvtbench_" + kind + "_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
