"""Every name in BENCHMARK.json resolves to its file, and the file keeps the
shape BENCHMARK.json must keep (keys, names, units, bounds)."""

import os
import re

import pytest

from lvtbench import cells

BENCH = cells.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"][:2] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for p in BENCH["paths"]:
        assert os.path.isdir(os.path.join(cells.REPO, p))


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_resolves(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and len(w["why"]) <= 200
    c = cells.cell(BENCH, w["name"])
    assert c.config["name"] == w["config"]
    cells.module("kinds", c.traffic["kind"])
    assert c.limits["limits"] and all(v > 0 for v in c.limits["limits"].values())
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and c.per_layer


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_resolves(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    conf = cells.read_json(os.path.join(cells.REPO, c["file"]))
    assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"] == []
    assert c["file"].startswith("benchmark/")


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_resolves(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    names = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", names)) <= names
    if "bound" in m:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    else:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert hasattr(cells.module("metrics", m["name"]), "read")


@pytest.mark.parametrize("name", ["decode_attn", "fused_layer", "sample_step", "vt_train",
                                  "vqvae"])
def test_kernel_counts_resolve(name):
    cells.module("kernels", name)
