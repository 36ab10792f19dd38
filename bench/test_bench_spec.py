"""BENCHMARK.json against the rules of its format (keys, names, units,
bounds), and every name it holds found in a file of its own."""
import json
import os
import re

import pytest

from benchkit import specs

ROOT = specs.ROOT
SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
WIDTH = re.compile(r"(_dim|_rank|_size|size|width|expand|heads?|"
                   r"num_experts_per_tok|d_model|d_state|headdim)$")


def test_top_level_keys_and_limits():
    assert set(SPEC) == TOP
    assert SPEC["command"][:2] == ["python3", "bench/run.py"]
    assert all(not p.startswith("/") and ".." not in p
               for p in SPEC["paths"])
    assert 1 <= SPEC["run_seconds"] <= 51
    n = len(SPEC["workloads"])
    # a full check of 24 cells fits its time: 2 + 14 runs a cell, each
    # allowed run_seconds + 60 s, 180 s a cell to compile, 1,200 s spare
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert 1 <= n <= 24
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, n // 4)


def test_names_units_and_lines():
    assert specs.check_names(SPEC) == []


def test_entry_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}


def test_reduced_names_no_width():
    for c in SPEC["configs"]:
        assert not [k for k in c["reduced"] if WIDTH.search(k)], c["name"]


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_found_by_name(cell):
    """A cell's configuration, mix, limits and metrics are files found by
    the names in BENCHMARK.json; it reports setup_s, another end-to-end
    metric and a per-layer one, and each per-layer metric the end-to-end
    metric it moves."""
    bench = specs.Bench(ROOT)
    w = bench.cell(cell)
    cfg = bench.config(w["config"])
    assert specs.family(cfg).build(cfg) is not None
    mix = bench.traffic(w["traffic"])
    assert os.path.exists(os.path.join(specs.BENCH_DIR, "benchkit", "loops",
                                       mix["loop"] + ".py"))
    assert bench.limits(cell)
    e2e = {m["name"] for m in bench.metrics_of(w, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = bench.metrics_of(w, "per_layer")
    assert layer
    for m in layer:
        assert m["moves"] in e2e, (cell, m["name"])
        assert callable(bench.reader(m["name"]))


def test_configs_used_and_files_distinct():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert len(set(files)) == len(files)
    assert all(f.startswith("bench/") for f in files)


def test_names_unique():
    for kind in ("configs", "workloads"):
        names = [x["name"] for x in SPEC[kind]]
        assert len(set(names)) == len(names)
    metrics = [m["name"] for k in ("end_to_end", "per_layer")
               for m in SPEC[k]]
    assert len(set(metrics)) == len(metrics)


def test_layers_match_metric_layers():
    layers = {}
    for m in SPEC["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_file_is_small():
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024
