"""BENCHMARK.json and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
The configuration's file is the entry's ``file``; a traffic mix is
``bench/traffic/<traffic>.json``; a per-layer metric is read by
``bench/metrics/<name>.py``. Nothing here knows a particular cell.
"""
from __future__ import annotations

import importlib.util
import json
import os
import re
from typing import Callable

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


class Bench:
    """BENCHMARK.json of a checkout, and what its entries name."""

    def __init__(self, root: str = ROOT):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.spec = json.load(f)
        self.bench_dir = os.path.join(root, "bench")

    # -- entries ------------------------------------------------------------
    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")

    def config_entry(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no config named {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        entry = self.config_entry(name)
        with open(os.path.join(self.root, entry["file"])) as f:
            cfg = json.load(f)
        cfg["_name"] = name
        return cfg

    def traffic(self, name: str) -> dict:
        with open(os.path.join(self.bench_dir, "traffic", f"{name}.json")) as f:
            t = json.load(f)
        t["_name"] = name
        return t

    def limits(self, cell: str) -> dict:
        """The limits of the numbers a cell's check compares
        (``bench/limits/<cell>.json``)."""
        with open(os.path.join(self.bench_dir, "limits",
                               f"{cell}.json")) as f:
            return json.load(f)

    def metrics_of(self, cell: dict, kind: str) -> list:
        """The ``end_to_end`` or ``per_layer`` metrics that ``cell`` reports:
        those that list it under ``workloads``, and those with no such key
        (every cell)."""
        return [m for m in self.spec[kind]
                if "workloads" not in m or cell["name"] in m["workloads"]]

    def reader(self, metric: str) -> Callable:
        """``read(run) -> float | None`` of ``bench/metrics/<metric>.py``."""
        return load_file(os.path.join(self.bench_dir, "metrics",
                                      f"{metric}.py")).read


def load_file(path: str):
    """A Python file loaded as a module of its own (named after its path,
    so two files never share a module)."""
    name = "bench_file_" + re.sub(r"\W", "_", os.path.relpath(path, ROOT))
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def family(cfg: dict):
    """The module that serves a configuration's ``family``: it builds the
    program's model from the file and counts its work
    (``benchkit/families/<family>.py``)."""
    return importlib.import_module(f"benchkit.families.{cfg['family']}")


def check_names(spec: dict) -> list:
    """Every name, unit and one-line text of a BENCHMARK.json against the
    characters the format allows; returns the faults found (empty when
    none)."""
    bad = []

    def name(x, what):
        if not isinstance(x, str) or not NAME_RE.match(x):
            bad.append(f"{what}: {x!r}")

    def line(x, what):
        if (not isinstance(x, str) or not 1 <= len(x) <= 200 or "\n" in x
                or "\t" in x):
            bad.append(f"{what}: {x!r}")

    for c in spec["configs"]:
        name(c["name"], "config name")
        line(c["source"], "config source")
        for k in c["reduced"]:
            name(k, "reduced key")
    for w in spec["workloads"]:
        name(w["name"], "workload name")
        name(w["config"], "workload config")
        name(w["traffic"], "workload traffic")
        line(w["why"], "workload why")
    for kind in ("end_to_end", "per_layer"):
        for m in spec[kind]:
            name(m["name"], f"{kind} name")
            if not UNIT_RE.match(m["unit"]):
                bad.append(f"unit: {m['unit']!r}")
            if m["better"] not in ("lower", "higher"):
                bad.append(f"better: {m['better']!r}")
            if m["source"] not in SOURCES:
                bad.append(f"source: {m['source']!r}")
            if kind == "per_layer":
                line(m["layer"], "layer")
    for word in spec["command"]:
        line(word, "command word")
    return bad
