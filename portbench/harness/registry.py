"""Finds the benchmark's parts by name, one file each, so a later change adds
a cell, a configuration, a traffic mix, a driver, a metric or a kernel
table by adding files and edits none:

  configs/<name>.json     a configuration's sizes (and its `reference`)
  workloads/<name>.json   a cell's driver and the limits of its check; its
                          configuration, traffic, chips, why and metrics
                          are its entries in BENCHMARK.json
  traffic/<name>.json     a traffic mix, read by harness/traffic.py
  drivers/<name>.py       the code that drives one kind of traffic
  metrics/<name>.py       a per-layer metric's reader; `idle_pct.gen` is
                          read by metrics/idle_pct.gen.py if it exists,
                          else by metrics/idle_pct.py
  kernels/<family>/*.json the device kernels of one family, by name
"""
from __future__ import annotations

import glob
import importlib.util
import json
import os

HOME = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def path(kind: str, name: str, ext: str = ".json") -> str:
    p = os.path.join(HOME, kind, name + ext)
    if not os.path.isfile(p):
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({p})")
    return p


def load(kind: str, name: str) -> dict:
    with open(path(kind, name)) as f:
        d = json.load(f)
    d["name"] = name  # a part is named by its file
    return d


def benchmark() -> dict:
    """BENCHMARK.json, beside portbench/ at the checkout's root."""
    with open(os.path.join(os.path.dirname(HOME), "BENCHMARK.json")) as f:
        return json.load(f)


def cell(name: str) -> dict:
    """A cell: its BENCHMARK.json entry (config, traffic, chips, why), the
    names of the metrics BENCHMARK.json gives it (a metric without a
    `workloads` list belongs to every cell), and workloads/<name>.json
    (driver, check)."""
    b = benchmark()
    entry = [w for w in b["workloads"] if w["name"] == name]
    if not entry:
        raise KeyError(f"BENCHMARK.json has no cell named {name!r}")
    c = dict(entry[0], **load("workloads", name))
    for kind in ("end_to_end", "per_layer"):
        c[kind] = [m["name"] for m in b[kind] if name in m.get("workloads", [name])]
    return c


def _module(kind: str, stem: str):
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{stem.replace('.', '_')}", path(kind, stem, ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    return _module("drivers", name)


def metric(name: str):
    """The reader of a per-layer metric: its own file, else its family's."""
    if os.path.isfile(os.path.join(HOME, "metrics", name + ".py")):
        return _module("metrics", name)
    return _module("metrics", name.split(".", 1)[0])


def kernel_patterns(family: str) -> list:
    """The regular expressions of every file of kernels/<family>/."""
    files = sorted(glob.glob(os.path.join(HOME, "kernels", family, "*.json")))
    if not files:
        raise FileNotFoundError(f"no kernel table for family {family!r}")
    out = []
    for p in files:
        with open(p) as f:
            out += json.load(f)["kernels"]
    return out
