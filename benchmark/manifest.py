"""``BENCHMARK.json`` and the files it names: a cell's configuration,
traffic mix and limits, and the reader of each metric, all found by
name, so that a configuration, a mix or a metric is added by adding
files and entries."""
from __future__ import annotations

import importlib
import json
import os
import re
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def cell(doc: dict, name: str) -> dict:
    for w in doc["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(doc: dict, name: str, root: str = ROOT) -> dict:
    for c in doc["configs"]:
        if c["name"] == name:
            return _json(os.path.join(root, c["file"]))
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return _json(os.path.join(HERE, "traffic", f"{name}.json"))


def kind(tr: dict):
    """The module of the mix's traffic kind, ``traffic/<kind>.py``."""
    return importlib.import_module("benchmark.traffic." + tr["kind"])


def limits(cell_name: str) -> dict:
    return _json(os.path.join(HERE, "limits", f"{cell_name}.json"))


def metrics_of(doc: dict, cell_name: str, traced: bool) -> List[dict]:
    """The cell's end-to-end metrics (untraced) or per-layer metrics
    (traced): those without a ``workloads`` key, and those that list
    the cell."""
    group = doc["per_layer"] if traced else doc["end_to_end"]
    return [m for m in group if cell_name in m.get("workloads",
                                                   [cell_name])]


def reader(metric_name: str):
    """The ``read(record)`` function of ``metrics/<name>.py``, each '.'
    of the metric's name written '_'."""
    mod = importlib.import_module(
        "benchmark.metrics." + metric_name.replace(".", "_"))
    return mod.read


def problems(doc: dict) -> List[str]:
    """What in ``doc`` breaks the benchmark's rules on names, units and
    the metrics' ``moves``; empty when nothing does."""
    out = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in doc[group]]
        for n in names:
            if not NAME.match(n):
                out.append(f"{group}: bad name {n!r}")
        if len(set(names)) != len(names):
            out.append(f"{group}: a name repeats")
    metric_names = [m["name"] for m in doc["end_to_end"] + doc["per_layer"]]
    if len(set(metric_names)) != len(metric_names):
        out.append("a metric name repeats")
    for m in doc["end_to_end"] + doc["per_layer"]:
        if not UNIT.match(m["unit"]):
            out.append(f"{m['name']}: bad unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            out.append(f"{m['name']}: better is {m['better']!r}")
    cells = {w["name"]: w for w in doc["workloads"]}
    e2e = {m["name"]: m for m in doc["end_to_end"]}
    for w in doc["workloads"]:
        for key in ("config", "traffic"):
            if not NAME.match(w[key]):
                out.append(f"{w['name']}: bad {key} {w[key]!r}")
    for m in doc["per_layer"]:
        target = e2e.get(m.get("moves"))
        if target is None:
            out.append(f"{m['name']}: moves {m.get('moves')!r}, no "
                       "end-to-end metric")
            continue
        for c in m.get("workloads", list(cells)):
            if c not in cells:
                out.append(f"{m['name']}: no cell {c!r}")
            elif c not in target.get("workloads", [c]):
                out.append(f"{m['name']}: cell {c} does not report "
                           f"{target['name']}")
    for c in doc["configs"]:
        for k in c["reduced"]:
            if not NAME.match(k):
                out.append(f"{c['name']}: bad reduced key {k!r}")
    return out


def check_lines(numbers: Dict[str, float], lims: Dict[str, float]):
    """{name: {"value", "limit"}} for the result line."""
    return {k: {"value": numbers[k], "limit": lims[k]} for k in lims}
