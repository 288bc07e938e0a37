"""Where the benchmark finds its parts, by name.

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration and a
traffic mix; each is a JSON file of its own, ``configs/<name>.json`` and
``traffic/<name>.json``, and each metric of ``end_to_end`` and
``per_layer`` is a reader of its own, ``metrics/<name>.py``, whose
``read(ctx)`` returns the metric's value or None. A later change adds a
configuration, a mix, a cell or a metric by adding files and entries;
nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from typing import Callable, List

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}\Z")


def _checked(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def spec(root: str = ROOT) -> dict:
    """``BENCHMARK.json`` at ``root``."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    """The ``workloads`` entry called ``name``; KeyError if none is."""
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _json(kind: str, name: str, bench_dir: str) -> dict:
    with open(os.path.join(bench_dir, kind, _checked(name) + ".json")) as f:
        return json.load(f)


def config(name: str, bench_dir: str = BENCH_DIR) -> dict:
    """``configs/<name>.json``."""
    return _json("configs", name, bench_dir)


def traffic(name: str, bench_dir: str = BENCH_DIR) -> dict:
    """``traffic/<name>.json``."""
    return _json("traffic", name, bench_dir)


def limits(cell_name: str, bench_dir: str = BENCH_DIR) -> dict:
    """The limits of the numbers a run is judged by:
    ``limits/default.json``, updated by ``limits/<cell>.json`` where a
    cell has one."""
    out = _json("limits", "default", bench_dir)
    own = os.path.join(bench_dir, "limits", _checked(cell_name) + ".json")
    if os.path.exists(own):
        with open(own) as f:
            out.update(json.load(f))
    return out


def reader(name: str, bench_dir: str = BENCH_DIR) -> Callable:
    """``read`` of ``metrics/<name>.py``."""
    path = os.path.join(bench_dir, "metrics", _checked(name) + ".py")
    mod_name = "benchmark_metric_" + re.sub(r"\W", "_", name)
    loader = importlib.util.spec_from_file_location(mod_name, path)
    if loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: dict, cell_name: str, kind: str) -> List[dict]:
    """The ``kind`` (``end_to_end`` or ``per_layer``) metrics that
    ``cell_name`` reports: those that list it under ``workloads``, and
    those with no such list."""
    return [m for m in bench[kind]
            if cell_name in m.get("workloads", [cell_name])]
