"""Structured run metrics: per-stage wall clock + throughput counters.

The reference's observability is per-job log files and progress bars
(SURVEY.md §5); this is the structured replacement: every pipeline run
can emit a ``simka_metrics.json`` with stage timings, reads/s and
k-mers/s, suitable for dashboards or regression tracking.
"""

from __future__ import annotations

import json
import time
from typing import Dict, Optional


class StageTimer:
    def __init__(self, metrics: "Metrics", stage: str):
        self.metrics = metrics
        self.stage = stage

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.metrics.timings[self.stage] = self.metrics.timings.get(
            self.stage, 0.0
        ) + (time.perf_counter() - self.t0)
        return False


class Metrics:
    def __init__(self):
        self.timings: Dict[str, float] = {}
        self.counters: Dict[str, float] = {}
        self._t_start = time.perf_counter()

    def stage(self, name: str) -> StageTimer:
        return StageTimer(self, name)

    def count(self, name: str, value: float) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + value

    def set(self, name: str, value) -> None:
        self.counters[name] = value

    def finalize(self) -> Dict:
        total = time.perf_counter() - self._t_start
        out = {
            "total_seconds": round(total, 3),
            "stages": {k: round(v, 3) for k, v in self.timings.items()},
            "counters": self.counters,
        }
        reads = self.counters.get("reads", 0)
        kmers = self.counters.get("kmer_instances", 0)
        if reads and total:
            out["reads_per_sec"] = round(reads / total, 1)
        if kmers:
            t = self.timings.get("count", 0) + self.timings.get(
                "merge", 0
            )
            if t:
                out["kmers_per_sec"] = round(kmers / t, 1)
        return out

    def save(self, path: str) -> Dict:
        data = self.finalize()
        with open(path, "w") as f:
            json.dump(data, f, indent=2, sort_keys=True)
        return data
