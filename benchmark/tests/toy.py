"""A toy cell for the CPU tests: a bench directory holding the real
metrics, limits and traffic mixes and a small community's configuration."""

from __future__ import annotations

import json
import os
import shutil

from benchmark import registry

TOY = {
    "options": {"kmer_size": 21, "abundance_min": 2,
                "abundance_max": 999999999},
    "community": {"n_samples": 4, "elements": [[3, 3000], [2, 500]],
                  "lognormal_mu": 1.0, "lognormal_sigma": 2.0,
                  "reads_per_sample": 400, "read_len": 150, "n_frac": 0.01},
    "batch_reads": 256,
}
CELLS = ("toy.default_dist", "toy.all_dist")


def bench_dir(tmp_path) -> str:
    """A copy of the benchmark's metrics, limits and traffic mixes, with
    ``configs/toy.json``."""
    d = str(tmp_path / "bench")
    for sub in ("metrics", "limits", "traffic"):
        shutil.copytree(os.path.join(registry.BENCH_DIR, sub),
                        os.path.join(d, sub))
    os.makedirs(os.path.join(d, "configs"))
    with open(os.path.join(d, "configs", "toy.json"), "w") as f:
        json.dump(TOY, f)
    return d


def bench() -> dict:
    """BENCHMARK.json with the toy cells in place of its workloads."""
    spec = registry.spec()
    spec["workloads"] = [
        {"name": c, "config": "toy", "traffic": c.split(".")[1], "chips": 1}
        for c in CELLS]
    for m in spec["end_to_end"] + spec["per_layer"]:
        m.pop("workloads", None)
    return spec
