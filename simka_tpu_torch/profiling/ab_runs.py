"""Two checkouts of the port, run in turns on one card.

    python -m simka_tpu_torch.profiling.ab_runs --a DIR --b DIR

Writes the full-size community of ``chip_smoke.py`` (8 samples x
500,000 reads x 100 bp of 20 genomes, seed 0) once, then, in the order
A B B A A B, starts one process in each checkout which runs
``python -m simka_tpu_torch.cli`` once on a small community (CUDA
context, kernel build) and then 3 times on the full one (k=21,
abundance-min 2, default distances): the first full-size run finds the
allocator's cache holding only small blocks, as ``chip_smoke.py``'s
first full-size run does, the other two warm. Prints each run's
wall-clock, stage times and peak device memory, and per checkout the
medians of first and of later runs, after the card's name and power
limit. Comparing two versions inside one call, in turns, keeps the card
and the host's load the same for both.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

ORDER = "ABBAAB"
RUNS = 3  # full-size runs per process: one first, two later

_RUN = r"""
import json, sys, time, torch
from simka_tpu_torch.cli import main
argv, small, runs = json.loads(sys.argv[1]), json.loads(sys.argv[2]), int(sys.argv[3])
if main(small) != 0:
    raise SystemExit("warm-up run failed")
for i in range(runs):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if main(argv) != 0:
        raise SystemExit("run failed")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = argv[argv.index("-out") + 1]
    with open(out + "/simka_metrics.json") as f:
        c = json.load(f)["counters"]
    print(("FIRST " if i == 0 else "RUN ") + json.dumps({
        "wall_s": wall, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        **{k: v for k, v in c.items() if k.startswith("stage_")}}), flush=True)
"""

KEYS = ("wall_s", "stage_parse_pack_s", "stage_extract_dispatch_s",
        "stage_join_s", "peak_gib")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", required=True)
    ap.add_argument("--b", required=True)
    args = ap.parse_args(argv)
    from simka_tpu_torch.utils.community import (FULL_COMMUNITY,
                                                 write_community)

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    trees = {"A": os.path.abspath(args.a), "B": os.path.abspath(args.b)}
    runs = {"A": [], "B": []}
    firsts = {"A": [], "B": []}  # each process's first run (cold)
    with tempfile.TemporaryDirectory(prefix="ab_runs_") as tmp:
        inp = write_community(os.path.join(tmp, "full"), seed=0,
                              **FULL_COMMUNITY)
        small = write_community(
            os.path.join(tmp, "small"), seed=0, n_samples=4, n_genomes=5,
            genome_len=20_000, reads_per_sample=3_000, n_frac=0.01,
        )
        for i, side in enumerate(ORDER):
            cli = ["-in", inp, "-out", os.path.join(tmp, f"out{i}"),
                   "-kmer-size", "21", "-abundance-min", "2", "-verbose", "0",
                   "-device", "cuda"]
            small_cli = ["-in", small, "-out", os.path.join(tmp, f"small{i}"),
                         "-verbose", "0", "-device", "cuda"]
            proc = subprocess.run(
                [sys.executable, "-c", _RUN, json.dumps(cli),
                 json.dumps(small_cli), str(RUNS)],
                cwd=trees[side], capture_output=True, text=True, check=True,
            )
            for line in proc.stdout.splitlines():
                kind, _, rec = line.partition(" ")
                if kind in ("FIRST", "RUN"):
                    r = json.loads(rec)
                    (firsts if kind == "FIRST" else runs)[side].append(r)
                    print(f"{side} {kind.lower()} " + ", ".join(
                        f"{k} {r[k]:.4f}" for k in KEYS), flush=True)
    for side, rs in runs.items():
        for what, sample in (("first runs", firsts[side]), ("later runs", rs)):
            print(f"{side} ({trees[side]}) {what}, medians of {len(sample)}: "
                  + ", ".join(f"{k} {np.median([r[k] for r in sample]):.4f}"
                              for k in KEYS))
    return 0


if __name__ == "__main__":
    sys.exit(main())
