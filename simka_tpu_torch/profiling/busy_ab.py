"""Device busy time and idle share of two checkouts, in turns on one card.

    python -m simka_tpu_torch.profiling.busy_ab --a DIR --b DIR

Writes ``chip_smoke.py``'s full-size community of phase 7
(``FULL_COMMUNITY``, seed 0) and its wide-N community of phase 14
(``WIDE_COMMUNITY``) once, then, in the order A B B A, starts one
process in each checkout which profiles four ``simka`` runs with that
checkout's ``profiling/trace.py`` (a warm-up run, then one under
``torch.profiler``): phase 7's default and every-distance runs (k=21,
abundance-min 2) and the same two at N = 100. Prints, after the card's
name and power limit, each run's wall-clock, device busy time, idle
share, extraction-dispatch and join stages and its top device events,
then per checkout and run the medians of its two processes.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

ORDER = "ABBA"
KEYS = ("wall_s", "busy_s", "idle_share", "stage_parse_pack_s",
        "stage_extract_dispatch_s", "stage_join_s")

_RUN = r"""
import json, sys
from simka_tpu_torch.profiling.trace import profile_simka
for tag, argv in json.loads(sys.argv[1]):
    r = profile_simka(argv)
    print("REC " + json.dumps({
        "tag": tag, "wall_s": r["wall_s"], "busy_s": r["busy_s"],
        "idle_share": r["idle_share"], **r["stages"],
        "top": [[t, c, name[:60]] for t, c, name in r["top"][:6]]}),
        flush=True)
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", required=True)
    ap.add_argument("--b", required=True)
    args = ap.parse_args(argv)
    from simka_tpu_torch.utils.community import (FULL_COMMUNITY,
                                                 WIDE_COMMUNITY,
                                                 write_community)

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    trees = {"A": os.path.abspath(args.a), "B": os.path.abspath(args.b)}
    recs = {"A": {}, "B": {}}
    with tempfile.TemporaryDirectory(prefix="busy_ab_") as tmp:
        inputs = {name: write_community(os.path.join(tmp, name), seed=0,
                                        **community)
                  for name, community in (("full", FULL_COMMUNITY),
                                          ("wide", WIDE_COMMUNITY))}
        for i, side in enumerate(ORDER):
            runs = []
            for name, inp in inputs.items():
                for flags in ([], ["-simple-dist", "-complex-dist"]):
                    tag = name + (" every distance" if flags else
                                  " default")
                    out = os.path.join(tmp, f"out{i}_{len(runs)}")
                    runs.append((tag, [
                        "-in", inp, "-out", out, "-kmer-size", "21",
                        "-abundance-min", "2", "-verbose", "0", *flags]))
            proc = subprocess.run(
                [sys.executable, "-c", _RUN, json.dumps(runs)],
                cwd=trees[side], capture_output=True, text=True, check=True)
            for line in proc.stdout.splitlines():
                kind, _, rec = line.partition(" ")
                if kind != "REC":
                    continue
                r = json.loads(rec)
                recs[side].setdefault(r["tag"], []).append(r)
                print(f"{side} {r['tag']}: " + ", ".join(
                    f"{k} {r[k]:.4f}" for k in KEYS) + "; top " + "; ".join(
                    f"{name} x{c} {t / 1e3:.3f} ms" for t, c, name in r["top"]),
                    flush=True)
    for side, by_tag in recs.items():
        for tag, rs in by_tag.items():
            print(f"{side} ({trees[side]}) {tag}, medians of {len(rs)}: "
                  + ", ".join(f"{k} {np.median([r[k] for r in rs]):.4f}"
                              for k in KEYS))
    return 0


if __name__ == "__main__":
    sys.exit(main())
