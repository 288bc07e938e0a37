"""The probe kernels' device times in two checkouts, in turns on one card.

    python -m simka_tpu_torch.profiling.probe_ab --a DIR --b DIR

Starts, in the order A B B A, one process in each checkout. Each builds
that checkout's kernels, holds every probe's kernel against its plain
version once (``probes.run_all``), then times on the device each probe's
call (the summed durations of its hand kernels' torch.profiler events,
names holding ``probe_``, over 50 calls after one warm-up call; null
when the trace lost any of the launches the wrappers counted) and a
one-element ``fill_``, the card's shortest kernel. Prints each process's
times and, per checkout and probe, the median of the processes that
measured it in microseconds, after the card's name and power limit.
Comparing two versions inside one call, in turns, keeps the card and
the host's load the same for both.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

ORDER = "ABBA"
REPS = 50

_RUN = r"""
import json, sys, torch
from simka_tpu_torch.profiling import probes, trace
reps = int(sys.argv[1])
dev = torch.device("cuda", 0)
probes.run_all(dev, 0, strict=True, log=None)
acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]

def device_us(fn, only):
    fn()
    torch.cuda.synchronize()
    n0 = sum(probes.launches.values())
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    n = sum(probes.launches.values()) - n0 if only else reps
    ev = [iv for iv in trace.device_intervals(prof.events())
          if only is None or only in iv[2]]
    return sum(e - s for s, e, _ in ev) / reps if len(ev) == n else None

times = {}
for p in probes.PROBES:
    args = probes.probe_inputs(p, 0, dev)
    times[p.name] = device_us(lambda: p.fn(*args), "probe_")
one = torch.empty(1, device=dev)
times["fill_ (launch floor)"] = device_us(lambda: one.fill_(1.0), None)
print("TIMES " + json.dumps(times), flush=True)
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", required=True, help="checkout A (e.g. the parent)")
    ap.add_argument("--b", required=True, help="checkout B (e.g. this tree)")
    args = ap.parse_args(argv)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    runs = {"A": [], "B": []}
    for side in ORDER:
        root = os.path.abspath(getattr(args, side.lower()))
        env = dict(os.environ, PYTHONPATH=root)
        proc = subprocess.run([sys.executable, "-c", _RUN, str(REPS)],
                              cwd=root, env=env, capture_output=True,
                              text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-4000:] + proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"{side} ({root}) failed: {proc.returncode}")
        line = next(ln for ln in proc.stdout.splitlines()
                    if ln.startswith("TIMES "))
        runs[side].append(json.loads(line[len("TIMES "):]))
        print(f"{side} {line}", flush=True)
    names = list(runs["A"][0])
    print(f"{'probe':32s} {'A us':>14s} {'B us':>14s}")
    for name in names:
        cells = []
        for side in "AB":
            vals = [r[name] for r in runs[side] if r.get(name) is not None]
            cells.append("not measured" if not vals else
                         f"{np.median(vals):.3f} ({len(vals)}/"
                         f"{len(runs[side])})")
        print(f"{name:32s} " + " ".join(f"{c:>14s}" for c in cells),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
