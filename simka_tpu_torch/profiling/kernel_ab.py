"""The extraction and run-count kernels in two checkouts, in turns on one
card.

    python -m simka_tpu_torch.profiling.kernel_ab --a DIR --b DIR

Starts, in the order A B B A, one process in each checkout. Each builds
that checkout's kernels and times, with CUDA events (the median of REPS
calls after one warm-up), on seed-made inputs made on the card in the
shapes of ``chip_smoke.py`` phase 7's main path:

  - ``ops.kmers.extract_kmers`` with the histogram, as the in-memory
    path calls it, at k = 21 and k = 63, on a packed batch of
    BATCH_READS reads x READ_SLOTS slots: reads of 100 bases (the last
    slots invalid) with an N a base at N_RATE;
  - ``ops.countjoin.run_counts`` on KEY_ROWS sorted int64 keys (phase
    7's packed key at k = 21), drawn from KEY_RANGE values so that runs
    average ~3 rows, with abundance-min 2, beside
    ``torch.unique_consecutive(return_counts=True)`` on the same key.

Each also takes the kernels' own device time a call under
torch.profiler. Each process prints its times and a digest of every
output (index-weighted sums), so that the two checkouts are seen to
compute the same thing; then the medians of each side, after the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

ORDER = "ABBA"
REPS = 20
BATCH_READS, READ_SLOTS, READ_BASES, N_RATE = 1 << 17, 104, 100, 0.001
KEY_ROWS, KEY_RANGE = 313_342_848, 100_000_000
EXTRACT_KS = (21, 63)

_RUN = r"""
import json, sys, torch
from simka_tpu_torch.ops import _kernels, countjoin, kmers
from simka_tpu_torch.profiling.trace import device_intervals
reps, seed = int(sys.argv[1]), int(sys.argv[2])
sh = json.loads(sys.argv[3])
_kernels.build()
dev = torch.device("cuda", 0)
g = torch.Generator(device=dev)
g.manual_seed(seed)

def timed(fn):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]

def device(fn, names):
    # the kernels' own device events (names holding one of `names`) a
    # call, under torch.profiler; None when the trace lost a launch
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ivs = [iv for iv in device_intervals(prof.events())
           if any(n in iv[2] for n in names)]
    if len(ivs) < reps:
        return None
    return sum(e - s for s, e, _ in ivs) / 1e3 / reps

def digest(ts):
    out = []
    for x in ts:
        x = x.flatten().to(torch.int64)
        w = torch.arange(1, x.numel() + 1, device=x.device)
        out.append(int((x * w).sum()))
    return out

B, L = sh["reads"], sh["slots"]
codes = torch.randint(0, 4, (B, L), generator=g, device=dev,
                      dtype=torch.uint8)
codes[torch.rand((B, L), generator=g, device=dev) < sh["n_rate"]] = 255
codes[:, sh["bases"]:] = 255
c = torch.where(codes == 255, 0, codes).to(torch.int32)
packed = (c[:, 0::4] | (c[:, 1::4] << 2) | (c[:, 2::4] << 4)
          | (c[:, 3::4] << 6)).to(torch.uint8)
v = (codes != 255).to(torch.int32).reshape(B, L // 8, 8)
vb = (v << torch.arange(8, device=dev, dtype=torch.int32)).sum(2).to(
    torch.uint8)
del codes, c, v
res = {}
for k in sh["ks"]:
    fn = lambda: kmers.extract_kmers(packed, vb, k, with_hist=True)
    ex = fn()
    res[f"extract_{k}_digest"] = digest((*ex.words, ex.keep, ex.hist,
                                         ex.n_kept))
    del ex
    n0 = kmers.launches
    res[f"extract_{k}_ms"] = timed(fn)
    res[f"extract_{k}_launches"] = (kmers.launches - n0) / (reps + 1)
    res[f"extract_{k}_device_ms"] = device(fn, ("extract_kmers",))
del packed, vb
torch.cuda.empty_cache()
key = torch.randint(0, sh["key_range"], (sh["key_rows"],), generator=g,
                    device=dev)
key = torch.sort(key * 0x9E3779B1).values
fn = lambda: countjoin.run_counts((key,), 2, countjoin.INT32_MAX)
count, keep, total = fn()
res["run_counts_digest"] = digest((count, keep, total))
del count, keep, total
n0 = countjoin.run_counts_launches
res["run_counts_ms"] = timed(fn)
res["run_counts_launches"] = (countjoin.run_counts_launches - n0) / (
    reps + 1)
res["run_counts_device_ms"] = device(
    fn, ("run_counts", "run_bounds", "run_lengths"))
res["unique_consecutive_ms"] = timed(
    lambda: torch.unique_consecutive(key, return_counts=True))
print("TIMES " + json.dumps(res), flush=True)
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", required=True, help="checkout A (e.g. the parent)")
    ap.add_argument("--b", required=True, help="checkout B (e.g. this tree)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    shapes = {"reads": BATCH_READS, "slots": READ_SLOTS, "bases": READ_BASES,
              "n_rate": N_RATE, "ks": list(EXTRACT_KS), "key_rows": KEY_ROWS,
              "key_range": KEY_RANGE}
    runs = {"A": [], "B": []}
    for side in ORDER:
        root = os.path.abspath(getattr(args, side.lower()))
        env = dict(os.environ, PYTHONPATH=root)
        proc = subprocess.run(
            [sys.executable, "-c", _RUN, str(REPS), str(args.seed),
             json.dumps(shapes)],
            cwd=root, env=env, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-4000:] + proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"{side} ({root}) failed: {proc.returncode}")
        line = next(ln for ln in proc.stdout.splitlines()
                    if ln.startswith("TIMES "))
        runs[side].append(json.loads(line[len("TIMES "):]))
        print(f"{side} {line}", flush=True)
    first = runs["A"][0]
    same = all(r[k] == first[k] for side in "AB" for r in runs[side]
               for k in first if k.endswith("_digest"))
    print("every process computed the same outputs: "
          + ("yes" if same else "NO"), flush=True)
    rows = [(f"extract_kmers k={k} ({BATCH_READS} reads x {READ_SLOTS})",
             f"extract_{k}") for k in EXTRACT_KS]
    rows += [(f"run_counts ({KEY_ROWS} sorted int64 rows)", "run_counts"),
             ("torch.unique_consecutive, same key", "unique_consecutive")]
    for what, key in rows:
        for part, how in (("_ms", "around the call"),
                          ("_device_ms", "on the device")):
            if key + part not in first:
                continue
            vals = [[r[key + part] for r in runs[side]] for side in "AB"]
            if any(v is None for side in vals for v in side):
                print(f"  {what}, {how}: not measured (the trace lost "
                      "launches)", flush=True)
                continue
            a, b = (float(np.median(v)) for v in vals)
            print(f"  {what}, {how}: A {a:.4f} ms  B {b:.4f} ms  A / B "
                  f"{a / b:.2f}", flush=True)
        if key + "_launches" in first:
            print(f"  {what}: launches a call A "
                  f"{runs['A'][0][key + '_launches']:g} B "
                  f"{runs['B'][0][key + '_launches']:g}", flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
