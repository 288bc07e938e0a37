"""The extraction, run-count and segment kernels in two checkouts, in
turns on one card.

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
    ``torch.unique_consecutive(return_counts=True)`` on the same key;
  - ``ops.countjoin.segment_stats`` on seed-made solid rows (as
    ``profiling/pair_ab.py`` makes them: each of S k-mers in each of N
    samples with probability p, an int64 word and sample id, an int32
    count) shaped like phase 14's (N = 100, runs of ~25 rows) and phase
    7's (N = 8, ~2.2 rows a k-mer), alone and as the chain from the
    rows to (bins, scalars, starts[:n_segs], seg_len) that the
    checkout's ``_raw_stats_from_rows`` runs: in the two-pass form (the
    pass returns a first-row mask) the host read, an arange, its
    compaction on the mask, a cat and a subtraction; in the one-pass
    form ``countjoin._segments``: the host read, the starts copied out
    of the pass's buffer and a subtraction.

Each also takes the kernels' own device time a call under
torch.profiler (for the segment chain, every device event of the
chain). Each process prints its times and a digest of every output
(index-weighted sums), so that the two checkouts are seen to compute
the same thing; then the medians of each side, after the card's name
and power limit.
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
# (tag, N, k-mers, presence probability) of the segment rows
SEGMENT_SHAPES = (("n100", 100, 4_000_000, 0.2475),
                  ("n8", 8, 39_000_000, 0.25))

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
del key
torch.cuda.empty_cache()

def solid_rows(N, S, p):
    seg, sid = (torch.rand((S, N), generator=g, device=dev) < p).nonzero(
        as_tuple=True)
    u = torch.rand(seg.shape[0], generator=g, device=dev)
    count = (2 + torch.floor(torch.log(u) / torch.log(torch.tensor(
        0.7, device=dev)))).clamp(max=1 << 20).to(torch.int32)
    return (seg,), sid, count

for tag, N, S, p in sh["segments"]:
    rows = solid_rows(N, S, p)
    one = lambda: countjoin.segment_stats(*rows, n_banks=N)

    def chain():
        if hasattr(countjoin, "_segments"):  # the one-pass form
            bins, scalars, _, starts, seg_len = countjoin._segments(*rows, N)
            return bins, scalars, starts, seg_len
        bins, second, scalars = one()
        n_segs, d_max = scalars[[0, 2]].tolist()
        from simka_tpu_torch.ops.compact import compact_rows
        n = rows[1].shape[0]
        (starts,) = compact_rows((torch.arange(n, dtype=torch.int64,
                                               device=dev),),
                                 second, fills=(-1,), n=n_segs)
        return (bins, scalars, starts,
                torch.cat([starts[1:], starts.new_tensor([n])]) - starts)

    key = f"seg_{tag}"
    res[key + "_digest"] = digest(chain())
    res[key + "_shape"] = [rows[1].shape[0], N]
    n0 = countjoin.segment_stats_launches
    res[key + "_ms"] = timed(one)
    res[key + "_launches"] = (countjoin.segment_stats_launches - n0) / (
        reps + 1)
    res[key + "_device_ms"] = device(one, ("segment_stats", "run_bounds"))
    res[key + "_chain_ms"] = timed(chain)
    res[key + "_chain_device_ms"] = device(chain, ("",))
    del rows
    torch.cuda.empty_cache()
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
              "key_range": KEY_RANGE, "segments": SEGMENT_SHAPES}
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
    for tag, N, S, p in SEGMENT_SHAPES:
        n = first[f"seg_{tag}_shape"][0]
        rows += [(f"segment_stats ({n} rows, N = {N})", f"seg_{tag}"),
                 (f"rows to (starts, seg_len) ({n} rows, N = {N})",
                  f"seg_{tag}_chain")]
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
