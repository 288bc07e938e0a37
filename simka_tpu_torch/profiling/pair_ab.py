"""The join's pair pass in two checkouts, in turns on one card.

    python -m simka_tpu_torch.profiling.pair_ab --a DIR --b DIR

Starts, in the order A B B A, one process in each checkout. Each builds
that checkout's kernels and times ``countjoin._raw_stats_from_rows`` (the
per-bank totals, the segments and the pair kernel; with every distance
also Whittaker's all-rows sums) with CUDA events, the median of REPS
calls after one warm-up, on seed-made solid rows made on the card:

  - shaped like ``chip_smoke.py`` phase 14's N = 100 run (3,999,316
    distinct solid k-mers, 99,009,246 rows, d_max 49, 1,216,992,386
    pairs): WIDE_SEGMENTS k-mers, each present in each of 100 samples
    with probability WIDE_P, empty ones dropped;
  - shaped like phase 7's N = 8 run (35,190,577 distinct solid k-mers,
    77,329,304 rows, d_max 8, 68,253,592 pairs): NARROW_SEGMENTS k-mers
    over 8 samples at NARROW_P;

each with the default channels and with every channel
(``simple=True, complex_=True``), and ``countjoin.pair_sums`` alone on
the same rows (the kernel; with every channel, whittaker_all too where
the checkout's pair_sums computes it). Counts are 2 + a geometric draw,
as solid counts at abundance-min 2. Each process prints its times and a
digest of every returned field (an index-weighted sum), so that the
two checkouts are seen to compute the same statistics; then the
medians of each side, after the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

ORDER = "ABBA"
REPS = 5
WIDE_N, WIDE_SEGMENTS, WIDE_P = 100, 4_000_000, 0.2475
NARROW_N, NARROW_SEGMENTS, NARROW_P = 8, 39_000_000, 0.25

_RUN = r"""
import inspect, json, sys, torch
from simka_tpu_torch.ops import _kernels, countjoin
reps, seed = int(sys.argv[1]), int(sys.argv[2])
shapes = json.loads(sys.argv[3])
_kernels.build()
dev = torch.device("cuda", 0)

def rows(N, S, p):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    seg, sid = (torch.rand((S, N), generator=g, device=dev) < p).nonzero(
        as_tuple=True)
    u = torch.rand(seg.shape[0], generator=g, device=dev)
    count = (2 + torch.floor(torch.log(u) / torch.log(torch.tensor(
        0.7, device=dev)))).clamp(max=1 << 20).to(torch.int32)
    return (seg,), sid, count

def digest(stats):
    out = []
    for x in stats:
        x = x.flatten().to(torch.int64)
        w = torch.arange(1, x.numel() + 1, device=x.device)
        out.append(int((x * w).sum()))
    return out

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

takes_wall = "whittaker_all" in inspect.signature(
    countjoin.pair_sums).parameters

def kernel_ms(sid, count, seg_len, N, full):
    sid, c64 = sid.to(torch.int64), count.to(torch.int64)
    starts = torch.cumsum(seg_len, 0) - seg_len
    K = torch.zeros(N, dtype=torch.int64, device=dev).index_add_(
        0, sid, c64).to(torch.float64)
    names = countjoin.PAIR_CHANNELS if full else countjoin.PAIR_CHANNELS[:4]
    flat = {n: torch.zeros(N * N, dtype=torch.int64, device=dev)
            for n in names}
    kl = torch.zeros((N * N, 5), dtype=torch.int64, device=dev)
    kw = {}
    if full and takes_wall:
        kw["whittaker_all"] = torch.zeros(N * N, dtype=torch.int64,
                                          device=dev)
    d_max = int(seg_len.max())
    return timed(lambda: countjoin.pair_sums(sid, c64, starts, seg_len, K,
                                             flat, kl, d_max=d_max, **kw))

res = {}
for name, N, S, p in shapes:
    words, sid, count = rows(N, S, p)
    seg_len = torch.bincount(words[0])
    seg_len = seg_len[seg_len > 0]
    res[name + "_shape"] = [sid.shape[0], seg_len.shape[0],
                            int(seg_len.max()),
                            int((seg_len * (seg_len - 1) // 2).sum())]
    for label, full in (("default", False), ("all", True)):
        fn = lambda: countjoin._raw_stats_from_rows(
            words, sid, count, n_banks=N, simple=full, complex_=full)
        res[f"{name}_{label}_digest"] = digest(fn())
        n0 = countjoin.launches
        res[f"{name}_{label}_ms"] = timed(fn)
        res[f"{name}_{label}_launches"] = (
            countjoin.launches - n0) / (reps + 1)
        res[f"{name}_{label}_kernel_ms"] = kernel_ms(sid, count, seg_len, N,
                                                     full)
    del words, sid, count, seg_len
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
    shapes = [("n100", WIDE_N, WIDE_SEGMENTS, WIDE_P),
              ("n8", NARROW_N, NARROW_SEGMENTS, NARROW_P)]
    runs = {"A": [], "B": []}
    for side in ORDER:
        root = os.path.abspath(getattr(args, side.lower()))
        env = dict(os.environ, PYTHONPATH=root)
        proc = subprocess.run(
            [sys.executable, "-c", _RUN, str(REPS), str(args.seed),
             json.dumps(shapes)],
            cwd=root, env=env, capture_output=True, text=True, timeout=1200)
        if proc.returncode != 0:
            print(proc.stdout[-4000:] + proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"{side} ({root}) failed: {proc.returncode}")
        line = next(ln for ln in proc.stdout.splitlines()
                    if ln.startswith("TIMES "))
        runs[side].append(json.loads(line[len("TIMES "):]))
        print(f"{side} {line}", flush=True)
    first = runs["A"][0]
    same = all(r[k] == first[k] for side in "AB" for r in runs[side]
               for k in first if k.endswith(("_digest", "_shape")))
    print("every process computed the same statistics: "
          + ("yes" if same else "NO"), flush=True)
    for name, *_ in shapes:
        rows, segs, d_max, pairs = first[name + "_shape"]
        print(f"{name}: {rows} rows, {segs} segments, d_max {d_max}, "
              f"{pairs} pairs", flush=True)
        for label in ("default", "all"):
            key = f"{name}_{label}"
            for part, what in (("_ms", "_raw_stats_from_rows"),
                               ("_kernel_ms", "pair_sums alone")):
                a = np.median([r[key + part] for r in runs["A"]])
                b = np.median([r[key + part] for r in runs["B"]])
                print(f"  {label:8s} {what:21s} A {a:10.4f} ms  B "
                      f"{b:10.4f} ms  A / B {a / b:.2f}", flush=True)
            print(f"  {label:8s} pair launches a join: A "
                  f"{runs['A'][0][key + '_launches']:g}, B "
                  f"{runs['B'][0][key + '_launches']:g}", flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
