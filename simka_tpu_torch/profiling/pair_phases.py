"""How much of the pair kernel's time is its adds into the partials.

    python -m simka_tpu_torch.profiling.pair_phases [--src DIR] [--seed S]

Writes phase 14's community (``utils.community.WIDE_COMMUNITY``, 100
samples) and runs this checkout's CLI on it once on the card (k=21,
default distances) to keep the inputs of its join's pair kernel: the
N = 100 run's own solid rows. Then, in the order A B B A, one process
in checkout DIR (default: this one) builds DIR's ``csrc/*.cu`` into a
temporary directory, as they are (A) or with ``-DSIMKA_PAIR_SINK`` (B),
in which ``csrc/pair_sums.cu`` adds every pair's channel values into a
register sink instead of its partials (the rest of the kernel, the row
loads, the pair terms and the flush, stays). Each process times
``countjoin.pair_sums`` on those rows with CUDA events (median of 5
after one warm-up), for the default channels and for every channel
with Whittaker's all-rows sums. DIR's ``pair_sums.cu`` must have the
``SIMKA_PAIR_SINK`` hook (ValueError otherwise). The card's name and
power limit are printed first. ``ncu`` does not run on the card's
machine; this is how the kernel's time is split there.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

ORDER = "ABBA"
REPS = 5
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

_RUN = r"""
import json, os, shutil, sys, tempfile, torch
from simka_tpu_torch.ops import _kernels, countjoin
rows_path, csrc, sink = sys.argv[1], sys.argv[2], sys.argv[3] == "B"
reps = int(sys.argv[4])
tmp = tempfile.mkdtemp(prefix="pair_phases_")
_kernels.CSRC = csrc
lib_path = os.path.join(tmp, "libsimka_kernels.so")
_kernels.compile_library(lib_path,
                         defines=("-DSIMKA_PAIR_SINK",) if sink else ())
_kernels._lib = None
_kernels.build = lambda verbose=False: lib_path
rows = torch.load(rows_path)
sid, count, starts, seg_len, K = rows
N = K.shape[0]
d_max = int(seg_len.max())

def run(names, wall):
    flat = {n: torch.zeros(N * N, dtype=torch.int64, device=sid.device)
            for n in names}
    kl = torch.zeros((N * N, 1 + countjoin.KL_FRAC_LIMBS), dtype=torch.int64,
                     device=sid.device)
    kw = {}
    if wall:
        kw["whittaker_all"] = torch.zeros(N * N, dtype=torch.int64,
                                          device=sid.device)
    fn = lambda: countjoin.pair_sums(*rows, flat, kl, d_max=d_max, **kw)
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

n0 = countjoin.launches
res = {"default_ms": run(countjoin.PAIR_CHANNELS[:4], False)}
res["default_launches"] = (countjoin.launches - n0) // (reps + 1)
n0 = countjoin.launches
res["all_ms"] = run(countjoin.PAIR_CHANNELS, True)
res["all_launches"] = (countjoin.launches - n0) // (reps + 1)
print("TIMES " + json.dumps(res), flush=True)
shutil.rmtree(tmp)
"""


def check_sink_hook(text: str) -> None:
    """ValueError unless ``pair_sums.cu``'s text has the
    ``SIMKA_PAIR_SINK`` hook."""
    if "SIMKA_PAIR_SINK" not in text:
        raise ValueError("pair_sums.cu has no SIMKA_PAIR_SINK hook")


def capture_rows(out: str, seed: int) -> dict:
    """Run the CLI on the wide community on the card and save its join's
    pair-kernel inputs (sid, count, starts, seg_len, K) to ``out``."""
    import torch

    from simka_tpu_torch.cli import main as cli_main
    from simka_tpu_torch.ops import countjoin
    from simka_tpu_torch.utils.community import (WIDE_COMMUNITY,
                                                 write_community)

    tmp = os.path.dirname(out)
    inp = write_community(os.path.join(tmp, "wide"), seed=seed,
                          **WIDE_COMMUNITY)
    kept = {}
    orig = countjoin.pair_sums

    def recording(sid, count, starts, seg_len, K, *args, **kw):
        if "rows" not in kept or sid.shape[0] > kept["rows"][0].shape[0]:
            kept["rows"] = (sid, count, starts, seg_len, K)
        return orig(sid, count, starts, seg_len, K, *args, **kw)

    countjoin.pair_sums = recording
    try:
        rc = cli_main(["-in", inp, "-out", os.path.join(tmp, "out"),
                       "-kmer-size", "21", "-abundance-min", "2",
                       "-verbose", "0", "-device", "cuda"])
    finally:
        countjoin.pair_sums = orig
    if rc != 0 or "rows" not in kept:
        raise RuntimeError(f"the wide-community run failed ({rc})")
    rows = kept["rows"]
    torch.save(rows, out)
    seg_len = rows[3]
    return {"rows": rows[0].shape[0], "segments": seg_len.shape[0],
            "d_max": int(seg_len.max()),
            "pairs": int((seg_len * (seg_len - 1) // 2).sum())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=_ROOT, help="the checkout to measure")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    src = os.path.abspath(args.src)
    with tempfile.TemporaryDirectory(prefix="pair_phases_") as tmp:
        csrc = os.path.join(tmp, "csrc")
        shutil.copytree(os.path.join(src, "simka_tpu_torch", "csrc"), csrc)
        kernel = os.path.join(csrc, "pair_sums.cu")
        with open(kernel) as f:
            check_sink_hook(f.read())
        rows_path = os.path.join(tmp, "rows.pt")
        shape = capture_rows(rows_path, args.seed)
        import torch

        torch.cuda.empty_cache()  # the workers load the rows themselves
        print(f"rows of the N = 100 run: {json.dumps(shape)}", flush=True)
        runs = {"A": [], "B": []}
        for side in ORDER:
            env = dict(os.environ, PYTHONPATH=src)
            proc = subprocess.run(
                [sys.executable, "-c", _RUN, rows_path, csrc, side, str(REPS)],
                cwd=src, env=env, capture_output=True, text=True,
                timeout=900)
            if proc.returncode != 0:
                print(proc.stdout[-4000:] + proc.stderr[-4000:],
                      file=sys.stderr)
                raise SystemExit(f"{side} failed: {proc.returncode}")
            line = next(ln for ln in proc.stdout.splitlines()
                        if ln.startswith("TIMES "))
            runs[side].append(json.loads(line[len("TIMES "):]))
            print(f"{side} ({'sink' if side == 'B' else 'as is'}) {line}",
                  flush=True)
    for key in ("default_ms", "all_ms"):
        a = np.median([r[key] for r in runs["A"]])
        b = np.median([r[key] for r in runs["B"]])
        print(f"{key}: as is {a:.4f} ms, adds into a register sink "
              f"{b:.4f} ms; the adds {a - b:.4f} ms ({100 * (a - b) / a:.1f}%)",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
