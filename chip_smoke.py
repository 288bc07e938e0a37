"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--seed 0]

Phases (each raises on failure; nothing is caught):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build of the CUDA kernels from simka_tpu_torch/csrc;
  3. the compaction kernel against its plain torch version on the card,
     bit for bit, at E in {1, 4095, 2^20+3, 2^24, 2^27} x kept
     fractions {0, 0.37, 1}, with their times at 2^24 and 2^27;
  4. a small community (4 samples, FASTA and FASTQ, N bases, both
     strands) through run_simka on cuda and on cpu: byte-equal CSVs
     and repartition histograms;
  5. the main path at full size through the CLI entry point
     (k=21, abundance-min 2): 8 samples x 500,000 reads x 100 bp of a
     20-genome community, run twice; the kernel's launch count over
     the first run must be > 0 and both runs' CSVs identical; then the
     kernel against its plain version at the shapes that run gave it.

Prints, before the last line, the kernels' JSON record and the card's
nvidia-smi line; the last line is the JSON result. Exits non-zero
without a result when no CUDA device is present.
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from simka_tpu_torch.ops import _kernels, compact

INT64_MAX = (1 << 63) - 1
REPLACES = "simka_tpu/ops/pallas_compact.py:48"


def say(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def rows(E: int, frac: float, gen: torch.Generator, dev, n_cols: int = 3):
    """(int64 key, int64 count, int32 sid)[:n_cols] columns + mask."""
    kept = torch.rand(E, generator=gen, device=dev) < frac
    key = torch.randint(0, INT64_MAX, (E,), generator=gen, device=dev)
    cnt = torch.randint(0, 1 << 40, (E,), generator=gen, device=dev)
    sid = torch.randint(-(1 << 31), 1 << 31, (E,), generator=gen,
                        device=dev, dtype=torch.int64).to(torch.int32)
    fills = (INT64_MAX, 0, 0)
    return (key, cnt, sid)[:n_cols], kept, fills[:n_cols]


def compare(cols, kept, fills) -> int:
    """Kernel vs plain on the same inputs, bit for bit; returns the
    max abs error, 0 (anything else raises)."""
    got = compact.compact_rows(cols, kept, fills)
    want = compact.compact_rows_plain(cols, kept, fills)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            bad = (g != w).nonzero()[:5].flatten().tolist()
            raise AssertionError(
                f"compact_rows kernel != plain at E={kept.shape[0]}, "
                f"{g.dtype}, first bad rows {bad}"
            )
    return 0


def time_ms(fn, reps: int = 10) -> float:
    """Median CUDA-event time of fn over reps runs after one warm-up."""
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
    return float(np.median(times))


def kernel_vs_plain(dev) -> int:
    """Phase 3; returns the max abs error."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    err = 0
    for E in (1, 4095, (1 << 20) + 3, 1 << 24, 1 << 27):
        for frac in (0.0, 0.37, 1.0):
            cols, kept, fills = rows(E, frac, gen, dev)
            err = max(err, compare(cols, kept, fills))
            if frac == 0.37 and E >= 1 << 24:
                saved = compact.launches
                k_ms = time_ms(lambda: compact.compact_rows(cols, kept, fills))
                p_ms = time_ms(
                    lambda: compact.compact_rows_plain(cols, kept, fills)
                )
                compact.launches = saved  # timing launches are not the path's
                say(f"compact E=2^{E.bit_length() - 1} frac=0.37 "
                    f"(i64 key, i64 count, i32 sid): kernel {k_ms:.4f} ms, "
                    f"plain {p_ms:.4f} ms")
            del cols, kept
    torch.cuda.empty_cache()
    say(f"compact kernel == plain at every shape (max_abs_err {err})")
    return err


def csv_texts(out_dir: str) -> dict:
    return {
        os.path.basename(p): gzip.open(p, "rt").read()
        for p in sorted(glob.glob(os.path.join(out_dir, "*.csv.gz")))
    }


def metrics_of(out_dir: str) -> dict:
    with open(os.path.join(out_dir, "simka_metrics.json")) as f:
        return json.load(f)


def small_gpu_vs_cpu(tmp: str, seed: int) -> None:
    from simka_tpu_torch.config import SimkaConfig
    from simka_tpu_torch.core.pipeline import run_simka
    from simka_tpu_torch.utils.community import write_community

    inp = write_community(
        os.path.join(tmp, "small"), seed=seed, n_samples=4, n_genomes=5,
        genome_len=20_000, reads_per_sample=3_000, n_frac=0.01,
        fastq_samples=2,
    )
    outs = {}
    for dev in ("cuda", "cpu"):
        out = os.path.join(tmp, f"small_{dev}")
        run_simka(
            SimkaConfig(input_filename=inp, output_dir=out, verbose=False),
            device=dev,
        )
        outs[dev] = (csv_texts(out), metrics_of(out)["counters"])
    (g_csv, g_m), (c_csv, c_m) = outs["cuda"], outs["cpu"]
    if not g_csv or g_csv != c_csv:
        raise AssertionError("small run: cuda and cpu CSVs differ")
    if g_m["repartition_histogram"] != c_m["repartition_histogram"]:
        raise AssertionError("small run: repartition histograms differ")
    if g_m["nb_distinct_kmers"] <= 0:
        raise AssertionError("small run found no solid k-mers")
    say(f"small run cuda == cpu: {len(g_csv)} matrices byte-equal, "
        f"{g_m['nb_distinct_kmers']} distinct solid k-mers")


def check_matrices(texts: dict, n: int) -> None:
    """Every matrix: n x n finite values in [0, sqrt 2], zero diagonal."""
    for name, text in texts.items():
        lines = text.splitlines()
        vals = np.array(
            [[float(v) for v in ln.split(";")[1:]] for ln in lines[1:]]
        )
        if vals.shape != (n, n) or not np.isfinite(vals).all():
            raise AssertionError(f"{name}: shape {vals.shape} or non-finite")
        if np.any(np.diag(vals) != 0) or vals.min() < 0 or vals.max() > 1.5:
            raise AssertionError(f"{name}: values out of range")


def full_size(tmp: str, seed: int) -> dict:
    from simka_tpu_torch.cli import main as cli_main
    from simka_tpu_torch.utils.community import write_community

    n = 8
    t0 = time.perf_counter()
    inp = write_community(
        os.path.join(tmp, "full"), seed=seed, n_samples=n, n_genomes=20,
        genome_len=2_000_000, reads_per_sample=500_000, read_len=100,
        n_frac=0.001,
    )
    say(f"full-size data written in {time.perf_counter() - t0:.2f} s "
        f"(8 samples x 500000 reads x 100 bp, 20 genomes x 2 Mbp)")
    runs = []
    launches = 0
    for r in range(2):
        out = os.path.join(tmp, f"full_out{r}")
        argv = ["-in", inp, "-out", out, "-kmer-size", "21",
                "-abundance-min", "2", "-verbose", "0", "-device", "cuda"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        compact.launches = 0
        t1 = time.perf_counter()
        rc = cli_main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        if r == 0:
            launches = compact.launches
        if rc != 0:
            raise AssertionError(f"cli returned {rc}")
        m = metrics_of(out)
        c = m["counters"]
        instances = int(sum(c["repartition_histogram"]))
        say(
            f"full run {r}: wall {wall:.3f} s; stages "
            + ", ".join(f"{k} {c[k]}" for k in sorted(c)
                        if k.startswith("stage_"))
            + f", count {m['stages']['count']}, output {m['stages']['output']}"
            + f"; reads {c['reads']}, instances {instances}, "
            f"distinct solid {c['nb_distinct_kmers']}, "
            f"compact launches {compact.launches}, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
        )
        runs.append((csv_texts(out), instances, c))
    if launches <= 0:
        raise AssertionError("the main path never launched the compaction kernel")
    if runs[0][0] != runs[1][0]:
        raise AssertionError("full-size runs gave different CSVs")
    check_matrices(runs[0][0], n)
    say(f"full-size runs identical: {len(runs[0][0])} matrices")
    return {"launches": launches, "instances": runs[0][1],
            "batch_rows": 131072 * 84}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2

    smi = nvidia_smi()
    say(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    path = _kernels.build(verbose=True)
    _kernels.lib()
    say(f"kernel build: {time.perf_counter() - t0:.2f} s -> "
        f"{os.path.relpath(path)}")

    dev = torch.device("cuda", 0)
    err = kernel_vs_plain(dev)
    with tempfile.TemporaryDirectory(prefix="simka_chip_smoke_") as tmp:
        small_gpu_vs_cpu(tmp, args.seed)
        run = full_size(tmp, args.seed)

    # the kernel against its plain version at the shapes the main path
    # gave it: one int64 column per extraction batch, (int64 key, int32
    # count) at the join
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    saved = compact.launches
    cols, kept, fills = rows(run["batch_rows"], 0.95, gen, dev, n_cols=1)
    err = max(err, compare(cols, kept, fills))
    E = run["instances"]
    cols, kept, _ = rows(E, 0.37, gen, dev, n_cols=2)
    cols = (cols[0], cols[1].to(torch.int32))
    fills = (-1, 0)
    err = max(err, compare(cols, kept, fills))
    k_ms = time_ms(lambda: compact.compact_rows(cols, kept, fills), reps=5)
    p_ms = time_ms(lambda: compact.compact_rows_plain(cols, kept, fills), reps=5)
    compact.launches = saved
    say(f"compact at the join shape E={E} (i64 key, i32 count, frac 0.37): "
        f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
    del cols, kept

    print(json.dumps({"kernels": [{
        "name": "compact_rows",
        "route": "cuda",
        "source": "simka_tpu_torch/csrc/compact.cu",
        "replaces": REPLACES,
        "launches": run["launches"],
        "max_abs_err": err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
