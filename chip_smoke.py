"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--seed 0]

Phases (each raises on failure; nothing is caught):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build of the CUDA kernels from simka_tpu_torch/csrc;
  3. the compaction kernel against its plain torch version on the card,
     bit for bit, at E in {1, 4095, 2^20+3, 2^24, 2^27} x kept
     fractions {0, 0.37, 1}, with their times at 2^24 and 2^27;
  4. the probe path (python -m simka_tpu_torch.profiling.probes): every
     probe kernel against its plain version (DMA routes printed), the
     launch count of each of the four groups over that run, then each
     group's kernel and plain CUDA-event times;
  5. small communities through run_simka on cuda and on cpu, byte-equal
     CSVs and repartition histograms: the default distances (k=21);
     -simple-dist -complex-dist at k in {21, 33, 63, 127} (150 bp
     reads); -kmer-shannon-index 1.5 at k=63 on a community with
     low-complexity genomes;
  6. determinism: count_join_stats with every channel twice on the card
     over one 3-word (k=63) instance stream, bit-identical JoinStats,
     and against the CPU (integers equal, floats to 1e-12);
  7. the main paths at full size through the CLI entry point: 8 samples
     x 500,000 reads x 100 bp of a 20-genome community; the default
     command (k=21, default distances), then -simple-dist
     -complex-dist at k=21 and at k=63; each run twice with identical
     CSVs, each run's compaction launch count > 0;
  8. the compaction kernel against its plain version at the column
     layouts those runs gave it, each at the largest E it saw (at least
     2^24 rows for 5 to 7 columns; 6 columns, k in 94..124, added), and
     at the join shape of the k=21 run, timed there.

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
from simka_tpu_torch.profiling import probes

INT64_MAX = (1 << 63) - 1
REPLACES = "simka_tpu/ops/pallas_compact.py:48"
ALL_DISTANCES = ["-simple-dist", "-complex-dist"]
# matrices whose distance formula bounds them to [0, sqrt 2]; Whittaker
# keeps the reference's int32 wrap of its double products
# (SimkaAlgorithm.hpp:481), which no formula bounds
UNBOUNDED = {"mat_abundance_whittaker.csv.gz"}


def say(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def rows(E: int, frac: float, gen: torch.Generator, dev, dtypes=None):
    """Random columns of ``dtypes`` (default int64 key, int64 count,
    int32 sid) + a kept mask at ``frac`` + fills."""
    dtypes = dtypes or (torch.int64, torch.int64, torch.int32)
    kept = torch.rand(E, generator=gen, device=dev) < frac
    cols, fills = [], []
    for dt in dtypes:
        if dt == torch.int64:
            cols.append(torch.randint(0, INT64_MAX, (E,), generator=gen,
                                      device=dev))
            fills.append(INT64_MAX)
        else:
            cols.append(torch.randint(-(1 << 31), 1 << 31, (E,),
                                      generator=gen, device=dev,
                                      dtype=torch.int64).to(torch.int32))
            fills.append(0)
    return tuple(cols), kept, tuple(fills)


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


def probe_phase(dev, seed: int) -> dict:
    """Phase 4: the probe path, then each group's kernel and plain
    times; returns per group {launches, max_abs_err, ms, plain_ms}."""
    for g in probes.launches:
        probes.launches[g] = 0
    results = probes.run_all(dev, seed, strict=True, log=say)
    torch.cuda.synchronize()
    groups = {g: {"launches": probes.launches[g], "max_abs_err": 0.0,
                  "ms": 0.0, "plain_ms": 0.0} for g in probes.GROUPS}
    idle = [g for g, v in groups.items() if v["launches"] <= 0]
    if idle:
        raise AssertionError(f"the probe path never launched {idle}")
    for r in results:
        g = groups[r["group"]]
        g["max_abs_err"] = max(g["max_abs_err"], r["max_abs_err"])
    saved = dict(probes.launches)
    for p in probes.PROBES:
        args = probes.probe_inputs(p, seed, dev)
        k_ms = time_ms(lambda: p.fn(*args), reps=20)
        p_ms = time_ms(lambda: p.plain(*args), reps=20)
        groups[p.group]["ms"] += k_ms
        groups[p.group]["plain_ms"] += p_ms
        say(f"probe {p.name} ({p.tpu}): kernel {k_ms:.4f} ms, plain "
            f"{p_ms:.4f} ms")
    probes.launches.update(saved)  # timing launches are not the path's
    for name, g in groups.items():
        say(f"probe group {name}: {g['launches']} launches, kernels "
            f"{g['ms']:.4f} ms, plain {g['plain_ms']:.4f} ms (sum of "
            f"per-probe medians), max_abs_err {g['max_abs_err']}")
    return groups


def csv_texts(out_dir: str) -> dict:
    return {
        os.path.basename(p): gzip.open(p, "rt").read()
        for p in sorted(glob.glob(os.path.join(out_dir, "*.csv.gz")))
    }


def metrics_of(out_dir: str) -> dict:
    with open(os.path.join(out_dir, "simka_metrics.json")) as f:
        return json.load(f)


class ShapeRecorder:
    """Records (column dtypes) -> largest E of the compactions the
    card runs while installed (the shapes the main paths give it)."""

    def __init__(self):
        self.shapes = {}
        self._orig = compact.compact_rows

    def __enter__(self):
        def recording(arrays, kept, fills):
            if kept.device.type == "cuda":
                key = tuple(a.dtype for a in arrays)
                self.shapes[key] = max(self.shapes.get(key, 0), kept.shape[0])
            return self._orig(arrays, kept, fills)

        compact.compact_rows = recording
        return self

    def __exit__(self, *exc):
        compact.compact_rows = self._orig


def gpu_vs_cpu(tmp: str, tag: str, inp: str, n_matrices: int, **cfg) -> None:
    from simka_tpu_torch.config import SimkaConfig
    from simka_tpu_torch.core.pipeline import run_simka

    outs = {}
    for dev in ("cuda", "cpu"):
        out = os.path.join(tmp, f"{tag}_{dev}")
        run_simka(
            SimkaConfig(input_filename=inp, output_dir=out, verbose=False,
                        **cfg),
            device=dev,
        )
        outs[dev] = (csv_texts(out), metrics_of(out)["counters"])
    (g_csv, g_m), (c_csv, c_m) = outs["cuda"], outs["cpu"]
    if len(g_csv) != n_matrices or g_csv != c_csv:
        raise AssertionError(f"{tag}: cuda and cpu CSVs differ")
    if g_m["repartition_histogram"] != c_m["repartition_histogram"]:
        raise AssertionError(f"{tag}: repartition histograms differ")
    if g_m["nb_distinct_kmers"] <= 0:
        raise AssertionError(f"{tag}: no solid k-mers")
    say(f"{tag}: cuda == cpu, {len(g_csv)} matrices byte-equal, "
        f"{sum(g_m['repartition_histogram'])} instances, "
        f"{g_m['nb_distinct_kmers']} distinct solid k-mers")


def small_gpu_vs_cpu(tmp: str, seed: int) -> None:
    """Phase 5."""
    from simka_tpu_torch.utils.community import write_community

    inp = write_community(
        os.path.join(tmp, "small"), seed=seed, n_samples=4, n_genomes=5,
        genome_len=20_000, reads_per_sample=3_000, n_frac=0.01,
        fastq_samples=2,
    )
    gpu_vs_cpu(tmp, "small default k=21", inp, 15)
    inp150 = write_community(
        os.path.join(tmp, "small150"), seed=seed + 1, n_samples=4,
        n_genomes=5, genome_len=20_000, reads_per_sample=3_000,
        read_len=150, n_frac=0.002, fastq_samples=2,
    )
    for k in (21, 33, 63, 127):
        gpu_vs_cpu(tmp, f"small all distances k={k}", inp150, 21,
                   kmer_size=k, simple_dist=True, complex_dist=True)
    motif = write_community(
        os.path.join(tmp, "motif"), seed=seed + 2, n_samples=4,
        n_genomes=6, genome_len=20_000, reads_per_sample=3_000,
        n_frac=0.005, fastq_samples=2, motif_genomes=3,
    )
    gpu_vs_cpu(tmp, "small kmer-shannon-index 1.5 k=63", motif, 15,
               kmer_size=63, min_kmer_shannon_index=1.5)


def determinism(dev, seed: int) -> None:
    """Phase 6: a k=63 (three-word) stream of 2^22 instances over 16
    samples, every channel."""
    from simka_tpu_torch.ops.countjoin import count_join_stats

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    E, N, distinct = 1 << 22, 16, 1 << 16
    table = [torch.randint(0, 1 << bits, (distinct,), generator=gen,
                           device=dev) for bits in (2, 62, 62)]
    pick = torch.randint(0, distinct, (E,), generator=gen, device=dev)
    words = tuple(t[pick] for t in table)
    sid = torch.randint(0, N, (E,), generator=gen, device=dev,
                        dtype=torch.int32)

    def run(ws, s):
        js = count_join_stats(ws, s, 2, 999_999_999, n_banks=N,
                              kmer_bits=126, simple=True, complex_=True)
        return js.to_numpy()

    a, b = run(words, sid), run(words, sid)
    c = run(tuple(w.cpu() for w in words), sid.cpu())
    for name in a._fields:
        x, y, z = (np.asarray(getattr(s, name)) for s in (a, b, c))
        if x.tobytes() != y.tobytes():
            raise AssertionError(f"determinism: {name} differs between runs")
        if x.dtype.kind == "f":
            ok = np.allclose(x, z, rtol=1e-12, atol=0)
        else:
            ok = np.array_equal(x, z)
        if not ok:
            raise AssertionError(f"determinism: {name} differs from the cpu")
    if not (a.kullback_leibler.any() and a.whittaker_all.any()
            and a.chord_ninj.any()):
        raise AssertionError("determinism: the channels stayed empty")
    say(f"determinism: two cuda runs bit-identical in every JoinStats "
        f"field, == cpu (E={E}, N={N}, k=63, {int(a.nb_shared)} shared "
        f"k-mers)")


def check_matrices(texts: dict, n: int) -> None:
    """Every matrix: n x n finite values with a zero diagonal; those
    the distances bound, in [0, sqrt 2]."""
    for name, text in texts.items():
        lines = text.splitlines()
        vals = np.array(
            [[float(v) for v in ln.split(";")[1:]] for ln in lines[1:]]
        )
        if vals.shape != (n, n) or not np.isfinite(vals).all():
            raise AssertionError(f"{name}: shape {vals.shape} or non-finite")
        if np.any(np.diag(vals) != 0):
            raise AssertionError(f"{name}: nonzero diagonal")
        if name not in UNBOUNDED and (vals.min() < 0 or vals.max() > 1.5):
            raise AssertionError(f"{name}: values out of range")


def full_size(tmp: str, seed: int) -> dict:
    """Phase 7; returns each path's first-run record."""
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
    paths = {}
    for tag, k, flags in (("default k=21", 21, []),
                          ("all distances k=21", 21, ALL_DISTANCES),
                          ("all distances k=63", 63, ALL_DISTANCES)):
        runs = []
        for r in range(2):
            out = os.path.join(tmp, f"full_{k}_{len(flags)}_{r}")
            argv = ["-in", inp, "-out", out, "-kmer-size", str(k),
                    "-abundance-min", "2", "-verbose", "0", "-device",
                    "cuda", *flags]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            compact.launches = 0
            t1 = time.perf_counter()
            rc = cli_main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            if rc != 0:
                raise AssertionError(f"cli returned {rc}")
            if compact.launches <= 0:
                raise AssertionError(
                    f"{tag}: the run never launched the compaction kernel")
            m = metrics_of(out)
            c = m["counters"]
            rec = {
                "launches": compact.launches,
                "instances": int(sum(c["repartition_histogram"])),
                "wall_s": wall,
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            }
            say(
                f"full {tag} run {r}: wall {wall:.3f} s; stages "
                + ", ".join(f"{key} {c[key]}" for key in sorted(c)
                            if key.startswith("stage_"))
                + f", count {m['stages']['count']}, output "
                f"{m['stages']['output']}; reads {c['reads']}, instances "
                f"{rec['instances']}, distinct solid "
                f"{c['nb_distinct_kmers']}, compact launches "
                f"{rec['launches']}, peak device memory "
                f"{rec['peak_gib']:.2f} GiB"
            )
            runs.append((csv_texts(out), rec))
        if runs[0][0] != runs[1][0]:
            raise AssertionError(f"full {tag}: the two runs' CSVs differ")
        check_matrices(runs[0][0], n)
        say(f"full {tag}: both runs identical, {len(runs[0][0])} matrices")
        paths[tag] = runs[0][1]
    return paths


def compaction_at_path_shapes(shapes: dict, join_rows: int, dev,
                              seed: int) -> tuple:
    """Phase 8; returns (max_abs_err, kernel ms, plain ms) at the k=21
    join shape."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    saved = compact.launches
    err = 0
    # the 6-column layout (4 words + sid + count, k in 94..124) is on no
    # run above; hold it all the same
    six = (torch.int64,) * 4 + (torch.int32, torch.int32)
    shapes = dict(shapes)
    shapes.setdefault(six, 0)
    for dtypes, E in sorted(shapes.items(), key=lambda kv: len(kv[0])):
        if len(dtypes) >= 5:
            E = max(E, 1 << 24)
        cols, kept, fills = rows(E, 0.37, gen, dev, dtypes)
        err = max(err, compare(cols, kept, fills))
        names = "+".join(str(d).split(".")[-1] for d in dtypes)
        if len(dtypes) >= 5:
            k_ms = time_ms(lambda: compact.compact_rows(cols, kept, fills),
                           reps=5)
            p_ms = time_ms(
                lambda: compact.compact_rows_plain(cols, kept, fills), reps=5)
            say(f"compact {len(dtypes)} columns ({names}) E={E}: kernel == "
                f"plain; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
        else:
            say(f"compact {len(dtypes)} columns ({names}) E={E}: kernel == "
                "plain")
        del cols, kept
        torch.cuda.empty_cache()
    # the join shape of the k=21 run: (int64 key, int32 count)
    cols, kept, fills = rows(join_rows, 0.37, gen, dev,
                             (torch.int64, torch.int32))
    fills = (-1, 0)
    err = max(err, compare(cols, kept, fills))
    k_ms = time_ms(lambda: compact.compact_rows(cols, kept, fills), reps=5)
    p_ms = time_ms(lambda: compact.compact_rows_plain(cols, kept, fills),
                   reps=5)
    compact.launches = saved
    say(f"compact at the join shape E={join_rows} (i64 key, i32 count, "
        f"frac 0.37): kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
    return err, k_ms, p_ms


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2

    t_all = time.perf_counter()
    smi = nvidia_smi()
    say(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    path = _kernels.build(verbose=True)
    _kernels.lib()
    say(f"kernel build: {time.perf_counter() - t0:.2f} s -> "
        f"{os.path.relpath(path)}")

    dev = torch.device("cuda", 0)
    err = kernel_vs_plain(dev)
    groups = probe_phase(dev, args.seed)
    with tempfile.TemporaryDirectory(prefix="simka_chip_smoke_") as tmp:
        with ShapeRecorder() as rec:
            small_gpu_vs_cpu(tmp, args.seed)
            determinism(dev, args.seed)
            paths = full_size(tmp, args.seed)
    main_run = paths["default k=21"]
    c_err, k_ms, p_ms = compaction_at_path_shapes(
        rec.shapes, main_run["instances"], dev, args.seed)
    err = max(err, c_err)

    kernels = [{
        "name": "compact_rows",
        "route": "cuda",
        "source": "simka_tpu_torch/csrc/compact.cu",
        "replaces": REPLACES,
        "launches": main_run["launches"],
        "max_abs_err": err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]
    for name, g in groups.items():
        kernels.append({
            "name": f"probes.{name}",
            "route": "cuda",
            "source": "simka_tpu_torch/csrc/probes.cu",
            "replaces": probes.GROUPS[name],
            "launches": g["launches"],
            "max_abs_err": g["max_abs_err"],
            "ms": g["ms"],
            "plain_ms": g["plain_ms"],
        })
    say(f"chip_smoke: all phases passed in "
        f"{time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
