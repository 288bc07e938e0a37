"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--seed 0]

Phases (each raises on failure; nothing is caught):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build of the CUDA kernels from simka_tpu_torch/csrc, and of the
     native parser (the run refuses the pure-Python reader's fallback:
     the parser sets the main path's pace);
  3. the compaction kernel against its plain torch version on the card,
     bit for bit in both forms ([E] with the fill, and exact-length
     [n]), with the kernel's own kept total equal to n, at E in {1,
     4095, 2^20+3, 2^24, 2^27} x kept fractions {0, 0.37, 1}, with
     their times at 2^24 and 2^27;
  4. the probe path (python -m simka_tpu_torch.profiling.probes): every
     probe kernel against its plain version (DMA routes printed), the
     launch count of each of the four groups over that run; then per
     probe the kernel's CUDA-event time around the Python call, its
     device time from torch.profiler (device events only, as
     profiling/trace.py counts them), the plain version's time and,
     where one torch call computes the same function, that call's
     times (for the bf16 products torch.mm(out_dtype=float32) on the
     operands cast beforehand); the bf16 product twice, bit-identical;
  5. small communities through run_simka on cuda and on cpu, byte-equal
     CSVs and repartition histograms: the default distances (k=21);
     -simple-dist -complex-dist at k in {21, 33, 63, 127} (150 bp
     reads); -kmer-shannon-index 1.5 at k=63 on a community with
     low-complexity genomes; the -out-tmp checkpoint path at k=21
     (default distances) and at k=63 (all distances), each also with
     -sweep-ranges 3 (the out-of-core sweep from <tmp>/sweep/); the
     in-memory command forced out-of-core on the device and the
     host-memory spill tiers (k=21, -max-memory 20: tens of hash
     ranges); the CSVs of every -out-tmp and out-of-core run equal to
     the in-memory run's;
  6. determinism: count_join_stats with every channel twice on the card
     over one 3-word (k=63) instance stream, bit-identical JoinStats,
     and against the CPU (integers equal, floats to 1e-12);
  7. the main paths at full size through the CLI entry point: 8 samples
     x 500,000 reads x 100 bp of a 20-genome community (the first 8 of
     9 written); the default command (k=21, default distances), then
     -simple-dist -complex-dist at k=21 and at k=63 (the join of three
     int64 words); each run in memory (its route checked), twice with
     identical CSVs, each run's compaction launch count > 0, and the
     kernel's own kept total equal to the caller's n on every call of
     the run (held on the card and compared after the run: no sync on
     the path);
  8. the -out-tmp checkpoint path at full size through the CLI (k=21,
     default distances, -max-memory 50000 unless said): run 1 counts the
     8 samples into checkpoints, its CSVs byte-equal to phase 7's
     default run (run 0); run 2 resumes all 8 (files untouched, same
     CSVs); run 3 adds the ninth sample and counts only it; run 3s
     resumes the 9 at the default -max-memory, where the reference's
     spill rule takes the sweep (the disk tier, -keep-tmp), its CSVs
     equal to run 3's; run 3f resumes the 8 with -simple-dist
     -complex-dist -sweep-ranges 7, its CSVs byte-equal to phase 7's
     all-distances k=21 run; run 4, without -keep-tmp, resumes all 9
     and removes <tmp>/count/. Per run: the count, merge and output
     stages, per-sample checkpoint load, count, save and spill times,
     the sweep's ranges, partition (each checkpoint shipped and cut on
     the card), npz write, range load and join times, compaction
     launches (kept total == n on each), peak device
     memory, spectrum rows and the memory budget. Then
     count_dataset_spectrum on one full-size sample with
     stream_batch_reads 2^18 (four partial spectra and their merge)
     equals the default call (one spectrum) word for word;
  9. the compaction kernel against its plain version in both forms at
     the column layouts phases 5-8 and 10 gave it, each at the largest
     E it saw (at least 2^24 rows for 5 to 7 columns; 6 columns, k in
     94..124, added); then timed, both forms beside the least time the
     card could take (bytes over 3.35 TB/s) and, for one column,
     torch.masked_select: at the join shape of the k=21 run, at an
     extraction batch (2^17 reads x 80 windows, kept 0.979), at the
     -out-tmp spectra join (word, sample id, count) and at the sweep's
     range extraction (the same columns over every resident spectrum
     row, kept about 1/R: phase 10's largest);
 10. the in-memory command out-of-core at full size through the CLI
     (k=21, default distances): (a) the 8 samples with a 30 GB device
     plan (SIMKA_TPU_HBM_MB=30000, for that run only), which the
     estimate (320 M windows) routes out-of-core up front on the device
     tier, its CSVs byte-equal to phase 7's default run; (r) the
     mid-ingest restart: compute_statistics on the 8 samples under a 20
     GB plan, the in-memory batches dropped (the device memory still
     allocated at the restart checked) and the run redone out-of-core,
     its CSVs byte-equal to phase 7's default run; (b) 16 samples of
     the same community (samples 9-15 written now), past the card's own
     plan with no override: the up-front route on the device tier, then
     run_simka on the host-memory tier, the two runs' CSVs byte-equal.
     Per run: route, spill tier, hash ranges, the count stage (parse,
     H2D, extraction, per-sample spectra, spill), the sweep (range
     extraction or load, joins), output, compaction launches (kept
     total == n on each), peak device memory and spectrum rows.

Prints, before the last line, the kernels' JSON record (per kernel:
launches on the main path, max_abs_err, ms, plain_ms, bound_ms,
bound_by, library_ms -- null where no one torch call computes the same
function -- launches_out_tmp and launches_sweep, the compaction's
launches in phase 8's run 1 and in phase 10's 16-sample run, and extra
fields) and the card's nvidia-smi line; the last
line is the JSON result. Exits non-zero without a result when no CUDA
device is present.
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from simka_tpu_torch.core import sweep
from simka_tpu_torch.ops import _kernels, compact
from simka_tpu_torch.profiling import probes, trace

INT64_MAX = (1 << 63) - 1
REPLACES = "simka_tpu/ops/pallas_compact.py:48"
ALL_DISTANCES = ["-simple-dist", "-complex-dist"]
# matrices whose distance formula bounds them to [0, sqrt 2]; Whittaker
# keeps the reference's int32 wrap of its double products
# (SimkaAlgorithm.hpp:481), which no formula bounds
UNBOUNDED = {"mat_abundance_whittaker.csv.gz"}
# published peaks of one H100 SXM (NVIDIA's H100 datasheet)
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
EXTRACT_ROWS = (1 << 17) * 80  # a 2^17-read batch of 100 bp reads, k=21
# the -out-tmp join's abundance filter at k=21: (word, sample id, count)
SPECTRA_JOIN = (torch.int64, torch.int32, torch.int32)


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


def bound(nbytes: float, ops: float = 0.0):
    """(least ms the card could take, "bytes" or "operations")."""
    b, o = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_OPS_PER_S * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


def compact_bytes(cols, kept, n: int, fill: bool) -> int:
    """The mask read once, each kept row read once, each output row
    written once."""
    row = sum(c.element_size() for c in cols)
    E = kept.shape[0]
    return E + n * row + (E if fill else n) * row


def compare(cols, kept, fills) -> int:
    """Kernel vs plain on the same inputs, bit for bit, in both forms,
    and the kernel's kept total against the count; returns the max abs
    error, 0 (anything else raises)."""
    n = int(kept.sum())
    for form in (None, n):
        got = compact.compact_rows(cols, kept, fills, n=form)
        total = int(compact.last_kept_total)
        want = compact.compact_rows_plain(cols, kept, fills, n=form)
        torch.cuda.synchronize()
        if total != n:
            raise AssertionError(
                f"compact_rows kept total {total} != {n} at E={kept.shape[0]}")
        for g, w in zip(got, want):
            if g.shape != w.shape or not torch.equal(g, w):
                bad = ((g != w).nonzero()[:5].flatten().tolist()
                       if g.shape == w.shape else (g.shape, w.shape))
                raise AssertionError(
                    f"compact_rows kernel != plain at E={kept.shape[0]}, "
                    f"n={form}, {g.dtype}, first bad rows {bad}"
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


def time_compaction(tag: str, cols, kept, fills, reps: int = 10) -> dict:
    """Both forms of the kernel and of the plain version, their bounds
    and, for one column, torch.masked_select, on the same inputs."""
    n = int(kept.sum())
    saved = compact.launches
    r = {
        "ms": time_ms(lambda: compact.compact_rows(cols, kept, fills, n=n),
                      reps),
        "fill_ms": time_ms(lambda: compact.compact_rows(cols, kept, fills),
                           reps),
        "plain_ms": time_ms(
            lambda: compact.compact_rows_plain(cols, kept, fills, n=n), reps),
        "plain_fill_ms": time_ms(
            lambda: compact.compact_rows_plain(cols, kept, fills), reps),
        "library_ms": (time_ms(lambda: torch.masked_select(cols[0], kept),
                               reps) if len(cols) == 1 else None),
        # a copy of every column: the traffic of reading all input rows
        # (a random mask touches nearly every sector) and writing E rows
        "copy_ms": time_ms(lambda: [c.clone() for c in cols], reps),
    }
    compact.launches = saved  # timing launches are not the path's
    r["bound_ms"], r["bound_by"] = bound(compact_bytes(cols, kept, n, False))
    r["fill_bound_ms"], _ = bound(compact_bytes(cols, kept, n, True))
    lib = ("" if r["library_ms"] is None
           else f", torch.masked_select {r['library_ms']:.4f} ms")
    say(f"compact {tag} E={kept.shape[0]} n={n}: exact-length "
        f"{r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms, plain "
        f"{r['plain_ms']:.4f} ms); with fill {r['fill_ms']:.4f} ms (bound "
        f"{r['fill_bound_ms']:.4f} ms, plain {r['plain_fill_ms']:.4f} ms); "
        f"a copy of the columns {r['copy_ms']:.4f} ms" + lib)
    return r


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
                time_compaction(f"2^{E.bit_length() - 1} (i64 key, i64 "
                                "count, i32 sid)", cols, kept, fills)
            del cols, kept
    torch.cuda.empty_cache()
    say(f"compact kernel == plain at every shape (max_abs_err {err})")
    return err


def device_ms(fn, reps: int = 20):
    """Device time of one call of fn: the union of its device events
    under torch.profiler (profiling/trace.py's count), over reps calls;
    None when the trace shows no device event."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    intervals = trace.device_intervals(prof.events())
    return trace.union_us(intervals) / 1e3 / reps if intervals else None


def library_call(p, args):
    """One torch call that computes probe p's function on its inputs,
    or None where none does (the bf16 products' operands are cast, and
    k6's one-hot built, outside the timed call). Timed here only: the
    port never calls it."""
    x = args[-1]
    if p.name in ("basic_2d_vmem", "basic_1d_vmem", "reshape_f32"):
        return lambda: torch.mul(x, 2)
    if p.name in ("reshape_i32", "reshape_2d_i32"):
        return lambda: torch.add(x, 1)
    if p.name.startswith(("gram_bf16", "cond_gram", "onehot_gram")):
        if p.name.startswith("onehot_gram"):
            lane = torch.arange(probes.LANES, device=x.device) % 8
            xb = (x.reshape(-1, 1) == lane).to(torch.bfloat16)
        else:
            xb = x.to(torch.bfloat16)
        return lambda: torch.mm(xb.t(), xb, out_dtype=torch.float32)
    return None


def probe_bound(p, args):
    """Bound of one probe call: the bytes of its inputs and outputs,
    and for a bf16 product that runs 2 x rows x 128^2 operations (kd
    on negative inputs skips it)."""
    out = p.plain(*args)
    outs = out if isinstance(out, tuple) else (out,)
    nbytes = sum(t.numel() * t.element_size() for t in (*args, *outs))
    product = (p.name.startswith(("gram_bf16", "cond_gram", "onehot_gram"))
               and p.name != "cond_gram_negative")
    ops = 2 * args[-1].shape[0] * probes.LANES ** 2 if product else 0
    return bound(nbytes, ops)


def probe_phase(dev, seed: int) -> dict:
    """Phase 4: the probe path, then each probe's times; returns per
    group, and for the bf16 product ("gram"), {launches, max_abs_err,
    ms, device_ms, plain_ms, library_ms, library_device_ms, bound_ms,
    bound_by}."""
    for g in probes.launches:
        probes.launches[g] = 0
    probes.gram_launches = 0
    results = probes.run_all(dev, seed, strict=True, log=say)
    torch.cuda.synchronize()
    keys = ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms",
            "bound_ms")
    groups = {g: {"launches": probes.launches[g], "max_abs_err": 0.0,
                  **dict.fromkeys(keys, 0.0)} for g in probes.GROUPS}
    gram = {"launches": probes.gram_launches, "max_abs_err": 0.0}
    idle = [g for g, v in groups.items() if v["launches"] <= 0]
    if idle or gram["launches"] <= 0:
        raise AssertionError(f"the probe path never launched {idle} "
                             f"(bf16 product: {gram['launches']})")
    for r in results:
        g = groups[r["group"]]
        g["max_abs_err"] = max(g["max_abs_err"], r["max_abs_err"])
        if "gram" in r["name"]:
            gram["max_abs_err"] = max(gram["max_abs_err"], r["max_abs_err"])
    saved = dict(probes.launches), probes.gram_launches
    for p in probes.PROBES:
        args = probes.probe_inputs(p, seed, dev)
        lib = library_call(p, args)
        t = {
            "ms": time_ms(lambda: p.fn(*args), reps=20),
            "device_ms": device_ms(lambda: p.fn(*args)),
            "plain_ms": time_ms(lambda: p.plain(*args), reps=20),
            "library_ms": None if lib is None else time_ms(lib, reps=20),
            "library_device_ms": None if lib is None else device_ms(lib),
        }
        t["bound_ms"], by = probe_bound(p, args)
        g = groups[p.group]
        g["bound_by"] = "bytes" if g.get("bound_by", "bytes") == by == \
            "bytes" else "operations"
        for k in keys:  # a group's sum is None once a probe lacks the time
            g[k] = None if g[k] is None or t[k] is None else g[k] + t[k]
        if p.name == "gram_bf16_normal":  # ka at its shape, normal values
            gram.update(t)
            gram["bound_ms"], gram["bound_by"] = probe_bound(p, args)
            a, b = p.fn(*args), p.fn(*args)
            torch.cuda.synchronize()
            if not torch.equal(a, b):
                raise AssertionError("the bf16 product differs between runs")
        say(f"probe {p.name} ({p.tpu}): kernel {t['ms']:.4f} ms around "
            f"the call, {fmt(t['device_ms'])} on the device; plain "
            f"{t['plain_ms']:.4f} ms; one torch call {fmt(t['library_ms'])} "
            f"({fmt(t['library_device_ms'])} on the device); bound "
            f"{t['bound_ms']:.6f} ms")
    probes.launches.update(saved[0])  # timing launches are not the path's
    probes.gram_launches = saved[1]
    for name, g in groups.items():
        say(f"probe group {name}: {g['launches']} launches, kernels "
            f"{g['ms']:.4f} ms ({fmt(g['device_ms'])} on the device), "
            f"plain {g['plain_ms']:.4f} ms, one torch call "
            f"{fmt(g['library_ms'])} (sums of per-probe medians), bound "
            f"{g['bound_ms']:.6f} ms, max_abs_err {g['max_abs_err']}")
    say(f"bf16 product (ka, normal values): kernel {gram['ms']:.4f} ms "
        f"({fmt(gram['device_ms'])} on the device), "
        f"torch.mm(out_dtype=float32) {fmt(gram['library_ms'])} "
        f"({fmt(gram['library_device_ms'])} on the device), "
        f"{gram['launches']} launches on the probe path, identical runs")
    return {"groups": groups, "gram": gram}


def fmt(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


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
    card runs while installed (the shapes the main paths give it), and
    each call's device-side kept total beside the caller's n, compared
    by ``check_totals`` after a run (the sync is there, not on the
    path). The sweep's range extractions are kept apart: ``range_shape``
    holds the (dtypes, E, n) of the largest."""

    def __init__(self):
        self.shapes = {}
        self.totals = []
        self.range_shape = None
        self._in_range = False
        self._orig = compact.compact_rows
        self._orig_range = sweep.range_extract

    def __enter__(self):
        def recording(arrays, kept, fills, n=None):
            out = self._orig(arrays, kept, fills, n=n)
            if kept.device.type == "cuda" and kept.shape[0] > 0:
                key = tuple(a.dtype for a in arrays)
                if self._in_range:
                    if (self.range_shape is None
                            or kept.shape[0] > self.range_shape[1]):
                        self.range_shape = (key, kept.shape[0], n)
                else:
                    self.shapes[key] = max(self.shapes.get(key, 0),
                                           kept.shape[0])
                self.totals.append((compact.last_kept_total,
                                    kept.sum() if n is None else n))
            return out

        def range_recording(*args, **kw):
            self._in_range = True
            try:
                return self._orig_range(*args, **kw)
            finally:
                self._in_range = False

        compact.compact_rows = recording
        sweep.range_extract = range_recording
        return self

    def check_totals(self) -> int:
        """The kernel's kept total == the caller's n on every call since
        the last check; returns the number of calls checked."""
        for got, want in self.totals:
            if int(got) != int(want):
                raise AssertionError(
                    f"compact_rows kept total {int(got)} != n {int(want)}")
        k = len(self.totals)
        self.totals.clear()
        return k

    def __exit__(self, *exc):
        compact.compact_rows = self._orig
        sweep.range_extract = self._orig_range


def gpu_vs_cpu(tmp: str, tag: str, inp: str, n_matrices: int,
               out_tmp: bool = False, tier=None, sweeps: bool = False,
               **cfg) -> dict:
    """run_simka on cuda and on cpu (with ``out_tmp``, through the
    -out-tmp checkpoint path; with ``tier``, out-of-core on that spill
    tier): byte-equal CSVs and repartition histograms, the sweep's hash
    ranges equal and present exactly when ``sweeps``; returns the CSV
    texts."""
    from simka_tpu_torch.config import SimkaConfig
    from simka_tpu_torch.core.pipeline import run_simka

    outs = {}
    for dev in ("cuda", "cpu"):
        out = os.path.join(tmp, f"{tag}_{dev}")
        if out_tmp:
            cfg["output_tmp_dir"] = out + "_tmp"
        run_simka(
            SimkaConfig(input_filename=inp, output_dir=out, verbose=False,
                        **cfg),
            device=dev, tier=tier,
        )
        outs[dev] = (csv_texts(out), metrics_of(out)["counters"])
    (g_csv, g_m), (c_csv, c_m) = outs["cuda"], outs["cpu"]
    if len(g_csv) != n_matrices or g_csv != c_csv:
        raise AssertionError(f"{tag}: cuda and cpu CSVs differ")
    if g_m["repartition_histogram"] != c_m["repartition_histogram"]:
        raise AssertionError(f"{tag}: repartition histograms differ")
    if g_m["nb_distinct_kmers"] <= 0:
        raise AssertionError(f"{tag}: no solid k-mers")
    ranges = g_m.get("sweep_ranges")
    if ranges != c_m.get("sweep_ranges") or (ranges is not None) != sweeps:
        raise AssertionError(f"{tag}: sweep ranges {ranges} (cuda), "
                             f"{c_m.get('sweep_ranges')} (cpu)")
    say(f"{tag}: cuda == cpu, {len(g_csv)} matrices byte-equal, "
        f"{sum(g_m['repartition_histogram'])} "
        f"{'distinct solid k-mers' if out_tmp or tier else 'instances'} "
        f"hashed, {g_m['nb_distinct_kmers']} distinct solid k-mers"
        + (f", {ranges} hash ranges" if sweeps else ""))
    return g_csv


def same_csvs(tag: str, a: dict, b: dict) -> None:
    if a != b:
        raise AssertionError(f"{tag}: the CSVs differ from the in-memory "
                             "run's")
    say(f"{tag}: CSVs == in-memory CSVs")


def small_gpu_vs_cpu(tmp: str, seed: int) -> None:
    """Phase 5."""
    from simka_tpu_torch.utils.community import write_community

    inp = write_community(
        os.path.join(tmp, "small"), seed=seed, n_samples=4, n_genomes=5,
        genome_len=20_000, reads_per_sample=3_000, n_frac=0.01,
        fastq_samples=2,
    )
    mem = gpu_vs_cpu(tmp, "small default k=21", inp, 15)
    same_csvs("small -out-tmp default k=21", mem,
              gpu_vs_cpu(tmp, "small -out-tmp default k=21", inp, 15, True))
    same_csvs("small -out-tmp -sweep-ranges 3 k=21", mem, gpu_vs_cpu(
        tmp, "small -out-tmp -sweep-ranges 3 k=21", inp, 15, True,
        sweeps=True, sweep_ranges=3))
    for tier in ("device", "ram"):
        # -max-memory 20 cuts the sweep into tens of ranges
        tag = f"small out-of-core, {tier} tier, k=21, -max-memory 20"
        same_csvs(tag, mem, gpu_vs_cpu(tmp, tag, inp, 15, tier=tier,
                                       sweeps=True, max_memory_mb=20))
    inp150 = write_community(
        os.path.join(tmp, "small150"), seed=seed + 1, n_samples=4,
        n_genomes=5, genome_len=20_000, reads_per_sample=3_000,
        read_len=150, n_frac=0.002, fastq_samples=2,
    )
    for k in (21, 33, 63, 127):
        mem = gpu_vs_cpu(tmp, f"small all distances k={k}", inp150, 21,
                         kmer_size=k, simple_dist=True, complex_dist=True)
        if k == 63:
            same_csvs(f"small -out-tmp all distances k={k}", mem, gpu_vs_cpu(
                tmp, f"small -out-tmp all distances k={k}", inp150, 21,
                True, kmer_size=k, simple_dist=True, complex_dist=True))
            tag = f"small -out-tmp -sweep-ranges 3 all distances k={k}"
            same_csvs(tag, mem, gpu_vs_cpu(
                tmp, tag, inp150, 21, True, sweeps=True, sweep_ranges=3,
                kmer_size=k, simple_dist=True, complex_dist=True))
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


def cli_run(tag: str, argv: list, out: str, recorder: ShapeRecorder,
            run=None):
    """One CLI run on the card (or ``run()``, another entry point
    writing to ``out`` and returning the run's metrics) with the
    compaction's launch count and peak memory reset before it; every
    launch's kept total checked after it. Returns (record, the metrics:
    simka_metrics.json of a CLI run)."""
    from simka_tpu_torch.cli import main as cli_main

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    compact.launches = 0
    t1 = time.perf_counter()
    rc, m = (cli_main(argv), None) if run is None else (0, run())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    if rc != 0:
        raise AssertionError(f"{tag}: cli returned {rc}")
    if compact.launches <= 0:
        raise AssertionError(
            f"{tag}: the run never launched the compaction kernel")
    checked = recorder.check_totals()
    if checked != compact.launches:
        raise AssertionError(f"{tag}: {checked} kept totals checked, "
                             f"{compact.launches} launches")
    rec = {
        "launches": compact.launches,
        "wall_s": wall,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    return rec, metrics_of(out) if m is None else m


def full_size(tmp: str, seed: int, recorder: ShapeRecorder):
    """Phase 7; returns (each path's first-run record, the inputs of the
    first 8 and of all 9 samples, each path's first CSVs)."""
    from simka_tpu_torch.utils.community import write_community

    n = 8
    t0 = time.perf_counter()
    # nine samples: the first eight are the community of 8 of this seed
    inp9 = write_community(
        os.path.join(tmp, "full"), seed=seed, n_samples=n + 1, n_genomes=20,
        genome_len=2_000_000, reads_per_sample=500_000, read_len=100,
        n_frac=0.001,
    )
    inp = os.path.join(tmp, "full", "input8.txt")
    with open(inp9) as f, open(inp, "w") as g:
        g.writelines(f.readlines()[:n])
    say(f"full-size data written in {time.perf_counter() - t0:.2f} s "
        f"(9 samples x 500000 reads x 100 bp, 20 genomes x 2 Mbp; the "
        f"main paths read the first 8)")
    paths, yardsticks = {}, {}
    for tag, k, flags in (("default k=21", 21, []),
                          ("all distances k=21", 21, ALL_DISTANCES),
                          ("all distances k=63", 63, ALL_DISTANCES)):
        runs = []
        for r in range(2):
            out = os.path.join(tmp, f"full_{k}_{len(flags)}_{r}")
            argv = ["-in", inp, "-out", out, "-kmer-size", str(k),
                    "-abundance-min", "2", "-verbose", "0", "-device",
                    "cuda", *flags]
            rec, m = cli_run(tag, argv, out, recorder)
            c = m["counters"]
            if c["route"] != "in-memory":
                raise AssertionError(f"full {tag}: route {c['route']}, "
                                     "expected in-memory")
            # in memory the histogram counts every instance
            rec["instances"] = int(sum(c["repartition_histogram"]))
            say(
                f"full {tag} run {r}: route {c['route']}; wall "
                f"{rec['wall_s']:.3f} s; stages "
                + ", ".join(f"{key} {c[key]}" for key in sorted(c)
                            if key.startswith("stage_"))
                + f", count {m['stages']['count']}, output "
                f"{m['stages']['output']}; reads {c['reads']}, instances "
                f"{rec['instances']}, distinct solid "
                f"{c['nb_distinct_kmers']}, compact launches "
                f"{rec['launches']} (kernel kept total == n on each), "
                f"peak device memory {rec['peak_gib']:.2f} GiB"
            )
            runs.append((csv_texts(out), rec))
        if runs[0][0] != runs[1][0]:
            raise AssertionError(f"full {tag}: the two runs' CSVs differ")
        check_matrices(runs[0][0], n)
        say(f"full {tag}: both runs identical, {len(runs[0][0])} matrices")
        paths[tag] = runs[0][1]
        yardsticks[tag] = runs[0][0]
    return paths, inp, inp9, yardsticks


def checkpoint_mtimes(tmp: str) -> dict:
    return {p: os.stat(p).st_mtime_ns
            for p in sorted(glob.glob(os.path.join(tmp, "count", "*.npz")))}


def out_tmp_full_size(tmp: str, inp8: str, inp9: str, yardsticks: dict,
                      recorder: ShapeRecorder, dev) -> dict:
    """Phase 8; returns run 1's record."""
    from simka_tpu_torch.core.pipeline import count_dataset_spectrum
    from simka_tpu_torch.io.dsl import parse_input_file
    from simka_tpu_torch.io.packed import PackedReadSource

    ckpt = os.path.join(tmp, "ckpt")
    sweep_dir = os.path.join(ckpt, "sweep")
    csvs = {0: yardsticks["default k=21"],
            "7all": yardsticks["all distances k=21"]}
    first = None
    fits = ["-max-memory", "50000"]
    # (run, input, -keep-tmp, datasets resumed, flags, CSVs equal to,
    #  hash ranges: None (no sweep), 0 (any), or the number forced)
    for r, inp, keep, resumed, flags, same_as, ranges in (
            (1, inp8, True, None, fits, 0, None),
            (2, inp8, True, 8, fits, 1, None),
            (3, inp9, True, 8, fits, None, None),
            ("3s", inp9, True, 9, [], 3, 0),
            ("3f", inp8, True, 8, ALL_DISTANCES + ["-sweep-ranges", "7"]
             + fits, "7all", 7),
            (4, inp9, False, 9, fits, 3, None)):
        tag = f"-out-tmp run {r}"
        out = os.path.join(tmp, f"ckpt_out_{r}")
        before = checkpoint_mtimes(ckpt)
        argv = ["-in", inp, "-out", out, "-out-tmp", ckpt, "-kmer-size",
                "21", "-abundance-min", "2", "-verbose", "0", "-device",
                "cuda", *flags]
        rec, m = cli_run(tag, argv + (["-keep-tmp"] if keep else []), out,
                         recorder)
        first = first or rec
        c, texts = m["counters"], csv_texts(out)
        after = checkpoint_mtimes(ckpt)
        if c.get("datasets_resumed") != resumed:
            raise AssertionError(f"{tag}: {c.get('datasets_resumed')} "
                                 f"datasets resumed, expected {resumed}")
        if any(after.get(p) != t for p, t in before.items()) and keep:
            raise AssertionError(f"{tag}: a resumed checkpoint was rewritten")
        n = 8 if inp == inp8 else 9
        n_ckpt = max(n, len(before))  # run 3f's input lacks the ninth
        if keep and len(after) != n_ckpt:
            raise AssertionError(f"{tag}: {len(after)} checkpoints, not "
                                 f"{n_ckpt}")
        if not keep and os.path.exists(os.path.join(ckpt, "count")):
            raise AssertionError(f"{tag}: <tmp>/count/ outlived the run")
        if same_as is not None and texts != csvs[same_as]:
            raise AssertionError(f"{tag}: CSVs differ from run {same_as}'s")
        got = c.get("sweep_ranges")
        if (got is None) != (ranges is None) or ranges and got != ranges:
            raise AssertionError(f"{tag}: {got} hash ranges, expected "
                                 f"{ranges}")
        check_matrices(texts, n)
        csvs[r] = texts
        per = c["per_sample"]
        sweep_line = "" if got is None else (
            f"; the sweep: {got} hash ranges (disk tier), partition (H2D, "
            f"the cut on the card, D2H) {c['sweep_partition_s']} s, npz write "
            f"{c['sweep_write_s']} s, range load {c['sweep_range_load_s']} "
            f"s, range joins {c['sweep_range_join_s']} s")
        say(
            f"full {tag}: wall {rec['wall_s']:.3f} s; stages count "
            f"{m['stages']['count']}, merge {m['stages']['merge']}, output "
            f"{m['stages']['output']}; datasets resumed {resumed or 0}; "
            f"spectrum rows {c['spectrum_rows']} x 16 B x 8 against the "
            f"budget {c['memory_budget_bytes']} B{sweep_line}; compact "
            f"launches {rec['launches']} (kernel kept total == n on each); "
            f"peak device memory {rec['peak_gib']:.2f} GiB; CSVs "
            + {0: "== phase 7's default run (run 0)", 1: "== run 1",
               3: "== run 3", "7all": "== phase 7's all-distances k=21 run",
               None: f"{len(texts)} matrices of 9 samples"}[same_as]
            + (", <tmp>/count/ removed" if not keep else ""))
        say(f"full {tag} per sample (rows, load / count / save / spill s): "
            + "; ".join(
                f"{x['id']} {x['rows']} "
                + " / ".join(f"{x[key]}" if key in x else "-"
                             for key in ("load_s", "count_s", "save_s",
                                         "spill_s"))
                for x in per))
        if got is not None:
            # -keep-tmp kept the spill; it is not needed again
            if len(os.listdir(sweep_dir)) != n * got:
                raise AssertionError(f"{tag}: {len(os.listdir(sweep_dir))} "
                                     f"spill files, not {n} x {got}")
            shutil.rmtree(sweep_dir)
    # the merge at size: one sample in 2^18-read gathers (four partial
    # spectra, then their merge) against one spectrum of all its reads
    d = parse_input_file(inp8)[0]
    spectra = {}
    for sbr in (1 << 20, 1 << 18):
        compact.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        words, counts, n_reads = count_dataset_spectrum(
            PackedReadSource(d.banks), 21, dev, stream_batch_reads=sbr)
        torch.cuda.synchronize()
        spectra[sbr] = (words, counts, compact.launches,
                        time.perf_counter() - t0)
        recorder.check_totals()
    (w1, c1, l1, t1), (w2, c2, l2, t2) = spectra[1 << 20], spectra[1 << 18]
    if l2 < l1 + 4 or not (all(torch.equal(a, b) for a, b in zip(w1, w2))
                           and torch.equal(c1, c2)):
        raise AssertionError("the merged spectrum differs from the "
                             f"one-spectrum count ({l1} vs {l2} launches)")
    say(f"merge at size ({d.id}, {n_reads} reads): stream_batch_reads 2^18 "
        f"(partials + merge, {l2} compactions, {t2:.3f} s) == 2^20 (one "
        f"spectrum, {l1} compactions, {t1:.3f} s): {c1.shape[0]} distinct "
        f"k-mers, {int(c1.sum())} instances, word for word")
    return first


def out_of_core_full_size(tmp: str, seed: int, inp8: str, inp9: str,
                          yardsticks: dict, recorder: ShapeRecorder) -> dict:
    """Phase 10; returns the 16-sample CLI run's record."""
    from simka_tpu_torch.config import SimkaConfig
    from simka_tpu_torch.core.pipeline import run_simka
    from simka_tpu_torch.utils.community import write_community

    def argv(inp, out):
        return ["-in", inp, "-out", out, "-kmer-size", "21",
                "-abundance-min", "2", "-verbose", "0", "-device", "cuda"]

    def report(tag, rec, m, tier):
        c = m["counters"]
        if c["route"] != "up-front" or c["spill_tier"] != tier:
            raise AssertionError(f"{tag}: route {c['route']}, tier "
                                 f"{c['spill_tier']}, expected up-front, "
                                 f"{tier}")
        if c["sweep_ranges"] < 2:
            raise AssertionError(f"{tag}: {c['sweep_ranges']} hash ranges")
        spectra = [x["spectrum_s"] for x in c["per_sample"]]
        say(f"full {tag}: wall {rec['wall_s']:.3f} s; route {c['route']}, "
            f"{c['spill_tier']} tier, {c['sweep_ranges']} hash ranges, "
            f"{c['spectrum_rows']} spectrum rows "
            f"({c['spectrum_rows'] / c['sweep_ranges']:.0f} a range); stage "
            f"'count' (the count and the sweep) {m['stages']['count']} s: "
            + ", ".join(f"{key[6:]} {c[key]}" for key in sorted(c)
                        if key.startswith("stage_"))
            + f"; per-sample spectra {min(spectra)}-{max(spectra)} s; "
            f"output {m['stages']['output']} s; compact launches "
            f"{rec['launches']} (kernel kept total == n on each); peak "
            f"device memory {rec['peak_gib']:.2f} GiB")

    # (a) the 8 samples with a 30 GB plan: the estimate (8 x 52 MB of
    # FASTA at 80 windows in 104 bytes, 320 M) exceeds its 312 M
    # instance rows
    out = os.path.join(tmp, "ooc_8")
    saved = os.environ.get("SIMKA_TPU_HBM_MB")
    os.environ["SIMKA_TPU_HBM_MB"] = "30000"
    try:
        rec, m = cli_run("out-of-core 8 samples", argv(inp8, out), out,
                         recorder)
    finally:
        if saved is None:
            del os.environ["SIMKA_TPU_HBM_MB"]
        else:
            os.environ["SIMKA_TPU_HBM_MB"] = saved
    report("out-of-core, 8 samples, SIMKA_TPU_HBM_MB=30000", rec, m,
           "device")
    if csv_texts(out) != yardsticks["default k=21"]:
        raise AssertionError("out-of-core 8 samples: CSVs differ from "
                             "phase 7's default run")
    say("full out-of-core, 8 samples: CSVs == phase 7's default run")
    restart_run(tmp, inp8, yardsticks, recorder)

    # (b) 16 samples of the same community: samples 9-15 join the 9
    # written in phase 7, past the card's own plan
    t0 = time.perf_counter()
    more = write_community(
        os.path.join(tmp, "full16"), seed=seed, n_samples=16, n_genomes=20,
        genome_len=2_000_000, reads_per_sample=500_000, read_len=100,
        n_frac=0.001, first=9,
    )
    inp16 = os.path.join(tmp, "full16", "input16.txt")
    with open(inp9) as f, open(more) as g, open(inp16, "w") as h:
        h.writelines(f.readlines() + g.readlines())
    say(f"samples 9-15 written in {time.perf_counter() - t0:.2f} s")
    out = os.path.join(tmp, "ooc_16")
    rec16, m = cli_run("out-of-core 16 samples", argv(inp16, out), out,
                       recorder)
    report("out-of-core, 16 samples", rec16, m, "device")
    texts = csv_texts(out)
    check_matrices(texts, 16)
    out_ram = os.path.join(tmp, "ooc_16_ram")

    def ram_tier() -> dict:
        run_simka(SimkaConfig(input_filename=inp16, output_dir=out_ram,
                              kmer_size=21, abundance_min=2, verbose=False),
                  device="cuda", tier="ram")
        return metrics_of(out_ram)

    rec, m = cli_run("out-of-core 16 samples, host-memory tier", [], out_ram,
                     recorder, run=ram_tier)
    report("out-of-core, 16 samples, run_simka(tier='ram')", rec, m, "ram")
    c = m["counters"]
    say(f"full out-of-core, 16 samples, host-memory tier: spill (the cut "
        f"per range on the card, D2H, stored; on a worker thread) "
        f"{c['stage_spill_s']} s")
    if csv_texts(out_ram) != texts:
        raise AssertionError("out-of-core 16 samples: the device and the "
                             "host-memory tiers' CSVs differ")
    say("full out-of-core, 16 samples: device tier CSVs == host-memory "
        "tier CSVs")
    return rec16


def restart_run(tmp: str, inp8: str, yardsticks: dict,
                recorder: ShapeRecorder) -> None:
    """Phase 10's restart: compute_statistics, which has no up-front
    route, on the 8 samples under a 20 GB plan (208 M instance rows
    against the run's 313 M): the in-memory ingest trips its guard
    after about 5 samples and the run restarts out-of-core, with the
    gathered batches (about 2.5 GB) dropped first."""
    from simka_tpu_torch.config import SimkaConfig
    from simka_tpu_torch.core.distances import compute_all_matrices
    from simka_tpu_torch.core.output import write_all_matrices
    from simka_tpu_torch.core.pipeline import compute_statistics
    from simka_tpu_torch.io.dsl import parse_input_file
    from simka_tpu_torch.io.packed import PackedReadSource

    out = os.path.join(tmp, "ooc_8_restart")
    lines = []

    def restart() -> dict:
        datasets = parse_input_file(inp8)
        ids = [d.id for d in datasets]
        observer = {"base_bytes": torch.cuda.memory_allocated()}
        t0 = time.perf_counter()
        stats = compute_statistics(
            [PackedReadSource(d.banks) for d in datasets], ids,
            SimkaConfig(kmer_size=21, abundance_min=2, verbose=False),
            torch.device("cuda", 0), log=lines.append, observer=observer)
        t1 = time.perf_counter()
        os.makedirs(out, exist_ok=True)
        write_all_matrices(out, compute_all_matrices(stats), ids)
        observer.update(statistics_s=t1 - t0,
                        output_s=time.perf_counter() - t1)
        return observer

    saved = os.environ.get("SIMKA_TPU_HBM_MB")
    os.environ["SIMKA_TPU_HBM_MB"] = "20000"
    try:
        rec, o = cli_run("restart 8 samples", [], out, recorder, run=restart)
    finally:
        if saved is None:
            del os.environ["SIMKA_TPU_HBM_MB"]
        else:
            os.environ["SIMKA_TPU_HBM_MB"] = saved
    held = o["restart_held_bytes"] - o["base_bytes"]
    trip = next(m for m in lines if "restarting out-of-core" in m)
    if o["route"] != "restart" or o["sweep_ranges"] < 2:
        raise AssertionError(f"restart 8 samples: route {o['route']}, "
                             f"{o.get('sweep_ranges')} hash ranges")
    if held > 256 << 20:
        raise AssertionError(f"restart 8 samples: {held} B of the in-memory "
                             "run still allocated at the restart")
    if csv_texts(out) != yardsticks["default k=21"]:
        raise AssertionError("restart 8 samples: CSVs differ from phase 7's "
                             "default run")
    say(f"full restart, 8 samples, compute_statistics under "
        f"SIMKA_TPU_HBM_MB=20000: {trip}; {held} B more allocated at the "
        f"restart than before the run; out-of-core on the "
        f"{o['spill_tier']} tier, {o['sweep_ranges']} hash ranges, "
        f"{o['spectrum_rows']} spectrum rows; wall {rec['wall_s']:.3f} s "
        f"(statistics {o['statistics_s']:.3f} s, the out-of-core part: "
        + ", ".join(f"{key} {v:.4f}" for key, v in
                    sorted(o["stage_timers"].items()))
        + f"; output {o['output_s']:.3f} s); compact launches "
        f"{rec['launches']} (kernel kept total == n on each); peak device "
        f"memory {rec['peak_gib']:.2f} GiB; CSVs == phase 7's default run")


def compaction_at_path_shapes(shapes: dict, join_rows: int, range_shape,
                              dev, seed: int) -> tuple:
    """Phase 9; returns (max_abs_err, timings at the k=21 join shape,
    at the extraction-batch shape, at the -out-tmp spectra join's
    abundance filter and at the sweep's largest range extraction)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    saved = compact.launches
    err = 0
    # the 6-column layout (4 words + sid + count, k in 94..124) is on no
    # run above; hold it all the same
    six = (torch.int64,) * 4 + (torch.int32, torch.int32)
    shapes = dict(shapes)
    shapes.setdefault(six, 0)
    spectra = None
    for dtypes, E in sorted(shapes.items(), key=lambda kv: len(kv[0])):
        if len(dtypes) >= 5:
            E = max(E, 1 << 24)
        cols, kept, fills = rows(E, 0.37, gen, dev, dtypes)
        err = max(err, compare(cols, kept, fills))
        names = "+".join(str(d).split(".")[-1] for d in dtypes)
        say(f"compact {len(dtypes)} columns ({names}) E={E}: kernel == "
            "plain in both forms")
        if len(dtypes) >= 5:
            time_compaction(f"{len(dtypes)} columns", cols, kept, fills, 5)
        if dtypes == SPECTRA_JOIN:
            spectra = time_compaction(
                "at the -out-tmp spectra join (i64 word, i32 sid, i32 count, "
                "frac 0.37)", cols, kept, fills, 5)
        del cols, kept
        torch.cuda.empty_cache()
    # the join shape of the k=21 run: (int64 key, int32 count)
    cols, kept, fills = rows(join_rows, 0.37, gen, dev,
                             (torch.int64, torch.int32))
    fills = (-1, 0)
    err = max(err, compare(cols, kept, fills))
    join = time_compaction("at the join shape (i64 key, i32 count, frac "
                           "0.37)", cols, kept, fills, 5)
    del cols, kept
    torch.cuda.empty_cache()
    # an extraction batch: one int64 word column
    cols, kept, fills = rows(EXTRACT_ROWS, 0.979, gen, dev, (torch.int64,))
    err = max(err, compare(cols, kept, fills))
    extract = time_compaction("at an extraction batch (i64 word, frac "
                              "0.979)", cols, kept, fills, 20)
    del cols, kept
    torch.cuda.empty_cache()
    # the sweep's range extraction: every resident spectrum row, one
    # range kept
    dtypes, E, n = range_shape
    cols, kept, fills = rows(E, n / E, gen, dev, dtypes)
    fills = (-1,) * (len(dtypes) - 2) + (0, 0)
    err = max(err, compare(cols, kept, fills))
    ranged = time_compaction(
        f"at the sweep's range extraction ({len(dtypes) - 2} i64 words, i32 "
        f"sid, i32 count, frac {n / E:.4f})", cols, kept, fills, 5)
    del cols, kept
    torch.cuda.empty_cache()
    compact.launches = saved
    return err, join, extract, spectra, ranged


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
    from simka_tpu_torch.io import native

    if not native.available():
        raise RuntimeError(
            "the native parser did not build (g++ and zlib): the measured "
            "run would take the slower pure-Python reader")
    say(f"native parser: {os.path.relpath(native.SRC)} -> "
        f"{os.path.relpath(native.get_lib()._name)}")

    dev = torch.device("cuda", 0)
    err = kernel_vs_plain(dev)
    probe = probe_phase(dev, args.seed)
    with tempfile.TemporaryDirectory(prefix="simka_chip_smoke_") as tmp:
        with ShapeRecorder() as rec:
            small_gpu_vs_cpu(tmp, args.seed)
            determinism(dev, args.seed)
            rec.check_totals()
            paths, inp8, inp9, yardsticks = full_size(tmp, args.seed, rec)
            out_tmp_run = out_tmp_full_size(tmp, inp8, inp9, yardsticks, rec,
                                            dev)
            sweep_run = out_of_core_full_size(tmp, args.seed, inp8, inp9,
                                              yardsticks, rec)
    main_run = paths["default k=21"]
    c_err, join, extract, spectra, ranged = compaction_at_path_shapes(
        rec.shapes, main_run["instances"], rec.range_shape, dev, args.seed)
    err = max(err, c_err)

    # compact_rows at the join shape in the path's exact-length form;
    # the fill form and the extraction batch beside it
    kernels = [{
        "name": "compact_rows",
        "route": "cuda",
        "source": "simka_tpu_torch/csrc/compact.cu",
        "replaces": REPLACES,
        "launches": main_run["launches"],
        "launches_out_tmp": out_tmp_run["launches"],
        "launches_sweep": sweep_run["launches"],
        "max_abs_err": err,
        **{k: join[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "fill_ms", "fill_bound_ms",
                                "copy_ms")},
        **{f"extract_{k}": extract[k] for k in ("ms", "plain_ms",
                                                 "bound_ms", "library_ms")},
        **{f"spectra_join_{k}": spectra[k] for k in ("ms", "plain_ms",
                                                      "bound_ms", "fill_ms")},
        **{f"sweep_extract_{k}": ranged[k] for k in (
            "ms", "plain_ms", "bound_ms", "library_ms", "fill_ms",
            "plain_fill_ms", "fill_bound_ms")},
    }]
    gram = probe["gram"]
    kernels.append({
        "name": "probe_gram_bf16",
        "route": "cuda",
        "source": "simka_tpu_torch/csrc/probes.cu",
        "replaces": "scripts/profiling/test_mosaic_features.py:11",
        **{k: gram[k] for k in ("launches", "max_abs_err", "ms", "plain_ms",
                                "bound_ms", "bound_by", "library_ms",
                                "device_ms", "library_device_ms")},
    })
    for name, g in probe["groups"].items():
        kernels.append({
            "name": f"probes.{name}",
            "route": "cuda",
            "source": "simka_tpu_torch/csrc/probes.cu",
            "replaces": probes.GROUPS[name],
            **{k: g[k] for k in ("launches", "max_abs_err", "ms", "plain_ms",
                                 "bound_ms", "bound_by", "library_ms",
                                 "device_ms", "library_device_ms")},
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
