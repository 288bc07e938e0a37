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
     launch count of each of the four groups and of each probe kernel
     over that run; then the edge inputs (probes.EDGES) kernel == plain
     bit for bit: kd's and ke's max predicate (all values <= 0, -0.0,
     one positive at the last element, int32 minimum), the DMA kernel
     at dma_align offsets 1, 2, 3 and 7131 (the last in bounds) and f6
     at 0, the elementwise kernel on f1, f2, k2, k7 and kc inputs 4, 8
     and 12 bytes past a 16-byte boundary, the one-hot kernel on k3's
     and k5's values below 0 only, at or past cols only, of every class,
     and one row; the launch floor (the device time of a one-element
     fill_); then per probe the kernel's
     CUDA-event time around the Python call, its device time from
     torch.profiler (the summed durations of the trace's events of the
     hand kernels' own names, kept only when the trace holds one for
     each launch counted; every event name of the first probe's and of
     the bf16 product's calls printed), the plain version's time, its
     bound (a DMA probe's: the window read and written and its offset)
     beside the launch floor and, where one torch call computes the
     same function, that call's times (the DMA probes: torch.add(out=)
     of the window, src and dst taken on the host; for the bf16
     products torch.mm(out_dtype=float32) on the operands cast
     beforehand); the bf16 product twice, bit-identical; per launch of
     probe_dma_add1 and of probe_map, means over the probes that launch
     it alone; the one-hot kernel's store floor (out.zero_() of its 1 MB
     output) beside its per-launch times;
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
     the path); then one more default run keeps its join's pair-kernel
     inputs for phase 14c's timing at N = 8;
  8. the -out-tmp checkpoint path at full size through the CLI (k=21,
     default distances, -max-memory 50000 unless said): run 1 counts the
     8 samples into checkpoints, its CSVs byte-equal to phase 7's
     default run (run 0); run 2 resumes all 8 (files untouched, same
     CSVs); run 3 adds the ninth sample and counts only it; run 3s
     resumes the 9 at the default -max-memory, where the reference's
     spill rule takes the sweep (the disk tier, -keep-tmp), its CSVs
     equal to run 3's; run 3f resumes the 8 with -simple-dist
     -complex-dist -sweep-ranges 7 over the shards [cuda:0] x 2 (phase
     13b), its CSVs byte-equal to phase 7's all-distances k=21 run;
     run 4, without -keep-tmp, resumes all 9
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
     the column layouts phases 5-8, 10 and 11 gave it, each at the
     largest E it saw up to 2^29 rows (at least 2^24 rows for 5 to 7
     columns; 6 columns, k in 94..124, added); then timed, both forms
     beside the least time the card could take (bytes over 3.35 TB/s)
     and, for one column,
     torch.masked_select: at the join shape of the k=21 run, at an
     extraction batch (2^17 reads x 80 windows, kept 0.979), at the
     -out-tmp spectra join (word, sample id, count) and at the sweep's
     range extraction (the same columns over every resident spectrum
     row, kept about 1/R: phase 10's largest) and at phase 13a's shard
     split (one exact-length compaction a destination of an extraction
     batch's words, kept 1/2 and 1/4);
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
     total == n on each), peak device memory and spectrum rows;
 11. SimkaMin's sketch: (a) the MurmurHash3 kernel (csrc/minhash.cu)
     against its plain version bit for bit (hashes, keep mask, valid and
     kept counts) at E in {1, 4095, 2^20+3, 2^24} x validity {0, 0.5, 1}
     x keep bound {all, 2^60}, edge words 0 and 2^62-1, and a misaligned
     view; (b) small communities, `min sketch` on cuda and on cpu with
     byte-equal sketch files: k 21 and 31 with and without -filter,
     -filter-bloom at k=21, every sketch full; each route forced once
     (batched with the prefilter, the bail to per-sample, one sample,
     streaming with and without -filter, -filter's cut counted), all
     equal; `min info` text and `min append` bytes equal; (c) phase 7's
     8 samples through `min sketch` (the CLI's min_main with an
     observer): -nb-kmers 100000 and 1000000 twice each (batched,
     prefiltered, identical bytes), -filter at 100000 (the bail to
     per-sample), the per-sample route's file == the batched one, one
     sample streamed (stream_threshold 2^22) == its one-shot sketch, and
     that sample on the CPU == the card's; then one -filter sample past
     the card's default streaming threshold (the 8 files three times
     over): the streaming route, cut at least once, == the same with the
     threshold at 2^26, and its members and counts but the largest ==
     the sketch without -filter; per run wall, route, prefilter
     fraction, stages, instances, kept instances, -filter cuts,
     hash-kernel and compaction launches (kept total == n on each), peak
     device memory; (d) at the first full-size batch of a sample: the
     hash kernel's time around the call and on the device (as the
     probes'; every event name of the call printed) against its
     plain version and bound (bytes or 32-bit integer instructions),
     then at 2^24; the compaction at the prefilter's shape (the int64
     hash, the run's own keep mask) in both forms beside its plain
     version, bound and torch.masked_select;
 12. SimkaMin's distance: (a) the sketch-pair kernel
     (csrc/min_distance.cu, a merge path in segments of SEG = 4,096
     merged positions) against its plain version, tallies bit for bit,
     in one launch and in tiles of 3 pairs, on every pair of small
     lists (an
     empty sketch, lengths 1 and unequal, identical and disjoint
     sketches, the all-ones hash as a member, hashes with the top bit
     set; merged lengths about one and two segments; a shared value
     whose A copy ends one segment and B copy opens the next, at the
     first and second boundary; identical sketches of 4 SEG, cut off
     at 2 min; interleaved disjoint ones, cut off at min; lengths 1
     against 1,000,000; each also == the host walk) and on 100
     in-memory sketches of 1,000,000 (ascending distinct uint64 over
     the full range, ~28% from a shared pool, counts 1-255; 4,950
     pairs; == the host walk on 50 seeded pairs), timed there beside its
     bound (the larger of each sample's needed rows read once and the
     merge's integer instructions), the design's L2 floor (every pair's
     needed members staged at an L2 read rate measured in the run) and
     the simple one-CTA-a-pair form's time from an earlier call (printed
     only); (b) small communities, `min pipeline` (k 21 and 31, with and
     without -filter, resident route, one pair launch) then `min
     update` on cuda and on cpu, every file equal; `min distance`
     whole, in 3 tiles of 2 x 2 and across two files, `export` and
     `matrix-update`, cuda == cpu, tiles == whole; (c) phase 7's 8
     samples through `min pipeline` at -nb-kmers 100000 and 1000000:
     the resident route, sketch.bin == phase 11c's `min sketch` file,
     the matrices == the host walk over it; `min update` with the 9th
     sample == a joint 9-sample pipeline (every file); per run wall,
     stages, route, kernel launches, peak memory; then the kernel at
     the 1,000,000 run's sketches (28 pairs) against its plain
     version, the host walk and its bound, timed as in (a);
 13. hash-space shards (parallel/) on repeated devices of the one card
     and -coordinator: (a) compute_statistics (run_simka with shards)
     over [cuda:0] x 2 and x 4 on phase 7's 8 samples at k=21 with
     every distance, in memory, its CSVs byte-equal to phase 7's
     all-distances k=21 run, the instances per shard summing to that
     run's; (b) inside phase 8: its run 3f, the -sweep-ranges 7 sweep
     (all distances) over [cuda:0] x 2, and before its run 4 the
     -out-tmp join over [cuda:0] x 2, each resuming phase 8's 8
     checkpoints, byte-equal to phase 7's all-distances and default
     runs; (c) the CLI with -coordinator as one NCCL
     rank in a subprocess (its exchange and reductions through NCCL),
     all distances, byte-equal to phase 7's run; two ranks, one a card
     (CUDA_VISIBLE_DEVICES), only where the machine has two cards (two
     ranks on one card are refused), else a line saying it did not run;
     (d) the -coordinator join as one NCCL rank in this process over the
     local shards [cuda:0] x 2 (run_simka_multihost with shards),
     all distances, byte-equal to phase 7's run. Per run wall, per-shard
     rows, compaction launches (kept total == n on each), peak memory;
 14. the wide-N exact path: (a) the pair kernel (csrc/pair_sums.cu)
     against its plain version on the same CUDA tensors, every channel,
     KL limb and whittaker_all entry (against _whittaker_all) equal, in
     one launch, at N in {2, 8, 33, 100, 256, 300, 1000} (a private copy
     of the partials a warp, copies shared by teams of warps, one copy,
     sample groups, the global form) on random segment layouts
     (singletons, full segments, counts up to 2^20 and 2^31 - 1), the
     default and every channel; (b) 100 samples x 50,000 reads of 20
     genomes x 200 kbp through the CLI (k=21), the default distances
     once and every distance twice (identical CSVs), each in memory and
     with one pair-kernel launch; per run wall, stages, instances,
     distinct solid k-mers, solid rows, d_max, pairs, pair-kernel and
     compaction launches, peak memory; (c) the kernel against its plain
     version on the default run's own solid rows, equal, each timed
     with CUDA events beside the bound (the plain loop held on a slice
     of whole segments when it would pass 60 s), for the default
     channels and every channel with whittaker_all, beside the kernel's
     global form on the same rows (equal, timed), and _whittaker_all's
     time there (the same on phase 7's rows, N = 8, after phase 7); (d)
     for three pairs (i, j) a 2-sample CLI run of samples i and j gives
     the [i, j] entry of every pair-local matrix
     (tests/test_large_n.py's PAIR_LOCAL) of the every-distance run,
     Jensen-Shannon to one unit of its 6th decimal. Every CLI run that
     joins on the card (phases 7, 8, 10, 13a, 13b, 13d, 14) launches the
     pair kernel, and the plain pair sums and _whittaker_all raise on a
     CUDA tensor while the path runs.
 15. the extraction, run-count and segment kernels (csrc/kmers.cu,
     csrc/runs.cu): (a) each against its plain version on the card, bit
     for bit: extract_kmers (words of every window, keep mask, kept
     count, histogram) at k in {1, 15, 16, 21, 31, 32, 33, 48, 62, 63,
     64, 127} x comp_xor {3, 2} x the Shannon filter {off, 1.0, 1.5} x
     the histogram {off, on} on 1,024 reads of 160 slots (ragged, all-N,
     shorter than k, empty, low-complexity repeats), and the codes
     entry point; run_counts (count, keep, total) with every row its
     own run, one run of 2^24 rows, runs ending at and beside every
     tile edge, runs of 1-8 rows under the bounds [3, 6] (counts at
     amin - 1 .. amax + 1) and E = 1, keys of 1 and 6 columns;
     segment_stats (per-bank totals, the segment starts, nb_distinct,
     nb_shared, d_max, max_count) at N in {1, 2, 8, 100, 1000, 20000}
     (shared bins, then device-memory atomics; N = 20000's first
     segment spans five tiles) and at the look-back and tile edges (a
     k-mer over five tiles, k-mers from each tile's first and last row,
     n = 1, 4095, 4096, 4097, every row of 2^24 its own k-mer, one
     k-mer of 2^22 rows, N = 1706 and 1707, 2 and 3 word columns whose
     first alone tells the k-mers apart), each twice with the same
     starts and totals; (b) timed with CUDA
     events beside the bound and the plain version: the extraction at
     phase 7's first full batch (k=21 and k=63), run_counts at phase
     7's sorted packed key (beside
     torch.unique_consecutive(return_counts=True)) and segment_stats at
     phase 14's and phase 7's solid rows (on the device too, the chain
     from the rows to the starts and lengths, and its plain version's
     three index_add_ totals), each input kept by the path's own run;
     the packed sort (ops/sort.py, csrc/sort.cu) == torch.sort bit for
     bit at phase 7's keys (its sorted key split back into words and
     sample ids, in a seeded random order) and at the benchmark cell's
     ~484 M seed-made 45-bit keys, timed around the call and on the
     device beside the yardstick's bound (16 B a key), the design's
     bound and torch.sort(...).values. Phase 7's k=21 runs launch the
     sort's 8 kernels once, its k=63 runs none.
     Every CLI run that joins launches the segment kernel; phase 7's
     runs launch the extraction once a batch (32) and run_counts and
     segment_stats once, phase 14b's 100 / 1 / 1; the plain extraction,
     run counts and segment pass raise on a CUDA tensor while the path
     runs.
 16. (run right after phase 2) the H2D line: one batch of the
     benchmark's cells (2^17 reads x 152 bases, 7,471,104 B) by the
     ingest's shipper (core/pipeline.py::_shipper) from pageable numpy
     and from page-locked arrays (the native parser's batches for a
     job on a card), each equal to the host batch and counted as
     page-locked or not; the host time around the call, the copies'
     device time and kind (torch.profiler's memcpy events) and their
     rate in GB/s.
     Alone: python3 -c "import torch, chip_smoke;
     chip_smoke.h2d_line(torch.device('cuda', 0), 0)".

Prints, before the last line, the kernels' JSON record (per kernel:
launches on the main path, max_abs_err, ms, plain_ms, bound_ms,
bound_by, library_ms -- null where no one torch call computes the same
function -- launches_out_tmp, launches_sweep and launches_sketch, the
compaction's launches in phase 8's run 1, in phase 10's 16-sample run
and in phase 11's -nb-kmers 100000 run, whose hash-kernel launches are
murmur_kmers' launches; launches_shards_2 and launches_shards_4, the
compaction's in phase 13a, launches_coordinator_shards_2 in phase 13d,
and the compaction's shard_split_* times at 13a's split; pair_sums'
launches in phase 7's default run, launches_wide_n and
launches_wide_n_all in phase 14b's default and first every-distance
run, the other launches_* as the compaction's, its times at phase 14c's
rows (all_*: every channel with whittaker_all; plan the launch's
layout; global_ms the global form; all_wall_plain_ms _whittaker_all's
torch ops; sample_counts the rows' distinct (sample, count), which
whittaker_all's bound counts N terms each), n8_* at phase 7's rows;
min_pair_distance's launches are phase 12c's
`min pipeline -nb-kmers 1000000`'s, its times at that run's sketches
(l2_floor_ms: the design's L2 floor), wide_* at phase 12a's 100 x
1,000,000; probe_dma_add1's, probe_map's and probe_onehot_f32's per
launch, with launch_floor_ms and per_probe, the last with
store_floor_ms and store_floor_device_ms; extract_kmers', run_counts',
segment_stats' and sort_packed_keys' launches in phase 7's default run,
the other
launches_* as the compaction's, their times at phase 15b's shapes
(k63_* the extraction at k=63; the segment pass's at phase 14's rows,
n8_* at phase 7's, device_ms on the device (CUDA events around
back-to-back launches of its entry point, the stream kept busy ahead
of them), chain_ms the rows to the
starts and lengths, index_add_ms the plain segment pass's three
index_add_ totals; the sort's at phase 7's keys, cell_* at the
cell's, device_ms as the segment pass's, design_bound_ms the design's
bytes, plain_ms its plain version, torch.sort); extra fields; beside
"kernels", "h2d": phase 16's numbers) and the card's nvidia-smi line;
the last line is the JSON result. Exits non-zero without a result when
no CUDA device is present.
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
from simka_tpu_torch.minhash import device as minhash
from simka_tpu_torch.minhash import device_distance as dd
from simka_tpu_torch.minhash.sketch import STAGES
from simka_tpu_torch.ops import _kernels, compact, countjoin, kmers, sort
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
# 32-bit integer instructions: 64 integer lanes an SM, a quarter of the
# datasheet's 67 TFLOP/s float32 rate (128 lanes, an FMA two operations)
INT32_OPS_PER_S = 67e12 / 4
# the hash kernel's 32-bit integer instructions a window (csrc/minhash.cu)
MURMUR_INT_OPS = 66
MURMUR_REPLACES = "simka_tpu/minhash/device.py:50"
# the hand kernels' __global__ names in csrc/ (compact.cu, kmers.cu,
# minhash.cu, min_distance.cu, pair_sums.cu, probes.cu, runs.cu): a
# device time counts only the trace's events of these
HAND_KERNELS = ("compact_onepass", "extract_kmers", "murmur_kmers",
                "min_pair_tallies", "pair_sums", "probe_", "run_counts",
                "segment_stats")
SKETCH_SIZES = (100_000, 1_000_000)  # `min sketch` and `min pipeline`
PAIR_REPLACES = "simka_tpu/minhash/device_distance.py:85"
WIDE_N, WIDE_S = 100, 1_000_000  # phase 12a's in-memory sketches
# the simple one-CTA-a-pair form's device times of the pair kernel (ms)
# at phase 12a's wide shape and at `min pipeline`'s 28 pairs: an earlier
# call on an NVIDIA H100 80GB HBM3, 700.00 W (PERF.md section 6), printed
# beside this run's times
EARLIER_PAIR_MS = {"wide": 147.5494, "pipeline": 10.1479}
# the pair merge's 32-bit integer instructions a member its walk needs:
# a 64-bit compare and a 64-bit add, two each
PAIR_INT_OPS = 4
# the L2 read-rate probe: a buffer inside the H100's 50 MB L2, read this
# many times in one launch
L2_PROBE_BYTES, L2_PROBE_READS = 24 << 20, 128
HOST_WALK_PAIRS = 50
PHASE9_MAX_ROWS = 1 << 29
EXTRACT_ROWS = (1 << 17) * 80  # a 2^17-read batch of 100 bp reads, k=21
# the -out-tmp join's abundance filter at k=21: (word, sample id, count)
SPECTRA_JOIN = (torch.int64, torch.int32, torch.int32)
BATCH_READS = 1 << 17  # the in-memory ingest's reads a batch


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


def bound(nbytes: float, ops: float = 0.0, ops_rate: float = BF16_OPS_PER_S):
    """(least ms the card could take, "bytes" or "operations")."""
    b, o = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_rate * 1e3
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


def stream_ms(fn, reps: int = 10, rounds: int = 3) -> float:
    """Device time of one call of fn whose device work outlasts its host
    work: CUDA events around reps back-to-back calls, the stream kept
    busy by a device sleep while the host enqueues them, so that no host
    time falls between the events; the median over rounds, a call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(4_000_000)  # ~2 ms of clock cycles
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
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


def h2d_line(dev, seed: int, reps: int = 30) -> dict:
    """Phase 16: one ingest batch of the benchmark's cells (2^17 reads
    of 152 bases: 38 B of packed codes and 19 B of valid bits a read,
    7,471,104 B) onto the card by the ingest's shipper
    (``core.pipeline._shipper``), from pageable numpy and from
    page-locked arrays, as the native parser gives them for a job on a
    card, each equal to the host batch and counted as page-locked or
    not (``h2d_pinned_in``). Per way: the host time around the call
    (the median over ``reps``), the copies' device time and kind from
    torch.profiler (its memcpy events), and their rate in GB/s."""
    from simka_tpu_torch.core import pipeline
    from simka_tpu_torch.utils.metrics import Spans

    rng = np.random.default_rng(seed)
    packed = rng.integers(0, 256, (BATCH_READS, 38), dtype=np.uint8)
    vb = rng.integers(0, 256, (BATCH_READS, 19), dtype=np.uint8)
    nbytes = packed.nbytes + vb.nbytes
    locked = [torch.empty(a.shape, dtype=torch.uint8, pin_memory=True)
              for a in (packed, vb)]
    for t, a in zip(locked, (packed, vb)):
        t.copy_(torch.from_numpy(a))
    locked = [t.numpy() for t in locked]

    out = {"bytes": nbytes}
    for name, (p0, v0) in (("pageable", (packed, vb)),
                           ("page_locked", locked)):
        spans = Spans()
        ship = pipeline._shipper(dev, spans)

        def fn():
            return ship((0, p0, v0, None))[1:3]

        p, v = fn()
        torch.cuda.synchronize()
        if not (np.array_equal(p.cpu().numpy(), packed)
                and np.array_equal(v.cpu().numpy(), vb)):
            raise AssertionError(f"H2D by {name}: the device batch differs")
        if spans.counters["h2d_pinned_in"] != (name == "page_locked"):
            raise AssertionError(f"H2D by {name}: counted {spans.counters}")
        host = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            host.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
        events, _ = traced(fn, reps)
        copies = [(s, e, n) for s, e, n in events if "Memcpy" in n]
        dev_ms = sum(e - s for s, e, _ in copies) / 1e3 / reps
        out[name] = {
            "host_ms": float(np.median(host)),
            "device_ms": dev_ms if copies else None,
            "gbps": nbytes / dev_ms / 1e6 if copies else None,
            "kinds": sorted({n for _, _, n in copies}),
        }

    def line(r):
        rate = "not measured" if r["gbps"] is None else f"{r['gbps']:.2f}"
        return (f"{r['host_ms']:.4f} ms around the call, "
                f"{fmt(r['device_ms'])} of {r['kinds']} ({rate} GB/s)")

    say(f"H2D of one cell batch ({nbytes:,} B, {reps} calls) by the "
        f"shipper: from pageable numpy {line(out['pageable'])}; from "
        f"page-locked arrays (the native parser's for a job on a card) "
        f"{line(out['page_locked'])}")
    return out


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


def traced(fn, reps: int, launches=None):
    """(the device events (start, end, name) of reps calls of fn under
    torch.profiler, after one call outside it; the kernel launches the
    zero-arg reader ``launches`` counted meanwhile, or None)."""
    fn()
    torch.cuda.synchronize()
    n0 = launches() if launches else 0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return (trace.device_intervals(prof.events()),
            launches() - n0 if launches else None)


def device_ms(fn, reps: int = 20, only=HAND_KERNELS, launches=None):
    """Device time of one call of fn: the summed durations of its device
    events whose name holds one of ``only`` (default: the hand kernels'
    own; None: every event) under torch.profiler, over reps calls (one
    stream: the events do not overlap). None when the trace shows no
    such event or, given the wrapper's launch counter ``launches``,
    fewer events than launches: the trace lost some of the kernels that
    ctypes launched."""
    events, n = traced(fn, reps, launches)
    intervals = [iv for iv in events
                 if only is None or any(k in iv[2] for k in only)]
    if not intervals or (n is not None and len(intervals) != n):
        return None
    return sum(e - s for s, e, _ in intervals) / 1e3 / reps


def trace_names(tag: str, fn, launches, reps: int = 3) -> None:
    """Print every device event name of reps calls of fn under
    torch.profiler, with its count and summed time, the union of the
    events' intervals and the hand-kernel launches counted meanwhile:
    what the trace saw."""
    events, n = traced(fn, reps, launches)
    rows = trace.top_events(events, n=len(events))
    say(f"trace of {tag}, {reps} calls, {n} hand-kernel launches: "
        + ("; ".join(f"{name} x{c} {t:.1f} us" for t, c, name in rows)
           or "no device event")
        + f"; union {trace.union_us(events):.1f} us")


def dma_window(p, args):
    """(src, dst, length) of DMA probe p on its inputs (the offset read
    on the host), or None for the other probes."""
    if p.name.split("@")[0] not in probes.DMA_SPANS:
        return None
    return probes.dma_window(p.name, args[0] if len(args) == 2 else None)


def library_call(p, args):
    """One torch call that computes probe p's function on its inputs,
    or None where none does (the bf16 products' operands are cast, and
    k6's one-hot built, outside the timed call). Timed here only: the
    port never calls it."""
    x = args[-1]
    if dma_window(p, args):
        # the window + 1 with src and dst taken on the host: the kernel
        # reads its offset on the device, a dependent read this call skips
        src, dst, length = dma_window(p, args)
        window = x.reshape(-1)[src:src + length]
        out = torch.zeros_like(x).view(-1)[dst:dst + length]
        return lambda: torch.add(window, 1, out=out)
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
    # none, each needing two calls: k3 and k5 (one_hot's result is int64
    # and wants a cast to f32; k3's negative values one_hot refuses), k7
    # and kc (a roll, then the add), kb (a shift, then the mask), ke (a
    # max-reduce, then the select)
    return None


def probe_bound(p, args):
    """Bound of one probe call: for a DMA probe the window read and
    written (2 x length x 4 B) and the offset it reads; otherwise the
    bytes of its inputs and outputs, and for a bf16 product that runs
    2 x rows x 128^2 operations (kd on negative inputs skips it)."""
    if dma_window(p, args):
        _, _, length = dma_window(p, args)
        return bound(2 * length * 4 + (4 if len(args) == 2 else 0))
    out = p.plain(*args)
    outs = out if isinstance(out, tuple) else (out,)
    nbytes = sum(t.numel() * t.element_size() for t in (*args, *outs))
    product = (p.name.startswith(("gram_bf16", "cond_gram", "onehot_gram"))
               and p.name != "cond_gram_negative")
    ops = 2 * args[-1].shape[0] * probes.LANES ** 2 if product else 0
    return bound(nbytes, ops)


def launch_floor_ms(dev):
    """Device time of the card's shortest kernel, a one-element fill_:
    what no probe design can remove."""
    t = torch.empty(1, device=dev)
    return device_ms(lambda: t.fill_(1.0), only=None)


def probe_launches() -> int:
    """Kernel launches of every probe group so far."""
    return sum(probes.launches.values())


# the hand kernels that the probe path's own record lists, with the TPU
# kernels they serve
PROBE_KERNEL_RECORDS = {
    "probe_dma_add1": "scripts/profiling/test_pallas_basic.py:61,92,123,158"
                      "; scripts/profiling/test_dma_align.py:35",
    "probe_map": "scripts/profiling/test_pallas_basic.py:27,39; "
                 "scripts/profiling/test_mosaic_reshape.py:11; "
                 "scripts/profiling/test_mosaic_features.py:11",
    "probe_onehot_f32": "scripts/profiling/test_mosaic_reshape.py:11",
}
PER_LAUNCH = ("ms", "device_ms", "plain_ms", "bound_ms")


def kernel_record(rows: list, launches: int, floor) -> dict:
    """One hand kernel's record, per launch: means over the probes whose
    call launches it alone and once (``rows``); the one-call yardstick's
    times are means over those of them that have one."""
    mean = lambda vals: (None if not vals or any(v is None for v in vals)
                         else float(np.mean(vals)))
    lib = [r for r in rows if r["library_ms"] is not None]
    return {
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        **{k: mean([r[k] for r in rows]) for k in PER_LAUNCH},
        "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r in rows)
                     else "operations"),
        "library_ms": mean([r["library_ms"] for r in lib]),
        "library_device_ms": mean([r["library_device_ms"] for r in lib]),
        "library_probes": [r["name"] for r in lib],
        "launch_floor_ms": floor,
        "per_probe": {r["name"]: {k: r[k] for k in (
            *PER_LAUNCH, "library_ms", "library_device_ms")} for r in rows},
    }


def probe_phase(dev, seed: int) -> dict:
    """Phase 4: the probe path, then each probe's times; returns per
    group, and for the bf16 product ("gram"), {launches, max_abs_err,
    ms, device_ms, plain_ms, library_ms, library_device_ms, bound_ms,
    bound_by}, and under "kernels" the record (kernel_record) of each
    kernel of PROBE_KERNEL_RECORDS."""
    for g in probes.launches:
        probes.launches[g] = 0
    for k in probes.kernel_launches:
        probes.kernel_launches[k] = 0
    results = probes.run_all(dev, seed, strict=True, log=say)
    torch.cuda.synchronize()
    keys = ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms",
            "bound_ms")
    groups = {g: {"launches": probes.launches[g], "max_abs_err": 0.0,
                  **dict.fromkeys(keys, 0.0)} for g in probes.GROUPS}
    path_launches = dict(probes.kernel_launches)
    gram = {"launches": path_launches["probe_gram_bf16"], "max_abs_err": 0.0}
    idle = [g for g, v in groups.items() if v["launches"] <= 0] + [
        k for k, n in path_launches.items() if n <= 0]
    if idle:
        raise AssertionError(f"the probe path never launched {idle}")
    errs = {r["name"]: r["max_abs_err"] for r in results}
    for r in results:
        g = groups[r["group"]]
        g["max_abs_err"] = max(g["max_abs_err"], r["max_abs_err"])
        if "gram" in r["name"]:
            gram["max_abs_err"] = max(gram["max_abs_err"], r["max_abs_err"])
    for e in probes.EDGES:
        probes.compare(*probes.edge_inputs(e.probe, e.edge, seed, dev))
    torch.cuda.synchronize()
    say("edge inputs, kernel == plain bit for bit: " + ", ".join(
        f"{e.probe} {e.edge}" for e in probes.EDGES))
    saved = dict(probes.launches), dict(probes.kernel_launches)
    floor = launch_floor_ms(dev)
    say(f"launch floor (a one-element fill_ on the device): {us(floor)}")
    rows = {k: [] for k in PROBE_KERNEL_RECORDS}
    for p in probes.PROBES:
        args = probes.probe_inputs(p, seed, dev)
        lib = library_call(p, args)
        before = dict(probes.kernel_launches)
        p.fn(*args)
        per_call = {k: n - before[k] for k, n in probes.kernel_launches.items()
                    if n != before[k]}
        t = {
            "ms": time_ms(lambda: p.fn(*args), reps=20),
            "device_ms": device_ms(lambda: p.fn(*args),
                                   launches=probe_launches),
            "plain_ms": time_ms(lambda: p.plain(*args), reps=20),
            "library_ms": None if lib is None else time_ms(lib, reps=20),
            "library_device_ms": (None if lib is None
                                  else device_ms(lib, only=None)),
        }
        if p is probes.PROBES[0]:
            trace_names(f"probe {p.name}", lambda: p.fn(*args),
                        probe_launches)
        t["bound_ms"], t["bound_by"] = probe_bound(p, args)
        g = groups[p.group]
        g["bound_by"] = "bytes" if g.get("bound_by", "bytes") == \
            t["bound_by"] == "bytes" else "operations"
        for k in keys:  # a group's sum is None once a probe lacks the time
            g[k] = None if g[k] is None or t[k] is None else g[k] + t[k]
        if len(per_call) == 1:  # the probes that launch one kernel once
            ((kernel_name, n),) = per_call.items()
            if n == 1 and kernel_name in rows:
                rows[kernel_name].append(
                    {"name": p.name, "max_abs_err": errs[p.name], **t})
        if p.name == "gram_bf16_normal":  # ka at its shape, normal values
            trace_names(f"probe {p.name}", lambda: p.fn(*args),
                        probe_launches)
            gram.update({k: t[k] for k in keys})
            gram["bound_ms"], gram["bound_by"] = t["bound_ms"], t["bound_by"]
            a, b = p.fn(*args), p.fn(*args)
            torch.cuda.synchronize()
            if not torch.equal(a, b):
                raise AssertionError("the bf16 product differs between runs")
        say(f"probe {p.name} ({p.tpu}; " + ", ".join(
            f"{k} x{n}" for k, n in per_call.items()) + f"): kernel "
            f"{us(t['ms'])} around the call, {us(t['device_ms'])} on the "
            f"device; plain {us(t['plain_ms'])}; one torch call "
            f"{us(t['library_ms'])} ({us(t['library_device_ms'])} on the "
            f"device); bound {us(t['bound_ms'])} by {t['bound_by']}, "
            f"launch floor {us(floor)}")
    # kd's predicate alone: the grid-wide max-reduce to a device flag
    # against torch.amax over the same [2048, 128] f32 input
    (x,) = probes.probe_inputs(next(p for p in probes.PROBES
                                    if p.name == "cond_gram_normal"), seed,
                               dev)
    kernel = lambda: probes._max_positive("mosaic_features", x)
    amax = lambda: torch.amax(x)
    pred = {
        "max_pred_ms": time_ms(kernel, reps=20),
        "max_pred_device_ms": device_ms(kernel, only=("probe_max_positive",),
                                        launches=probe_launches),
        "max_pred_library_ms": time_ms(amax, reps=20),
        "max_pred_library_device_ms": device_ms(amax, only=None),
    }
    groups["mosaic_features"].update(pred)
    say(f"kd's max predicate: kernel {pred['max_pred_ms']:.4f} ms around "
        f"the call, {fmt(pred['max_pred_device_ms'])} on the device; "
        f"torch.amax {pred['max_pred_library_ms']:.4f} ms "
        f"({fmt(pred['max_pred_library_device_ms'])} on the device)")
    probes.launches.update(saved[0])  # timing launches are not the path's
    probes.kernel_launches.update(saved[1])
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
    # the one-hot kernel's store floor: out.zero_() of the same [2048,
    # 128] f32 (1 MB), the stores alone; no one torch call computes the
    # one-hot itself, so its library_ms stays null
    out = torch.empty((2048, probes.LANES), dtype=torch.float32, device=dev)
    store_floor = {"store_floor_ms": time_ms(out.zero_, reps=20),
                   "store_floor_device_ms": device_ms(out.zero_, only=None)}
    say(f"the one-hot's store floor, out.zero_() of [2048, 128] f32: "
        f"{us(store_floor['store_floor_ms'])} around the call, "
        f"{us(store_floor['store_floor_device_ms'])} on the device")
    kernels = {}
    for k, r in rows.items():
        rec = kernels[k] = kernel_record(r, path_launches[k], floor)
        if k == "probe_onehot_f32":
            rec.update(store_floor)
        say(f"{k}: {rec['launches']} launches on the probe path; per launch "
            f"(means over {', '.join(x['name'] for x in r)}) "
            f"{us(rec['device_ms'])} on the device, bound "
            f"{us(rec['bound_ms'])} by {rec['bound_by']}, launch floor "
            f"{us(floor)}; one torch call {us(rec['library_device_ms'])} "
            f"on the device (means over "
            f"{', '.join(rec['library_probes'])})"
            + (f"; store floor {us(rec['store_floor_device_ms'])} on the "
               "device" if "store_floor_ms" in rec else ""))
    return {"groups": groups, "gram": gram, "kernels": kernels}


def fmt(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def us(ms) -> str:
    return "not measured" if ms is None else f"{ms * 1e3:.4f} us"


def csv_texts(out_dir: str) -> dict:
    return {
        os.path.basename(p): gzip.open(p, "rt").read()
        for p in sorted(glob.glob(os.path.join(out_dir, "*.csv.gz")))
    }


def metrics_of(out_dir: str) -> dict:
    with open(os.path.join(out_dir, "simka_metrics.json")) as f:
        return json.load(f)


# set while a comparison runs a plain version on CUDA tensors
PLAIN_ON_CARD = [False]


class plain_on_card:
    """Lets the plain versions of the hand kernels (the pair sums,
    ``_whittaker_all``, the extraction, the run counts, the segment
    pass) run on CUDA tensors inside ``ShapeRecorder`` (a comparison,
    not the path)."""

    def __enter__(self):
        PLAIN_ON_CARD[0] = True

    def __exit__(self, *exc):
        PLAIN_ON_CARD[0] = False


class ShapeRecorder:
    """Records (column dtypes) -> largest E of the compactions the
    card runs while installed (the shapes the main paths give it), and
    each call's device-side kept total beside the caller's n, compared
    by ``check_totals`` after a run (the sync is there, not on the
    path). The sweep's range extractions are kept apart: ``range_shape``
    holds the (dtypes, E, n) of the largest. The plain versions of the
    hand kernels (``GUARDED``) raise on a CUDA tensor while it is
    installed (outside ``plain_on_card``): on the card the path takes
    the kernels."""

    GUARDED = ((countjoin, "_pair_sums_plain", "the plain pair sums"),
               (countjoin, "_whittaker_all", "_whittaker_all"),
               (kmers, "_extract_kmers_plain", "the plain extraction"),
               (countjoin, "_run_counts_plain", "the plain run counts"),
               (countjoin, "_segment_stats_plain",
                "the plain per-bank and segment pass"))

    def __init__(self):
        self.shapes = {}
        self.totals = []
        self.range_shape = None
        self._in_range = False
        self._orig = compact.compact_rows
        self._orig_range = sweep.range_extract
        self._orig_plain = [getattr(m, a) for m, a, _ in self.GUARDED]

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

        def guard(name, orig):
            def guarded(first, *args, **kw):
                t = first[0] if isinstance(first, (tuple, list)) else first
                if t.device.type == "cuda" and not PLAIN_ON_CARD[0]:
                    raise AssertionError(f"{name} ran on a CUDA tensor on "
                                         "the path")
                return orig(first, *args, **kw)
            return guarded

        compact.compact_rows = recording
        sweep.range_extract = range_recording
        for (mod, attr, name), orig in zip(self.GUARDED, self._orig_plain):
            setattr(mod, attr, guard(name, orig))
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
        for (mod, attr, _), orig in zip(self.GUARDED, self._orig_plain):
            setattr(mod, attr, orig)


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
            run=None, joins: bool = True):
    """One CLI run on the card (or ``run()``, another entry point
    writing to ``out`` and returning the run's metrics) with the hand
    kernels' launch counts and peak memory reset before it; every
    compaction's kept total checked after it, and, for a run that
    ``joins``, the pair kernel and the segment pass launched. Returns
    (record, the metrics: simka_metrics.json of a CLI run)."""
    from simka_tpu_torch.cli import main as cli_main

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    compact.launches = 0
    countjoin.launches = 0
    kmers.launches = 0
    countjoin.run_counts_launches = 0
    countjoin.segment_stats_launches = 0
    sort.sort_launches = 0
    t1 = time.perf_counter()
    rc, m = (cli_main(argv), None) if run is None else (0, run())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    if rc != 0:
        raise AssertionError(f"{tag}: cli returned {rc}")
    if compact.launches <= 0:
        raise AssertionError(
            f"{tag}: the run never launched the compaction kernel")
    if joins and countjoin.launches <= 0:
        raise AssertionError(
            f"{tag}: the run never launched the pair-sums kernel")
    if joins and countjoin.segment_stats_launches <= 0:
        raise AssertionError(
            f"{tag}: the run never launched the segment kernel")
    checked = recorder.check_totals()
    if checked != compact.launches:
        raise AssertionError(f"{tag}: {checked} kept totals checked, "
                             f"{compact.launches} launches")
    rec = {
        "launches": compact.launches,
        "pair_launches": countjoin.launches,
        "extract_launches": kmers.launches,
        "run_counts_launches": countjoin.run_counts_launches,
        "segment_launches": countjoin.segment_stats_launches,
        "sort_launches": sort.sort_launches,
        "wall_s": wall,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    return rec, metrics_of(out) if m is None else m


def full_size(tmp: str, seed: int, recorder: ShapeRecorder):
    """Phase 7; returns (each path's first-run record, the inputs of the
    first 8 and of all 9 samples, each path's first CSVs)."""
    from simka_tpu_torch.utils.community import (FULL_COMMUNITY,
                                                 write_community)

    n = FULL_COMMUNITY["n_samples"]
    t0 = time.perf_counter()
    # nine samples: the first eight are the community of 8 of this seed
    inp9 = write_community(os.path.join(tmp, "full"), seed=seed,
                           **{**FULL_COMMUNITY, "n_samples": n + 1})
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
            # one extraction launch a batch, one run count and one
            # segment pass for the one join; at k=21 its packed sort (the
            # histogram, the scan and a launch a digit), at k=63 none
            launches = (rec["extract_launches"], rec["run_counts_launches"],
                        rec["segment_launches"], rec["sort_launches"])
            per = -(-FULL_COMMUNITY["reads_per_sample"] // BATCH_READS)
            sorts = 2 + len(sort.radix_passes(
                2 * k + countjoin._sbits(n))) if k <= 21 else 0
            if launches != (n * per, 1, 1, sorts):
                raise AssertionError(f"full {tag}: extraction, run-count, "
                                     f"segment and sort launches {launches}")
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
                f"pair-sums launches {rec['pair_launches']}, extraction "
                f"{rec['extract_launches']}, run counts "
                f"{rec['run_counts_launches']}, segment pass "
                f"{rec['segment_launches']}, sort {rec['sort_launches']}, "
                f"peak device memory {rec['peak_gib']:.2f} GiB"
            )
            runs.append((csv_texts(out), rec))
        if runs[0][0] != runs[1][0]:
            raise AssertionError(f"full {tag}: the two runs' CSVs differ")
        check_matrices(runs[0][0], n)
        say(f"full {tag}: both runs identical, {len(runs[0][0])} matrices")
        paths[tag] = runs[0][1]
        yardsticks[tag] = runs[0][0]
    # one more default run keeps its join's pair-kernel and hand-kernel
    # inputs (apart from the runs above, whose peak memory they would
    # raise)
    out = os.path.join(tmp, "full_21_rows")
    with PairRecorder() as pr, KernelInputs() as inputs:
        cli_run("default k=21, the join's rows kept", [
            "-in", inp, "-out", out, "-kmer-size", "21", "-abundance-min",
            "2", "-verbose", "0", "-device", "cuda"], out, recorder)
    if csv_texts(out) != yardsticks["default k=21"]:
        raise AssertionError("full default k=21: the rows-kept run's CSVs "
                             "differ from run 0's")
    paths["default k=21"]["n8"] = pair_sums_at_rows(
        f"phase 7's rows (N={n})", pr.args, compare_global=False)
    inputs.to_host()
    paths["default k=21"]["inputs"] = inputs
    del pr
    torch.cuda.empty_cache()
    return paths, inp, inp9, yardsticks


def checkpoint_mtimes(tmp: str) -> dict:
    return {p: os.stat(p).st_mtime_ns
            for p in sorted(glob.glob(os.path.join(tmp, "count", "*.npz")))}


def out_tmp_full_size(tmp: str, inp8: str, inp9: str, yardsticks: dict,
                      recorder: ShapeRecorder, dev) -> dict:
    """Phase 8, with phase 13b before its run 4; returns run 1's
    record."""
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
        if r == 4:  # phase 13b, while the 8 checkpoints are kept
            shards_from_checkpoints(tmp, inp8, ckpt, csvs, recorder, dev)
        # run 3f: the sweep over the shards [cuda:0] x 2 (phase 13b)
        shards = [dev] * 2 if r == "3f" else [dev]
        tag = f"-out-tmp run {r}" + (" over [cuda:0] x 2" if r == "3f"
                                     else "")
        out = os.path.join(tmp, f"ckpt_out_{r}")
        before = checkpoint_mtimes(ckpt)
        argv = ["-in", inp, "-out", out, "-out-tmp", ckpt, "-kmer-size",
                "21", "-abundance-min", "2", "-verbose", "0", "-device",
                "cuda", *flags]
        argv += ["-keep-tmp"] if keep else []
        rec, m = cli_run(tag, argv, out, recorder,
                         run=None if r != "3f" else lambda: sharded_argv(
                             argv, out, shards))
        first = first or rec
        c, texts = m["counters"], csv_texts(out)
        if c["n_shards"] != len(shards):
            raise AssertionError(f"{tag}: {c['n_shards']} shards, expected "
                                 f"{len(shards)}")
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
            f"launches {rec['launches']} (kernel kept total == n on each), "
            f"pair-sums launches {rec['pair_launches']}; "
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
            f"{rec['launches']} (kernel kept total == n on each), "
            f"pair-sums launches {rec['pair_launches']}; peak "
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
        f"{rec['launches']} (kernel kept total == n on each), "
        f"pair-sums launches {rec['pair_launches']}; peak device "
        f"memory {rec['peak_gib']:.2f} GiB; CSVs == phase 7's default run")


def compaction_at_path_shapes(shapes: dict, join_rows: int, range_shape,
                              dev, seed: int) -> tuple:
    """Phase 9; returns (max_abs_err, timings at the k=21 join shape,
    at the extraction-batch shape, at the -out-tmp spectra join's
    abundance filter, at the sweep's largest range extraction and, by
    shard count, at phase 13a's shard split)."""
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
        # phase 11c's 24-file sample cuts and folds about 0.8 G rows; the
        # kernel and its plain version side by side do not fit there
        E = min(E, PHASE9_MAX_ROWS)
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
    # the shard split of phase 13a (parallel/sharded.py::split_rows): one
    # exact-length compaction a destination of an extraction batch's
    # words, each keeping about 1/n
    split = {}
    for n in SHARD_COUNTS:
        cols, kept, fills = rows(EXTRACT_ROWS, 1 / n, gen, dev,
                                 (torch.int64,))
        err = max(err, compare(cols, kept, fills))
        split[n] = time_compaction(
            f"at the shard split over {n} (i64 word, frac 1/{n}, one "
            "destination)", cols, kept, fills, 20)
        del cols, kept
    compact.launches = saved
    return err, join, extract, spectra, ranged, split


# ---- phase 11: SimkaMin's sketch ----------------------------------------


def murmur_compare(words, valid, seed: int, thresh: int) -> None:
    """The hash kernel against its plain version on the same inputs:
    hashes, keep mask and (valid, kept) counts bit for bit."""
    got = minhash.hash_kmer_words(words, valid, seed, thresh)
    want = minhash.hash_kmer_words_plain(words, valid, seed, thresh)
    torch.cuda.synchronize()
    for name, g, w in zip(("hashes", "keep", "counts"), got, want):
        if g.shape != w.shape or not torch.equal(g, w):
            raise AssertionError(
                f"murmur kernel != plain ({name}) at E={words.shape[0]}, "
                f"valid {float(valid.float().mean()):.2f}, thresh {thresh}")


def murmur_vs_plain(dev, seed: int) -> int:
    """Phase 11a; returns the max abs error, 0 (anything else raises)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    saved = minhash.launches
    for E in (1, 4095, (1 << 20) + 3, 1 << 24):
        words = torch.randint(0, 1 << 62, (E,), generator=gen, device=dev)
        words[0] = 0
        words[-1] = (1 << 62) - 1
        for frac in (0.0, 0.5, 1.0):
            valid = torch.rand(E, generator=gen, device=dev) < frac
            for thresh in (minhash.FULL64, 1 << 60):
                murmur_compare(words, valid, seed, thresh)
        del words, valid
    # a view one element in: misaligned, so the scalar loop
    words = torch.randint(0, 1 << 62, (4097,), generator=gen, device=dev)
    valid = torch.rand(4097, generator=gen, device=dev) < 0.5
    murmur_compare(words[1:], valid[1:], 100, 1 << 61)
    minhash.launches = saved
    torch.cuda.empty_cache()
    say("murmur kernel == plain at every shape, validity and bound "
        "(hashes, keep mask, counts; max_abs_err 0)")
    return 0


def time_murmur(tag: str, words, valid, seed: int, thresh: int,
                reps: int = 20) -> dict:
    """The hash kernel's and its plain version's times on the same
    inputs, and the bound: 8 + 1 bytes read and 8 + 1 written a window
    (the counts' 16 beside them), or MURMUR_INT_OPS 32-bit integer
    instructions a window at INT32_OPS_PER_S."""
    E = words.shape[0]
    saved = minhash.launches
    r = {
        "ms": time_ms(lambda: minhash.hash_kmer_words(words, valid, seed,
                                                      thresh), reps),
        "plain_ms": time_ms(lambda: minhash.hash_kmer_words_plain(
            words, valid, seed, thresh), 3),
        "library_ms": None,  # no one torch call computes MurmurHash3
        "device_ms": device_ms(lambda: minhash.hash_kmer_words(
            words, valid, seed, thresh), reps, only=("murmur_kmers",),
            launches=lambda: minhash.launches),
    }
    trace_names(f"the hash wrapper {tag}",
                lambda: minhash.hash_kmer_words(words, valid, seed, thresh),
                lambda: minhash.launches)
    minhash.launches = saved
    r["bound_ms"], r["bound_by"] = bound(18 * E + 16, MURMUR_INT_OPS * E,
                                         INT32_OPS_PER_S)
    say(f"murmur {tag} E={E}: kernel {r['ms']:.4f} ms around the call, "
        f"{fmt(r['device_ms'])} on the device, plain "
        f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']}; bytes {18 * E / HBM_BYTES_PER_S * 1e3:.4f} ms, "
        f"integer instructions "
        f"{MURMUR_INT_OPS * E / INT32_OPS_PER_S * 1e3:.4f} ms)")
    return r


def sketch_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def min_cli(argv: list) -> dict:
    """One `min` command through the CLI's min_main; its metrics."""
    from simka_tpu_torch.minhash.cli import min_main

    obs = {}
    if min_main(argv, observer=obs) != 0:
        raise AssertionError(f"min {argv[0]} failed")
    return obs


def min_info(path: str) -> str:
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        min_cli(["info", "-in", path])
    return buf.getvalue()


def small_sketch_gpu_vs_cpu(tmp: str, seed: int) -> None:
    """Phase 11b."""
    from simka_tpu_torch.minhash.pipeline import sketch_command
    from simka_tpu_torch.minhash.sketch_file import SketchFile
    from simka_tpu_torch.utils.community import write_community

    inp = write_community(
        os.path.join(tmp, "small_min"), seed=seed + 3, n_samples=4,
        n_genomes=5, genome_len=20_000, reads_per_sample=3_000,
        n_frac=0.01, fastq_samples=2,
    )
    one = os.path.join(tmp, "small_min", "input1.txt")
    with open(inp) as f, open(one, "w") as g:
        g.write(f.readline())
    s = 500  # every sketch fills, -filter's too
    saved = minhash.launches
    minhash.launches = 0
    files = {}
    for tag, flags in (("k=21", ["-kmer-size", "21"]),
                       ("k=21 -filter", ["-kmer-size", "21", "-filter"]),
                       ("k=31", ["-kmer-size", "31"]),
                       ("k=31 -filter", ["-kmer-size", "31", "-filter"]),
                       ("k=21 -filter-bloom", ["-kmer-size", "21",
                                               "-filter-bloom",
                                               "-max-memory", "64"])):
        out = {}
        for dev in ("cuda", "cpu"):
            path = os.path.join(tmp, f"min_{tag.replace(' ', '_')}_{dev}.bin")
            m = min_cli(["sketch", "-in", inp, "-out", path, "-nb-kmers",
                         str(s), "-device", dev, *flags])
            out[dev] = (sketch_bytes(path), m)
            files[(tag, dev)] = path
        (g, gm), (c, cm) = out["cuda"], out["cpu"]
        if g != c:
            raise AssertionError(f"small min sketch {tag}: cuda != cpu")
        sizes = [len(SketchFile(files[(tag, "cuda")]).read_slot(i)[0])
                 for i in range(4)]
        if sizes != [s] * 4:
            raise AssertionError(f"small min sketch {tag}: sketch sizes "
                                 f"{sizes}, not all {s}")
        say(f"small min sketch {tag}: cuda == cpu ({len(g)} B), route "
            f"{gm['sketch_route']} ({gm.get('sketch_route_reason', '-')}), "
            f"prefilter fraction {gm.get('prefilter_fraction', '-')}, "
            f"{gm['kept_instances']} of {gm['instances']} instances kept")
    # each route forced, on both devices, against the batched file
    want = {False: sketch_bytes(files[("k=21", "cpu")]),
            True: sketch_bytes(files[("k=21 -filter", "cpu")])}
    for tag, route, kw, inp_r in (
            ("bail to per-sample", ["one-shot"] * 4,
             dict(instance_limit=1000), inp),
            ("streaming", ["streaming"] * 4,
             dict(instance_limit=0, stream_threshold=20_000), inp),
            ("-filter streaming", ["streaming"] * 4,
             dict(use_filter=True, instance_limit=0,
                  stream_threshold=20_000), inp),
            ("one sample", ["one-shot"], {}, one)):
        for dev in ("cuda", "cpu"):
            path = os.path.join(tmp, f"min_route_{dev}.bin")
            m = sketch_command(inp_r, path, 21, s, 100, verbose=False,
                               device=dev, **kw)
            got = sketch_bytes(path)
            cuts = 4 if kw.get("use_filter") else 0
            if m["sketch_route"] != "per-sample" or m[
                    "sample_routes"] != route or m["filter_cuts"] != cuts:
                raise AssertionError(f"small min sketch {tag} ({dev}): route "
                                     f"{m['sketch_route']} "
                                     f"{m['sample_routes']}, "
                                     f"{m['filter_cuts']} -filter cuts")
            if inp_r == inp and got != want[kw.get("use_filter", False)]:
                raise AssertionError(f"small min sketch {tag} ({dev}): the "
                                     "file differs from the batched one")
            if inp_r == one:
                first = SketchFile(files[("k=21", "cpu")]).read_slot(0)
                mine = SketchFile(path).read_slot(0)
                if not all(np.array_equal(a, b) for a, b in zip(first, mine)):
                    raise AssertionError(f"small min sketch {tag} ({dev}): "
                                         "!= the batched file's sample 0")
                files[("one", dev)] = got
        say(f"small min sketch route {tag}: {m['sketch_route']}, "
            f"{m['sample_routes']}, {m['filter_cuts']} -filter cuts: cuda "
            "== cpu == the batched file")
    if files[("one", "cuda")] != files[("one", "cpu")]:
        raise AssertionError("small min sketch one sample: cuda != cpu")
    # info and append: the same path for each device's files
    texts, appended = {}, {}
    for dev in ("cuda", "cpu"):
        a = os.path.join(tmp, "min_info_a.bin")
        b = os.path.join(tmp, "min_info_b.bin")
        shutil.copy(files[("k=21", dev)], a)
        shutil.copy(files[("k=21 -filter", dev)], b)
        min_cli(["append", "-in1", a, "-in2", b])
        texts[dev], appended[dev] = min_info(a), sketch_bytes(a)
    if texts["cuda"] != texts["cpu"] or appended["cuda"] != appended["cpu"]:
        raise AssertionError("small min info / append: cuda != cpu")
    if "Nb datasets: 8" not in texts["cuda"]:
        raise AssertionError(f"min append: {texts['cuda']!r}")
    if minhash.launches <= 0:
        raise AssertionError("small min sketches never launched the hash "
                             "kernel")
    say(f"small min info and append: cuda == cpu (8 datasets, "
        f"{len(appended['cuda'])} B); hash kernel launches "
        f"{minhash.launches}")
    minhash.launches = saved


def sketch_run(tag: str, argv: list, out: str, recorder) -> tuple:
    """One `min sketch` on the card through min_main, with the hash
    kernel's and the compaction's launch counts and the peak memory
    reset before it; returns (record, metrics)."""
    minhash.launches = 0
    rec, m = cli_run(tag, [], out, recorder, run=lambda: min_cli(argv),
                     joins=False)
    rec["murmur_launches"] = minhash.launches
    if minhash.launches <= 0:
        raise AssertionError(f"{tag}: the run never launched the hash kernel")
    stages = ", ".join(f"{k} {m[k]:.4f}" for k in STAGES)
    say(f"full {tag}: wall {rec['wall_s']:.3f} s; route {m['sketch_route']} "
        f"({m.get('sketch_route_reason', '-')}; samples "
        f"{m['sample_routes'] or '-'}); prefilter fraction "
        f"{m.get('prefilter_fraction', '-')}; stages {stages}; instances "
        f"{m['instances']}, kept {m['kept_instances']}; hash kernel "
        f"launches {rec['murmur_launches']}, compact launches "
        f"{rec['launches']} (kernel kept total == n on each); peak device "
        f"memory {rec['peak_gib']:.2f} GiB")
    return rec, m


def sketch_full_size(tmp: str, inp8: str, recorder, dev) -> dict:
    """Phase 11c; returns the -nb-kmers 100000 run's record."""
    from simka_tpu_torch.io.dsl import parse_input_file
    from simka_tpu_torch.io.packed import PackedReadSource
    from simka_tpu_torch.minhash.pipeline import sketch_command
    from simka_tpu_torch.minhash.sketch import compute_sketch
    from simka_tpu_torch.minhash.sketch_file import SketchFile

    first, files = None, {}
    for s in SKETCH_SIZES:
        got = []
        for r in range(2):
            out = os.path.join(tmp, f"full_min_{s}_{r}.bin")
            rec, m = sketch_run(
                f"min sketch -nb-kmers {s} run {r}",
                ["sketch", "-in", inp8, "-out", out, "-nb-kmers", str(s),
                 "-device", "cuda"], out, recorder)
            if m["sketch_route"] != "batched" or not (
                    m["prefilter_fraction"] < 0.25):
                raise AssertionError(f"min sketch {s}: route "
                                     f"{m['sketch_route']}, prefilter "
                                     f"{m['prefilter_fraction']}")
            first = first or rec
            got.append(sketch_bytes(out))
            files[s] = out
        if got[0] != got[1]:
            raise AssertionError(f"min sketch {s}: the two runs differ")
        say(f"full min sketch -nb-kmers {s}: both runs identical")
    out = os.path.join(tmp, "full_min_filter.bin")
    rec, m = sketch_run("min sketch -filter -nb-kmers 100000",
                        ["sketch", "-in", inp8, "-out", out, "-filter",
                         "-device", "cuda"], out, recorder)
    if m["sketch_route"] != "per-sample" or m["sample_routes"] != [
            "one-shot"] * 8 or not m.get("sketch_route_reason",
                                         "").startswith("stream"):
        raise AssertionError(f"min sketch -filter: route {m['sketch_route']}"
                             f" ({m.get('sketch_route_reason')})")
    out = os.path.join(tmp, "full_min_per_sample.bin")
    minhash.launches = 0
    rec, m = cli_run("per-sample route", [], out, recorder,
                     run=lambda: sketch_command(inp8, out, 21, SKETCH_SIZES[0],
                                                100, verbose=False,
                                                instance_limit=0),
                     joins=False)
    if m["sketch_route"] != "per-sample" or sketch_bytes(out) != sketch_bytes(
            files[SKETCH_SIZES[0]]):
        raise AssertionError("min sketch per-sample route: the file differs "
                             "from the batched one")
    say(f"full min sketch -nb-kmers 100000, per-sample route (sketch_command, "
        f"instance_limit=0): == the batched file; wall {rec['wall_s']:.3f} "
        f"s, samples {m['sample_routes']}, hash kernel launches "
        f"{minhash.launches}, compact launches {rec['launches']}, peak "
        f"{rec['peak_gib']:.2f} GiB")
    # one sample: streamed, one-shot, on the CPU
    d = parse_input_file(inp8)[0]
    sketches = {}
    for tag, kw in (("one-shot", {}),
                    ("streaming", dict(stream_threshold=1 << 22)),
                    ("cpu", dict(device="cpu"))):
        obs = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sketches[tag] = compute_sketch(
            PackedReadSource(d.banks, encoding="gatb"), 21, SKETCH_SIZES[0],
            100, observer=obs, **kw)
        wall = time.perf_counter() - t0
        recorder.check_totals()
        route = ["streaming" if tag == "streaming" else "one-shot"]
        if obs["sample_routes"] != route:
            raise AssertionError(f"full min sketch of {d.id} ({tag}): route "
                                 f"{obs['sample_routes']}")
        say(f"full min sketch of {d.id} ({tag}): {obs['sample_routes']}, "
            f"wall {wall:.3f} s, {obs['instances']} instances")
    batched = SketchFile(files[SKETCH_SIZES[0]]).read_slot(0)
    for tag, (h, c) in sketches.items():
        if not (np.array_equal(h, batched[0]) and np.array_equal(c,
                                                                 batched[1])):
            raise AssertionError(f"full min sketch of {d.id} ({tag}) != the "
                                 "batched file's slot 0")
    say(f"full min sketch of {d.id}: streaming == one-shot == cpu == the "
        "batched file's slot 0")
    return first


def filter_past_threshold(tmp: str, inp8: str, recorder, dev) -> dict:
    """Phase 11c's last part: one -filter sample past the card's default
    streaming threshold (phase 7's 8 files three times over, one sample,
    every k-mer seen at least three times), through the CLI: the
    streaming route, cut at least once. The same sample with the
    threshold forced to 2^26 (cut earlier) gives the same file; without
    -filter (the O(s) fold) the members and every count but the
    largest member's (the heap quirk, whose entry differs) are the
    same. Returns the CLI run's record and metrics."""
    from simka_tpu_torch.io.dsl import parse_input_file
    from simka_tpu_torch.minhash.pipeline import sketch_command
    from simka_tpu_torch.minhash.sketch import _sketch_stream_threshold
    from simka_tpu_torch.minhash.sketch_file import SketchFile

    files = [f for d in parse_input_file(inp8) for g in d.banks for f in g]
    inp = os.path.join(tmp, "input_min_big.txt")
    with open(inp, "w") as f:
        f.write("big: " + ", ".join(files * 3) + "\n")
    threshold = _sketch_stream_threshold(dev)
    out = os.path.join(tmp, "full_min_big_filter.bin")
    rec, m = sketch_run("min sketch -filter of one sample of 24 files",
                        ["sketch", "-in", inp, "-out", out, "-filter",
                         "-device", "cuda"], out, recorder)
    if not (m["sample_routes"] == ["streaming"] and m["filter_cuts"] >= 1
            and m["instances"] > threshold
            and m["kept_instances"] < m["instances"]):
        raise AssertionError(f"min sketch -filter past the threshold "
                             f"{threshold}: routes {m['sample_routes']}, "
                             f"{m['filter_cuts']} cuts, {m['instances']} "
                             f"instances, {m['kept_instances']} kept")
    say(f"full min sketch -filter of one 24-file sample: "
        f"{m['instances']} instances past the threshold {threshold}, "
        f"{m['filter_cuts']} cuts, {m['kept_instances']} kept")
    runs = {}
    for tag, use_filter, kw in (
            ("-filter, threshold 2^26", True, dict(stream_threshold=1 << 26)),
            ("no -filter", False, {})):
        path = os.path.join(tmp, "full_min_big.bin")
        minhash.launches = 0
        r, mm = cli_run(f"min sketch {tag} of one 24-file sample", [], path,
                        recorder, run=lambda: sketch_command(
                            inp, path, 21, SKETCH_SIZES[0], 100, use_filter,
                            verbose=False, **kw), joins=False)
        if mm["sample_routes"] != ["streaming"]:
            raise AssertionError(f"min sketch {tag}: {mm['sample_routes']}")
        runs[tag] = (sketch_bytes(path), SketchFile(path).read_slot(0))
        say(f"full min sketch {tag} of one 24-file sample: wall "
            f"{r['wall_s']:.3f} s, {mm['filter_cuts']} cuts, "
            f"{mm['kept_instances']} of {mm['instances']} kept, hash kernel "
            f"launches {minhash.launches}, compact launches {r['launches']}, "
            f"peak {r['peak_gib']:.2f} GiB")
    if runs["-filter, threshold 2^26"][0] != sketch_bytes(out):
        raise AssertionError("min sketch -filter: the cut schedule changed "
                             "the file")
    (h, c), (h2, c2) = SketchFile(out).read_slot(0), runs["no -filter"][1]
    if not (len(h) == SKETCH_SIZES[0] and np.array_equal(h, h2)
            and np.array_equal(c[:-1], c2[:-1])):
        raise AssertionError("min sketch -filter of the 24-file sample: "
                             "members or counts differ from the fold's")
    say("full min sketch of one 24-file sample: -filter at the default "
        "threshold == at 2^26; members and counts but the largest == "
        "without -filter")
    return rec, m


def sketch_shapes(inp8: str, dev, seed: int) -> tuple:
    """Phase 11d: (the hash kernel's times at one full-size batch and at
    2^24, the compaction's at the prefilter's shape)."""
    from simka_tpu_torch.io.dsl import parse_input_file
    from simka_tpu_torch.io.packed import PackedReadSource
    from simka_tpu_torch.minhash.sketch import prefilter_threshold

    srcs = [PackedReadSource(d.banks, encoding="gatb")
            for d in parse_input_file(inp8)]
    thresh, frac = prefilter_threshold(srcs, SKETCH_SIZES[0], False)
    packed, vb, n_reads, _ = next(srcs[0].iter_packed(1 << 15, k=21))
    words, valid = minhash.gatb_words(torch.from_numpy(packed).to(dev),
                                      torch.from_numpy(vb).to(dev), 21)
    batch = time_murmur(f"at a full-size batch ({n_reads} reads x "
                        f"{words.shape[0] // packed.shape[0]} windows)",
                        words, valid, 100, thresh)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    big = 1 << 24
    w24 = torch.randint(0, 1 << 42, (big,), generator=gen, device=dev)
    v24 = torch.rand(big, generator=gen, device=dev) < 0.97
    at_2e24 = time_murmur("at 2^24", w24, v24, 100, thresh, 10)
    del w24, v24
    saved = minhash.launches, compact.launches
    h, keep, _ = minhash.hash_kmer_words(words, valid, 100, thresh)
    cols, fills = (h,), (minhash.FULL64,)
    compare(cols, keep, fills)
    kept = float(keep.float().mean())
    prefilter = time_compaction(
        f"at the sketch prefilter (i64 hash, kept {kept:.4f} of the batch's "
        f"windows, keep bound {frac:.4f} of the hash range)",
        cols, keep, fills, 20)
    minhash.launches, compact.launches = saved
    torch.cuda.empty_cache()
    return batch, at_2e24, prefilter


# ---- phase 12: SimkaMin's distance ---------------------------------------


def pair_compare(tag: str, d1, d2, ii, jj, tiled: bool = False
                 ) -> torch.Tensor:
    """The pair kernel against its plain version on the same inputs,
    tallies bit for bit; with ``tiled`` also in tiles of 3 pairs (the
    wrapper's scratch cap made small); returns the kernel's tallies."""
    (o1, l1, h1, c1), (o2, l2, h2, c2) = d1, d2
    args = (h1, c1, o1, l1, h2, c2, o2, l2, ii, jj)
    got = dd.pair_tallies(*args)
    want = dd.pair_tallies_plain(*args)
    forms = {"one launch": got}
    if tiled:
        k = pair_segments(args)
        words = _kernels.lib().simka_min_pair_scratch_words
        saved = dd.SCRATCH_BYTES
        dd.SCRATCH_BYTES = 8 * words(3, k)
        n0 = dd.launches
        try:
            forms["tiles of 3 pairs"] = dd._pair_tallies_cuda(*args, k_max=k)
        finally:
            dd.SCRATCH_BYTES = saved
        if dd.launches - n0 != -(-len(ii) // 3):
            raise AssertionError(f"pair kernel ({tag}): {dd.launches - n0} "
                                 f"tiles for {len(ii)} pairs")
    torch.cuda.synchronize()
    for form, t in forms.items():
        if t.shape != want.shape or not torch.equal(t, want):
            bad = (t != want).any(1).nonzero()[:5].flatten().tolist()
            raise AssertionError(f"pair kernel ({form}) != plain ({tag}), "
                                 f"first bad pairs {bad}")
    return got


def pair_segments(args) -> int:
    """The wrapper's bound on segments a pair for these arguments."""
    _, _, _, len1, _, _, _, len2, ii, jj = args
    return int(dd.segments_bound(len1, len2, ii, jj,
                                 _kernels.lib().simka_min_pair_segment()))


def host_walk(sk1, sk2, ii, jj) -> np.ndarray:
    """[P, 2] float32 (jaccard, braycurtis) of the host walk
    (minhash/distance.py::sketch_pair_distance) on pairs (ii, jj) of
    the host sketch lists ``sk1`` and ``sk2`` (callables i -> sketch),
    one pair a worker thread (numpy's sorts release the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    from simka_tpu_torch.minhash.distance import sketch_pair_distance

    walk = lambda ij: sketch_pair_distance(*sk1(int(ij[0])),
                                           *sk2(int(ij[1])))
    with ThreadPoolExecutor(os.cpu_count() or 4) as ex:
        return np.array(list(ex.map(walk, zip(ii, jj))),
                        np.float64).astype(np.float32).reshape(-1, 2)


def host_walk_check(tag: str, sk1, sk2, ii, jj, tallies) -> None:
    """The kernel's distances (from its tallies) against the host walk
    on pairs (ii, jj)."""
    got = np.stack([x.cpu().numpy()
                    for x in dd.distances_from_tallies(tallies)], 1)
    want = host_walk(sk1, sk2, ii, jj)
    bad = np.nonzero((got != want).any(1))[0]
    if len(bad):
        p = bad[0]
        raise AssertionError(
            f"pair distances ({tag}) pair ({ii[p]}, {jj[p]}): kernel "
            f"{got[p].tolist()} != host walk {want[p].tolist()}")


def edge_sketches(seed: int) -> dict:
    """Phase 12a's small cases as host (hashes uint64, counts uint32)
    lists, every pair of each list compared; the last five stress the
    merge path's split into segments of SEG merged positions."""
    seg = _kernels.lib().simka_min_pair_segment()
    rng = np.random.default_rng([seed, 12])
    ones = np.uint64(2**64 - 1)
    pool = rng.integers(0, 2**64, 4000, dtype=np.uint64)

    def sk(m, lo=0, hi=2**64, frac=0.5):
        h = np.unique(np.concatenate([
            rng.integers(lo, hi, m, dtype=np.uint64),
            pool[rng.integers(0, len(pool), int(m * frac))]]))
        return h, rng.integers(1, 256, len(h)).astype(np.uint32)

    def exact(m):
        """A sketch of exactly m members, half from the pool."""
        h = np.unique(np.concatenate([pool, rng.integers(
            0, 2**64, 2 * m, dtype=np.uint64)]))
        h = np.sort(rng.choice(h, m, replace=False))
        return h, rng.integers(1, 256, m).astype(np.uint32)

    def counted(h):
        return h, rng.integers(1, 256, len(h)).astype(np.uint32)

    def straddle(before: int, after: int):
        """A and B whose merged order alternates A, B over `before`
        distinct values, then holds a shared value (its A copy at merged
        position `before`, its B copy at `before` + 1), then alternates
        over `after` more."""
        v = np.unique(rng.integers(0, 2**64, 2 * (before + 1 + after),
                                   dtype=np.uint64))
        v = np.sort(rng.permutation(v)[:before + 1 + after])
        head, shared, rest = v[:before], v[before:before + 1], v[before + 1:]
        a = np.concatenate([head[0::2], shared, rest[0::2]])
        b = np.concatenate([head[1::2], shared, rest[1::2]])
        return counted(np.sort(a)), counted(np.sort(b))

    empty = (np.empty(0, np.uint64), np.empty(0, np.uint32))
    one = lambda v: (np.array([v], np.uint64), np.array([3], np.uint32))
    low, high = sk(3000, 0, 2**62, 0), sk(2000, 2**62, 2**63, 0)
    with_ones = [(np.unique(np.append(h, ones)),
                  rng.integers(1, 256, len(h) + 1).astype(np.uint32))
                 for h, _ in (sk(m) for m in (1, 40, 2500))]
    big = exact(4 * seg)
    evens = np.arange(1, 4 * seg + 1, dtype=np.uint64) * np.uint64(2**40)
    return {
        "an empty sketch": [empty, sk(100), empty, sk(3)],
        "lengths 1 and unequal": [one(pool[0]), one(pool[1]), sk(1),
                                  sk(5000), sk(17), sk(700)],
        "identical and disjoint": [low, low, high, sk(900)],
        "the all-ones hash as a member": with_ones + [one(ones), sk(60)],
        "hashes with the top bit set": [sk(m, 2**63, 2**64) for m in
                                        (10, 300, 2999)] + [sk(400)],
        "merged lengths about one and two segments": [
            exact(m) for m in (seg // 2 - 1, seg // 2, seg // 2 + 1,
                               seg - 1, seg, seg + 1, 2 * seg - 1,
                               2 * seg, 2 * seg + 1)],
        "a shared value split by a segment boundary": [
            *straddle(seg - 1, 3 * seg), *straddle(2 * seg - 1, 3 * seg)],
        "identical sketches (cut-off at 2 min)": [big, big],
        "disjoint sketches (cut-off at min)": [
            counted(evens), counted(evens + np.uint64(1))],
        "lengths 1 against 1,000,000": [one(pool[2]), exact(1_000_000),
                                        one(ones)],
    }


def wide_sketches(n: int, s: int, gen, dev):
    """n sketches of exactly s ascending distinct uint64 hashes (int64
    bits, the full range) in the exact-length layout on ``dev``: the s
    smallest of 0.45 s draws from a shared pool of s / 2 hashes and
    0.75 s of the sample's own (about 28% from the pool), counts
    1..255."""
    full = dict(generator=gen, device=dev, dtype=torch.int64)
    pool = torch.randint(-2**63, 2**63 - 1, (s // 2,), **full)
    hs = []
    for _ in range(n):
        drawn = pool[torch.randint(0, s // 2, (int(0.45 * s),), **full)]
        own = torch.randint(-2**63, 2**63 - 1, (int(0.75 * s),), **full)
        key = torch.unique(torch.cat([drawn, own]) ^ minhash.SIGN)[:s]
        if key.shape[0] != s:
            raise AssertionError(f"wide sketch of {key.shape[0]} < {s}")
        hs.append(key ^ minhash.SIGN)
    lens = torch.full((n,), s, dtype=torch.int64, device=dev)
    counts = torch.randint(1, 256, (n * s,), generator=gen, device=dev,
                           dtype=torch.int32)
    return (torch.cumsum(lens, 0) - lens, lens, torch.cat(hs), counts)


def needed_rows(d, ii, jj, processed) -> int:
    """Rows of the sketch list ``d`` (both sides of the pairs) that must
    be read at least once: per sample the longest prefix that one of its
    pairs' walks includes (the members of rank <= processed, a prefix of
    each list), summed; computed as the plain version ranks members."""
    o, ln, h, c = d
    ii, jj = ii.long(), jj.long()
    need = torch.zeros_like(ln)
    width = max(int(ln.max()), 1)
    step = max(dd.PLAIN_CHUNK_ROWS // width, 1)
    for p0 in range(0, len(ii), step):
        sl = slice(p0, p0 + step)
        for x, y in ((ii[sl], jj[sl]), (jj[sl], ii[sl])):
            kx, _, vx = dd._padded(h, c, o[x], ln[x], width)
            ky, _, _ = dd._padded(h, c, o[y], ln[y], width)
            _, _, rank = dd._ranked(kx, vx, ky, ln[y])
            n = (vx & (rank <= processed[sl, None])).sum(1)
            need.scatter_reduce_(0, x, n, "amax")
    return int(need.sum())


def l2_read_rate(dev) -> float:
    """Bytes a second that one torch.sum reads from L2: a float32 buffer
    of L2_PROBE_BYTES, warm, as L2_PROBE_READS rows of a stride-0 view,
    each row summed, in one launch. A measured rate, so at most the L2's
    peak."""
    x = torch.zeros(L2_PROBE_BYTES // 4, device=dev)
    rows = x.expand(L2_PROBE_READS, -1)
    ms = time_ms(lambda: rows.sum(1), reps=10)
    return L2_PROBE_BYTES * L2_PROBE_READS / (ms * 1e-3)


def time_pairs(tag: str, d, ii, jj, t, reps: int, plain_reps: int,
               earlier_ms: float) -> dict:
    """The pair kernel's time around the call and on the device (CUDA
    events around its launch alone), its plain version's, and its bound
    from this run's tallies ``t``: the larger of the bytes it must move
    (each sample's longest needed prefix read once, 12 B a member; per
    pair the two last hashes, its indices, offsets and lengths read and
    its four tallies written) over device memory's rate and the merge's
    PAIR_INT_OPS 32-bit integer instructions a member the walk needs
    (processed + shared_distinct) over INT32_OPS_PER_S. Beside it, the
    design's own floor: it stages every pair's needed members through
    L2 anew, at the L2 read rate measured here. ``earlier_ms``: the
    simple form's device time at this shape, from an earlier call
    (PERF.md section 6), printed beside, not recorded."""
    (o, ln, h, c) = d
    args = (h, c, o, ln, h, c, o, ln, ii, jj)
    k = pair_segments(args)
    fn = lambda: dd.pair_tallies(*args)
    saved = dd.launches
    r = {
        "ms": time_ms(fn, reps),
        "device_ms": time_ms(lambda: dd._pair_tallies_cuda(*args, k_max=k),
                             reps),
        "plain_ms": time_ms(lambda: dd.pair_tallies_plain(*args), plain_reps),
        "library_ms": None,  # no one torch call computes the tallies
    }
    trace_names(f"the pair wrapper {tag}", fn, lambda: dd.launches, reps=1)
    dd.launches = saved
    members = int((t[:, 0] + t[:, 1]).sum())
    rows_once = needed_rows(d, ii, jj, t[:, 0])
    r["bytes"] = rows_once * 12 + len(ii) * (2 * 8 + 2 * 4 + 2 * 16 + 4 * 8)
    r["ops"] = members * PAIR_INT_OPS
    r["bound_ms"], r["bound_by"] = bound(r["bytes"], r["ops"],
                                         INT32_OPS_PER_S)
    rate = l2_read_rate(h.device)
    r["l2_floor_ms"] = members * 12 / rate * 1e3
    share = lambda x: f"{100 * x / r['device_ms']:.1f}%"
    say(f"pair tallies {tag} ({len(ii)} pairs, {k} segments a pair at "
        f"most): kernel {r['ms']:.4f} ms around the call, "
        f"{r['device_ms']:.4f} ms on the device (events around the "
        f"launch); plain {r['plain_ms']:.4f} ms; bound {r['bound_ms']:.4f} "
        f"ms by {r['bound_by']}, {share(r['bound_ms'])} of the device time "
        f"(bytes {r['bytes'] / HBM_BYTES_PER_S * 1e3:.4f} ms: {rows_once} "
        f"rows read once; operations {r['ops'] / INT32_OPS_PER_S * 1e3:.4f} "
        f"ms: {members} members the walks need x {PAIR_INT_OPS}); the "
        f"design's L2 floor {r['l2_floor_ms']:.4f} ms, "
        f"{share(r['l2_floor_ms'])} ({members * 12} B staged at the "
        f"measured L2 read rate {rate / 1e12:.3f} TB/s); the simple "
        f"one-CTA-a-pair form took {earlier_ms} ms on the device at this "
        f"shape in an earlier call (PERF.md section 6)")
    return r


def pair_vs_plain(dev, seed: int) -> tuple:
    """Phase 12a: the pair kernel against its plain version on every
    small case and on WIDE_N in-memory sketches of WIDE_S, the latter's
    distances against the host walk on HOST_WALK_PAIRS seeded pairs;
    returns (max_abs_err, the wide shape's times)."""
    saved = dd.launches
    for tag, sk in edge_sketches(seed).items():
        d = dd.ship_sketches(sk, dev)
        ii, jj = (torch.from_numpy(a).to(dev)
                  for a in dd.sketch_pairs(len(sk), len(sk), False))
        t = pair_compare(tag, d, d, ii, jj, tiled=True)
        host_walk_check(tag, sk.__getitem__, sk.__getitem__,
                        ii.cpu().numpy(), jj.cpu().numpy(), t)
        say(f"pair kernel == plain == host walk: {tag} "
            f"({len(sk)} x {len(sk)} pairs, lengths "
            f"{[len(h) for h, _ in sk]})")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    d = wide_sketches(WIDE_N, WIDE_S, gen, dev)
    ii, jj = (torch.from_numpy(a).to(dev)
              for a in dd.sketch_pairs(WIDE_N, WIDE_N, True))
    torch.cuda.synchronize()
    say(f"wide sketches: {WIDE_N} x {WIDE_S} made in "
        f"{time.perf_counter() - t0:.2f} s")
    t = pair_compare(f"{WIDE_N} x {WIDE_S}", d, d, ii, jj)
    o, _, h, c = d
    host = lambda i: (h[i * WIDE_S:(i + 1) * WIDE_S].cpu().numpy().view(
        np.uint64), c[i * WIDE_S:(i + 1) * WIDE_S].cpu().numpy().view(
        np.uint32))
    pick = np.random.default_rng(seed).choice(len(ii), HOST_WALK_PAIRS,
                                              replace=False)
    t0 = time.perf_counter()
    host_walk_check(f"{WIDE_N} x {WIDE_S}", host, host,
                    ii.cpu().numpy()[pick], jj.cpu().numpy()[pick],
                    t[torch.from_numpy(pick).to(dev)])
    shared = float((t[:, 1].double() / t[:, 0].double()).mean())
    say(f"pair kernel == plain at {WIDE_N} x {WIDE_S} ({len(ii)} pairs, "
        f"mean shared share of processed {shared:.4f}); == host walk on "
        f"{HOST_WALK_PAIRS} pairs ({time.perf_counter() - t0:.1f} s)")
    dd.launches = saved
    wide = time_pairs(f"at {WIDE_N} x {WIDE_S}", d, ii, jj, t, 3, 1,
                      EARLIER_PAIR_MS["wide"])
    del d, t
    torch.cuda.empty_cache()
    return 0, wide


def run_files(out: str) -> dict:
    """Every file under a `min` output dir: .bin bytes, CSV text."""
    files = {}
    for p in sorted(glob.glob(os.path.join(out, "**", "*"), recursive=True)):
        if os.path.isfile(p):
            files[os.path.relpath(p, out)] = (
                gzip.open(p, "rt").read() if p.endswith(".gz")
                else sketch_bytes(p))
    return files


def small_min_distance_gpu_vs_cpu(tmp: str, seed: int) -> None:
    """Phase 12b."""
    from simka_tpu_torch.utils.community import write_community

    root = os.path.join(tmp, "small_min_dist")
    inp5 = write_community(root, seed=seed + 5, n_samples=5, n_genomes=5,
                           genome_len=20_000, reads_per_sample=3_000,
                           n_frac=0.01, fastq_samples=2)
    with open(inp5) as f:
        lines = f.readlines()
    inp, new = os.path.join(root, "input4.txt"), os.path.join(root, "new.txt")
    with open(inp, "w") as f:
        f.writelines(lines[:4])
    with open(new, "w") as f:
        f.writelines(lines[4:])
    saved = dd.launches
    for tag, flags in (("k=21", ["-kmer-size", "21"]),
                       ("k=21 -filter", ["-kmer-size", "21", "-filter"]),
                       ("k=31", ["-kmer-size", "31"]),
                       ("k=31 -filter", ["-kmer-size", "31", "-filter"])):
        got = {}
        for dev in ("cuda", "cpu"):
            out = os.path.join(tmp, f"min_pipe_{tag.replace(' ', '_')}_{dev}")
            dd.launches = 0
            m = min_cli(["pipeline", "-in", inp, "-out", out, "-nb-kmers",
                         "500", "-device", dev, *flags])
            if m["min_route"] != "resident" or m["pair_launches"] != (
                    1 if dev == "cuda" else 0) or dd.launches != m[
                    "pair_launches"]:
                raise AssertionError(f"small min pipeline {tag} ({dev}): "
                                     f"route {m['min_route']}, "
                                     f"{m['pair_launches']} pair launches")
            filt = ["-filter"] if "-filter" in flags else []
            min_cli(["update", "-in", new, "-out", out, "-device", dev,
                     *filt])
            got[dev] = run_files(out)
        if got["cuda"] != got["cpu"] or len(got["cuda"]) != 5:
            raise AssertionError(f"small min pipeline + update {tag}: cuda "
                                 f"!= cpu ({sorted(got['cuda'])})")
        say(f"small min pipeline {tag} + update: cuda == cpu "
            f"({sorted(got['cuda'])}; resident route, 1 pair launch)")
    # distance whole, in tiles and across two files; export and
    # matrix-update on the results
    x = os.path.join(tmp, "min_dist_old.bin")
    y = os.path.join(tmp, "min_dist_new.bin")
    for path, samples in ((x, inp), (y, new)):
        min_cli(["sketch", "-in", samples, "-out", path, "-nb-kmers", "500",
                 "-device", "cuda"])
    runs = {
        "whole": [[]],
        "tiles": [["-n-i", "2", "-n-j", "2"],
                  ["-start-j", "2", "-n-i", "2", "-n-j", "2"],
                  ["-start-i", "2", "-start-j", "2", "-n-i", "2"]],
    }
    got = {}
    for dev in ("cuda", "cpu"):
        for tag, calls in runs.items():
            out = os.path.join(tmp, f"min_dist_{tag}_{dev}")
            for call in calls:
                min_cli(["distance", "-in1", x, "-in2", x, "-out", out,
                         "-device", dev, *call])
            got[tag, dev] = run_files(out)
        for tag, a, b in (("evn", x, y), ("nvn", y, y)):
            out = os.path.join(tmp, f"min_dist_{tag}_{dev}")
            min_cli(["distance", "-in1", a, "-in2", b, "-out", out,
                     "-device", dev])
            got[tag, dev] = run_files(out)
        csv = os.path.join(tmp, f"min_dist_csv_{dev}")
        min_cli(["export", "-in", os.path.join(tmp, f"min_dist_whole_{dev}"),
                 "-in1", x, "-in2", x, "-out", csv])
        got["export", dev] = run_files(csv)
        grown = os.path.join(tmp, f"min_dist_grown_{dev}")
        shutil.copytree(os.path.join(tmp, f"min_dist_whole_{dev}"), grown)
        min_cli(["matrix-update", "-in", grown, "-in-evn",
                 os.path.join(tmp, f"min_dist_evn_{dev}"), "-in-nvn",
                 os.path.join(tmp, f"min_dist_nvn_{dev}"), "-n-old", "4",
                 "-n-new", "1"])
        got["matrix-update", dev] = run_files(grown)
    for tag in ("whole", "tiles", "evn", "nvn", "export", "matrix-update"):
        if got[tag, "cuda"] != got[tag, "cpu"] or not got[tag, "cuda"]:
            raise AssertionError(f"small min {tag}: cuda != cpu")
    if got["tiles", "cuda"] != got["whole", "cuda"]:
        raise AssertionError("small min distance: tiles != whole")
    say("small min distance (whole, 3 tiles, two files), export, "
        "matrix-update: cuda == cpu; tiles == whole")
    dd.launches = saved


def min_pipeline_run(tag: str, argv: list, out: str, recorder) -> tuple:
    """One `min pipeline` or `min update` on the card through min_main,
    with every kernel's launch count and the peak memory reset before
    it; returns (record, metrics)."""
    minhash.launches = 0
    dd.launches = 0
    rec, m = cli_run(tag, [], out, recorder, run=lambda: min_cli(argv),
                     joins=False)
    rec["murmur_launches"] = minhash.launches
    rec["pair_launches"] = dd.launches
    if minhash.launches <= 0 or dd.launches <= 0:
        raise AssertionError(f"{tag}: hash kernel launches "
                             f"{minhash.launches}, pair kernel launches "
                             f"{dd.launches}")
    stages = ", ".join(f"{k} {m[k]:.4f}" for k in (*STAGES, "distance_s")
                       if k in m)
    say(f"full {tag}: wall {rec['wall_s']:.3f} s; route "
        f"{m.get('min_route', '-')} (sketch {m['sketch_route']}); stages "
        f"{stages}; instances {m['instances']}, kept "
        f"{m['kept_instances']}; launches: pair kernel "
        f"{rec['pair_launches']}, hash kernel {rec['murmur_launches']}, "
        f"compaction {rec['launches']} (kept total == n on each); peak "
        f"device memory {rec['peak_gib']:.2f} GiB")
    return rec, m


def min_pipeline_full_size(tmp: str, inp8: str, inp9: str, recorder,
                           dev) -> tuple:
    """Phase 12c; returns (the -nb-kmers 1000000 run's record, the
    kernel's times at that run's sketches)."""
    from simka_tpu_torch.minhash.distance import MATRIX_NAMES
    from simka_tpu_torch.minhash.sketch_file import SketchFile

    recs = {}
    for s in SKETCH_SIZES:
        out = os.path.join(tmp, f"full_min_pipe_{s}")
        rec, m = min_pipeline_run(
            f"min pipeline -nb-kmers {s}",
            ["pipeline", "-in", inp8, "-out", out, "-nb-kmers", str(s),
             "-device", "cuda"], out, recorder)
        if m["min_route"] != "resident" or m["sketch_route"] != "batched":
            raise AssertionError(f"min pipeline {s}: route {m['min_route']},"
                                 f" sketch {m['sketch_route']}")
        path = os.path.join(out, "sketch", "sketch.bin")
        if sketch_bytes(path) != sketch_bytes(
                os.path.join(tmp, f"full_min_{s}_0.bin")):
            raise AssertionError(f"min pipeline {s}: sketch.bin != phase "
                                 "11c's min sketch file")
        t0 = time.perf_counter()
        sf = SketchFile(path)
        sk = [sf.read_slot(i) for i in range(8)]
        ii, jj = dd.sketch_pairs(8, 8, True)
        walked = host_walk(sk.__getitem__, sk.__getitem__, ii, jj)
        for name, w in zip(MATRIX_NAMES, walked.T):
            want = np.zeros((8, 8), np.float32)
            want[ii, jj] = want[jj, ii] = w
            got = np.fromfile(os.path.join(out, "distance", name + ".bin"),
                              np.float32).reshape(8, 8)
            if not np.array_equal(got, want):
                raise AssertionError(f"min pipeline {s}: {name} != the host "
                                     "walk over its sketch file")
        check_matrices(csv_texts(out), 8)
        say(f"full min pipeline -nb-kmers {s}: resident route; sketch.bin "
            f"== phase 11c's file; matrices == the host walk over it "
            f"({time.perf_counter() - t0:.1f} s)")
        recs[s] = (rec, out, sk)
    # update with the 9th sample == a joint 9-sample pipeline
    s = SKETCH_SIZES[-1]
    upd = os.path.join(tmp, "full_min_update")
    shutil.copytree(recs[s][1], upd)
    new = os.path.join(tmp, "input_min_9th.txt")
    with open(inp9) as f, open(new, "w") as g:
        g.write(f.readlines()[8])
    min_pipeline_run(f"min update (+ the 9th sample) -nb-kmers {s}",
                     ["update", "-in", new, "-out", upd, "-device", "cuda"],
                     upd, recorder)
    joint = os.path.join(tmp, "full_min_joint")
    min_pipeline_run(f"min pipeline of 9 samples -nb-kmers {s}",
                     ["pipeline", "-in", inp9, "-out", joint, "-nb-kmers",
                      str(s), "-device", "cuda"], joint, recorder)
    if run_files(upd) != run_files(joint):
        raise AssertionError("min update with the 9th sample != the joint "
                             "9-sample pipeline")
    say("full min update with the 9th sample == the joint 9-sample "
        "pipeline (matrices, sketch.bin, CSVs)")
    # the kernel at this run's shape: its 8 sketches of s
    d = dd.ship_sketches(recs[s][2], dev)
    ii, jj = (torch.from_numpy(a).to(dev) for a in dd.sketch_pairs(8, 8, True))
    t = pair_compare(f"min pipeline -nb-kmers {s}", d, d, ii, jj)
    host_walk_check(f"min pipeline -nb-kmers {s}", recs[s][2].__getitem__,
                    recs[s][2].__getitem__, ii.cpu().numpy(),
                    jj.cpu().numpy(), t)
    times = time_pairs(f"at min pipeline -nb-kmers {s} (8 samples)", d, ii,
                       jj, t, 10, 3, EARLIER_PAIR_MS["pipeline"])
    return recs[s][0], times


# ---- phase 13: hash-space shards and -coordinator -------------------------

SHARD_COUNTS = (2, 4)


def sharded_argv(argv: list, out: str, shards: list) -> dict:
    """The CLI's run of ``argv`` over the shard devices ``shards``;
    returns the run's metrics."""
    from simka_tpu_torch.cli import parse_simka_args
    from simka_tpu_torch.core.pipeline import run_simka

    run_simka(parse_simka_args(argv)[1], device="cuda", shards=shards)
    return metrics_of(out)


def sharded_run(tag: str, out: str, recorder: ShapeRecorder, shards: list,
                **cfg) -> tuple:
    """run_simka over the shard devices ``shards``, as ``cli_run``
    measures a run; returns (record, metrics)."""
    from simka_tpu_torch.config import SimkaConfig
    from simka_tpu_torch.core.pipeline import run_simka

    def run():
        run_simka(SimkaConfig(output_dir=out, verbose=False, **cfg),
                  device=shards[0].type, shards=shards)
        return metrics_of(out)

    return cli_run(tag, None, out, recorder, run=run)


def shards_in_memory(tmp: str, inp8: str, yardsticks: dict, instances: int,
                     recorder: ShapeRecorder, dev) -> dict:
    """Phase 13a; returns each shard count's record."""
    want = yardsticks["all distances k=21"]
    recs = {}
    for n in SHARD_COUNTS:
        tag = f"phase 13a: shards [cuda:0] x {n}, all distances k=21"
        out = os.path.join(tmp, f"shards_{n}")
        rec, m = sharded_run(tag, out, recorder, [dev] * n,
                             input_filename=inp8, kmer_size=21,
                             abundance_min=2, simple_dist=True,
                             complex_dist=True)
        c = m["counters"]
        rows = c["repartition_histogram"]  # instances per shard
        if (c["route"], c["n_shards"], len(rows)) != ("in-memory", n, n):
            raise AssertionError(f"{tag}: route {c['route']}, "
                                 f"{c['n_shards']} shards, {len(rows)} rows")
        if sum(rows) != instances:
            raise AssertionError(f"{tag}: {sum(rows)} instances over the "
                                 f"shards, phase 7 had {instances}")
        if csv_texts(out) != want:
            raise AssertionError(f"{tag}: CSVs differ from phase 7's")
        say(f"{tag}: CSVs == phase 7's all-distances k=21 run; wall "
            f"{rec['wall_s']:.3f} s; stages " + ", ".join(
                f"{key} {c[key]}" for key in sorted(c)
                if key.startswith("stage_"))
            + f"; instances per shard {rows} (of {instances}); compact "
            f"launches {rec['launches']} (kept total == n on each), "
            f"pair-sums launches {rec['pair_launches']}; peak "
            f"device memory {rec['peak_gib']:.2f} GiB")
        recs[n] = {**rec, "shard_rows": rows}
    return recs


def shards_from_checkpoints(tmp: str, inp8: str, ckpt: str, csvs: dict,
                            recorder: ShapeRecorder, dev) -> None:
    """Phase 13b: the -out-tmp join over [cuda:0] x 2 from phase 8's 8
    checkpoints (the sweep over them is phase 8's run 3f)."""
    tag = "phase 13b: shards [cuda:0] x 2, -out-tmp join, default k=21"
    out = os.path.join(tmp, "shards_ckpt")
    rec, m = sharded_run(tag, out, recorder, [dev] * 2, input_filename=inp8,
                         output_tmp_dir=ckpt, keep_tmp=True, kmer_size=21,
                         abundance_min=2, max_memory_mb=50000)
    c = m["counters"]
    if (c.get("datasets_resumed"), c.get("sweep_ranges"),
            c["n_shards"]) != (8, None, 2):
        raise AssertionError(
            f"{tag}: {c.get('datasets_resumed')} resumed, "
            f"{c.get('sweep_ranges')} ranges, {c['n_shards']} shards")
    if csv_texts(out) != csvs[0]:
        raise AssertionError(f"{tag}: CSVs differ from phase 7's")
    say(f"{tag}: CSVs == phase 7's default run; wall {rec['wall_s']:.3f} s; "
        f"stages count {m['stages']['count']}, merge {m['stages']['merge']}; "
        f"compact launches {rec['launches']} (kept total == n on each), "
        f"pair-sums launches {rec['pair_launches']}; "
        f"peak device memory {rec['peak_gib']:.2f} GiB")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def coordinator_runs(tmp: str, inp8: str, yardsticks: dict) -> None:
    """Phase 13c: -coordinator through the CLI, one process a rank; two
    ranks each see one card (CUDA_VISIBLE_DEVICES)."""
    want = yardsticks["all distances k=21"]
    root = os.path.dirname(os.path.abspath(__file__))
    torch.cuda.empty_cache()  # the ranks' processes share the card
    for n in (1, 2):
        if n > torch.cuda.device_count():
            say(f"phase 13c: the {n}-rank NCCL run did not run: "
                f"{torch.cuda.device_count()} card(s), and two ranks on "
                "one card are refused (NCCL takes one rank a card)")
            continue
        tag = f"phase 13c: -coordinator, {n} NCCL rank(s), all distances"
        out = os.path.join(tmp, f"coordinator_{n}")
        argv = [sys.executable, "-m", "simka_tpu_torch.cli", "-in", inp8,
                "-out", out, "-simple-dist", "-complex-dist", "-verbose",
                "0", "-device", "cuda", "-coordinator",
                f"localhost:{free_port()}", "-num-hosts", str(n)]
        env = [dict(os.environ, **({"CUDA_VISIBLE_DEVICES": str(r)}
                                   if n > 1 else {})) for r in range(n)]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(argv + ["-host-id", str(r)], cwd=root,
                                  env=env[r], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(n)]
        try:
            logs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        for p, log in zip(procs, logs):
            if p.returncode != 0:
                raise AssertionError(f"{tag}: a rank returned "
                                     f"{p.returncode}:\n{log[-3000:]}")
        if csv_texts(out) != want:
            raise AssertionError(f"{tag}: CSVs differ from phase 7's")
        m = metrics_of(out)
        launches = m["counters"]["compact_launches"]
        if launches <= 0:  # rank 0's process, counted from its start
            raise AssertionError(f"{tag}: rank 0 never launched the "
                                 "compaction kernel")
        say(f"{tag}: CSVs == phase 7's all-distances k=21 run; wall "
            f"{wall:.3f} s (process start included); stages count "
            f"{m['stages']['count']}, merge {m['stages']['merge']}; "
            f"processes {m['counters']['n_processes']}; rank 0's compact "
            f"launches {launches}")


def coordinator_shards(tmp: str, inp8: str, yardsticks: dict,
                       recorder: ShapeRecorder, dev) -> dict:
    """Phase 13d: the -coordinator join as one NCCL rank in this process
    over the local shards [cuda:0] x 2 (run_simka_multihost with
    shards: the exchange, the split by local shard, a join a shard);
    returns its record."""
    import torch.distributed as dist

    from simka_tpu_torch.config import SimkaConfig
    from simka_tpu_torch.parallel import multihost

    tag = ("phase 13d: -coordinator, one NCCL rank over [cuda:0] x 2, all "
           "distances k=21")
    out = os.path.join(tmp, "coordinator_shards_2")
    config = SimkaConfig(input_filename=inp8, output_dir=out, kmer_size=21,
                         abundance_min=2, simple_dist=True,
                         complex_dist=True, verbose=False)

    def run():
        multihost.run_simka_multihost(config, device="cuda",
                                      shards=[dev] * 2)
        return metrics_of(out)

    multihost.init_distributed(f"localhost:{free_port()}", 1, 0, "cuda")
    try:
        rec, m = cli_run(tag, None, out, recorder, run=run)
    finally:
        dist.destroy_process_group()
    c = m["counters"]
    if (c["n_processes"], c["n_shards"], c["shards_per_process"],
            c["compact_launches"]) != (1, 2, [2], rec["launches"]):
        raise AssertionError(
            f"{tag}: {c['n_processes']} processes, {c['n_shards']} shards "
            f"{c['shards_per_process']}, {c['compact_launches']} launches")
    if csv_texts(out) != yardsticks["all distances k=21"]:
        raise AssertionError(f"{tag}: CSVs differ from phase 7's")
    say(f"{tag}: CSVs == phase 7's all-distances k=21 run; wall "
        f"{rec['wall_s']:.3f} s (process group formed before); stages count "
        f"{m['stages']['count']}, merge {m['stages']['merge']}; compact "
        f"launches {rec['launches']} (kept total == n on each), "
        f"pair-sums launches {rec['pair_launches']}; peak device "
        f"memory {rec['peak_gib']:.2f} GiB")
    return rec


# ---- phase 14: the wide-N exact path --------------------------------------

PAIR_SUMS_REPLACES = "simka_tpu/ops/countjoin.py:1112"
# phase 14a's sample counts: a private copy of the partials a warp (N =
# 2, 8), teams (N = 33), one copy (N = 100, default), sample groups (N =
# 100 every channel, 256 and 300 default), the global form (every
# channel from N = 256, N = 1000)
PAIR_SUMS_NS = (2, 8, 33, 100, 256, 300, 1000)
# the counts' largest values: past 2^20, and int32's largest (the
# Whittaker terms' wrap)
PAIR_SUMS_CMAX = (1 << 20, (1 << 31) - 1)
# an N whose row stage and K alone pass a CTA's shared memory
PAIR_SUMS_WIDEST_N = 20_000
# the bound's 32-bit integer instructions a pair and channel, and a
# whittaker_all term: one 64-bit add each (the index arithmetic, the
# loads and the products are not counted: the bound stays a floor)
PAIR_SUMS_INT_OPS = 2
# the f64 operations a pair of the complex channels takes, a division
# and a log one each (the floor of every channel): xY and yX, their sum,
# 2 xY and 2 yX, two divisions, two logs, two products and a sum, then
# the limbs' abs, 5 floors, 5 subtractions, 4 scalings and 5 signs
PAIR_SUMS_F64_OPS = 32
# f64 instructions a second: the datasheet's 34 TFLOP/s FP64 outside the
# tensor cores (64 f64 lanes an SM), an FMA two operations
F64_OPS_PER_S = 34e12 / 2
# the matrices whose [i, j] depends on samples i and j alone
# (tests/test_large_n.py::PAIR_LOCAL)
PAIR_LOCAL = ("mat_abundance_braycurtis", "mat_abundance_jaccard",
              "mat_presenceAbsence_jaccard", "mat_presenceAbsence_ochiai",
              "mat_presenceAbsence_chord", "mat_abundance_chord",
              "mat_abundance_hellinger", "mat_abundance_whittaker",
              "mat_abundance_jensenshannon", "mat_abundance_canberra")
# Jensen-Shannon may differ by one unit of its 6th decimal (ROADMAP
# section 3); every other pair-local entry is equal
JS_MATRIX = "mat_abundance_jensenshannon"
# past this predicted time the plain loop is held on a slice of whole
# segments of the run's rows
PLAIN_PAIR_SECONDS = 60.0
PAIR_SUMS_PLAIN = countjoin._pair_sums_plain
WHITTAKER_ALL_PLAIN = countjoin._whittaker_all


def pair_outputs(N: int, simple: bool, complex_: bool, dev):
    """Zeroed pair outputs: (flat, kl, whittaker_all or None), as
    ``countjoin.pair_sums`` takes them."""
    names = countjoin.PAIR_CHANNELS[:4 + 2 * simple] + (
        countjoin.PAIR_CHANNELS[6:] if complex_ else ())
    flat = {name: torch.zeros(N * N, dtype=torch.int64, device=dev)
            for name in names}
    kl = torch.zeros((N * N, 1 + countjoin.KL_FRAC_LIMBS),
                     dtype=torch.int64, device=dev)
    wall = (torch.zeros(N * N, dtype=torch.int64, device=dev) if complex_
            else None)
    return flat, kl, wall


def kernel_pair_sums(rows, out, d_max: int) -> None:
    countjoin.pair_sums(*rows, out[0], out[1], d_max=d_max,
                        whittaker_all=out[2])


def plain_pair_sums(rows, out, d_max: int) -> None:
    with plain_on_card():
        PAIR_SUMS_PLAIN(*rows, out[0], out[1], d_max=d_max,
                        whittaker_all=out[2])


def pair_plan_of(N: int, simple: bool, complex_: bool, d_max: int):
    """The plan ``countjoin.pair_sums`` takes for these channels."""
    flat = pair_outputs(1, simple, complex_, "cpu")[0]
    budget = _kernels.lib().simka_pair_sums_budget(N, int(complex_))
    return countjoin.pair_plan(N, len(countjoin._kernel_channels(flat)),
                               complex_, budget, d_max)


def plan_text(plan) -> str:
    if plan.form == "global":
        return "the global form"
    copies = countjoin.PAIR_WARPS // plan.team_warps
    return (f"{len(plan.groups) - 1} sample group(s) {list(plan.groups)}, "
            f"{copies} cop{'y' if copies == 1 else 'ies'} of "
            f"{plan.smem // copies} B of partials a CTA")


def segment_rows(N: int, n_segs: int, cmax: int, rng, dev):
    """Solid rows of n_segs random k-mers over N samples, as the join
    hands them to pair_sums: (sid, count, starts, seg_len, K). Each
    segment a singleton (40%), every sample (10%) or 2..N samples, the
    first two a full segment and a singleton; its samples a sorted
    random subset; counts uniform in [1, cmax], one in 20 at cmax; K
    the per-bank sums of the counts."""
    kind = rng.choice(3, size=n_segs, p=(0.1, 0.4, 0.5))
    kind[:2] = (0, 1)
    lens = np.where(kind == 0, N, np.where(
        kind == 1, 1, rng.integers(2, N + 1, size=n_segs)))
    sid = np.concatenate([np.arange(N) if L == N else
                          np.sort(rng.choice(N, L, replace=False))
                          for L in lens])
    count = rng.integers(1, cmax + 1, size=sid.size)
    count[rng.random(sid.size) < 0.05] = cmax
    K = np.zeros(N, np.int64)
    np.add.at(K, sid, count)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    as_dev = (lambda a, dt=torch.int64:
              torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt))
    return (as_dev(sid), as_dev(count), as_dev(starts), as_dev(lens),
            as_dev(K, torch.float64))


def same_pair_sums(tag: str, got, want, complex_: bool) -> int:
    """Two pair_sums outputs (flat, kl, whittaker_all) equal in every
    channel, KL limb and whittaker_all entry (anything else raises);
    returns the max abs error, 0."""
    torch.cuda.synchronize()
    for name in got[0]:
        if not torch.equal(got[0][name], want[0][name]):
            bad = (got[0][name] != want[0][name]).nonzero()[:5].flatten()
            raise AssertionError(f"pair_sums {tag}: {name} kernel != plain "
                                 f"at bins {bad.tolist()}")
    if not torch.equal(got[1], want[1]):
        bad = (got[1] != want[1]).nonzero()[:5].tolist()
        raise AssertionError(f"pair_sums {tag}: KL limbs kernel != plain at "
                             f"{bad}")
    if complex_ and not torch.equal(got[2], want[2]):
        bad = (got[2] != want[2]).nonzero()[:5].flatten()
        raise AssertionError(f"pair_sums {tag}: whittaker_all kernel != "
                             f"plain at {bad.tolist()}")
    if not got[0]["distinct"].any() or complex_ and not (
            got[1].any() and got[2].any()):
        raise AssertionError(f"pair_sums {tag}: the channels stayed empty")
    return 0


def pair_sums_compare(tag: str, rows, simple: bool, complex_: bool) -> int:
    """Kernel against plain on the same CUDA rows (``same_pair_sums``)."""
    N = rows[4].shape[0]
    d_max = int(rows[3].max())
    got, want = (pair_outputs(N, simple, complex_, rows[0].device)
                 for _ in range(2))
    kernel_pair_sums(rows, got, d_max)
    plain_pair_sums(rows, want, d_max)
    return same_pair_sums(tag, got, want, complex_)


def pair_sums_vs_plain(dev, seed: int) -> int:
    """Phase 14a: the pair kernel against its plain version on random
    segment layouts at every N of PAIR_SUMS_NS, each count bound, the
    default and every channel (with whittaker_all): one launch each;
    returns the max abs error."""
    rng = np.random.default_rng(seed + 14)
    saved = countjoin.launches
    forms = set()
    for N in PAIR_SUMS_NS:
        n_segs = max(40, min(3000, 60_000 // N))
        plans = [pair_plan_of(N, s, s, N) for s in (False, True)]
        for cmax in PAIR_SUMS_CMAX:
            rows = segment_rows(N, n_segs, cmax, rng, dev)
            for simple, complex_ in ((False, False), (True, True)):
                n0 = countjoin.launches
                pair_sums_compare(f"N={N} cmax={cmax}", rows, simple,
                                  complex_)
                if countjoin.launches - n0 != 1:
                    raise AssertionError(
                        f"pair_sums N={N}: {countjoin.launches - n0} "
                        "launches, expected 1")
        for plan in plans:
            forms.add("global" if plan.form == "global" else
                      "groups" if len(plan.groups) > 2 else
                      "copies" if plan.team_warps < countjoin.PAIR_WARPS
                      else "one copy")
        sl = rows[3]
        say(f"pair_sums N={N}: kernel == plain in every channel, KL limb "
            f"and whittaker_all entry ({n_segs} segments, "
            f"{int(rows[0].shape[0])} rows, "
            f"{int((sl * (sl - 1) // 2).sum())} pairs at cmax 2^31 - 1), "
            f"one launch each; default: {plan_text(plans[0])}; every "
            f"channel: {plan_text(plans[1])}")
    if forms != {"global", "groups", "copies", "one copy"}:
        raise AssertionError(f"pair_sums forms held: {sorted(forms)}")
    # past N ~ 16,600 the row stage and K alone fill a CTA's shared
    # memory: the budget is 0 (the global form), never negative
    wide = [_kernels.lib().simka_pair_sums_budget(PAIR_SUMS_WIDEST_N, kl)
            for kl in (0, 1)]
    if wide != [0, 0]:
        raise AssertionError(f"pair_sums budget at N={PAIR_SUMS_WIDEST_N}: "
                             f"{wide}, expected [0, 0]")
    say(f"pair_sums budget at N={PAIR_SUMS_WIDEST_N}: 0 B (the global form)")
    countjoin.launches = saved  # comparison launches are not the path's
    return 0


class PairRecorder:
    """Keeps the inputs (sid, count, starts, seg_len, K) of the largest
    pair_sums call on the card while installed: the join's own rows."""

    def __init__(self):
        self.args = None
        self._orig = countjoin.pair_sums

    def __enter__(self):
        def recording(sid, count, starts, seg_len, K, flat, kl, **kw):
            if sid.device.type == "cuda" and (
                    self.args is None or sid.shape[0] > self.args[0].shape[0]):
                self.args = (sid, count, starts, seg_len, K)
            return self._orig(sid, count, starts, seg_len, K, flat, kl, **kw)

        countjoin.pair_sums = recording
        return self

    def __exit__(self, *exc):
        countjoin.pair_sums = self._orig


def wide_n_runs(tmp: str, seed: int, recorder: ShapeRecorder):
    """Phase 14b: the N = 100 community through the CLI, default
    distances, then every distance twice (one pair-kernel launch, one
    run-count launch, one segment pass and an extraction launch a batch
    each). Returns (the input, the all-distances CSVs, the default run's
    record, the first every-distance run's record, the default run's
    join's pair-kernel rows, its segment pass's rows on the host)."""
    from simka_tpu_torch.utils.community import (WIDE_COMMUNITY,
                                                 write_community)

    t0 = time.perf_counter()
    inp = write_community(os.path.join(tmp, "wide"), seed=seed,
                          **WIDE_COMMUNITY)
    N = WIDE_COMMUNITY["n_samples"]
    say(f"phase 14: wide-N data written in {time.perf_counter() - t0:.2f} s "
        f"({N} samples x {WIDE_COMMUNITY['reads_per_sample']} reads x 100 "
        f"bp, {WIDE_COMMUNITY['n_genomes']} genomes x "
        f"{WIDE_COMMUNITY['genome_len']} bp)")
    texts, recs, rows = {}, [], None
    for tag, flags, r in (("default", [], 0),
                          ("all distances", ALL_DISTANCES, 0),
                          ("all distances", ALL_DISTANCES, 1)):
        out = os.path.join(tmp, f"wide_{len(flags)}_{r}")
        argv = ["-in", inp, "-out", out, "-kmer-size", "21",
                "-abundance-min", "2", "-verbose", "0", "-device", "cuda",
                *flags]
        name = f"phase 14b: N={N} {tag} run {r}"
        # the last run's segment rows kept (the same rows as every run's)
        with PairRecorder() as pr, KernelInputs(
                extract=False, runs=False, segments=r == 1) as inputs:
            rec, m = cli_run(name, argv, out, recorder)
        launches = (rec["extract_launches"], rec["run_counts_launches"],
                    rec["segment_launches"])
        per = -(-WIDE_COMMUNITY["reads_per_sample"] // BATCH_READS)
        if launches != (N * per, 1, 1):
            raise AssertionError(f"{name}: extraction, run-count and "
                                 f"segment launches {launches}")
        if r == 1:
            inputs.to_host()
            segment_rows = inputs.segments
        c = m["counters"]
        if c["route"] != "in-memory":
            raise AssertionError(f"{name}: route {c['route']}, expected "
                                 "in-memory")
        if rec["pair_launches"] != 1:
            raise AssertionError(f"{name}: {rec['pair_launches']} pair-kernel "
                                 "launches, expected 1 (one join)")
        sid, _, starts, seg_len, _ = pr.args
        d_max, pairs = torch.stack(
            [seg_len.max(), (seg_len * (seg_len - 1) // 2).sum()]).tolist()
        rec.update(instances=int(sum(c["repartition_histogram"])),
                   distinct=c["nb_distinct_kmers"], rows=sid.shape[0],
                   d_max=d_max, pairs=pairs, stages={
                       k: c[k] for k in sorted(c) if k.startswith("stage_")})
        say(f"{name}: route {c['route']}; wall {rec['wall_s']:.3f} s; stages "
            + ", ".join(f"{k} {v}" for k, v in rec["stages"].items())
            + f", count {m['stages']['count']}, output "
            f"{m['stages']['output']}; reads {c['reads']}, instances "
            f"{rec['instances']}, distinct solid {rec['distinct']}, solid "
            f"rows {rec['rows']}, d_max {d_max}, pairs {pairs}; pair-sums "
            f"launches {rec['pair_launches']}, compact launches "
            f"{rec['launches']}, extraction {launches[0]}, run counts "
            f"{launches[1]}, segment pass {launches[2]}; peak device memory "
            f"{rec['peak_gib']:.2f} GiB")
        if rows is None:
            rows = pr.args
        recs.append(rec)
        del pr, sid, starts, seg_len
        got = csv_texts(out)
        check_matrices(got, N)
        if r == 1 and got != texts:
            raise AssertionError(f"{name}: CSVs differ from run 0's")
        texts = got
    say(f"phase 14b: N={N} all distances, both runs identical, "
        f"{len(texts)} matrices")
    return inp, texts, recs[0], recs[1], rows, segment_rows


def once_ms(fn) -> float:
    """CUDA-event time of one call of fn."""
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def pair_sums_bound(n: int, S: int, N: int, pairs: int, n_chans: int,
                    complex_: bool, sample_counts: int) -> tuple:
    """(bound ms, "bytes" or "operations") of one pair_sums call: rows
    and segments read once, outputs written once; the larger of the
    32-bit integer instructions (PAIR_SUMS_INT_OPS a pair and channel
    and a whittaker_all term) at INT32_OPS_PER_S and the f64 floor
    (PAIR_SUMS_F64_OPS a pair) at F64_OPS_PER_S. A whittaker_all term
    |w32(c K_j)| depends on (c, j) alone, so A[a][.] needs N terms for
    each distinct (sample, count) of the rows, ``sample_counts`` of
    them, each added times its rows (the rows are read in the bytes)."""
    nbytes = 16 * n + 16 * S + 8 * N + (n_chans + complex_) * N * N * 8
    int_ops = (pairs * n_chans + complex_ * sample_counts * N
               ) * PAIR_SUMS_INT_OPS
    f64_ms = complex_ * pairs * PAIR_SUMS_F64_OPS / F64_OPS_PER_S * 1e3
    b_ms, b_by = bound(nbytes, int_ops, INT32_OPS_PER_S)
    return (f64_ms, "operations") if f64_ms > b_ms else (b_ms, b_by)


def pair_sums_at_rows(tag: str, rows, compare_global: bool) -> dict:
    """Phase 14c (and phase 7's rows): the kernel against its plain
    version on a run's own solid rows, equal, each timed with CUDA
    events, with the bound, for the default channels and for every
    channel with whittaker_all; the plain loop on a slice of whole
    segments when its time on all rows is predicted past
    PLAIN_PAIR_SECONDS; _whittaker_all's time (the plain version of
    that part). With ``compare_global``, the kernel's global form
    (every add straight into the outputs) on the same rows, equal to
    the path's and timed."""
    sid, count, starts, seg_len, K = rows
    N, n, S = K.shape[0], sid.shape[0], starts.shape[0]
    d_max, pairs = torch.stack(
        [seg_len.max(), (seg_len * (seg_len - 1) // 2).sum()]).tolist()
    # the distinct (sample, count) of the rows: whittaker_all's terms / N
    sample_counts = torch.unique(
        sid * (int(count.max()) + 1) + count).numel()
    saved = countjoin.launches
    # whole segments covering about a sixteenth of the rows
    s_cut = max(1, int(torch.searchsorted(starts, n // 16)))
    cut = int(starts[s_cut]) if s_cut < S else n
    part = (sid[:cut], count[:cut], starts[:s_cut], seg_len[:s_cut], K)
    d_part = int(part[3].max())
    res = {}
    for label, simple, complex_ in (("", False, False),
                                    ("all_", True, True)):
        plan = pair_plan_of(N, simple, complex_, d_max)
        flat = pair_outputs(N, simple, complex_, "cpu")[0]
        n_chans = len(countjoin._kernel_channels(flat))
        want = pair_outputs(N, simple, complex_, sid.device)
        plain_ms = once_ms(lambda: plain_pair_sums(part, want, d_part))
        whole = plain_ms * n / max(cut, 1) < PLAIN_PAIR_SECONDS * 1e3
        held, dm = (rows, d_max) if whole else (part, d_part)
        if whole:
            want = pair_outputs(N, simple, complex_, sid.device)
            plain_ms = once_ms(lambda: plain_pair_sums(rows, want, d_max))
        got = pair_outputs(N, simple, complex_, sid.device)
        n0 = countjoin.launches
        kernel_pair_sums(held, got, dm)
        if countjoin.launches - n0 != 1:
            raise AssertionError(f"pair_sums {tag}: "
                                 f"{countjoin.launches - n0} launches")
        same_pair_sums(f"{tag}" + ("" if whole else f", rows [0, {cut})"),
                       got, want, complex_)
        del got, want
        out = pair_outputs(N, simple, complex_, sid.device)
        ms = time_ms(lambda: kernel_pair_sums(rows, out, d_max), reps=5)
        b_ms, b_by = pair_sums_bound(n, S, N, pairs, n_chans, complex_,
                                     sample_counts)
        res.update({f"{label}ms": ms, f"{label}plain_ms": plain_ms,
                    f"{label}plain_rows": held[0].shape[0],
                    f"{label}bound_ms": b_ms, f"{label}bound_by": b_by,
                    f"{label}plan": plan_text(plan)})
        line = ""
        if compare_global:
            glob = pair_outputs(N, simple, complex_, sid.device)
            countjoin._launch_pair_sums(*rows, *glob, countjoin.GLOBAL_PLAN)
            path = pair_outputs(N, simple, complex_, sid.device)
            kernel_pair_sums(rows, path, d_max)
            same_pair_sums(f"{tag}, global form", glob, path, complex_)
            del glob, path
            res[f"{label}global_ms"] = time_ms(
                lambda: countjoin._launch_pair_sums(*rows, *out,
                                                    countjoin.GLOBAL_PLAN),
                reps=5)
            line = (f"; the global form {res[label + 'global_ms']:.4f} ms "
                    "(== the path's)")
        say(f"pair_sums at {tag} ({n} rows, {S} segments, d_max {d_max}, "
            f"{pairs} pairs, {sample_counts} distinct (sample, count)), "
            + ("default channels" if not simple else
               "every channel with whittaker_all")
            + f": kernel {ms:.4f} ms in one launch, {plan_text(plan)} "
            f"(bound {b_ms:.4f} ms by {b_by}, {100 * b_ms / ms:.1f}%){line}; "
            "plain "
            + (f"{plain_ms:.4f} ms on all rows" if whole else
               f"{plain_ms:.4f} ms on rows [0, {cut}) (all rows predicted "
               f"past {PLAIN_PAIR_SECONDS:.0f} s), the kernel held there")
            + "; kernel == plain in every channel, limb and whittaker_all "
            "entry")
        del out
    with plain_on_card():
        res["all_wall_plain_ms"] = time_ms(
            lambda: WHITTAKER_ALL_PLAIN(sid, count, K, N), reps=3)
    say(f"_whittaker_all (torch ops, the plain version of that part) at "
        f"{tag}: {res['all_wall_plain_ms']:.4f} ms")
    countjoin.launches = saved  # timing launches are not the path's
    res.update(rows=n, segments=S, d_max=d_max, pairs=pairs,
               sample_counts=sample_counts)
    return res


def csv_cell(text: str, i: int, j: int) -> str:
    return text.splitlines()[1 + i].split(";")[1 + j]


def pair_local_oracle(tmp: str, inp: str, texts: dict, seed: int,
                      recorder: ShapeRecorder) -> None:
    """Phase 14d: for three pairs (i, j) a 2-sample CLI run of samples i
    and j gives the [i, j] entry of every pair-local matrix of the
    N = 100 all-distances run (Jensen-Shannon to one unit of its 6th
    decimal)."""
    with open(inp) as f:
        lines = f.readlines()
    N = len(lines)
    rng = np.random.default_rng(seed + 141)
    for _ in range(3):
        i, j = sorted(int(x) for x in rng.choice(N, 2, replace=False))
        two = os.path.join(tmp, f"wide_pair_{i}_{j}.txt")
        with open(two, "w") as f:
            f.writelines([lines[i], lines[j]])
        out = os.path.join(tmp, f"wide_pair_{i}_{j}")
        rec, _ = cli_run(f"phase 14d: samples {i} and {j}", [
            "-in", two, "-out", out, "-kmer-size", "21", "-abundance-min",
            "2", "-verbose", "0", "-device", "cuda", *ALL_DISTANCES],
            out, recorder)
        pair = csv_texts(out)
        worst = 0.0
        for name in PAIR_LOCAL:
            key = name + ".csv.gz"
            got, want = csv_cell(texts[key], i, j), csv_cell(pair[key], 0, 1)
            diff = abs(float(got) - float(want))
            if name == JS_MATRIX and diff <= 1.0000001e-6:
                worst = max(worst, diff)
            elif got != want:
                raise AssertionError(f"phase 14d: {name}[{i}, {j}] {got} != "
                                     f"{want} of the 2-sample run")
        say(f"phase 14d: samples {i} and {j}: every pair-local entry of the "
            f"N={N} run == the 2-sample run's (Jensen-Shannon off by "
            f"{worst:.1e}; wall {rec['wall_s']:.3f} s)")


def wide_n_phase(tmp: str, seed: int, recorder: ShapeRecorder, dev) -> dict:
    """Phase 14; returns the pair kernel's numbers for its record."""
    t0 = time.perf_counter()
    err = pair_sums_vs_plain(dev, seed)
    inp, texts, run, run_all, rows, segment_rows = wide_n_runs(tmp, seed,
                                                                recorder)
    times = pair_sums_at_rows(f"the N={len(rows[4])} run's rows", rows,
                              compare_global=True)
    del rows
    torch.cuda.empty_cache()
    pair_local_oracle(tmp, inp, texts, seed, recorder)
    say(f"phase 14: {time.perf_counter() - t0:.1f} s")
    return {"max_abs_err": err, "run": run, "run_all": run_all,
            "segment_rows": segment_rows, **times}


def wide_n_alone(seed: int = 0) -> dict:
    """Phase 14 on its own, the kernels built first:
    python3 -c "import chip_smoke; chip_smoke.wide_n_alone()"."""
    _kernels.build()
    with tempfile.TemporaryDirectory(prefix="simka_chip_smoke_") as tmp, \
            ShapeRecorder() as rec:
        return wide_n_phase(tmp, seed, rec, torch.device("cuda", 0))


# ---- phase 15: the extraction, run-count and segment kernels ----------

EXTRACT_REPLACES = "simka_tpu/core/pipeline.py:794"
RUN_COUNTS_REPLACES = "simka_tpu/ops/countjoin.py:376"
SEGMENT_REPLACES = "simka_tpu/ops/countjoin.py:1080"
SORT_REPLACES = "simka_tpu/ops/countjoin.py:404"  # lax.sort of the key
EXTRACT_KS = (1, 15, 16, 21, 31, 32, 33, 48, 62, 63, 64, 127)
EXTRACT_WIDTHS = (32, 104, 160)
SEGMENT_NS = (1, 2, 8, 100, 1000, 20000)
RUN_TILE = 4096  # csrc/runs.cu's rows a tile
# low-complexity repeats of phase 15a's batch: Shannon indices 0, 0.81,
# 1.0, 1.5 and 2.0 at k a multiple of 4
LOW_PATTERNS = (b"AAAA", b"AAAC", b"AACC", b"AACG", b"ACGT")


class KernelInputs:
    """Keeps, while installed, the inputs of the largest call on the
    card of the extraction kernel (its packed batch and k), of
    ``run_counts`` (its key columns and bounds) and of ``segment_stats``
    (its rows and N: a join's): the main path's own
    shapes, for phase 15b. It
    holds references, no copy, so the run's stages are not slowed;
    ``to_host`` moves the columns to the host after the run."""

    def __init__(self, extract: bool = True, runs: bool = True,
                 segments: bool = True):
        self.want = (extract, runs, segments)
        self.extract = self.runs = self.segments = None
        self._rows = [0, 0, 0]  # the rows of each kept call
        self._orig = (kmers.extract_kmers, countjoin.run_counts,
                      countjoin.segment_stats)

    def __enter__(self):
        ex, rc, ss = self._orig

        def bigger(i: int, t) -> bool:
            if self.want[i] and t.is_cuda and t.shape[0] > self._rows[i]:
                self._rows[i] = t.shape[0]
                return True
            return False

        def extract(packed, validbits, k, **kw):
            if bigger(0, packed):
                self.extract = (packed, validbits, k)
            return ex(packed, validbits, k, **kw)

        def runs(cols, *bounds):
            cols = tuple(cols)
            if bigger(1, cols[0]):
                self.runs = (cols, *bounds)
            return rc(cols, *bounds)

        def segments(words, sid, count, *, n_banks):
            if bigger(2, sid):
                self.segments = (tuple(words), sid, count, n_banks)
            return ss(words, sid, count, n_banks=n_banks)

        kmers.extract_kmers = extract
        countjoin.run_counts = runs
        countjoin.segment_stats = segments
        return self

    def __exit__(self, *exc):
        (kmers.extract_kmers, countjoin.run_counts,
         countjoin.segment_stats) = self._orig

    def to_host(self) -> None:
        """The kept key columns and rows moved to the host."""
        if self.runs is not None:
            cols, *bounds = self.runs
            self.runs = (tuple(c.cpu() for c in cols), *bounds)
        if self.segments is not None:
            words, sid, count, N = self.segments
            self.segments = (tuple(w.cpu() for w in words), sid.cpu(),
                             count.cpu(), N)
        torch.cuda.empty_cache()


def flat(outs) -> list:
    """A kernel's outputs (tensors, None, tuples of them) as one list."""
    return [t for o in outs for t in (
        flat(o) if isinstance(o, (tuple, list)) else [o])]


def same(tag: str, got, want) -> None:
    """Outputs (tensors or None, nested in tuples) equal pairwise, bit
    for bit."""
    got, want = flat(got), flat(want)
    if len(got) != len(want):
        raise AssertionError(f"{tag}: {len(got)} outputs, {len(want)} "
                             "expected")
    for i, (g, w) in enumerate(zip(got, want)):
        if (g is None) != (w is None) or g is not None and (
                g.shape != w.shape or not torch.equal(g, w)):
            raise AssertionError(f"{tag}: output {i} of the kernel differs "
                                 "from the plain version's")


def extract_batch(seed: int, n: int = 1024, width: int = 160):
    """Phase 15a's read batch as [n, width] codes (255 invalid): ragged
    reads with N bases, all-N reads, reads shorter than most k, empty
    slots, and every other read a low-complexity repeat."""
    from simka_tpu_torch.io.bank import encode_batch

    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGTN", np.uint8)
    reads = []
    for i in range(n):
        kind = i % 16
        if kind == 0:
            reads.append(b"N" * int(rng.integers(1, width + 1)))
        elif kind == 1:
            reads.append(b"")
        elif kind in (2, 3):
            reads.append(bytes(rng.choice(bases[:4], size=int(
                rng.integers(1, 40)))))
        elif i % 2:
            pat = np.frombuffer(LOW_PATTERNS[(i // 2) % len(LOW_PATTERNS)],
                                np.uint8)
            reads.append(bytes(np.tile(pat, width // 4)[:width]))
        else:
            reads.append(bytes(rng.choice(
                bases, size=int(rng.integers(width // 2, width + 1)),
                p=[0.2475] * 4 + [0.01])))
    return encode_batch(reads, max_len=width)[0]


def extract_vs_plain(dev, seed: int) -> int:
    """Phase 15a, the extraction kernel == its plain version bit for bit
    (words of every window, keep mask, kept count, histogram) at every k
    of EXTRACT_KS, comp_xor 3 and 2, the Shannon filter off, 1.0 and
    1.5, the histogram on and off; and the codes entry point."""
    from simka_tpu_torch.io.packed import pack_codes_host

    codes = extract_batch(seed)
    packed, vb = (torch.from_numpy(a).to(dev) for a in pack_codes_host(codes))
    codes_d = torch.from_numpy(codes).to(dev)
    saved, cases = kmers.launches, 0
    for k in EXTRACT_KS:
        for cx in (3, 2):
            for thr in (0.0, 1.0, 1.5):
                for hist in (False, True):
                    got = kmers.extract_kmers(packed, vb, k, comp_xor=cx,
                                              min_shannon=thr, with_hist=hist)
                    with plain_on_card():
                        want = kmers._extract_kmers_plain(
                            kmers.unpack_codes(packed, vb), k, cx, thr, hist)
                    same(f"extract_kmers k={k} comp_xor={cx} shannon={thr} "
                         f"hist={hist}", got, want)
                    cases += 1
            got = kmers.extract_kmers_codes(codes_d, k, comp_xor=cx)
            with plain_on_card():
                want = kmers._extract_kmers_plain(codes_d, k, cx, 0.0, False)
            same(f"extract_kmers_codes k={k} comp_xor={cx}", got, want)
            cases += 1
    # row strides of 8, 26 and 40 packed bytes, 1021 reads (the stream
    # ends mid-tile), and views one row in (pointers off 16-byte
    # alignment: the staging's byte loads)
    strides = 0
    for width in EXTRACT_WIDTHS:
        codes = extract_batch(seed + width, n=1022, width=width)
        packed, vb = (torch.from_numpy(a).to(dev)
                      for a in pack_codes_host(codes))
        codes_d = torch.from_numpy(codes).to(dev)
        for k in (k for k in EXTRACT_KS if k <= width):
            for cx in (3, 2):
                for thr in (0.0, 1.5):
                    for view in (slice(0, 1021), slice(1, 1022)):
                        p, v = packed[view], vb[view]
                        got = kmers.extract_kmers(p, v, k, comp_xor=cx,
                                                  min_shannon=thr,
                                                  with_hist=True)
                        with plain_on_card():
                            want = kmers._extract_kmers_plain(
                                kmers.unpack_codes(p, v), k, cx, thr, True)
                        same(f"extract_kmers L={width} k={k} comp_xor={cx} "
                             f"shannon={thr} rows {view}", got, want)
                        cases += 1
                        strides += 1
                got = kmers.extract_kmers_codes(codes_d[1:], k, comp_xor=cx,
                                                with_hist=True)
                with plain_on_card():
                    want = kmers._extract_kmers_plain(codes_d[1:], k, cx,
                                                      0.0, True)
                same(f"extract_kmers_codes L={width} k={k} comp_xor={cx} "
                     "rows 1..", got, want)
                cases += 1
                strides += 1
    torch.cuda.synchronize()
    if kmers.launches - saved != cases:
        raise AssertionError(f"extract_kmers: {kmers.launches - saved} "
                             f"launches for {cases} calls")
    kmers.launches = saved
    say(f"phase 15a: extract_kmers == plain bit for bit in {cases} cases "
        f"(k {EXTRACT_KS}, comp_xor 3 and 2, Shannon off / 1.0 / 1.5, "
        f"histogram on / off, the codes entry point; 1024 reads x 160: "
        "ragged, all-N, shorter than k, empty, low-complexity; of them "
        f"{strides} at L {EXTRACT_WIDTHS} (rows of 8, 26 and 40 packed "
        "bytes), 1021 reads, aligned and one row in)")
    return 0


def run_keys(flags: torch.Tensor, n_cols: int):
    """Key columns whose runs start where ``flags`` is set: int64 run
    ids spread over ``n_cols`` columns (the last int32 with 2 or more)."""
    rid = torch.cumsum(flags.to(torch.int64), 0)
    if n_cols == 1:
        return (rid * 0x9E3779B1,)
    cols = [(rid >> (8 * (n_cols - 2 - j))) & 0xFF for j in range(n_cols - 1)]
    return (*cols, (rid & 0x7FFFFFFF).to(torch.int32))


def run_counts_vs_plain(dev, seed: int) -> int:
    """Phase 15a, run_counts == its plain version bit for bit (count,
    keep, total): every row its own run; one run of 2^24 rows, from row
    0 and from mid-tile; runs ending at, one before and one after every
    tile edge; random runs of 1-8 rows with the bounds (3, 6), so counts
    at amin - 1, amin, amax and amax + 1; runs ending at each distance
    run_end searches past a tile; E = 1; keys of 1 and 6 columns; and
    SimkaMin's unsigned-order hashes with 1 and 2 columns."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 15)
    E = 64 * RUN_TILE + 123
    edges = torch.zeros(E, dtype=torch.bool, device=dev)
    at = torch.arange(RUN_TILE, E, RUN_TILE, device=dev)
    for d in (-1, 0, 1):
        edges[at + d] = True
    short = torch.randint(1, 9, (E,), generator=gen, device=dev)
    starts = torch.cumsum(short, 0)
    randoms = torch.zeros(E, dtype=torch.bool, device=dev)
    randoms[starts[starts < E]] = True
    mid = torch.zeros((1 << 24) + 3 * RUN_TILE, dtype=torch.bool,
                      device=dev)
    mid[:RUN_TILE + 1000] = True
    mid[RUN_TILE + 1000 + (1 << 24)] = True
    kinds = {
        "every row its own run": torch.ones(E, dtype=torch.bool, device=dev),
        "one run of 2^24 rows": torch.zeros(1 << 24, dtype=torch.bool,
                                            device=dev),
        "a run of 2^24 rows from mid-tile": mid,
        "runs at every tile edge": edges,
        "runs of 1-8 rows": randoms,
        "runs ending at each search distance past a tile":
            search_distance_flags(dev),
        "E = 1": torch.ones(1, dtype=torch.bool, device=dev),
    }
    saved, cases = countjoin.run_counts_launches, 0
    for kind, flags in kinds.items():
        flags[0] = True
        for n_cols in (1, 6):
            cols = run_keys(flags, n_cols)
            for amin, amax in ((1, countjoin.INT32_MAX), (3, 6),
                               (1 << 24, 1 << 24)):
                got = countjoin.run_counts(cols, amin, amax)
                with plain_on_card():
                    want = countjoin._run_counts_plain(cols, amin, amax)
                same(f"run_counts, {kind}, {n_cols} columns, [{amin}, "
                     f"{amax}]", got, want)
                cases += 1
    for n_cols, cols in unsigned_order_keys(gen, dev):
        for amin, amax in ((1, countjoin.INT32_MAX), (2, 1000)):
            got = countjoin.run_counts(cols, amin, amax)
            with plain_on_card():
                want = countjoin._run_counts_plain(cols, amin, amax)
            same(f"run_counts, unsigned-order keys, {n_cols} columns, "
                 f"[{amin}, {amax}]", got, want)
            cases += 1
    torch.cuda.synchronize()
    if countjoin.run_counts_launches - saved != cases:
        raise AssertionError("run_counts: one launch a call expected")
    countjoin.run_counts_launches = saved
    say(f"phase 15a: run_counts == plain bit for bit in {cases} cases "
        f"({', '.join(kinds)}; 1 and 6 key columns; bounds [1, INT32_MAX], "
        "[3, 6], [2^24, 2^24]; and hashes grouped in unsigned order, "
        "positive before negative, alone and with a sample id)")
    return 0


def search_distance_flags(dev) -> torch.Tensor:
    """Runs that start mid-tile and end d rows past the tile's end, for
    every d of 2^j - 1, 2^j, 2^j + 1 (j = 0..20) and of run_end's probe
    rows 31 + (32 << l) +- 1 (l = 0..15), each in its own tiles: every
    row its own run before the long one, runs of 3 rows after it."""
    ends = sorted({d for j in range(21) for d in ((1 << j) - 1, 1 << j,
                                                 (1 << j) + 1)}
                  | {31 + (32 << l) + o for l in range(16)
                     for o in (-1, 0, 1)})
    flags = []
    for d in ends:
        start = RUN_TILE // 2 + d % 1000
        n = -(-(2 * RUN_TILE + d) // RUN_TILE) * RUN_TILE  # whole tiles
        region = torch.zeros(n, dtype=torch.bool)
        region[:start] = True
        region[RUN_TILE + d::3] = True
        flags.append(region)
    return torch.cat(flags).to(dev)


def unsigned_order_keys(gen, dev):
    """SimkaMin's key orders (minhash/device.py): int64 hashes with runs
    of 1 to 3000, sorted unsigned (``h ^ SIGN``: positive before
    negative, grouped but not ascending as signed numbers), alone and
    then by a sample id as the second column."""
    from simka_tpu_torch.minhash.device import SIGN

    distinct = torch.randint(-(1 << 62), 1 << 62, (200_000,), generator=gen,
                             device=dev) * 2
    reps = torch.randint(1, 40, (distinct.shape[0],), generator=gen,
                         device=dev)
    reps[:50] = 3000
    h = torch.repeat_interleave(distinct, reps)
    h = h[torch.randperm(h.shape[0], generator=gen, device=dev)]
    sid = torch.randint(0, 4, h.shape, generator=gen, device=dev)
    order = torch.sort(h ^ SIGN, stable=True).indices
    yield 1, (h[order],)
    order = order[torch.sort(sid[order], stable=True).indices]
    yield 2, (h[order], sid[order])


def segment_rows_of(N: int, gen, dev, n_pairs: int = 1 << 20):
    """Solid rows in (k-mer, sample) order over N samples: about
    ``n_pairs`` random (k-mer, sample) pairs made unique, k-mer 0 in
    every sample (a segment of N rows), three int64 words (k = 63),
    int32 sample ids, int32 counts up to 2^31 - 1."""
    n_kmers = max(1, n_pairs // 4)
    pairs = torch.randint(0, n_kmers * N, (n_pairs,), generator=gen,
                          device=dev)
    pairs = torch.unique(torch.cat([pairs, torch.arange(N, device=dev)]))
    kmer, sid = pairs // N, (pairs % N).to(torch.int32)
    words = (kmer >> 20, (kmer >> 10) & 1023, kmer * 0x9E3779B1 % (1 << 62))
    count = torch.randint(1, 1 << 31, (kmer.shape[0],), generator=gen,
                          device=dev, dtype=torch.int64).to(torch.int32)
    count[::3] = (count[::3] & 7) + 1
    return words, sid, count


def flag_segment_rows(flags, N: int, gen, n_words: int = 1,
                      first_only: bool = False):
    """Solid rows whose k-mers start where ``flags`` is set: int64 word
    columns (the k-mer's rank, spread over ``n_words`` columns; with
    ``first_only`` the rank in the first column alone and every later
    column one constant, so a boundary shows in the first column only),
    int32 sample ids in [0, N), int32 counts up to 2^31 - 1."""
    rank = torch.cumsum(flags.to(torch.int64), 0)
    if first_only:
        words = (rank,) + tuple(torch.full_like(rank, 0x5A5A5A5A5A)
                                for _ in range(n_words - 1))
    else:
        words = tuple((rank >> (20 * (n_words - 1 - j))) & ((1 << 20) - 1)
                      if j < n_words - 1 else rank for j in range(n_words))
    n, dev = flags.shape[0], flags.device
    sid = torch.randint(0, N, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    count = torch.randint(1, 1 << 31, (n,), generator=gen, device=dev,
                          dtype=torch.int64).to(torch.int32)
    return words, sid, count


def segment_edge_cases(gen, dev):
    """(tag, N, first-row flags, word columns, rank in the first column
    alone) of phase 15a's look-back and tile edge shapes, at
    csrc/runs.cu's own 4096-row tiles."""
    T = RUN_TILE

    def random_flags(n: int, p: float):
        f = torch.rand(n, generator=gen, device=dev) < p
        f[0] = True
        return f

    span = random_flags(12 * T + 77, 0.3)  # one k-mer from row 1000 on
    span[1000:1000 + 5 * T + 7] = False
    span[1000] = True
    ends = torch.zeros(9 * T + 5, dtype=torch.bool, device=dev)
    ends[0::T] = True
    ends[T - 1::T] = True
    yield ("a k-mer over five tiles (tiles without a boundary)", 8, span,
           1, False)
    yield "k-mers from each tile's first and last row", 8, ends, 3, False
    for n in (1, 4095, 4096, 4097):
        yield f"n = {n}", 100, random_flags(n, 0.3), 1, False
    yield ("every row its own k-mer (4096 tiles: look-backs past a window "
           "of 32)", 8, torch.ones(1 << 24, dtype=torch.bool, device=dev), 1,
           False)
    one = torch.zeros(1 << 22, dtype=torch.bool, device=dev)
    one[0] = True
    yield "one k-mer of all rows (2^22)", 8, one, 1, False
    for N in (1706, 1707):  # the last N of shared bins, the first past
        yield f"N = {N}", N, random_flags(1 << 22, 0.05), 2, False
    for n_words in (2, 3):
        yield (f"{n_words} words, the k-mer's rank in the first alone", 8,
               random_flags(1 << 22, 0.3), n_words, True)


def same_segments(tag: str, words, sid, count, N: int) -> int:
    """segment_stats on the card == its plain version bit for bit (the
    totals, starts[:nb_distinct + 1] and the scalars), twice with the
    same starts and totals. Returns the kernel's launches (2)."""
    saved = countjoin.segment_stats_launches
    bins, starts, scalars = countjoin.segment_stats(words, sid, count,
                                                    n_banks=N)
    with plain_on_card():
        want = countjoin._segment_stats_plain(words, sid, count, N)
    nb = int(scalars[0])
    if starts.shape[0] != sid.shape[0] + 1:
        raise AssertionError(f"segment_stats {tag}: starts of "
                             f"{starts.shape[0]} entries")
    same(f"segment_stats {tag}", (bins, starts[:nb + 1], scalars), want)
    again = countjoin.segment_stats(words, sid, count, n_banks=N)
    same(f"segment_stats {tag}, a repeat run",
         (again[0], again[1][:nb + 1], again[2]), want)
    return countjoin.segment_stats_launches - saved


def segment_stats_vs_plain(dev, seed: int) -> int:
    """Phase 15a, segment_stats == its plain version bit for bit (the
    three per-bank totals, the starts, nb_distinct, nb_shared, d_max,
    max_count) at every N of SEGMENT_NS (shared bins up to N = 1706,
    device-memory atomics past them; N = 20000's first segment spans
    five tiles) and at the look-back and tile edge shapes of
    ``segment_edge_cases``; a repeat run gives the same starts and
    totals."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 16)
    saved = countjoin.segment_stats_launches
    for N in SEGMENT_NS:
        words, sid, count = segment_rows_of(N, gen, dev)
        if same_segments(f"N={N}", words, sid, count, N) != 2:
            raise AssertionError("segment_stats: one launch a call expected")
    tags = []
    for tag, N, flags, n_words, first in segment_edge_cases(gen, dev):
        words, sid, count = flag_segment_rows(flags, N, gen, n_words, first)
        if same_segments(tag, words, sid, count, N) != 2:
            raise AssertionError("segment_stats: one launch a call expected")
        tags.append(tag)
        del words, sid, count, flags
    torch.cuda.synchronize()
    countjoin.segment_stats_launches = saved
    banks = _kernels.lib().simka_segment_shared_banks()
    say(f"phase 15a: segment_stats == plain bit for bit at N in "
        f"{SEGMENT_NS} (shared bins up to N = {banks}, device-memory "
        f"atomics past them) and at {'; '.join(tags)}; repeat runs "
        "identical")
    return 0


def time_extract(packed, vb, k: int) -> dict:
    """Phase 15b: the extraction kernel at a path batch (with the
    histogram, as the in-memory path calls it) == its plain version,
    both timed, beside the bound: the packed codes and validity read
    once, the words, mask and counts written once."""
    saved = kmers.launches
    got = kmers.extract_kmers(packed, vb, k, with_hist=True)
    with plain_on_card():
        want = kmers._extract_kmers_plain(kmers.unpack_codes(packed, vb), k,
                                          3, 0.0, True)
        plain_ms = time_ms(lambda: kmers._extract_kmers_plain(
            kmers.unpack_codes(packed, vb), k, 3, 0.0, True), reps=3)
    same(f"extract_kmers at the path batch, k={k}", got, want)
    E = got.keep.shape[0]
    del got, want
    ms = time_ms(lambda: kmers.extract_kmers(packed, vb, k, with_hist=True))
    kmers.launches = saved
    nbytes = (packed.numel() + vb.numel()
              + E * (8 * kmers.n_words(k) + 1) + 8 * 17)
    b_ms, b_by = bound(nbytes)
    say(f"phase 15b: extract_kmers at phase 7's batch ({packed.shape[0]} "
        f"reads x {4 * packed.shape[1]}, k={k}, {E} windows): kernel "
        f"{ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}, {100 * b_ms / ms:.1f}%)"
        f", plain {plain_ms:.4f} ms; == plain; no torch call makes "
        "canonical k-mers")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, "windows": E}


def time_run_counts(cols, amin: int, amax: int, dev) -> dict:
    """Phase 15b: run_counts on phase 7's sorted packed key == plain,
    timed beside the bound (the key read once, count and keep written
    once) and torch.unique_consecutive(return_counts=True)."""
    cols = tuple(c.to(dev) for c in cols)
    saved = countjoin.run_counts_launches
    got = countjoin.run_counts(cols, amin, amax)
    with plain_on_card():
        want = countjoin._run_counts_plain(cols, amin, amax)
        plain_ms = time_ms(lambda: countjoin._run_counts_plain(
            cols, amin, amax), reps=3)
    same("run_counts at phase 7's key", got, want)
    del got, want
    ms = time_ms(lambda: countjoin.run_counts(cols, amin, amax))
    countjoin.run_counts_launches = saved
    lib_ms = (time_ms(lambda: torch.unique_consecutive(
        cols[0], return_counts=True), reps=3) if len(cols) == 1 else None)
    E = cols[0].shape[0]
    nbytes = sum(c.element_size() for c in cols) * E + 5 * E + 8
    b_ms, b_by = bound(nbytes)
    say(f"phase 15b: run_counts at phase 7's sorted key ({E} rows, "
        f"{len(cols)} column(s), bounds [{amin}, {amax}]): kernel {ms:.4f} "
        f"ms (bound {b_ms:.4f} ms by {b_by}, {100 * b_ms / ms:.1f}%), plain "
        f"{plain_ms:.4f} ms, torch.unique_consecutive(return_counts=True) "
        f"{fmt(lib_ms)}; == plain")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms, "rows": E}


def time_segment_stats(held, dev, at: str) -> dict:
    """Phase 15b: segment_stats on a path's solid rows == plain, timed
    beside the bound (words, sample id and count read once, the starts
    and the totals written once), on the device (``stream_ms``), the
    whole chain from
    the rows to (starts, seg_len) as ``_raw_stats_from_rows`` runs it
    (``countjoin._segments``: the pass, the one host read, the starts
    copied out, the subtraction), the plain version
    and its three index_add_ totals alone (the part of the plain version
    they are)."""
    words, sid, count, N = held
    sid, count = sid.to(dev), count.to(dev)
    words = tuple(w.to(dev) for w in words)
    saved = countjoin.segment_stats_launches
    got = countjoin.segment_stats(words, sid, count, n_banks=N)
    with plain_on_card():
        want = countjoin._segment_stats_plain(words, sid, count, N)
        plain_ms = time_ms(lambda: countjoin._segment_stats_plain(
            words, sid, count, N), reps=3)
    nb = int(got[2][0])
    same(f"segment_stats at {at} (N={N})", (got[0], got[1][:nb + 1],
                                            got[2]), want)
    del got, want
    ms = time_ms(lambda: countjoin.segment_stats(words, sid, count,
                                                 n_banks=N))
    dev_ms = stream_ms(lambda: countjoin.segment_stats(words, sid, count,
                                                      n_banks=N))

    chain_ms = time_ms(lambda: countjoin._segments(words, sid, count, N))
    countjoin.segment_stats_launches = saved
    s64, c64 = sid.to(torch.int64), count.to(torch.int64)

    def totals():
        bins = torch.zeros((3, N), dtype=torch.int64, device=dev)
        for row, v in zip(bins, (torch.ones_like(c64), c64, c64 * c64)):
            row.index_add_(0, s64, v)

    add_ms = time_ms(totals, reps=3)
    n = sid.shape[0]
    nbytes = (n * (8 * len(words) + sid.element_size() + count.element_size())
              + 8 * (nb + 1) + 3 * 8 * N + 32)
    b_ms, b_by = bound(nbytes)
    say(f"phase 15b: segment_stats at {at} ({n} rows, {nb} k-mers, N={N}, "
        f"{len(words)} word(s), sample id int{8 * sid.element_size()}, "
        f"count int{8 * count.element_size()}): kernel {ms:.4f} ms around "
        f"the call, {dev_ms:.4f} ms on the device (events around "
        f"back-to-back calls; bound {b_ms:.4f} ms by {b_by}, "
        f"{100 * b_ms / ms:.1f}% around the call, "
        f"{100 * b_ms / dev_ms:.1f}% on the device); rows to (starts, "
        f"seg_len) {chain_ms:.4f} ms; plain {plain_ms:.4f} ms of which the "
        f"three index_add_ totals {add_ms:.4f} ms "
        f"({100 * add_ms / plain_ms:.1f}%); == plain; no torch call "
        "computes the per-bank totals and the segments")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, "device_ms": dev_ms,
            "chain_ms": chain_ms, "index_add_ms": add_ms, "rows": n,
            "segments": nb}


# the cell cami_high.default_dist's packed keys a job (benchmark/, 5
# samples of 760,000 150-bp reads; ledger)
CELL_SORT_KEYS, CELL_SORT_BANKS = 484_000_000, 5


def sort_design_bytes(E: int, bits: int, sid_bytes: int) -> int:
    """What csrc/sort.cu moves: the histogram's read of the words and
    sample ids, the first pass's read of them and write of the keys, 16
    B a key each later pass, and the status words (1 KB a tile, zeroed
    once and written and read by each pass, counted once a pass)."""
    passes = len(sort.radix_passes(bits))
    tiles = -(-E // _kernels.lib().simka_sort_tile_keys())
    return (E * (2 * (8 + sid_bytes) + 8 + 16 * (passes - 1))
            + tiles * 1024 * (passes + 1))


def time_sort(word, sid, sbits: int, bits: int, at: str) -> dict:
    """Phase 15b: the packed sort (``ops.sort.sort_packed_keys``) ==
    ``torch.sort((word << sbits) | sid).values``, bit for bit, timed
    around the call and on the device (``stream_ms``), beside the
    yardstick's bound (16 B a key: benchmark/yardstick.py::sort_bytes),
    the design's (``sort_design_bytes``) and the library call. The plain
    version is that library call (on a CPU tensor the wrapper runs it),
    so ``plain_ms`` is ``library_ms``; the port never calls it on CUDA."""
    E = word.shape[0]
    saved = sort.sort_launches

    def library():
        return torch.sort((word << sbits) | sid.to(torch.int64)).values

    got = sort.sort_packed_keys(word, sid, sbits, bits)
    if not torch.equal(got, library()):
        raise AssertionError(f"sort_packed_keys at {at} differs from "
                             "torch.sort")
    del got
    torch.cuda.empty_cache()
    ms = time_ms(lambda: sort.sort_packed_keys(word, sid, sbits, bits))
    dev_ms = stream_ms(lambda: sort.sort_packed_keys(word, sid, sbits, bits))
    sort.sort_launches = saved
    lib_ms = time_ms(library, reps=5)
    b_ms, b_by = bound(16 * E)
    d_ms, _ = bound(sort_design_bytes(E, bits, sid.element_size()))
    say(f"phase 15b: sort_packed_keys at {at} ({E} keys, {bits} bits, "
        f"{len(sort.radix_passes(bits))} passes, sample id "
        f"int{8 * sid.element_size()}): kernel {ms:.4f} ms around the call, "
        f"{dev_ms:.4f} ms on the device (the yardstick's bound {b_ms:.4f} ms "
        f"by {b_by}, {100 * b_ms / dev_ms:.1f}% on the device; the design's "
        f"{d_ms:.4f} ms, {100 * d_ms / dev_ms:.1f}%); torch.sort(...).values "
        f"{lib_ms:.4f} ms (the plain version); == torch.sort")
    return {"ms": ms, "plain_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms, "device_ms": dev_ms,
            "design_bound_ms": d_ms, "keys": E, "bits": bits}


def sort_at_path_shapes(dev, seed: int, runs) -> dict:
    """Phase 15b's sort: at phase 7's keys (run_counts' sorted key of its
    default run, ``runs``, split back into words and sample ids and put
    in a seeded random order) and at the cell's ~484 M seed-made keys
    (42-bit words, 5 samples)."""
    from simka_tpu_torch.utils.community import FULL_COMMUNITY

    (key,), _, _ = runs
    sbits = countjoin._sbits(FULL_COMMUNITY["n_samples"])
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    key = key.to(dev)[torch.randperm(key.shape[0], generator=g, device=dev)]
    word, sid = key >> sbits, (key & ((1 << sbits) - 1)).to(torch.int32)
    del key
    res = time_sort(word, sid, sbits, 42 + sbits, "phase 7's keys")
    del word, sid
    torch.cuda.empty_cache()
    sbits = countjoin._sbits(CELL_SORT_BANKS)
    word = torch.randint(0, 1 << 42, (CELL_SORT_KEYS,), generator=g,
                         device=dev)
    sid = torch.randint(0, CELL_SORT_BANKS, (CELL_SORT_KEYS,), generator=g,
                        device=dev, dtype=torch.int32)
    cell = time_sort(word, sid, sbits, 42 + sbits,
                     "the cell's shape, seed-made")
    res.update((f"cell_{k}", v) for k, v in cell.items()
               if k not in ("bound_by", "plain_ms"))
    del word, sid
    torch.cuda.empty_cache()
    return res


def kernels_phase(dev, seed: int, inputs: KernelInputs,
                  segment_rows) -> dict:
    """Phase 15; returns the three kernels' numbers for their records."""
    t0 = time.perf_counter()
    err = (extract_vs_plain(dev, seed) + run_counts_vs_plain(dev, seed)
           + segment_stats_vs_plain(dev, seed))
    torch.cuda.empty_cache()
    packed, vb, _ = inputs.extract
    res = {"max_abs_err": err,
           "extract": time_extract(packed, vb, 21),
           "extract_63": time_extract(packed, vb, 63)}
    cols, amin, amax = inputs.runs
    res["run_counts"] = time_run_counts(cols, amin, amax, dev)
    torch.cuda.empty_cache()
    res["segment_stats"] = time_segment_stats(segment_rows, dev,
                                              "phase 14's solid rows")
    torch.cuda.empty_cache()
    res["segment_stats"].update(
        (f"n8_{k}", v) for k, v in time_segment_stats(
            inputs.segments, dev, "phase 7's solid rows").items()
        if k not in ("bound_by", "library_ms"))
    torch.cuda.empty_cache()
    res["sort"] = sort_at_path_shapes(dev, seed, inputs.runs)
    say(f"phase 15: {time.perf_counter() - t0:.1f} s")
    return res


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
    h2d = h2d_line(dev, args.seed)
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
            shard_recs = shards_in_memory(
                tmp, inp8, yardsticks,
                paths["all distances k=21"]["instances"], rec, dev)
            coordinator_runs(tmp, inp8, yardsticks)
            coord_shards = coordinator_shards(tmp, inp8, yardsticks, rec,
                                              dev)
            wide_n = wide_n_phase(tmp, args.seed, rec, dev)
            hand = kernels_phase(dev, args.seed,
                                 paths["default k=21"].pop("inputs"),
                                 wide_n.pop("segment_rows"))
            m_err = murmur_vs_plain(dev, args.seed)
            small_sketch_gpu_vs_cpu(tmp, args.seed)
            rec.check_totals()
            sketch_main = sketch_full_size(tmp, inp8, rec, dev)
            filter_past_threshold(tmp, inp8, rec, dev)
            murmur_batch, murmur_2e24, prefilter = sketch_shapes(
                inp8, dev, args.seed)
            p_err, wide = pair_vs_plain(dev, args.seed)
            small_min_distance_gpu_vs_cpu(tmp, args.seed)
            rec.check_totals()
            pipe_main, pipe_times = min_pipeline_full_size(tmp, inp8, inp9,
                                                           rec, dev)
    main_run = paths["default k=21"]
    c_err, join, extract, spectra, ranged, split = compaction_at_path_shapes(
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
        **{f"launches_shards_{n}": r["launches"]
           for n, r in shard_recs.items()},
        "launches_coordinator_shards_2": coord_shards["launches"],
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
        **{f"shard_split_{n}_{k}": split[n][k] for n in split
           for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
        "launches_sketch": sketch_main["launches"],
        **{f"sketch_prefilter_{k}": prefilter[k] for k in (
            "ms", "plain_ms", "bound_ms", "library_ms", "fill_ms",
            "plain_fill_ms", "fill_bound_ms")},
    }, {
        "name": "murmur_kmers",
        "route": "cuda",
        "source": "simka_tpu_torch/csrc/minhash.cu",
        "replaces": MURMUR_REPLACES,
        "launches": sketch_main["murmur_launches"],
        "max_abs_err": m_err,
        **{k: murmur_batch[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms",
                                        "device_ms")},
        **{f"{k}_2e24": murmur_2e24[k] for k in ("ms", "plain_ms",
                                                 "bound_ms", "bound_by",
                                                 "device_ms")},
    }, {
        "name": "min_pair_distance",
        "route": "cuda",
        "source": "simka_tpu_torch/csrc/min_distance.cu",
        "replaces": PAIR_REPLACES,
        "launches": pipe_main["pair_launches"],
        "max_abs_err": p_err,
        **{k: pipe_times[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms",
                                      "device_ms")},
        "l2_floor_ms": pipe_times["l2_floor_ms"],
        **{f"wide_{k}": wide[k] for k in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "device_ms",
                                          "l2_floor_ms")},
    }]
    kernels.append({
        "name": "pair_sums",
        "route": "cuda",
        "source": "simka_tpu_torch/csrc/pair_sums.cu",
        "replaces": PAIR_SUMS_REPLACES,
        "launches": main_run["pair_launches"],
        "launches_wide_n": wide_n["run"]["pair_launches"],
        "launches_out_tmp": out_tmp_run["pair_launches"],
        "launches_sweep": sweep_run["pair_launches"],
        **{f"launches_shards_{n}": r["pair_launches"]
           for n, r in shard_recs.items()},
        "launches_coordinator_shards_2": coord_shards["pair_launches"],
        "max_abs_err": wide_n["max_abs_err"],
        # at the N = 100 run's own rows; all_*: every channel with
        # whittaker_all, all_wall_plain_ms _whittaker_all's torch ops
        **{k: wide_n[k] for k in ("ms", "plain_ms", "bound_ms",
                                  "bound_by")},
        "library_ms": None,  # no torch call computes the pair sums
        # launches per join at N = 100 with every distance (14b)
        "launches_wide_n_all": wide_n["run_all"]["pair_launches"],
        **{k: wide_n[k] for k in ("plain_rows", "plan", "all_ms",
                                  "all_plain_ms", "all_plain_rows",
                                  "all_bound_ms", "all_bound_by",
                                  "all_plan", "all_wall_plain_ms",
                                  "global_ms", "all_global_ms", "rows",
                                  "segments", "d_max", "pairs",
                                  "sample_counts")},
        # at phase 7's own rows (N = 8, the main path)
        **{f"n8_{k}": main_run["n8"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "all_ms",
            "all_plain_ms", "all_bound_ms", "all_bound_by",
            "all_wall_plain_ms", "rows", "segments", "d_max", "pairs",
            "sample_counts")},
    })
    times = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    later_runs = {
        "launches_wide_n": "run", "launches_out_tmp": out_tmp_run,
        "launches_sweep": sweep_run,
        **{f"launches_shards_{n}": r for n, r in shard_recs.items()},
        "launches_coordinator_shards_2": coord_shards}
    for name, src, replaces, key, at in (
            ("extract_kmers", "kmers.cu", EXTRACT_REPLACES,
             "extract_launches", "extract"),
            ("run_counts", "runs.cu", RUN_COUNTS_REPLACES,
             "run_counts_launches", "run_counts"),
            ("segment_stats", "runs.cu", SEGMENT_REPLACES,
             "segment_launches", "segment_stats"),
            ("sort_packed_keys", "sort.cu", SORT_REPLACES, "sort_launches",
             "sort")):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"simka_tpu_torch/csrc/{src}",
            "replaces": replaces,
            # phase 7's default run; then phase 14b's default run and the
            # runs of the compaction's launches_* keys
            "launches": main_run[key],
            **{lk: (wide_n["run"] if r == "run" else r)[key]
               for lk, r in later_runs.items()},
            "max_abs_err": hand["max_abs_err"],
            # at phase 7's batch (extraction, k=21) and sorted key (run
            # counts), at phase 14's solid rows (the segment pass), at
            # phase 7's keys (the sort; cell_*: the cell's ~484 M keys)
            **{k: hand[at][k] for k in times},
            **{k: v for k, v in hand[at].items() if k not in times},
            **({f"k63_{k}": hand["extract_63"][k] for k in times}
               if at == "extract" else {}),
        })
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
    for name, rec in probe["kernels"].items():
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "simka_tpu_torch/csrc/probes.cu",
            "replaces": PROBE_KERNEL_RECORDS[name],
            **rec,
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
            **{k: v for k, v in g.items() if k.startswith("max_pred_")},
        })
    say(f"chip_smoke: all phases passed in "
        f"{time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels, "h2d": h2d}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
