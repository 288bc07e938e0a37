"""Out-of-core execution: a sweep over k-mer hash ranges on one device,
or over hash shards.

The torch counterpart of ``simka_tpu.core.sweep``. The reference's disk
architecture exists so that N samples whose k-mers far exceed memory
still run: counting spills partition files (src/SimkaPotara.hpp:713-723),
each partition is merged on its own, and the per-partition statistics
are folded with operator+= (src/SimkaPotara.hpp:1152-1187,
src/SimkaMerge.cpp:638-823).

Here the k-mer hash space is split into R ranges. Every sample's
spectrum rows are spilled per range; one device then joins the ranges
one after another and folds the statistics. Ranges partition the
k-mers, so every reduction is disjoint and the folded statistics equal
one in-memory join bit for bit, given two things: the Whittaker and
Kullback-Leibler terms read whole-sample solid totals, computed at
spill time and given to every range (``solid_override``); and the fold
adds the raw stats (chord as its int64 sum, KL as its fixed-point
limbs, ``parallel.sharded.raw_sharded_join_from_spectra``) and
converts them once, so no range rounds.

Three spill tiers, one interface (``spill_parts``, or ``spill_sample``
for the device tier and for host rows on disk; ``load_range``, and on
the host tiers ``host_range``; ``cleanup``):
  - ``DeviceSpill``: the spectra stay on the device; each range is
    extracted from their concatenation by the stable compaction;
  - ``RamSpill``: host memory, per range (runs without -out-tmp whose
    spectra would crowd the device);
  - ``SpectrumSpill``: ``<tmp>/sweep/s{sample}_r{r}.npz``, the
    reference's files (runs with -out-tmp).
The host tiers hold ``simka_tpu``'s uint32 words and ship a range as
the port's int64 words (``ops.spectrum.words_from_host``). Every
spectrum is cut per range on the device before its copy to the host
(``partition_on_device``); a spectrum already on the host (a
checkpoint's) is shipped there first. A k-mer's range is ``_range_of``
its uint32 words in both packages (``range_ids`` on the device), so
both cut the same input into the same ranges.

With shards (``parallel.sharded``), each range's rows are routed over
the shards by the shard hash and joined per shard with the whole
samples' totals, the sweep composed with the device list as
``simka_tpu``'s is with its mesh (``simka_tpu/core/sweep.py:363-412``):
on the run's device when every shard is there (``shard_rows_by_hash``),
else staged from the host in chunks (``stage_rows_by_hash``), so that
each device holds only its own shards' rows and a range may hold
every device's plan. The salted second mix of the
range id keeps the range and the shard of a k-mer independent.
"""

from __future__ import annotations

import os
import shutil
from typing import Sequence, Tuple

import numpy as np
import torch

from simka_tpu_torch.ops.countjoin import JoinStats
from simka_tpu_torch.utils.metrics import span
from simka_tpu_torch.ops.kmers import mix_hash_np

# the second mix decorrelates the range id from the shard id (the same
# chained mix % n_shards in simka_tpu's mesh)
RANGE_SALT = 0x27D4EB2F

Rows = Tuple[Tuple[torch.Tensor, ...], torch.Tensor, torch.Tensor]


def _range_of(words32: Sequence[np.ndarray], n_ranges: int) -> np.ndarray:
    """Hash range of each row of ``simka_tpu``'s uint32 words
    (``simka_tpu.core.sweep._range_of``), in the smallest unsigned
    dtype that holds ``n_ranges - 1``. The host oracle of
    ``range_ids``."""
    h = words32[0]
    for w in words32[1:]:
        h = mix_hash_np(h, w)
    h = mix_hash_np(h, np.uint32(RANGE_SALT))
    return (h % np.uint32(n_ranges)).astype(np.min_scalar_type(n_ranges - 1))


def range_ids(words: Sequence[torch.Tensor], k: int,
              n_ranges: int) -> torch.Tensor:
    """``_range_of`` on the device, from the port's int64 words: the
    same chain of mixes over the reference's uint32 words, as int16
    (int32 past 2^15 ranges)."""
    from simka_tpu_torch.ops.kmers import (
        mix_hash,
        mix_hash_words,
        uint32_words,
    )

    h = mix_hash(mix_hash_words(uint32_words(tuple(words), k)), RANGE_SALT)
    return (h % n_ranges).to(torch.int16 if n_ranges <= 1 << 15
                             else torch.int32)


def partition_on_device(words, counts, k: int, n_ranges: int):
    """One sample's spectrum on its device (the port's words, int32
    counts) cut per range: the range ids, a stable sort of them and the
    gather there, then one copy to the host in the checkpoint layout
    (``ops.spectrum.to_host``). Returns [(words32, counts)] of every
    range (views), in row order within each. At 20 M rows the same cut
    on the host (hash, radix argsort, gather) took 1.0-1.6 s (PERF.md,
    PR 5)."""
    from simka_tpu_torch.ops.spectrum import to_host

    rid = range_ids(words, k, n_ranges)
    order = torch.sort(rid, stable=True).indices
    bounds = [0] + torch.bincount(rid, minlength=n_ranges).cumsum(0).tolist()
    words32, counts = to_host(
        (tuple(w[order] for w in words), counts[order]), k)
    return [(tuple(w[a:b] for w in words32), counts[a:b])
            for a, b in zip(bounds[:-1], bounds[1:])]


def host_rows(parts, k: int):
    """Per-sample host rows (``[(words32, counts)]``, in sample order) as
    one ``ops.spectrum.HostRows``: the uint32 words, int32 sample ids
    and counts, concatenated. Empty samples are skipped: their word
    count may differ (a ``simka_tpu`` checkpoint of an empty sample,
    ROADMAP section 3)."""
    from simka_tpu_torch.ops.kmers import n_uint32_words

    live = [(s, w, c) for s, (w, c) in enumerate(parts) if len(c)]

    def column(arrays, dtype):
        return np.concatenate(arrays) if arrays else np.empty(0, dtype)

    return (
        tuple(column([w[i] for _, w, _ in live], np.uint32)
              for i in range(n_uint32_words(k))),
        column([np.full(len(c), s, np.int32) for s, _, c in live], np.int32),
        column([c.astype(np.int32) for _, _, c in live], np.int32),
    )


class _HostSpill:
    """What the host tiers share: a range shipped to their device from
    its host rows (``host_range``)."""

    def load_range(self, r: int, n_samples: int) -> Rows:
        from simka_tpu_torch.ops.spectrum import rows_from_host

        return rows_from_host(self.host_range(r, n_samples), self.k,
                              self.device)


class SpectrumSpill(_HostSpill):
    """Disk store of per-(sample, hash range) spectrum rows:
    ``<tmp_dir>/sweep/s{sample}_r{r}.npz`` with keys ``w0..`` (uint32
    words) and ``counts``, the reference's files (the role of its
    ``solid/part_<p>/__p__<bank>.gz``, src/SimkaCount.cpp:248-257).
    ``spans`` (``utils.metrics.Spans``, or None) times each sample's cut
    on the device (``simka.sweep.partition``) and its file writes
    (``simka.sweep.write``)."""

    def __init__(self, tmp_dir: str, n_ranges: int, k: int,
                 device: torch.device, spans=None):
        self.dir = os.path.join(tmp_dir, "sweep")
        self.n_ranges, self.k, self.device = n_ranges, k, device
        self.spans = spans
        os.makedirs(self.dir, exist_ok=True)

    def _path(self, sample: int, r: int) -> str:
        return os.path.join(self.dir, f"s{sample}_r{r}.npz")

    def spill_sample(self, sample: int, words32, counts) -> None:
        """One sample's host spectrum in the checkpoint layout (uint32
        words, counts), shipped to the device and cut there."""
        from simka_tpu_torch.ops.kmers import n_uint32_words
        from simka_tpu_torch.ops.spectrum import words_from_host

        with span("simka.sweep.partition", self.spans):
            if len(counts):
                parts = partition_on_device(
                    words_from_host(list(words32), self.k, self.device),
                    torch.from_numpy(counts.astype(np.int32)).to(
                        self.device),
                    self.k, self.n_ranges)
            else:  # a simka_tpu checkpoint's may have another word count
                empty = np.empty(0, np.uint32)
                parts = [((empty,) * n_uint32_words(self.k),
                          np.empty(0, np.int64))] * self.n_ranges
        self.spill_parts(sample, parts)

    def spill_parts(self, sample: int, parts) -> None:
        """One sample's rows already cut per range
        (``partition_on_device``)."""
        with span("simka.sweep.write", self.spans):
            for r, (words, c) in enumerate(parts):
                np.savez(self._path(sample, r),
                         **{f"w{i}": w for i, w in enumerate(words)},
                         counts=c)

    def host_range(self, r: int, n_samples: int):
        """Range ``r``'s rows of every sample on the host (``host_rows``)."""
        parts = []
        for s in range(n_samples):
            with np.load(self._path(s, r)) as z:
                nw = sum(name.startswith("w") for name in z.files)
                parts.append((tuple(z[f"w{i}"] for i in range(nw)),
                              z["counts"]))
        return host_rows(parts, self.k)

    def cleanup(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)


class RamSpill(_HostSpill):
    """Host-memory form of ``SpectrumSpill`` for runs without -out-tmp:
    what the sweep defends is device memory, which the join's working
    set outgrows long before the spectra outgrow host memory. Its rows
    come from the device already cut (``partition_on_device``)."""

    def __init__(self, n_ranges: int, k: int, device: torch.device):
        self.n_ranges, self.k, self.device = n_ranges, k, device
        self._store = {}

    def spill_parts(self, sample: int, parts) -> None:
        """One sample's rows already cut per range
        (``partition_on_device``)."""
        for r, part in enumerate(parts):
            self._store[(sample, r)] = part

    def host_range(self, r: int, n_samples: int):
        """Range ``r``'s rows of every sample on the host (``host_rows``)."""
        return host_rows([self._store[(s, r)] for s in range(n_samples)],
                         self.k)

    def cleanup(self) -> None:
        self._store.clear()


def range_extract(words, sid, counts, rid, r: int, n: int) -> Rows:
    """Range ``r``'s rows of the resident concatenation
    (``_range_extract``): the stable compaction, in its exact-length
    form, of (words..., sid, counts) on ``rid == r``; ``n`` is the
    range's row count."""
    from simka_tpu_torch.ops.compact import compact_rows

    nw = len(words)
    cols = compact_rows((*words, sid, counts), rid == r,
                        fills=(-1,) * nw + (0, 0), n=n)
    return cols[:nw], cols[nw], cols[nw + 1]


class DeviceSpill:
    """The device tier: every sample's spectrum stays on the device at
    its exact length. ``spill_sample`` takes the port's words and int32
    counts on the device and computes each row's range id there once
    (``range_ids``). The first ``load_range`` concatenates the samples
    column by column, dropping each sample's tensors as its column
    joins, adds each row's sample id from the samples' start offsets and
    reads the rows per range once; each range is then one
    ``range_extract``. Nothing is hashed again per range: the range id
    costs 2 bytes a row (4 past 2^15 ranges), the sample id 4."""

    def __init__(self, n_ranges: int, k: int):
        self.n_ranges, self.k = n_ranges, k
        self._samples = {}
        self._concat = None

    def spill_sample(self, sample: int, words, counts) -> None:
        if self._concat is not None:
            # the per-sample tensors are gone once the concatenation
            # exists; the sweep is strictly spill, then load
            raise RuntimeError("DeviceSpill: spill_sample after load_range")
        self._samples[sample] = [*words, counts.to(torch.int32),
                                 range_ids(words, self.k, self.n_ranges)]

    def _ensure_concat(self, n_samples: int):
        if self._concat is None:
            samples = [self._samples.pop(s) for s in range(n_samples)]
            lengths = [cols[-1].shape[0] for cols in samples]
            cols = []
            for i in range(len(samples[0])):
                cols.append(torch.cat([c[i] for c in samples]))
                for c in samples:
                    c[i] = None
            *words, counts, rid = cols
            # one fill a sample (torch.repeat_interleave gives each
            # sample's whole run to one thread: 23 ms at 157 M rows on
            # an H100, PERF.md)
            sid = torch.cat([
                torch.full((n,), s, dtype=torch.int32, device=rid.device)
                for s, n in enumerate(lengths)
            ])
            per_range = torch.bincount(rid, minlength=self.n_ranges).tolist()
            self._concat = (tuple(words), sid, counts, rid, per_range)
        return self._concat

    def load_range(self, r: int, n_samples: int) -> Rows:
        words, sid, counts, rid, per_range = self._ensure_concat(n_samples)
        return range_extract(words, sid, counts, rid, r, per_range[r])

    def cleanup(self) -> None:
        self._samples.clear()
        self._concat = None


def sweep_join_stats(
    spill,
    n_samples: int,
    abundance_min: int,
    abundance_max: int,
    global_solid: np.ndarray,
    *,
    k: int,
    device: torch.device,
    simple: bool = False,
    complex_: bool = False,
    log=lambda msg: None,
    spans=None,
    shards=None,
) -> JoinStats:
    """Join every hash range in turn and fold the statistics
    (``simka_tpu.core.sweep.sweep_join_stats``) over the hash shards
    on the device list ``shards`` (default ``[device]``: one device).
    With every shard on ``device``, each range is loaded there and
    routed there (``shard_rows_by_hash``; one shard takes it
    untouched). Otherwise (a host tier: the device tier needs every
    shard on ``device``) each range is staged over the shards from the
    host in chunks (``stage_rows_by_hash``), so a range may hold every
    device's plan.

    ``global_solid``: the whole samples' post-filter solid totals
    (``filtered_solid_per_bank``), which every range's Whittaker and KL
    terms read (SimkaDistance.cpp:114-152). Returns ``JoinStats`` on
    ``device``. ``spans`` (``utils.metrics.Spans``, or None) times
    each range's load (``simka.sweep.load``: its rows loaded or
    extracted, and on the device; staged, routing included) and join
    (``simka.sweep.join``).
    """
    from simka_tpu_torch.ops.countjoin import _add_raw, _finish
    from simka_tpu_torch.parallel.sharded import (
        raw_sharded_join_from_spectra,
        shard_rows_by_hash,
        stage_rows_by_hash,
    )

    K = torch.as_tensor(np.asarray(global_solid, np.int64)).to(device)
    shards = shards or [device]
    resident = all(d == device for d in shards)
    total = None
    for r in range(spill.n_ranges):
        with span("simka.sweep.load", spans):
            if resident:
                words, sid, counts = spill.load_range(r, n_samples)
                rows = sid.shape[0]
            else:
                parts = stage_rows_by_hash(spill.host_range(r, n_samples),
                                           k, shards, device)
                rows = sum(p[1].shape[0] for p in parts)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        with span("simka.sweep.join", spans):
            if resident:
                parts = shard_rows_by_hash(words, sid, counts, k, shards)
                del words, sid, counts
            raw = raw_sharded_join_from_spectra(
                parts, abundance_min, abundance_max, K, n_banks=n_samples,
                kmer_bits=2 * k, simple=simple, complex_=complex_)
            del parts
            raw = JoinStats(*(t.to(device) for t in raw))
            total = raw if total is None else _add_raw(total, raw)
        log(f"sweep range {r + 1}/{spill.n_ranges}: {rows} rows joined")
    return _finish(total, complex_)


def filtered_solid_per_bank(
    counts_per_sample: Sequence[np.ndarray],
    abundance_min: int,
    abundance_max: int,
) -> np.ndarray:
    """Whole-space per-bank solid totals under the count-time abundance
    filter (MiniKC.hpp:56) -- exactly what the reference's merge reads
    from the count_synchro .ok metadata."""
    out = np.zeros(len(counts_per_sample), np.int64)
    for s, c in enumerate(counts_per_sample):
        c = np.asarray(c, np.int64)
        keep = (c >= abundance_min) & (c <= abundance_max)
        out[s] = int(c[keep].sum())
    return out


def choose_n_ranges(
    total_rows: int,
    n_words: int,
    max_memory_mb: int,
    requested: int = 0,
) -> int:
    """Number of hash ranges so one range's join working set fits the
    memory budget (the role of the reference's ConfigurationAlgorithm
    partition-count estimate, SimkaPotara.hpp:617-713).

    The fused join holds roughly 8x the row payload (sort buffers,
    panels, one-hot operands), so budget_rows = budget / (row_bytes*8).
    """
    if requested:
        return max(1, requested)
    row_bytes = 4 * (n_words + 2)
    budget = max(max_memory_mb, 1) * 1_000_000
    budget_rows = max(budget // (row_bytes * 8), 1)
    return max(1, -(-int(total_rows) // int(budget_rows)))
