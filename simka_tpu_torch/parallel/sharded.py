"""Hash-space shards over a list of devices, in one process.

The torch counterpart of ``simka_tpu.parallel.sharded``. Each shard owns
the k-mers whose hash (``mix_hash`` chained over ``simka_tpu``'s
uint32 words, modulo the shard count) is its index, so every instance
of a k-mer lands on one shard and each shard's join is exact on its
own. The reference runs the shards as one program over a device mesh
and reduces the statistics with a ``psum``; here a shard is an entry of
an explicit device list, its join runs on that device, and the psum is
the fold of raw statistics (``ops.countjoin._add_raw``, then
``_finish`` once): every ``JoinStats`` field is additive over disjoint
k-mer sets, ``max_count`` a max.

One order matters. The Whittaker and Kullback-Leibler terms read the
per-bank solid totals of the WHOLE k-mer space, so every shard first
takes its solid rows, the totals of all shards are summed, and only
then does each shard compute its pair terms with those totals
(``solid_override``), as the reference's psum does before its pair
terms consume the totals (``simka_tpu/parallel/sharded.py:149-163``).

The device list may repeat a device: ``[cpu] * n`` is how the tests
run the sharded code (the reference's virtual CPU mesh), ``[cuda:0] *
n`` how one card does. Lengths are exact: a shard's rows are the
stable compaction (``ops.compact``) of its own rows in the exact-length
form, so there is no padding class, no routing capacity and no
overflow fallback (the reference's static-shape workarounds).
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import torch

from simka_tpu_torch.ops.countjoin import JoinStats

Rows = Tuple[Tuple[torch.Tensor, ...], torch.Tensor, torch.Tensor]


def shard_devices(n_shards: int, device: torch.device) -> List[torch.device]:
    """The devices of ``n_shards`` hash shards on ``device``'s kind, by
    the reference's rule (``make_mesh``, ``compute_statistics``):
    ``n = n_shards or`` the number of devices; sharded only when n > 1
    and at least n devices exist, else ``[device]`` (one device). CUDA
    shards are the first n cards; CPU shards are n copies of the CPU
    (``n_shards`` 0: one)."""
    if device.type == "cpu":
        return [device] * max(n_shards, 1)
    count = torch.cuda.device_count()
    n = n_shards or count
    if n > 1 and count >= n:
        return [torch.device("cuda", i) for i in range(n)]
    return [device]


def check_shards(devices: Sequence, device: torch.device) -> List[torch.device]:
    """``devices`` as torch devices, each of ``device``'s kind (a run
    asked for on the card never puts a shard on the CPU); ValueError
    otherwise."""
    out = [torch.device(d) for d in devices]
    if not out or any(d.type != device.type for d in out):
        raise ValueError(f"shard devices {[str(d) for d in out]} are not all "
                         f"of the run's device type {device.type!r}")
    return out


def shard_ids(words: Sequence[torch.Tensor], k: int,
              n_shards: int) -> torch.Tensor:
    """Each k-mer's shard, int64: ``mix_hash`` chained over
    ``simka_tpu``'s uint32 words, mod ``n_shards`` (``simka_tpu``'s
    ``shard_instances_by_hash``, ``sharded.py:84-89``), so that every
    k-mer lands on the same shard in both packages."""
    from simka_tpu_torch.ops.kmers import mix_hash_words, uint32_words

    return mix_hash_words(uint32_words(tuple(words), k)) % n_shards


def split_rows(cols: Sequence[torch.Tensor], dest: torch.Tensor, n: int,
               only: Optional[Sequence[int]] = None) -> list:
    """The rows of ``cols`` (int32 or int64 columns on one device) for
    each destination in [0, n) (or those in ``only``), in row order:
    the stable compaction in its exact-length form, one launch a
    destination, after one read of the destinations' sizes. One
    destination takes ``cols`` untouched."""
    from simka_tpu_torch.ops.compact import compact_rows

    cols = tuple(cols)
    if n == 1:
        return [cols]
    sizes = torch.bincount(dest, minlength=n).tolist()
    fills = (0,) * len(cols)
    return [compact_rows(cols, dest == i, fills, n=sizes[i])
            for i in (range(n) if only is None else only)]


def _by_hash(cols, words, k: int, n: int) -> list:
    """``split_rows`` of ``cols`` by the shard of ``words``; one shard
    takes the rows untouched, with no hash and no read of sizes."""
    if n == 1:
        return [tuple(cols)]
    return split_rows(cols, shard_ids(words, k, n), n)


def shard_instances_by_hash(words: Sequence[torch.Tensor], sid: torch.Tensor,
                            k: int, devices: Sequence[torch.device]) -> list:
    """Instances (the port's int64 words, int32 sample ids, on one
    device) routed to their shards (``simka_tpu``'s
    ``shard_instances_by_hash``): one (words, sid) entry a shard, on
    its device, in exact-length columns."""
    nw = len(words)
    parts = _by_hash((*words, sid), words, k, len(devices))
    return [(tuple(c.to(d) for c in p[:nw]), p[nw].to(d))
            for p, d in zip(parts, devices)]


def shard_rows_by_hash(words: Sequence[torch.Tensor], sid: torch.Tensor,
                       counts: torch.Tensor, k: int,
                       devices: Sequence[torch.device]) -> List[Rows]:
    """Spectrum rows routed to their shards by the hash of the k-mer
    alone, the counts riding along (``simka_tpu``'s
    ``shard_rows_by_hash``): one (words, sid, counts) entry a shard.
    The rows are split on their own device, which so holds them and
    every shard's part at once (``stage_rows_by_hash`` bounds that by
    chunks)."""
    nw = len(words)
    parts = _by_hash((*words, sid, counts), words, k, len(devices))
    return [(tuple(c.to(d) for c in p[:nw]), p[nw].to(d), p[nw + 1].to(d))
            for p, d in zip(parts, devices)]


def stage_rows_by_hash(rows, k: int, devices: Sequence[torch.device],
                       device: torch.device) -> List[Rows]:
    """Spectrum rows on the host (``ops.spectrum.HostRows``) routed to
    the shards on ``devices`` through ``device``, as
    ``shard_rows_by_hash`` splits them there. With every shard on
    ``device``, the rows are shipped and split at once. Otherwise they
    go in chunks of one device's spectrum plan
    (``core.budget.spectrum_rows_budget``): each chunk is shipped to
    ``device`` and split there, its parts move to their shards, and
    each shard's parts are concatenated on its device. So no device
    holds more than its own shards' rows and one chunk with its parts,
    and a shard list plans with every device's memory
    (``simka_tpu`` routes these rows on the host,
    ``simka_tpu/core/sweep.py:396-412``)."""
    from simka_tpu_torch.core.budget import spectrum_rows_budget
    from simka_tpu_torch.ops.kmers import n_words
    from simka_tpu_torch.ops.spectrum import rows_from_host

    words32, sid, counts = rows
    n = len(sid)
    chunk = (n if all(d == device for d in devices)
             else spectrum_rows_budget(device, n_words(k), None))
    if n <= chunk:
        return shard_rows_by_hash(*rows_from_host(rows, k, device), k,
                                  devices)
    pieces = [[] for _ in devices]  # per shard, per chunk: its columns
    for a in range(0, n, chunk):
        cut = slice(a, a + chunk)
        part = (tuple(w[cut] for w in words32), sid[cut], counts[cut])
        for i, (w, s, c) in enumerate(shard_rows_by_hash(
                *rows_from_host(part, k, device), k, devices)):
            pieces[i].append([*w, s, c])
    out = []
    for i, chunks in enumerate(pieces):
        pieces[i] = None
        cols = []
        for j in range(len(chunks[0])):
            # a column at a time, each chunk's column dropped as it
            # joins: the device holds its part and one column more
            cols.append(torch.cat([c[j] for c in chunks]))
            for c in chunks:
                c[j] = None
        out.append((tuple(cols[:-2]), cols[-2], cols[-1]))
    return out


def route_packed_batch(batch: dict, sample: int, k: int,
                       devices: Sequence[torch.device], n_valid=None,
                       min_shannon: float = 0.0) -> list:
    """One 2-bit packed read batch routed to the shards on the devices
    (``simka_tpu``'s ``route_packed_batch``), recompute over
    communicate: ``batch`` holds the packed reads on each distinct
    device, ``{device: (packed, validbits)}``; each device extracts
    every kept window (``core.pipeline.kept_windows``) and compacts out
    the windows of each shard it holds. No extracted word crosses
    between devices. Returns one (words, sid) entry a shard, on its
    device, exact length."""
    from simka_tpu_torch.core.pipeline import kept_windows

    n = len(devices)
    out = [None] * n
    for dev, (packed, vb) in batch.items():
        words = kept_windows(packed, vb, k, n_valid, min_shannon)
        mine = [i for i, d in enumerate(devices) if d == dev]
        for i, cols in zip(mine, split_rows(words, shard_ids(words, k, n), n,
                                            only=mine)):
            out[i] = (cols, torch.full(cols[0].shape, sample,
                                       dtype=torch.int32, device=dev))
    return out


def sharded_raw_stats(rows: Iterable[Rows], *, n_banks: int,
                      simple: bool = False, complex_: bool = False,
                      solid_override=None, all_reduce=None) -> JoinStats:
    """Raw statistics (``ops.countjoin._raw_stats_from_rows``' form) of
    every shard's solid rows, folded on the first shard's device.

    Without ``solid_override``, over several shards or with
    ``all_reduce``, each shard's segment pass (``segment_stats``) runs
    first and only its per-bank solid totals are kept: they are summed
    over the shards (and, with ``all_reduce``, an in-place sum over
    processes) BEFORE any pair term reads them; each shard's join runs
    its own pass again, so no shard's segment starts are held beside
    another's rows. One shard alone takes its join's own totals.
    ``solid_override`` (the sweep's whole-sample totals) replaces them.
    The entries of a list are dropped (set to None) as each shard's pair
    terms are taken, which frees its rows."""
    from simka_tpu_torch.ops.countjoin import (
        _add_raw,
        _raw_stats_from_rows,
        segment_stats,
    )

    rows = rows if isinstance(rows, list) else list(rows)
    home = rows[0][1].device
    i64 = torch.int64
    if solid_override is not None:
        K = torch.as_tensor(solid_override, dtype=i64).to(home)
    elif len(rows) > 1 or all_reduce is not None:
        K = torch.zeros(n_banks, dtype=i64, device=home)
        for r in rows:
            K += segment_stats(*r, n_banks=n_banks)[0][1].to(home)
        if all_reduce is not None:
            all_reduce(K)
    else:
        K = None  # one shard: its join's own totals
    total = None
    for i in range(len(rows)):
        words, sid, count = rows[i]
        rows[i] = None
        raw = _raw_stats_from_rows(words, sid, count, n_banks=n_banks,
                                   simple=simple, complex_=complex_,
                                   solid_override=K)
        del words, sid, count
        raw = JoinStats(*(t.to(home) for t in raw))
        total = raw if total is None else _add_raw(total, raw)
    return total


def sharded_count_join_stats(
    shards: Iterable[Tuple[Sequence[torch.Tensor], torch.Tensor]],
    abundance_min: int, abundance_max: int, *, n_banks: int,
    kmer_bits: int, simple: bool = False, complex_: bool = False,
) -> JoinStats:
    """``ops.countjoin.count_join_stats`` over hash shards
    (``simka_tpu``'s ``sharded_count_join_stats``; its split forms
    collapse into this one, since the port's join takes any N).

    ``shards`` yields each shard's instances (words, sid) on its device
    (a generator lets the caller build each just in time: a shard's
    instances are dropped once its solid rows exist). Returns
    ``JoinStats`` on the first shard's device."""
    from simka_tpu_torch.ops.countjoin import (
        _checked_rows,
        _finish,
        solid_rows,
    )

    rows = []
    for words, sid in shards:
        words = _checked_rows(words, sid, n_banks, kmer_bits)
        rows.append(solid_rows(words, sid, abundance_min, abundance_max,
                               n_banks=n_banks, kmer_bits=kmer_bits))
        del words, sid
    return _finish(sharded_raw_stats(rows, n_banks=n_banks, simple=simple,
                                     complex_=complex_), complex_)


def raw_sharded_join_from_spectra(
    shards: Iterable[Rows], abundance_min: int, abundance_max: int,
    solid_override=None, *, n_banks: int, kmer_bits: int,
    simple: bool = False, complex_: bool = False, all_reduce=None,
) -> JoinStats:
    """``sharded_join_from_spectra`` in the raw form (the sweep folds
    its ranges in it)."""
    from simka_tpu_torch.ops.countjoin import solid_rows_from_spectra

    rows = [solid_rows_from_spectra(words, sid, counts, abundance_min,
                                    abundance_max, n_banks=n_banks,
                                    kmer_bits=kmer_bits)
            for words, sid, counts in shards]
    return sharded_raw_stats(rows, n_banks=n_banks, simple=simple,
                             complex_=complex_,
                             solid_override=solid_override,
                             all_reduce=all_reduce)


def sharded_join_from_spectra(
    shards: Iterable[Rows], abundance_min: int, abundance_max: int,
    solid_override=None, *, n_banks: int, kmer_bits: int,
    simple: bool = False, complex_: bool = False,
) -> JoinStats:
    """``ops.countjoin.join_stats_from_spectra`` over hash shards
    (``simka_tpu``'s ``sharded_join_from_spectra`` and its split form):
    ``shards`` yields each shard's spectrum rows (words, sid, counts)
    on its device. ``solid_override``: the whole samples' solid totals,
    where the rows are one hash range of the sweep (the shards' sum
    covers the range, not the samples). Returns ``JoinStats`` on the
    first shard's device."""
    from simka_tpu_torch.ops.countjoin import _finish

    return _finish(raw_sharded_join_from_spectra(
        shards, abundance_min, abundance_max, solid_override,
        n_banks=n_banks, kmer_bits=kmer_bits, simple=simple,
        complex_=complex_), complex_)

