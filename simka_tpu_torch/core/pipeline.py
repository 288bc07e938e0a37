"""End-to-end exact-mode pipeline (the `simka` tool) on one device or
over hash-space shards.

In memory (the default): host parse + 2-bit pack -> H2D -> per batch:
one extraction launch (canonical k-mers, keep mask, repartition
histogram), compaction of the kept windows -> one join over the
concatenated instance stream -> host statistics, distances and csv.gz.

Out-of-core (``compute_statistics_out_of_core``), for runs past the
device plan: taken up front when the estimated instances (the input
files' sizes x the k-mer windows per byte of their first reads)
exceed it, or on restart when the in-memory ingest outgrows it. One
pipelined stream counts every sample's spectrum, spilled per k-mer
hash range on the device or in host memory; the hash ranges are then
joined one at a time and their statistics folded exactly
(``core.sweep``).

With -out-tmp (the checkpoint path): per sample, its spectrum from a
checkpoint whose key matches, or counted (the same per-batch
extraction, then ``ops.spectrum``) and checkpointed under
<tmp>/count/ -> the repartition histogram of its distinct solid
k-mers; then the spectra concatenated -> one join from spectra ->
statistics, distances, csv.gz; <tmp>/count/ is removed unless
-keep-tmp. Past the reference's spill rule (the spectra's join over
-max-memory or the device plan), or with -sweep-ranges, the spectra go
to <tmp>/sweep/ per hash range and the join is the sweep.

Lengths are exact throughout: each batch keeps exactly its valid
windows, so the stream that reaches the join holds only real
instances (no padding classes, no invalid-window sentinel rows).

Every distance (default, -simple-dist, -complex-dist), k from 1 to
127 and the -kmer-shannon-index filter run. ``shards`` (a device
list, ``parallel.sharded``; -n-shards; one device by default) shards
the k-mer space: in memory, with two or more, each batch is routed on
the devices (``route_packed_batch``) and each shard joined there; out
of core, with -out-tmp and in the sweep, the rows of the spectra or of
each hash range are routed on ``device`` when every shard is there
(``shard_rows_by_hash``; one shard takes them untouched), else staged
from the host over the shards' devices in chunks
(``stage_rows_by_hash``), and joined per shard; the plans count every
device (``core.budget``). The statistics are the same bit for bit at
any shard count.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from simka_tpu_torch import resolve_device
from simka_tpu_torch.config import SimkaConfig
from simka_tpu_torch.core.distances import compute_all_matrices
from simka_tpu_torch.core.output import write_all_matrices
from simka_tpu_torch.core.stats import SimkaStatistics
from simka_tpu_torch.io.dsl import check_input_validity, parse_input_file
from simka_tpu_torch.ops.kmers import N_HIST_BUCKETS
from simka_tpu_torch.utils.metrics import (
    OUT_OF_CORE_SPANS,
    RUN,
    RUN_STAGES,
    SAMPLE_SPANS,
    SWEEP_SPANS,
    Metrics,
    Spans,
    clock_anchor,
    span,
)

# a sample's kept windows are counted into a partial spectrum each time
# this many reads' worth (x 32 windows) are gathered
STREAM_BATCH_READS = 1 << 20


def resolve_max_reads(read_counts: Sequence[int], max_reads: int) -> int:
    """-1: use all (0 internally); 0: auto-normalize to
    (min + mean) / 2 (reference SimkaAlgorithm::computeMaxReads);
    N: literal cap."""
    if max_reads == -1:
        return 0
    if max_reads == 0:
        counts = np.asarray(read_counts, np.int64)
        mean = int(counts.sum()) // len(counts)
        return (int(counts.min()) + mean) // 2
    return max_reads


def _iter_read_chunks(seqs, batch_reads: int):
    """Yield lists of <= batch_reads reads from a list, an iterator,
    or a zero-arg provider callable returning an iterator."""
    from itertools import islice

    it = iter(seqs() if callable(seqs) else seqs)
    while True:
        chunk = list(islice(it, batch_reads))
        if not chunk:
            return
        yield chunk


def _packed_batch_stream(
    dataset_seqs, dataset_ids, k, nb_reads, log, batch_reads,
    encoding="acgt",
):
    """Yield (sample_id, packed, validbits, n_valid) host batches for
    every dataset: the native parse+filter+2-bit-pack single pass when
    the source is a PackedReadSource (io/packed.py), the Python
    encode+pack otherwise, in the base codes of ``encoding``. ``n_valid``
    is the exact count of valid k-mer windows when the native parser
    knows it, else None."""
    from simka_tpu_torch.io.packed import host_pack_chunk

    for s, src in enumerate(dataset_seqs):
        if log is not None:
            log(f"count [{s + 1}/{len(dataset_seqs)}] {dataset_ids[s]}")
        if hasattr(src, "iter_packed"):
            batches = src.iter_packed(batch_reads, k=k)
        else:
            batches = (
                (*host_pack_chunk(chunk, k, encoding), len(chunk), None)
                for chunk in _iter_read_chunks(src, batch_reads)
            )
        for packed, vb, n, n_valid in batches:
            nb_reads[s] += n
            yield s, packed, vb, n_valid


def _pipelined_ingest(stream, ship, consume, spans: Optional[Spans] = None):
    """Three-stage ingest pipeline: parse/pack (worker A) || H2D ship
    (worker B) || device dispatch (main thread). One batch in flight
    per stage -- parse of batch i+2, ship of batch i+1 and the
    device's extraction of batch i overlap.

    Spans (``spans``): ``simka.ingest`` around the whole; on the main
    thread its waits for a parsed batch (``simka.ingest.wait_parse``)
    and for a shipped one (``simka.ingest.wait_h2d``); on worker A each
    batch's pull of ``stream`` (``simka.ingest.parse``)."""
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    def pull():
        with span("simka.ingest.parse", spans):
            return next(stream, None)

    def next_shipped():
        with span("simka.ingest.wait_h2d", spans):
            return shipped.popleft().result()

    with span("simka.ingest", spans):
        workers = {} if spans is None else spans.pool_args()
        with ThreadPoolExecutor(max_workers=1, **workers) as parse_ex, \
                ThreadPoolExecutor(max_workers=1, **workers) as ship_ex:
            pending = parse_ex.submit(pull)
            shipped = deque()
            while True:
                with span("simka.ingest.wait_parse", spans):
                    item = pending.result()
                if item is not None:
                    pending = parse_ex.submit(pull)
                if shipped:
                    consume(*next_shipped())
                if item is None:
                    break
                shipped.append(ship_ex.submit(ship, item))
            while shipped:
                consume(*next_shipped())


def _extract_kept(packed, validbits, k: int, n_valid, min_shannon: float,
                  with_hist: bool):
    """One ingest batch through the extraction kernel
    (``ops.kmers.extract_kmers``) and the compaction of its kept
    windows: (words, the histogram or None)."""
    from simka_tpu_torch.ops.compact import compact_rows
    from simka_tpu_torch.ops.kmers import extract_kmers

    ex = extract_kmers(packed, validbits, k, min_shannon=min_shannon,
                       with_hist=with_hist)
    # the parser's count spares the read of the kernel's own unless the
    # Shannon filter drops windows the parser counted
    n = int(ex.n_kept) if n_valid is None or min_shannon > 0.0 else int(
        n_valid)
    words = compact_rows(ex.words, ex.keep, fills=(-1,) * len(ex.words), n=n)
    return words, ex.hist


def kept_windows(
    packed, validbits, k: int, n_valid=None, min_shannon: float = 0.0,
):
    """One ingest batch on the device: canonical k-mers, the optional
    k-mer Shannon filter (one extraction launch) and the compaction of
    the kept windows.

    Returns the ``n_words(k)`` [n] int64 k-mer words (ops/kmers.py), n
    the batch's exact kept-window count. ``n_valid``, the native
    parser's count of valid windows, spares a device sync when no
    Shannon filter drops windows the parser counted.
    """
    return _extract_kept(packed, validbits, k, n_valid, min_shannon,
                         False)[0]


def extract_windows(
    packed, validbits, sample: int, k: int, n_valid=None,
    min_shannon: float = 0.0,
):
    """``kept_windows`` with the batch's sample ids and its repartition
    histogram: instances per ``mix_hash`` bucket over the reference's
    uint32 words (its repartition diagnostic), made by the same
    extraction launch.

    Returns (words, sid [n] int32, hist [16] int64).
    """
    words, hist = _extract_kept(packed, validbits, k, n_valid, min_shannon,
                                True)
    sid = torch.full(words[0].shape, sample, dtype=torch.int32,
                     device=words[0].device)
    return words, sid, hist


def _concat_columns(batches: List[list], nw: int, device) -> tuple:
    """The ``nw`` word columns of per-batch lists of columns, each
    concatenated; a batch's copy goes as soon as its column exists, and
    ``batches`` is left empty."""
    words = []
    for i in range(nw):
        words.append(torch.cat([b[i] for b in batches]) if batches
                     else torch.empty(0, dtype=torch.int64, device=device))
        for b in batches:
            b[i] = None
    batches.clear()
    return tuple(words)


def compute_statistics(
    dataset_seqs,
    dataset_ids: List[str],
    config: SimkaConfig,
    device: torch.device,
    batch_reads: int = 1 << 17,
    log=None,
    observer: Optional[dict] = None,
    shards: Optional[Sequence[torch.device]] = None,
) -> SimkaStatistics:
    """Statistics of every dataset on one device, or over the hash
    shards on the devices ``shards`` (default ``[device]``; a device
    may repeat), in memory while the instances fit the device plan.

    ``dataset_seqs[s]``: a PackedReadSource, a list of read byte
    strings, or a zero-arg provider callable returning an iterator
    (re-iterable: a run past the plan reads them again).
    Every k-mer instance stays on ``device`` from extraction through
    the join, and reads stream through in O(batch) host memory; a
    worker thread parses and packs batch i+2 and another ships batch
    i+1 while the device extracts batch i. When the instances outgrow
    the device plan mid-ingest (DeviceBudgetExceeded), the gathered
    batches are dropped and the run restarts out-of-core
    (``compute_statistics_out_of_core``), as ``simka_tpu`` does.

    ``observer``, when given, receives ``stage_timers``,
    ``repartition_instances`` (instances per hash bucket in memory --
    per shard when sharded, as ``simka_tpu``'s sharded path -- and
    distinct solid k-mers out-of-core), ``counters`` (in memory:
    ``h2d_bytes``, the packed and valid-bits bytes shipped;
    ``ingest_batches``, the batches dispatched; ``h2d_pinned_in``, the
    copies to a card from page-locked arrays, ``_shipper``; on one device
    ``pair_groups``, the sample groups of the pair kernel's plan,
    ``ops.countjoin.pair_groups``) and ``route``;
    on a restart also ``restart_held_bytes``, the device memory still
    allocated when the out-of-core run begins. When ``observer`` holds
    a list under ``"spans"``, the job's spans are appended to it
    (``utils.metrics.Spans``), from the root ``simka.job`` and its
    ``simka.clock``; the in-memory stage timers are sums of spans
    (``utils.metrics.STAGE_SPANS``), timed with or without records.
    """
    from simka_tpu_torch.core.budget import DeviceBudgetExceeded

    shards = list(shards) if shards else [device]
    spans = None if observer is None else Spans(observer.get("spans"))
    if observer is not None:
        observer["counters"] = spans.counters
    with span("simka.job", spans):
        clock_anchor(spans)
        try:
            if len(shards) > 1:
                stats = _compute_statistics_sharded(
                    dataset_seqs, dataset_ids, config, shards, batch_reads,
                    log, observer, spans)
            else:
                stats = _compute_statistics_in_memory(
                    dataset_seqs, dataset_ids, config, device, batch_reads,
                    log, observer, spans)
        except DeviceBudgetExceeded as e:
            # the restart runs after the handler, once the traceback's
            # frames, and the batches they reference, are gone
            reason = str(e)
        else:
            if observer is not None:
                observer["route"] = "in-memory"
            return stats
        if log is not None:
            log(f"device plan: {reason}; restarting out-of-core")
        if observer is not None:
            observer["route"] = "restart"
            observer["restart_held_bytes"] = (
                torch.cuda.memory_allocated(device) if device.type == "cuda"
                else 0)
        return compute_statistics_out_of_core(
            dataset_seqs, dataset_ids, config, device, batch_reads, log=log,
            observer=observer, shards=shards,
        )


def _shipper(device: torch.device, spans: Optional[Spans]):
    """The ingest's H2D stage: a host batch of ``_packed_batch_stream``
    shipped to ``device``, in the span ``simka.ingest.h2d``. Counts
    ``h2d_pinned_in``, the copies to a card from page-locked arrays (the
    native parser's where the job's device is a card,
    ``io.packed.PackedReadSource``'s ``pin``), which the driver copies
    straight, not through a staging buffer of its own."""
    card = device.type == "cuda"

    def ship(item):
        sample, packed, vb, n_valid = item
        with span("simka.ingest.h2d", spans):
            packed, vb = torch.from_numpy(packed), torch.from_numpy(vb)
            if spans is not None:
                spans.count("h2d_pinned_in", card and packed.is_pinned()
                            and vb.is_pinned())
            packed, vb = packed.to(device), vb.to(device)
        return sample, packed, vb, n_valid

    return ship


def _compute_statistics_in_memory(
    dataset_seqs, dataset_ids, config, device, batch_reads, log, observer,
    spans: Optional[Spans] = None,
) -> SimkaStatistics:
    """``compute_statistics``'s in-memory run; raises
    DeviceBudgetExceeded, with every gathered batch dropped, once the
    instances exceed the device plan."""
    from simka_tpu_torch.core.budget import (
        DeviceBudgetExceeded,
        instance_rows_budget,
    )
    from simka_tpu_torch.ops.countjoin import count_join_stats
    from simka_tpu_torch.ops.kmers import n_words

    k = config.kmer_size
    nw = n_words(k)
    nb_reads = [0] * len(dataset_seqs)
    rows_budget = instance_rows_budget(device, nw)
    batches, sids = [], []  # per batch: its k-mer word columns; sids
    hist = torch.zeros(N_HIST_BUCKETS, dtype=torch.int64, device=device)
    state = {"rows": 0}

    stream = _packed_batch_stream(
        dataset_seqs, dataset_ids, k, nb_reads, log, batch_reads
    )

    ship = _shipper(device, spans)

    def consume(sample, packed, vb, n_valid):
        with span("simka.ingest.dispatch", spans):
            words, sid, h = extract_windows(
                packed, vb, sample, k, n_valid, config.min_kmer_shannon_index
            )
            hist.add_(h)
            batches.append(list(words))
            sids.append(sid)
            state["rows"] += sid.shape[0]
        if spans is not None:
            spans.count("h2d_bytes", packed.nbytes + vb.nbytes)
            spans.count("ingest_batches", 1)
        if state["rows"] > rows_budget:
            batches.clear()
            sids.clear()
            raise DeviceBudgetExceeded(
                f"{state['rows']} k-mer instances exceed the device "
                f"plan of {rows_budget} rows"
            )

    _pipelined_ingest(stream, ship, consume, spans)

    with span("simka.join", spans):
        with span("simka.join.concat", spans):
            words = _concat_columns(batches, nw, device)
            sid = torch.cat(sids) if sids else torch.empty(
                0, dtype=torch.int32, device=device
            )
            sids.clear()
        js = count_join_stats(
            words,
            sid,
            config.abundance_min,
            config.abundance_max,
            n_banks=len(dataset_ids),
            kmer_bits=2 * k,
            simple=config.simple_dist,
            complex_=config.complex_dist,
            spans=spans,
        )
        del words, sid
        stats = _host_stats(js, dataset_ids, k, nb_reads, config, spans)
    if observer is not None:
        observer["stage_timers"] = spans.stage_timers()
        observer["repartition_instances"] = hist.cpu().numpy()
    return stats


def _host_stats(js, dataset_ids, k, nb_reads, config, spans):
    """The join's statistics on the host (``simka.join.host_stats``):
    ``to_numpy`` waits for the device (``simka.sync.to_numpy``)."""
    with span("simka.join.host_stats", spans):
        with span("simka.sync.to_numpy", spans):
            js = js.to_numpy()
        return SimkaStatistics.from_join_stats(
            js, dataset_ids, k, np.asarray(nb_reads, np.int64),
            config.simple_dist, config.complex_dist,
        )


def _compute_statistics_sharded(
    dataset_seqs, dataset_ids, config, shards, batch_reads, log, observer,
    spans: Optional[Spans] = None,
) -> SimkaStatistics:
    """``compute_statistics``' in-memory run over hash shards
    (``simka_tpu``'s ``_compute_statistics_sharded_device``): each batch
    is shipped once to every distinct device of ``shards`` and routed
    there (``parallel.sharded.route_packed_batch``), each shard's
    instances stay on its device, and the shards are joined and folded
    (``sharded_count_join_stats``). Raises DeviceBudgetExceeded, with
    every gathered batch dropped, once a device holds more instances,
    summed over the shards it holds, than its plan."""
    from collections import Counter

    from simka_tpu_torch.core.budget import (
        DeviceBudgetExceeded,
        instance_rows_budget,
    )
    from simka_tpu_torch.ops.kmers import n_words
    from simka_tpu_torch.parallel.sharded import (
        route_packed_batch,
        sharded_count_join_stats,
    )

    k = config.kmer_size
    nw = n_words(k)
    held = Counter(shards)
    plan = {d: instance_rows_budget(d, nw) for d in held}
    nb_reads = [0] * len(dataset_seqs)
    batches = [[] for _ in shards]  # per shard, per batch: word columns
    sids = [[] for _ in shards]
    rows = [0] * len(shards)
    shippers = {d: _shipper(d, spans) for d in held}

    def ship(item):  # the batch on every distinct device
        return (item[0], {d: s(item)[1:3] for d, s in shippers.items()},
                item[3])

    def consume(sample, batch, n_valid):
        with span("simka.ingest.dispatch", spans):
            routed = route_packed_batch(batch, sample, k, shards, n_valid,
                                        config.min_kmer_shannon_index)
            for i, (words, sid) in enumerate(routed):
                batches[i].append(list(words))
                sids[i].append(sid)
                rows[i] += sid.shape[0]
        if spans is not None:
            spans.count("h2d_bytes", sum(p.nbytes + v.nbytes
                                         for p, v in batch.values()))
            spans.count("ingest_batches", 1)
        for d, m in held.items():
            on_d = sum(r for r, s in zip(rows, shards) if s == d)
            if on_d > plan[d]:
                for b in (*batches, *sids):
                    b.clear()
                raise DeviceBudgetExceeded(
                    f"{on_d} k-mer instances of {m} shard(s) on {d} exceed "
                    f"its plan of {plan[d]} rows")

    stream = _packed_batch_stream(
        dataset_seqs, dataset_ids, k, nb_reads, log, batch_reads
    )
    _pipelined_ingest(stream, ship, consume, spans)

    def shard_streams():  # each shard's instances, built just in time
        for i, d in enumerate(shards):
            words = _concat_columns(batches[i], nw, d)
            sid = torch.cat(sids[i]) if sids[i] else torch.empty(
                0, dtype=torch.int32, device=d)
            sids[i].clear()
            yield words, sid
            del words, sid

    with span("simka.join", spans):
        js = sharded_count_join_stats(
            shard_streams(), config.abundance_min, config.abundance_max,
            n_banks=len(dataset_ids), kmer_bits=2 * k,
            simple=config.simple_dist, complex_=config.complex_dist,
        )
        stats = _host_stats(js, dataset_ids, k, nb_reads, config, spans)
    if observer is not None:
        observer["stage_timers"] = spans.stage_timers()
        observer["repartition_instances"] = np.asarray(rows, np.int64)
    return stats


SPILL_TIERS = ("device", "ram", "disk")


def compute_statistics_out_of_core(
    dataset_seqs,
    dataset_ids: List[str],
    config: SimkaConfig,
    device: torch.device,
    batch_reads: int = 1 << 17,
    log=None,
    observer: Optional[dict] = None,
    tier: Optional[str] = None,
    shards: Optional[Sequence[torch.device]] = None,
) -> SimkaStatistics:
    """Out-of-core statistics on one device (``simka_tpu``'s
    ``_compute_statistics_out_of_core``): per-sample spectra, spilled
    per hash range, then the sweep (``core.sweep``), whose ranges are
    joined over the hash shards on ``shards`` (default ``[device]``).
    The spectra are counted and spilled on ``device``; each range is
    loaded and routed there when every shard is on ``device``, else
    staged over the shards from the host, so a range's budget is the
    shards' plan (``budget.spectrum_rows_budget``).

    The count phase is one pipelined stream over every sample, as in
    memory: parse/pack || H2D || per batch the kept windows, gathered
    per sample (``_SpectrumGather``). A sample's spectrum is made and
    spilled once its last batch is consumed (at the next sample's first
    batch, or the stream's end) while the next batches parse; the host
    tiers cut it per range on the device, copy it and store it on a
    worker thread (``partition_on_device``). Each sample's solid total
    and repartition histogram (``spill_stats``) stay on the device
    until the stream ends.

    The spill tier is ``tier`` when given ("device", "ram", or "disk",
    which needs ``config.output_tmp_dir``; the -out-tmp command spills
    to disk through ``compute_statistics_checkpointed``). Otherwise the
    device tier when every shard is on ``device`` and the estimated
    instances' (``budget.estimate_total_instances`` with k) spectrum
    bytes fit a third of the device plan (the resident spectra then
    share the device with each range's join, whose budget shrinks to
    3/5), else host memory. Shards on other devices take no device
    tier, as in ``simka_tpu``: its resident spectra would sit on
    ``device`` alone and bound the run by that one device again.
    Ranges are provisioned from the worse of the first sample's
    spectrum x N x 1.3 and that estimate, since they cannot be split
    once spilling starts. The spill is removed at the end.

    ``observer``, when given, receives ``stage_timers`` (sums of spans,
    ``utils.metrics.OUT_OF_CORE_SPANS``), ``repartition_instances``
    (distinct solid k-mers per hash bucket, as ``simka_tpu``'s),
    ``sweep_ranges``, ``spill_tier``, ``spectrum_rows`` and
    ``per_sample`` (rows, and the seconds of the sample's spectrum and,
    on the host tiers, of its spill: its own spans).
    """
    from concurrent.futures import ThreadPoolExecutor

    from simka_tpu_torch.core.budget import (
        COUNT_BYTES,
        WORD_BYTES,
        device_budget_bytes,
        estimate_total_instances,
        spectrum_rows_budget,
    )
    from simka_tpu_torch.core.sweep import (
        DeviceSpill,
        RamSpill,
        SpectrumSpill,
        partition_on_device,
        sweep_join_stats,
    )
    from simka_tpu_torch.ops.kmers import n_words

    k = config.kmer_size
    n = len(dataset_ids)
    nw = n_words(k)
    est_rows = (estimate_total_instances(dataset_seqs, k)
                if all(hasattr(s, "banks") for s in dataset_seqs) else None)
    shards = list(shards) if shards else [device]
    resident = all(d == device for d in shards)
    if tier is None:
        fits = (resident and est_rows is not None
                and est_rows * (WORD_BYTES * nw + COUNT_BYTES)
                <= device_budget_bytes(device) // 3)
        tier = "device" if fits else "ram"
    if tier not in SPILL_TIERS:
        raise ValueError(f"spill tier {tier!r} is not one of {SPILL_TIERS}")
    if tier == "disk" and not config.output_tmp_dir:
        raise ValueError("the disk spill tier needs an -out-tmp directory")
    if tier == "device" and not resident:
        raise ValueError("the device spill tier needs every shard on the "
                         f"run's device {device}")
    budget_rows = spectrum_rows_budget(shards, nw, config.max_memory_mb)
    if tier == "device":
        budget_rows = max(budget_rows * 3 // 5, 1)

    nb_reads = [0] * n
    spans = Spans()  # the route's stage timers
    steps = [Spans() for _ in range(n)]  # each sample's spectrum and spill
    solid = torch.zeros(n, dtype=torch.int64, device=device)
    hist = torch.zeros(N_HIST_BUCKETS, dtype=torch.int64, device=device)
    per_sample = [{"id": i} for i in dataset_ids]
    gather = _SpectrumGather(k, device, STREAM_BATCH_READS * 32)
    state = {"sample": 0, "spill": None}
    spills = []  # the host tiers' spill futures

    def make_spill(rows: int):
        projected = max(int(rows * n * 1.3), 1)
        if est_rows is not None:
            projected = max(projected, est_rows)
        n_ranges = max(1, -(-projected // budget_rows))
        if tier == "device":
            spill = DeviceSpill(n_ranges, k)
        elif tier == "ram":
            spill = RamSpill(n_ranges, k, device)
        else:
            spill = SpectrumSpill(config.output_tmp_dir, n_ranges, k, device)
        if log is not None:
            log(f"out-of-core sweep: {n_ranges} hash ranges "
                f"({type(spill).__name__}, projected {projected} rows, "
                f"budget {budget_rows}/range)")
        return spill

    def spill_host(spill, s, spectrum):
        with span("simka.spectra.spill", steps[s]):
            spill.spill_parts(s, partition_on_device(*spectrum, k,
                                                     spill.n_ranges))

    def finish(s):  # every batch of sample s is consumed
        with span("simka.spectra.spectrum", steps[s]):
            words, counts = gather.spectrum()
            sd, hd = spill_stats(words, counts, k, config.abundance_min,
                                 config.abundance_max)
            solid[s] = sd
            hist.add_(hd)
            if state["spill"] is None:
                state["spill"] = make_spill(counts.shape[0])
        per_sample[s]["rows"] = counts.shape[0]
        if tier == "device":
            with span("simka.spectra.spill", steps[s]):
                state["spill"].spill_sample(s, words, counts)
        else:
            spills.append(spill_ex.submit(
                spill_host, state["spill"], s, (words, counts)))

    def consume(sample, packed, vb, n_valid):
        while state["sample"] < sample:  # samples without a batch too
            finish(state["sample"])
            state["sample"] += 1
        with span("simka.ingest.dispatch", spans):
            gather.add(kept_windows(packed, vb, k, n_valid,
                                    config.min_kmer_shannon_index))

    stream = _packed_batch_stream(
        dataset_seqs, dataset_ids, k, nb_reads, log, batch_reads
    )
    # the host tiers' spill overlaps the count: simka.spectra spans both
    with span("simka.spectra", spans):
        with ThreadPoolExecutor(max_workers=1) as spill_ex:
            _pipelined_ingest(stream, _shipper(device, spans), consume,
                              spans)
            while state["sample"] < n:
                finish(state["sample"])
                state["sample"] += 1
            for f in spills:
                f.result()
        spill = state["spill"]
        if spill is None:
            raise ValueError("no datasets")
        # the one read of the count phase's per-sample statistics
        solid_np, hist_np = solid.cpu().numpy(), hist.cpu().numpy()
    for s, step in enumerate(steps):
        spans.add(step)
        per_sample[s]["spectrum_s"] = round(
            step.seconds("simka.spectra.spectrum"), 4)
        if tier != "device":
            per_sample[s]["spill_s"] = round(
                step.seconds("simka.spectra.spill"), 4)
    js = sweep_join_stats(
        spill, n, config.abundance_min, config.abundance_max, solid_np,
        k=k, device=device, simple=config.simple_dist,
        complex_=config.complex_dist,
        log=log if log is not None else (lambda m: None), spans=spans,
        shards=shards,
    )
    spill.cleanup()
    stats = SimkaStatistics.from_join_stats(
        js.to_numpy(), dataset_ids, k, np.asarray(nb_reads, np.int64),
        config.simple_dist, config.complex_dist,
    )
    if observer is not None:
        observer.update(
            stage_timers=spans.stage_timers(OUT_OF_CORE_SPANS),
            repartition_instances=hist_np,
            sweep_ranges=spill.n_ranges, spill_tier=tier,
            spectrum_rows=int(sum(p["rows"] for p in per_sample)),
            per_sample=per_sample,
        )
    return stats


HostSpectrum = Tuple[Tuple[np.ndarray, ...], np.ndarray]


def compute_statistics_from_spectra(
    spectra: Sequence[HostSpectrum],
    dataset_ids: List[str],
    nb_reads: List[int],
    config: SimkaConfig,
    device: torch.device,
    shards: Optional[Sequence[torch.device]] = None,
) -> SimkaStatistics:
    """Statistics from per-sample spectra over the hash shards on
    ``shards`` (default ``[device]``: one device; the checkpoint path's
    merge, ``simka_tpu``'s ``compute_statistics_from_spectra``).

    ``spectra[s]`` = (words, counts) of sample s on the host, as
    ``count_one_dataset`` returns them: ``simka_tpu``'s uint32 words
    and the counts. They are concatenated on the host, staged over the
    shards through ``device`` (``stage_rows_by_hash``: shipped once and
    routed there when every shard is on ``device``) and joined per
    shard (``sharded_join_from_spectra``).
    """
    from simka_tpu_torch.core.sweep import host_rows
    from simka_tpu_torch.ops.kmers import n_uint32_words
    from simka_tpu_torch.parallel.sharded import (
        sharded_join_from_spectra,
        stage_rows_by_hash,
    )

    k = config.kmer_size
    nw32 = n_uint32_words(k)
    for s, (w, c) in enumerate(spectra):
        if len(c) and len(w) != nw32:
            raise ValueError(
                f"{dataset_ids[s]}: a spectrum of {len(w)} uint32 words "
                f"where k={k} has {nw32}"
            )
    parts = stage_rows_by_hash(host_rows(spectra, k), k, shards or [device],
                               device)
    js = sharded_join_from_spectra(
        parts, config.abundance_min, config.abundance_max,
        n_banks=len(dataset_ids), kmer_bits=2 * k,
        simple=config.simple_dist, complex_=config.complex_dist)
    return SimkaStatistics.from_join_stats(
        js.to_numpy(),
        dataset_ids,
        k,
        np.asarray(nb_reads, np.int64),
        config.simple_dist,
        config.complex_dist,
    )


class _SpectrumGather:
    """One sample's kept windows, counted into a partial spectrum each
    time ``flush_rows`` of them are gathered (which bounds the device
    memory by the gather instead of the sample), the partials merged
    into its spectrum at the end."""

    def __init__(self, k: int, device: torch.device, flush_rows: int):
        from simka_tpu_torch.ops.kmers import n_words

        self.k, self.nw, self.device = k, n_words(k), device
        self.flush_rows = flush_rows
        self.parts: List[list] = []  # per batch: its k-mer word columns
        self.partials = []
        self.rows = 0

    def _flush(self):
        from simka_tpu_torch.ops.spectrum import count_spectrum

        self.partials.append(count_spectrum(
            _concat_columns(self.parts, self.nw, self.device), self.k))
        self.rows = 0

    def add(self, words) -> None:
        self.parts.append(list(words))
        self.rows += words[0].shape[0]
        if self.rows >= self.flush_rows:
            self._flush()

    def spectrum(self):
        """(words, counts) of the windows added since the last call."""
        from simka_tpu_torch.ops.spectrum import merge_spectra

        if self.parts or not self.partials:
            self._flush()
        spectrum = merge_spectra(self.partials)
        self.partials = []
        return spectrum


def count_dataset_spectrum(
    seqs,
    k: int,
    device: torch.device,
    stream_batch_reads: int = STREAM_BATCH_READS,
    min_kmer_shannon_index: float = 0.0,
):
    """Count phase for one sample on ``device`` (``simka_tpu``'s
    ``count_dataset_spectrum``).

    ``seqs``: a PackedReadSource, a list of read byte strings, or a
    zero-arg provider callable. Batches of at most 2^17 reads are
    extracted as in the in-memory path (``kept_windows``, pipelined as
    there); each time the kept windows gathered reach
    ``stream_batch_reads * 32`` rows they are counted into a partial
    spectrum, and the partials are merged at the end (``_SpectrumGather``).

    Returns (words, counts, n_reads): the sample's spectrum on
    ``device`` (``ops.spectrum``) and its read count.
    """
    nb_reads = [0]
    gather = _SpectrumGather(k, device, stream_batch_reads * 32)

    def consume(_sample, packed, vb, n_valid):
        gather.add(kept_windows(packed, vb, k, n_valid,
                                min_kmer_shannon_index))

    stream = _packed_batch_stream(
        [seqs], [""], k, nb_reads, None, min(stream_batch_reads, 1 << 17),
    )
    _pipelined_ingest(stream, _shipper(device, None), consume)
    words, counts = gather.spectrum()
    return words, counts, nb_reads[0]


def repartition_histogram(
    spectra_iter,
    abundance_min: int,
    abundance_max: int,
    n_buckets: int = N_HIST_BUCKETS,
) -> np.ndarray:
    """Distinct solid k-mers per hash bucket, summed over samples
    (``simka_tpu``'s ``repartition_histogram``, the reference's
    printCountInfo, src/SimkaPotara.hpp:785-811), over host spectra of
    uint32 words. The in-memory path's histogram counts instances."""
    from simka_tpu_torch.ops.kmers import mix_hash_np

    hist = np.zeros(n_buckets, np.int64)
    for words, counts in spectra_iter:
        h = words[0]
        for w in words[1:]:
            h = mix_hash_np(h, w)
        keep = (counts >= abundance_min) & (counts <= abundance_max)
        hist += np.bincount(
            (h[keep] % np.uint32(n_buckets)).astype(np.int64),
            minlength=n_buckets,
        )
    return hist


def spill_stats(words, counts, k: int, abundance_min: int,
                abundance_max: int):
    """One spectrum's post-filter solid total and its distinct solid
    k-mers per repartition bucket, on the spectrum's device and with
    no sync (``simka_tpu``'s ``_spill_stats_device``: the device form
    of ``filtered_solid_per_bank`` and ``repartition_histogram``).
    Returns (scalar int64, [N_HIST_BUCKETS] int64) tensors."""
    from simka_tpu_torch.ops.kmers import mix_hash_words, uint32_words

    c = counts.to(torch.int64)
    keep = (c >= abundance_min) & (c <= abundance_max)
    solid = torch.where(keep, c, 0).sum()
    h = mix_hash_words(uint32_words(tuple(words), k))
    bucket = torch.where(keep, h % N_HIST_BUCKETS, N_HIST_BUCKETS)
    hist = torch.bincount(bucket, minlength=N_HIST_BUCKETS + 1)
    return solid, hist[:N_HIST_BUCKETS]


def count_one_dataset(
    d, config: SimkaConfig, cap: int, device: torch.device, ckpt=None,
    log=lambda m: None, spans: Optional[Spans] = None,
):
    """Count phase for one dataset (``simka_tpu``'s
    ``count_one_dataset``): checkpoint reuse, the count, the checkpoint
    save, and the reference's retry-x4 (simkaCountProcess,
    src/minikc/SimkaCountProcess.cpp:21-28) for read failures
    (OSError) only: an error of the device or of a kernel wrapper
    propagates at once, since a sticky CUDA error would only repeat and
    hide the first message.

    Returns (words, counts, n_reads, resumed): the spectrum on the host
    in the checkpoint's layout, ``simka_tpu``'s uint32 words and int64
    counts. ``spans`` (or None) times the steps taken: the
    checkpoint's load, the count and the checkpoint's save
    (``utils.metrics.SAMPLE_SPANS``).
    """
    from simka_tpu_torch.io.packed import PackedReadSource
    from simka_tpu_torch.ops.spectrum import to_host

    k = config.kmer_size
    key = None
    if ckpt is not None:
        from simka_tpu_torch.core.checkpoint import count_key

        key = count_key(
            d.files,
            k,
            config.min_read_size,
            config.min_read_shannon_index,
            cap,
            config.min_kmer_shannon_index,
        )
        with span(SAMPLE_SPANS["load_s"], spans):
            cached = ckpt.load(d.id, key)
        if cached is not None:
            words, counts, n = cached
            log(f"count {d.id}: resumed from checkpoint "
                f"({len(counts)} distinct k-mers)")
            return words, counts, n, True
    source = PackedReadSource(
        d.banks,
        config.min_read_size,
        config.min_read_shannon_index,
        max_reads=cap,
        pin=device.type == "cuda",
    )
    with span(SAMPLE_SPANS["count_s"], spans):
        for attempt in range(4):
            try:
                *spectrum, n = count_dataset_spectrum(
                    source, k, device,
                    min_kmer_shannon_index=config.min_kmer_shannon_index,
                )
                break
            except OSError as e:
                if attempt == 3:
                    raise
                log(f"count {d.id}: attempt {attempt + 1} failed ({e}); "
                    "retrying")
        words, counts = to_host(spectrum, k)
    if ckpt is not None:
        with span(SAMPLE_SPANS["save_s"], spans):
            ckpt.save(d.id, key, words, counts, n)
    log(f"count {d.id}: {n} reads -> {len(counts)} distinct k-mers")
    return words, counts, n, False


def compute_statistics_checkpointed(
    datasets, config: SimkaConfig, cap: int, device: torch.device,
    metrics, log, shards: Optional[Sequence[torch.device]] = None,
) -> SimkaStatistics:
    """The -out-tmp path (``simka_tpu``'s ``run_simka`` with
    ``output_tmp_dir``, one device): per sample its checkpointed or
    counted spectrum and the repartition histogram of its distinct
    solid k-mers; then the join from the spectra.

    The reference's spill rule routes to the out-of-core sweep: at the
    first sample where the spectrum rows so far x the reference's row
    bytes x 8 exceed the budget (-max-memory and the device plan), or
    from the first sample with -sweep-ranges. There the samples held so
    far are cut per hash range on the device and spilled to
    ``<tmp>/sweep/`` (``SpectrumSpill``; ``choose_n_ranges`` of the
    projected rows, raised where one range's join would outgrow the
    device plan) and their host copies freed, every later sample is
    spilled as it comes, and the merge is the sweep
    (``sweep_join_stats``); ``<tmp>/sweep/`` is removed unless
    -keep-tmp.

    Fills ``metrics``' count and merge stages (spans into
    ``metrics.spans``) and counters (the reference's keys, plus
    ``spectrum_rows``, ``memory_budget_bytes``, ``per_sample`` step
    times, each sample's own spans, ``utils.metrics.SAMPLE_SPANS``, and,
    after a sweep, ``sweep_ranges`` and the seconds
    ``sweep_range_load_s``, ``sweep_range_join_s``, ``sweep_partition_s``
    and ``sweep_write_s``, ``utils.metrics.SWEEP_SPANS``). The join, or each
    range of the sweep, runs over the hash shards on ``shards``
    (default ``[device]``), each shard's rows staged on its own device
    (``stage_rows_by_hash``), so the budget is the shards' plan
    (``budget.plan_bytes``)."""
    from simka_tpu_torch.core.budget import (
        JOIN_WORKING_SET_FACTOR,
        plan_bytes,
        spectrum_rows_budget,
    )
    from simka_tpu_torch.core.checkpoint import CountCheckpoint
    from simka_tpu_torch.core.sweep import (
        SpectrumSpill,
        choose_n_ranges,
        filtered_solid_per_bank,
        sweep_join_stats,
    )
    from simka_tpu_torch.ops.kmers import n_uint32_words, n_words

    ids = [d.id for d in datasets]
    k = config.kmer_size
    shards = list(shards) if shards else [device]
    ckpt = CountCheckpoint(config.output_tmp_dir)
    # the reference's rule, over the row bytes of its uint32 layout, so
    # both packages route an input alike: the join must fit both the
    # -max-memory declaration and the shards' plan
    nw32 = n_uint32_words(k)
    row_bytes = 4 * (nw32 + 2)
    budget = min(max(config.max_memory_mb, 1) * 1_000_000,
                 plan_bytes(shards))
    spectra, nb_reads, per_sample = [], [], []
    steps = []  # each sample's spans (SAMPLE_SPANS)
    rows_so_far = 0
    hist = np.zeros(N_HIST_BUCKETS, np.int64)
    solid = np.zeros(len(datasets), np.int64)
    spill = None
    spans = metrics.spans

    def step_times(s):  # the steps sample s has taken, in seconds
        per_sample[s].update({
            name: round(steps[s].seconds(n), 4)
            for name, n in SAMPLE_SPANS.items() if n in steps[s].ns})

    def spill_one(s, words, counts):
        with span(SAMPLE_SPANS["spill_s"], steps[s]):
            spill.spill_sample(s, words, counts)
            solid[s] = filtered_solid_per_bank(
                [counts], config.abundance_min, config.abundance_max)[0]
        step_times(s)

    with span(RUN_STAGES["count"], spans):
        for i, d in enumerate(datasets):
            log(f"count [{i + 1}/{len(datasets)}] {d.id}")
            steps.append(Spans())
            words, counts, n, resumed = count_one_dataset(
                d, config, cap, device, ckpt=ckpt, log=log, spans=steps[i]
            )
            hist += repartition_histogram(
                [(words, counts)], config.abundance_min, config.abundance_max
            )
            if resumed:
                metrics.count("datasets_resumed", 1)
            per_sample.append({"id": d.id, "resumed": resumed,
                               "rows": len(counts)})
            step_times(i)
            rows_so_far += len(counts)
            need = rows_so_far * row_bytes * JOIN_WORKING_SET_FACTOR
            log(f"{rows_so_far} spectrum rows so far: {need} B of a "
                f"{budget} B budget")
            if spill is None and (config.sweep_ranges > 0 or need > budget):
                # the projected join outgrows the budget: the hash-range
                # sweep (the reference's disk partitions,
                # SimkaPotara.hpp:713-723), projected from the mean
                # sample so far
                projected = int(rows_so_far * len(datasets) * 1.3 / (i + 1))
                # the reference's count, raised where a range's join in
                # the port's rows would outgrow the shards' plan
                n_ranges = max(
                    choose_n_ranges(projected, nw32, config.max_memory_mb,
                                    config.sweep_ranges),
                    -(-projected // spectrum_rows_budget(
                        shards, n_words(k), None)))
                spill = SpectrumSpill(config.output_tmp_dir, n_ranges, k,
                                      device, spans)
                log(f"out-of-core sweep: {n_ranges} hash ranges "
                    f"(projected {projected} rows)")
                for s, (w, c) in enumerate(spectra):
                    spill_one(s, w, c)
                    spectra[s] = None  # frees the host copy
            if spill is not None:
                spill_one(i, words, counts)
                spectra.append(None)
            else:
                spectra.append((words, counts))
            nb_reads.append(n)
            metrics.count("kmer_instances", int(counts.sum()))
        metrics.count("reads", int(sum(nb_reads)))
        metrics.set("repartition_histogram", hist.tolist())
    metrics.set("spectrum_rows", rows_so_far)
    metrics.set("memory_budget_bytes", budget)
    metrics.set("per_sample", per_sample)
    if hist.sum():
        log(f"kmer repartition over {N_HIST_BUCKETS} hash buckets: min "
            f"{int(hist.min())} mean {int(hist.mean())} max "
            f"{int(hist.max())}")
    log(f"count phase: {int(sum(nb_reads))} reads in "
        f"{spans.seconds(RUN_STAGES['count']):.2f}s")
    with span(RUN_STAGES["merge"], spans):
        if spill is None:
            stats = compute_statistics_from_spectra(
                spectra, ids, nb_reads, config, device, shards
            )
        else:
            metrics.set("sweep_ranges", spill.n_ranges)
            js = sweep_join_stats(
                spill, len(ids), config.abundance_min, config.abundance_max,
                solid, k=k, device=device, simple=config.simple_dist,
                complex_=config.complex_dist, log=log, spans=spans,
                shards=shards,
            )
            stats = SimkaStatistics.from_join_stats(
                js.to_numpy(), ids, k, np.asarray(nb_reads, np.int64),
                config.simple_dist, config.complex_dist,
            )
            for name, v in spans.stage_timers(SWEEP_SPANS).items():
                metrics.set(f"sweep_{name}", round(v, 4))
            if not config.keep_tmp:
                spill.cleanup()
    log(f"merge: {spans.seconds(RUN_STAGES['merge']):.2f}s")
    return stats


def run_simka(
    config: SimkaConfig, device: str = "cuda", tier: Optional[str] = None,
    shards: Optional[Sequence] = None,
) -> Dict[str, np.ndarray]:
    """The `simka` tool: input file -> distance matrices on disk, on
    ``device`` ("cuda" or "cpu"; "cuda" without a GPU raises).

    With ``output_tmp_dir`` set, per-sample spectra are checkpointed
    there and reused on resume (the reference's sentinel-file system,
    SimkaPotara.hpp:838-842); ``keep_tmp`` preserves them so later runs
    can add datasets without recounting. Without it, a run whose
    estimated instances (the files' sizes x the k-mer windows per byte
    of their first reads) exceed the device plan goes out-of-core up
    front (``compute_statistics_out_of_core``), and one that outgrows
    the plan mid-ingest restarts there (``compute_statistics``).
    ``tier`` ("device" or "ram"; refused with ``output_tmp_dir``) sends
    the run out-of-core on that spill tier whatever the estimate.

    The k-mer space is sharded over the devices ``shards`` (of
    ``device``'s kind; one may repeat) when given, else over
    ``config.n_shards`` by the reference's rule
    (``parallel.sharded.shard_devices``: the first n cards, or n copies
    of the CPU); one device runs the one-device path.
    """
    from simka_tpu_torch.core.budget import (
        estimate_total_instances,
        instance_rows_budget,
    )
    from simka_tpu_torch.io.packed import PackedReadSource
    from simka_tpu_torch.ops.kmers import n_words
    from simka_tpu_torch.parallel.sharded import check_shards, shard_devices

    if tier is not None and config.output_tmp_dir:
        raise ValueError("a spill tier applies to the in-memory command; "
                         "-out-tmp spills to <tmp>/sweep/")
    dev = resolve_device(device)
    devices = (shard_devices(config.n_shards, dev) if shards is None
               else check_shards(shards, dev))
    spans = Spans()  # the run and its stages (utils.metrics.RUN_STAGES)
    metrics = Metrics(spans)
    datasets = parse_input_file(config.input_filename)
    check_input_validity(datasets)
    ids = [d.id for d in datasets]
    metrics.set("n_datasets", len(ids))
    metrics.set("kmer_size", config.kmer_size)
    metrics.set("device", str(dev))
    metrics.set("n_shards", len(devices))

    if config.max_reads == 0:
        # auto mode from per-GROUP read estimates, as the reference
        from simka_tpu_torch.io.bank import estimate_dataset_reads

        raw_counts = [
            estimate_dataset_reads(
                d.banks,
                config.min_read_size,
                config.min_read_shannon_index,
            )
            // max(len(d.banks), 1)
            for d in datasets
        ]
        cap = resolve_max_reads(raw_counts, 0)
    else:
        cap = resolve_max_reads([], config.max_reads)

    def log(msg):
        if config.verbose:
            print(f"[simka-tpu-torch] {msg}", flush=True)

    if config.output_tmp_dir:
        stats = compute_statistics_checkpointed(
            datasets, config, cap, dev, metrics, log, devices
        )
    else:
        providers = [
            PackedReadSource(
                d.banks,
                config.min_read_size,
                config.min_read_shannon_index,
                max_reads=cap,
                pin=dev.type == "cuda",
            )
            for d in datasets
        ]
        observer: dict = {}
        est = estimate_total_instances(datasets, config.kmer_size)
        plan_rows = instance_rows_budget(devices, n_words(config.kmer_size))
        with span(RUN_STAGES["count"], spans):
            if tier is not None or est > plan_rows:
                # clearly past the device plan: straight out-of-core
                # (the mid-ingest guard would catch it anyway, after up
                # to a plan's worth of wasted ingest)
                log(f"estimated ~{est} instances, device plan {plan_rows} "
                    "rows: out-of-core route")
                observer["route"] = "up-front"
                stats = compute_statistics_out_of_core(
                    providers, ids, config, dev,
                    log=log if config.verbose else None,
                    observer=observer, tier=tier, shards=devices,
                )
            else:
                stats = compute_statistics(
                    providers, ids, config, dev,
                    log=log if config.verbose else None,
                    observer=observer, shards=devices,
                )
        metrics.set("route", observer["route"])
        for key in ("sweep_ranges", "spill_tier", "spectrum_rows",
                    "per_sample"):
            if key in observer:
                metrics.set(key, observer[key])
        for name, v in observer["stage_timers"].items():
            metrics.set(f"stage_{name}", round(v, 4))
        total = int(np.sum(stats.dataset_nb_reads))
        metrics.count("reads", total)
        hist = observer["repartition_instances"]
        metrics.set("repartition_histogram", hist.tolist())
        if hist.sum():
            log(
                f"kmer repartition over {len(hist)} hash "
                f"buckets: min {int(hist.min())} "
                f"mean {int(hist.mean())} max {int(hist.max())}"
            )
        log(f"{len(ids)} datasets, {total} reads")

    with span(RUN_STAGES["output"], spans):
        matrices = compute_all_matrices(stats)
        os.makedirs(config.output_dir, exist_ok=True)
        write_all_matrices(config.output_dir, matrices, ids)
    metrics.set("nb_distinct_kmers", stats.nb_distinct_kmers)
    metrics.save(os.path.join(config.output_dir, "simka_metrics.json"))
    if config.verbose:
        print(stats.summary())
    if config.output_tmp_dir and not config.keep_tmp:
        # the reference removes its temporary files unless -keep-tmp
        # (SimkaPotara.hpp:288-315)
        shutil.rmtree(os.path.join(config.output_tmp_dir, "count"),
                      ignore_errors=True)
    log(
        f"wrote {len(matrices)} matrices to {config.output_dir} "
        f"in {spans.seconds(RUN):.2f}s"
    )
    return matrices


def run_data_info(config: SimkaConfig) -> List[Tuple[str, int]]:
    """The reference's -data-info mode (Simka.cpp:30): only compute and
    display input statistics, (id, filtered reads) per dataset. Host
    only: no device is used."""
    from simka_tpu_torch.io.bank import count_dataset_reads

    datasets = parse_input_file(config.input_filename)
    check_input_validity(datasets)
    out = []
    for d in datasets:
        n = count_dataset_reads(
            d.banks,
            config.min_read_size,
            config.min_read_shannon_index,
        )
        out.append((d.id, n))
        if config.verbose:
            print(f"{d.id}: {n} reads")
    return out
