"""End-to-end exact-mode pipeline (the `simka` tool), in memory, on one
device.

host parse + 2-bit pack -> H2D -> per batch: unpack, canonical k-mers,
repartition histogram, compaction of the valid windows -> one join
over the concatenated instance stream -> host statistics, distances
and csv.gz.

Lengths are exact throughout: each batch keeps exactly its valid
windows, so the stream that reaches the join holds only real
instances (no padding classes, no invalid-window sentinel rows).

Every distance (default, -simple-dist, -complex-dist), k from 1 to
127 and the -kmer-shannon-index filter run. Outside this slice, and
raising NotImplementedError (see ROADMAP.md, queue 1): the -out-tmp
checkpoint path (item 9), the out-of-core sweep for runs beyond the
device plan (item 10), and more than one device (item 12).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from simka_tpu_torch import resolve_device
from simka_tpu_torch.config import SimkaConfig
from simka_tpu_torch.core.distances import compute_all_matrices
from simka_tpu_torch.core.output import write_all_matrices
from simka_tpu_torch.core.stats import SimkaStatistics
from simka_tpu_torch.io.dsl import check_input_validity, parse_input_file

N_HIST_BUCKETS = 16


def check_slice(config: SimkaConfig) -> None:
    """Raise NotImplementedError for options the port does not run."""
    todo = []
    if config.output_tmp_dir:
        todo.append("-out-tmp checkpoints (ROADMAP queue 1, item 9)")
    if config.sweep_ranges > 0:
        todo.append("-sweep-ranges out-of-core (ROADMAP queue 1, item 10)")
    if config.n_shards > 1:
        todo.append("-n-shards > 1 (ROADMAP queue 1, item 12)")
    if todo:
        raise NotImplementedError(
            "not ported to simka_tpu_torch yet: " + "; ".join(todo)
        )


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
    dataset_seqs, dataset_ids, k, nb_reads, log, batch_reads, timers
):
    """Yield (sample_id, packed, validbits, n_valid) host batches for
    every dataset: the native parse+filter+2-bit-pack single pass when
    the source is a PackedReadSource (io/packed.py), the Python
    encode+pack otherwise. ``n_valid`` is the exact count of valid
    k-mer windows when the native parser knows it, else None.

    Stage time accumulates in ``timers['parse_pack_s']``."""
    from simka_tpu_torch.io.packed import host_pack_chunk

    for s, src in enumerate(dataset_seqs):
        if log is not None:
            log(f"count [{s + 1}/{len(dataset_seqs)}] {dataset_ids[s]}")
        t0 = time.perf_counter()
        if hasattr(src, "iter_packed"):
            batches = src.iter_packed(batch_reads, k=k)
        else:
            batches = (
                (*host_pack_chunk(chunk, k), len(chunk), None)
                for chunk in _iter_read_chunks(src, batch_reads)
            )
        for packed, vb, n, n_valid in batches:
            nb_reads[s] += n
            timers["parse_pack_s"] += time.perf_counter() - t0
            yield s, packed, vb, n_valid
            t0 = time.perf_counter()


def _pipelined_ingest(stream, ship, consume):
    """Three-stage ingest pipeline: parse/pack (worker A) || H2D ship
    (worker B) || device dispatch (main thread). One batch in flight
    per stage -- parse of batch i+2, ship of batch i+1 and the
    device's extraction of batch i overlap."""
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=1) as parse_ex, \
            ThreadPoolExecutor(max_workers=1) as ship_ex:
        pull = lambda: next(stream, None)  # noqa: E731
        pending = parse_ex.submit(pull)
        shipped = deque()
        while True:
            item = pending.result()
            if item is not None:
                pending = parse_ex.submit(pull)
            if shipped:
                consume(*shipped.popleft().result())
            if item is None:
                break
            shipped.append(ship_ex.submit(ship, item))
        while shipped:
            consume(*shipped.popleft().result())


def extract_windows(
    packed, validbits, sample: int, k: int, n_valid=None,
    min_shannon: float = 0.0,
):
    """One ingest batch on the device: unpack, canonical k-mers, the
    optional k-mer Shannon filter, the repartition histogram and the
    compaction of the kept windows.

    Returns (words, sid [n] int32, hist [16] int64): ``words`` the
    ``n_words(k)`` [n] int64 k-mer words (ops/kmers.py), n the batch's
    exact kept-window count. ``n_valid``, the native parser's count of
    valid windows, spares a device sync when no Shannon filter drops
    windows the parser counted.
    """
    from simka_tpu_torch.ops.compact import compact_rows
    from simka_tpu_torch.ops.kmers import (
        canonical_kmers,
        kmer_shannon_index_words,
        mix_hash_words,
        uint32_words,
        unpack_codes,
    )

    words, valid = canonical_kmers(unpack_codes(packed, validbits), k)
    words = tuple(w.reshape(-1) for w in words)
    valid = valid.reshape(-1)
    if min_shannon > 0.0:
        # compared in f32, as the reference compares its f32 index
        # with the threshold
        thr = torch.tensor(min_shannon, dtype=torch.float32)
        valid &= kmer_shannon_index_words(words, k) >= thr.to(valid.device)
        n_valid = None
    # instances per mix_hash bucket over the reference's uint32 words:
    # its repartition diagnostic, with dropped windows in an extra
    # bucket
    h = mix_hash_words(uint32_words(words, k))
    bucket = torch.where(valid, h & (N_HIST_BUCKETS - 1), N_HIST_BUCKETS)
    hist = torch.bincount(bucket, minlength=N_HIST_BUCKETS + 1)
    n = int(valid.sum()) if n_valid is None else int(n_valid)
    words = compact_rows(words, valid, fills=(-1,) * len(words), n=n)
    sid = torch.full((n,), sample, dtype=torch.int32, device=valid.device)
    return words, sid, hist[:N_HIST_BUCKETS]


def compute_statistics(
    dataset_seqs,
    dataset_ids: List[str],
    config: SimkaConfig,
    device: torch.device,
    batch_reads: int = 1 << 17,
    log=None,
    observer: Optional[dict] = None,
) -> SimkaStatistics:
    """Statistics of every dataset on one device, fully in memory.

    ``dataset_seqs[s]``: a PackedReadSource, a list of read byte
    strings, or a zero-arg provider callable returning an iterator.
    Every k-mer instance stays on ``device`` from extraction through
    the join, and reads stream through in O(batch) host memory; a
    worker thread parses and packs batch i+2 and another ships batch
    i+1 while the device extracts batch i.

    ``observer``, when given, receives ``stage_timers`` and
    ``repartition_instances`` (instances per hash bucket).
    """
    from simka_tpu_torch.core.budget import instance_rows_budget
    from simka_tpu_torch.ops.countjoin import count_join_stats
    from simka_tpu_torch.ops.kmers import n_words

    check_slice(config)
    k = config.kmer_size
    nw = n_words(k)
    nb_reads = [0] * len(dataset_seqs)
    rows_budget = instance_rows_budget(device, nw)
    batches, sids = [], []  # per batch: its k-mer word columns; sids
    hist = torch.zeros(N_HIST_BUCKETS, dtype=torch.int64, device=device)
    state = {"rows": 0}
    timers = {
        "parse_pack_s": 0.0,
        "h2d_s": 0.0,
        "extract_dispatch_s": 0.0,
        "join_s": 0.0,
    }

    stream = _packed_batch_stream(
        dataset_seqs, dataset_ids, k, nb_reads, log, batch_reads, timers
    )

    def ship(item):
        sample, packed, vb, n_valid = item
        t0 = time.perf_counter()
        out = (
            sample,
            torch.from_numpy(packed).to(device),
            torch.from_numpy(vb).to(device),
            n_valid,
        )
        timers["h2d_s"] += time.perf_counter() - t0
        return out

    def consume(sample, packed, vb, n_valid):
        t0 = time.perf_counter()
        words, sid, h = extract_windows(
            packed, vb, sample, k, n_valid, config.min_kmer_shannon_index
        )
        hist.add_(h)
        batches.append(list(words))
        sids.append(sid)
        state["rows"] += sid.shape[0]
        timers["extract_dispatch_s"] += time.perf_counter() - t0
        if state["rows"] > rows_budget:
            raise NotImplementedError(
                f"{state['rows']} k-mer instances exceed the device "
                f"plan of {rows_budget} rows; the out-of-core sweep is "
                "not ported yet (ROADMAP queue 1, item 10)"
            )

    _pipelined_ingest(stream, ship, consume)

    t_join = time.perf_counter()
    words = []
    for i in range(nw):
        words.append(torch.cat([b[i] for b in batches]) if batches
                     else torch.empty(0, dtype=torch.int64, device=device))
        for b in batches:  # the batch copies go as their column exists
            b[i] = None
    sid = torch.cat(sids) if sids else torch.empty(
        0, dtype=torch.int32, device=device
    )
    batches.clear()
    sids.clear()
    js = count_join_stats(
        tuple(words),
        sid,
        config.abundance_min,
        config.abundance_max,
        n_banks=len(dataset_ids),
        kmer_bits=2 * k,
        simple=config.simple_dist,
        complex_=config.complex_dist,
    )
    del words, sid
    stats = SimkaStatistics.from_join_stats(
        js.to_numpy(),
        dataset_ids,
        k,
        np.asarray(nb_reads, np.int64),
        config.simple_dist,
        config.complex_dist,
    )
    # to_numpy waits for the device, so this spans the extraction
    # backlog and the join
    timers["join_s"] = time.perf_counter() - t_join
    if observer is not None:
        observer["stage_timers"] = timers
        observer["repartition_instances"] = hist.cpu().numpy()
    return stats


def run_simka(
    config: SimkaConfig, device: str = "cuda"
) -> Dict[str, np.ndarray]:
    """The `simka` tool: input file -> distance matrices on disk, on
    ``device`` ("cuda" or "cpu"; "cuda" without a GPU raises)."""
    from simka_tpu_torch.io.packed import PackedReadSource
    from simka_tpu_torch.utils.metrics import Metrics

    dev = resolve_device(device)
    metrics = Metrics()
    t0 = time.time()
    datasets = parse_input_file(config.input_filename)
    check_input_validity(datasets)
    ids = [d.id for d in datasets]
    metrics.set("n_datasets", len(ids))
    metrics.set("kmer_size", config.kmer_size)
    metrics.set("device", str(dev))

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

    providers = [
        PackedReadSource(
            d.banks,
            config.min_read_size,
            config.min_read_shannon_index,
            max_reads=cap,
        )
        for d in datasets
    ]
    observer: dict = {}
    with metrics.stage("count"):
        stats = compute_statistics(
            providers, ids, config, dev,
            log=log if config.verbose else None,
            observer=observer,
        )
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

    with metrics.stage("output"):
        matrices = compute_all_matrices(stats)
        os.makedirs(config.output_dir, exist_ok=True)
        write_all_matrices(config.output_dir, matrices, ids)
    metrics.set("nb_distinct_kmers", stats.nb_distinct_kmers)
    metrics.save(os.path.join(config.output_dir, "simka_metrics.json"))
    if config.verbose:
        print(stats.summary())
    log(
        f"wrote {len(matrices)} matrices to {config.output_dir} "
        f"in {time.time() - t0:.2f}s"
    )
    return matrices
