"""Sketch drivers: seeded bottom-s MinHash with abundances, on one device.

Reference: SelectKmersCommand (src/simkaMin/SimkaMinCount.hpp:89-384)
keeps the s smallest murmur hashes in a streaming max-heap. As
``simka_tpu.minhash.sketch`` shows, its membership is order-free (the s
smallest distinct hashes) and its counts are total occurrences except
for the largest member, whose occurrences after the last smaller
member's heap entry are dropped (the `hash < top` test at
SimkaMinCount.hpp:324 excludes equality); that correction is a closed
form over occurrence positions. `-filter` is the exact total-count >= 2
semantics; a member then enters at its second occurrence.

Routes, as ``simka_tpu``'s (each gives the same sketch):
- batched (``compute_sketches_batched``, two or more samples): every
  sample's kept instances, tagged with its sample id, then one
  ``sketch_multi_prefix``; without -filter a bottom-s hash prefilter
  keeps only hashes below 8 s / (the smallest sample's estimated
  windows) of the hash range. It leaves for the per-sample route when
  the stream outgrows ``instance_limit`` or a prefiltered sample neither
  fills its sketch nor kept all its instances (underfill);
- per sample (``compute_sketch``): one-shot (``sketch_prefix_device``)
  or, past ``stream_threshold`` held instances, streaming: without
  -filter the O(s) fold (``sketch_stream_step``); under -filter the
  held stream is cut to the hashes at or below the s-th smallest hash
  already seen twice, and later batches keep only those (the
  reference's exact host path, ``_compute_sketch_host``, holds the
  whole stream in host memory instead).

Each ingest is ``core.pipeline``'s: a worker parses and packs, another
ships, the main thread extracts and hashes (one batch a sample; the
reference's coalesced batches were sized for a remote TPU link).
Lengths are exact, so no padding or all-ones sentinel needs checking
afterwards, and a prefiltered batch is compacted to the kernel's kept
count, so no slice cap can clip it.

Every driver takes ``device`` ("cuda", the default, or "cpu", or a
``torch.device``) and an ``observer`` dict that receives the route
(``sketch_route``, ``sketch_route_reason``, per-sample
``sample_routes``), the stage times and the instance counts.
"""

from __future__ import annotations

import sys
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from simka_tpu_torch.minhash.device import (
    FULL64,
    SIGN,
    as_device,
    hash_packed_batch,
    hash_packed_sid_batch,
    sketch_multi_prefix,
    sketch_prefix_device,
    sketch_stream_step,
)
from simka_tpu_torch.ops import compact as _compact
from simka_tpu_torch.ops.spectrum import hash_spectrum

# the stage times an observer receives, in seconds (parse_pack_s and
# h2d_s are core.pipeline's ingest timers)
STAGES = ("parse_pack_s", "h2d_s", "hash_s", "prefix_s", "fetch_s",
          "write_s")

Sketch = Tuple[np.ndarray, np.ndarray]


class _Bail(Exception):
    """The batched route leaves for the per-sample one."""


def _sketch_stream_threshold(device: torch.device) -> int:
    """Held instances of one sample above which its sketch streams
    instead of holding the whole hash stream: 1/64 of the device plan
    (an eighth of it at 8 B an instance), at least 2^22."""
    from simka_tpu_torch.core.budget import device_budget_bytes

    return max(device_budget_bytes(device) // 64, 1 << 22)


def _batched_instance_limit(device: torch.device) -> int:
    """Most kept instances the batched route holds at once: the (hash,
    sample id, position) sort operands and their temporaries, about 48 B
    an instance, capped at 2^27."""
    from simka_tpu_torch.core.budget import device_budget_bytes

    return min(max(device_budget_bytes(device) // 48, 1 << 20), 1 << 27)


def _bail(reason: str) -> None:
    print(f"[simka-tpu min] batched sketch fallback: {reason}",
          file=sys.stderr, flush=True)


def _estimate_sample_windows(src) -> "int | None":
    """Crude estimate of one sample's valid k-mer windows from its input
    file sizes (~1 base a byte, gz ~4x; the gatb Bank::estimate role).
    It sets the prefilter's threshold only: an overestimate shows as
    underfill, which leaves for the per-sample route."""
    import os

    banks = getattr(src, "banks", None)
    if not banks:
        return None
    total = 0
    for group in banks:
        for f in group:
            try:
                size = os.path.getsize(f)
            except OSError:
                return None
            if str(f).endswith(".gz"):
                size *= 4
            total += size
    return total


def prefilter_threshold(sources, sketch_size: int,
                        use_filter: bool) -> Tuple[int, float]:
    """(keep bound as int64 bits, kept fraction of the hash range): keep
    hashes below 8 s / (the smallest sample's estimated windows) of the
    range when that is under a quarter; otherwise, and always under
    -filter (whose members are far fewer than s), keep every hash."""
    d_min = None
    for src in sources:
        est = _estimate_sample_windows(src)
        if est is None:
            d_min = None
            break
        d_min = est if d_min is None else min(d_min, est)
    if d_min and d_min > 0 and not use_filter:
        frac = min(8.0 * sketch_size / d_min, 1.0)
        if frac < 0.25:
            return int(frac * (2.0**64)), frac
    return FULL64, 1.0


def _gatb_source(src):
    """A source for the gatb packing: a gatb PackedReadSource as it is
    (the native parser packs gatb codes), any other source as its read
    stream (packed in Python)."""
    if hasattr(src, "iter_packed") and getattr(src, "encoding", "") != "gatb":
        return src.__call__
    return src


def _observer(observer: Optional[dict]) -> dict:
    """``observer`` (a new dict for None) with every stage time and
    count present; it also serves as the ingest's timer dict."""
    obs = {} if observer is None else observer
    for key in STAGES:
        obs.setdefault(key, 0.0)
    obs.setdefault("instances", 0)
    obs.setdefault("kept_instances", 0)
    obs.setdefault("sample_routes", [])
    obs.setdefault("filter_cuts", 0)
    return obs


def _ingest(sources, k: int, batch_reads: int, device, obs, consume):
    """Parse + pack (worker), H2D (worker) and ``consume(sample, packed,
    validbits, n_valid)`` on the main thread, sample after sample; the
    workers' times are added to ``obs``."""
    from simka_tpu_torch.core.pipeline import (
        _packed_batch_stream,
        _pipelined_ingest,
        _shipper,
    )
    from simka_tpu_torch.utils.metrics import Spans

    sources = [_gatb_source(s) for s in sources]
    stream = _packed_batch_stream(
        sources, [str(i) for i in range(len(sources))], k,
        [0] * len(sources), None, batch_reads, encoding="gatb")
    spans = Spans()
    try:
        _pipelined_ingest(stream, _shipper(device, spans), consume, spans)
    finally:
        obs["parse_pack_s"] += spans.seconds("simka.ingest.parse")
        obs["h2d_s"] += spans.seconds("simka.ingest.h2d")


def _batched_device_sketch(sources, kmer_size: int, sketch_size: int,
                           seed: int, use_filter: bool, batch_reads: int,
                           device: torch.device, instance_limit: int,
                           obs: dict) -> dict:
    """Device half of the batched route: ingest, prefilter, one
    ``sketch_multi_prefix``. Returns a bundle holding the prefixes on
    the device; raises _Bail for the per-sample route."""
    n = len(sources)
    thresh, frac = prefilter_threshold(sources, sketch_size, use_filter)
    obs["prefilter_fraction"] = frac
    h_parts, sid_parts = [], []
    inst_total = np.zeros(n, np.int64)
    inst_kept = np.zeros(n, np.int64)

    def consume(sample, packed, vb, _n_valid):
        t0 = time.perf_counter()
        h, sid, nv, nk = hash_packed_sid_batch(packed, vb, sample, thresh,
                                               kmer_size, seed)
        obs["hash_s"] += time.perf_counter() - t0
        inst_total[sample] += nv
        inst_kept[sample] += nk
        obs["instances"] += nv
        obs["kept_instances"] += nk
        h_parts.append(h)
        sid_parts.append(sid)
        total = int(inst_kept.sum())
        if total > instance_limit:
            h_parts.clear()
            sid_parts.clear()
            raise _Bail(f"stream {total} > limit {instance_limit}")

    _ingest(sources, kmer_size, batch_reads, device, obs, consume)
    t0 = time.perf_counter()
    h_all = torch.cat(h_parts) if h_parts else torch.empty(
        0, dtype=torch.int64, device=device)
    h_parts.clear()
    sid_all = torch.cat(sid_parts) if sid_parts else h_all.to(torch.int32)
    sid_parts.clear()
    hashes, counts, n_kept, n_before = sketch_multi_prefix(
        h_all, sid_all, n_samples=n, sketch_size=sketch_size,
        use_filter=use_filter)
    del h_all, sid_all
    obs["prefix_s"] += time.perf_counter() - t0
    if thresh != FULL64:
        # every sample filled its sketch, or lost nothing to the
        # prefilter; otherwise the bound may have cut into a bottom-s
        bad = np.nonzero(~((n_kept >= sketch_size)
                           | (inst_total == inst_kept)))[0]
        if len(bad):
            raise _Bail("prefilter underfill: samples %s (n_kept %s)"
                        % (bad[:5].tolist(), n_kept[bad[:5]].tolist()))
    return {"empty": not n_kept.any(), "n": n, "sketch_size": sketch_size,
            "use_filter": use_filter, "hashes": hashes, "counts": counts,
            "n_kept": n_kept, "n_before": n_before}


def fetch_batched_sketches(bundle: dict) -> List[Sketch]:
    """Host half: the prefixes to the host, cut per sample, each full
    sketch's largest member given its corrected count."""
    n = bundle["n"]
    if bundle["empty"]:
        return [(np.empty(0, np.uint64), np.empty(0, np.uint32))] * n
    s = bundle["sketch_size"]
    n_kept, n_before = bundle["n_kept"], bundle["n_before"]
    hashes_all = bundle["hashes"].cpu().numpy().view(np.uint64)
    cnt_all = bundle["counts"].cpu().numpy().astype(np.int64)
    base_c = 2 if bundle["use_filter"] else 1
    out, off = [], 0
    for i in range(n):
        m = int(min(n_kept[i], s))
        hashes = hashes_all[off: off + m].copy()
        counts = cnt_all[off: off + m].copy()
        if n_kept[i] >= s and m >= 1:
            counts[-1] = max(base_c, int(n_before[i]))
        out.append((hashes, counts.astype(np.uint32)))
        off += m
    return out


def compute_sketches_batched(
    sources,
    kmer_size: int,
    sketch_size: int,
    seed: int,
    use_filter: bool = False,
    batch_reads: int = 1 << 15,
    device="cuda",
    instance_limit: Optional[int] = None,
    observer: Optional[dict] = None,
) -> Optional[List[Sketch]]:
    """Bottom-s sketches of many samples through one
    ``sketch_multi_prefix``: a list of (hashes ascending uint64, counts
    uint32) a sample, or None when the route leaves for the per-sample
    one (the reason on stderr and in ``observer["sketch_route_reason"]``).

    ``sources``: PackedReadSources in gatb encoding (any other source is
    read as a read stream). ``instance_limit`` (default: from the device
    plan) bounds the kept instances held at once.
    """
    dev = as_device(device)
    obs = _observer(observer)
    limit = (_batched_instance_limit(dev) if instance_limit is None
             else instance_limit)
    try:
        bundle = _batched_device_sketch(sources, kmer_size, sketch_size,
                                        seed, use_filter, batch_reads, dev,
                                        limit, obs)
    except _Bail as e:
        _bail(str(e))
        obs["sketch_route_reason"] = str(e)
        return None
    t0 = time.perf_counter()
    out = fetch_batched_sketches(bundle)
    obs["fetch_s"] += time.perf_counter() - t0
    return out


def _to_host(hashes: torch.Tensor, counts: torch.Tensor) -> Sketch:
    return (hashes.cpu().numpy().view(np.uint64).copy(),
            counts.cpu().numpy().astype(np.uint32))


def _filter_cut(stream: torch.Tensor, sketch_size: int):
    """-filter's cut of a held hash stream: (the stream cut to the hashes
    at or below its s-th smallest hash seen twice, that hash as the new
    keep bound), or None when fewer than s hashes were seen twice.

    Exact: counts only grow, so the sample's final members (its s
    smallest hashes seen twice) are at or below the bound, every
    occurrence of them is held, and the cut keeps the held order, which
    is all the heap-entry positions and the largest member's
    correction compare."""
    uniq, counts, _, _ = hash_spectrum(stream)
    seen_twice = uniq[counts >= 2]
    if seen_twice.shape[0] < sketch_size:
        return None
    bound = seen_twice[sketch_size - 1]
    keep = (stream ^ SIGN) <= (bound ^ SIGN)
    (stream,) = _compact.compact_rows((stream,), keep, fills=(FULL64,),
                                      n=int(keep.sum()))
    return stream, int(bound)


def compute_sketch(
    seqs,
    kmer_size: int,
    sketch_size: int,
    seed: int,
    use_filter: bool = False,
    batch_reads: int = 1 << 15,
    device="cuda",
    stream_threshold: Optional[int] = None,
    observer: Optional[dict] = None,
) -> Sketch:
    """Bottom-s sketch of one sample on ``device``: (hashes ascending
    uint64, counts uint32), at most s long.

    ``seqs``: a gatb PackedReadSource, or a list, iterator or zero-arg
    provider of read byte strings. Each batch's valid instance hashes
    stay on the device. Past ``stream_threshold`` held instances
    (default: from the device plan) the sample streams: without -filter
    they fold into the O(s) streaming state; under -filter they are cut
    (``_filter_cut``; ``observer["filter_cuts"]`` counts the cuts) and
    every later batch keeps only hashes at or below the cut's bound. A
    -filter sample with fewer than s hashes seen twice cannot be cut and
    is held whole; it is checked again at twice the held instances.
    """
    dev = as_device(device)
    obs = _observer(observer)
    threshold = (_sketch_stream_threshold(dev) if stream_threshold is None
                 else stream_threshold)
    s = sketch_size
    parts: list = []
    state: list = []  # (st_h, st_c, corr_h, corr_n) once folding
    held = [0, threshold]  # held instances, the next check
    bound = [FULL64]  # -filter's keep bound, lowered by each cut
    streamed = [False]

    def fold():
        if not parts:
            return
        stream = torch.cat(parts)
        parts.clear()
        held[0] = 0
        if not state:
            empty = torch.empty(0, dtype=torch.int64, device=dev)
            state[:] = [empty, empty,
                        torch.tensor(FULL64, dtype=torch.int64, device=dev),
                        torch.tensor(0, dtype=torch.int64, device=dev)]
        t0 = time.perf_counter()
        state[:] = sketch_stream_step(stream, *state, sketch_size=s)
        obs["prefix_s"] += time.perf_counter() - t0

    def cut():
        t0 = time.perf_counter()
        stream = torch.cat(parts)
        parts.clear()
        out = _filter_cut(stream, s)
        if out is not None:
            stream, bound[0] = out
            obs["filter_cuts"] += 1
        parts.append(stream)
        held[0] = stream.shape[0]
        held[1] = max(threshold, 2 * held[0])
        obs["prefix_s"] += time.perf_counter() - t0

    def consume(_sample, packed, vb, _n_valid):
        t0 = time.perf_counter()
        h, nv = hash_packed_batch(packed, vb, kmer_size, seed, bound[0])
        obs["hash_s"] += time.perf_counter() - t0
        obs["instances"] += nv
        obs["kept_instances"] += h.shape[0]
        parts.append(h)
        held[0] += h.shape[0]
        if held[0] >= held[1]:
            streamed[0] = True
            if use_filter:
                cut()
            else:
                fold()

    _ingest([seqs], kmer_size, batch_reads, dev, obs, consume)
    obs["sample_routes"].append("streaming" if streamed[0] else "one-shot")
    if state:
        fold()
        t0 = time.perf_counter()
        st_h, st_c, corr_h, corr_n = state
        hashes, counts = _to_host(st_h, st_c)
        if len(hashes) >= s:
            # the carried correction belongs to the final largest member
            if int(corr_h) != int(st_h[-1]):
                raise RuntimeError(
                    "streaming sketch: the carried correction is not the "
                    "largest member's")
            counts[-1] = max(1, int(corr_n))
        obs["fetch_s"] += time.perf_counter() - t0
        return hashes, counts
    if not parts:
        return np.empty(0, np.uint64), np.empty(0, np.uint32)
    t0 = time.perf_counter()
    stream = torch.cat(parts)
    parts.clear()
    hashes, counts, _, _ = sketch_prefix_device(
        stream, sketch_size=s, use_filter=use_filter)
    del stream
    t1 = time.perf_counter()
    out = _to_host(hashes, counts)
    obs["prefix_s"] += t1 - t0
    obs["fetch_s"] += time.perf_counter() - t1
    return out
