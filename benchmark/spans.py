"""The program's spans on the device trace: where the card's idle time
goes, by what the port's main thread was doing.

``compute_statistics`` records its spans when its observer holds a
``"spans"`` list (``simka_tpu_torch.utils.metrics``): (name, thread id,
start_ns, end_ns, parent) on ``time.perf_counter_ns``, with one
``simka.clock`` span around an empty profiler range of that name. The
range's event, whose interval lies inside the span's, gives the offset
from the program's clock to the trace's; every thread's spans move by
the same offset.

``idle_by_span`` splits each idle stretch of the traced window at the
main thread's span boundaries and gives each piece to the innermost
main-thread span open over it, or to ``unspanned``: a partition of the
idle time that ``idle_share`` reads. ``readings`` gives the numbers the
spans make of traced jobs. Both take the idle stretches as they are
given; ``benchmark/span_runs.py`` makes the traced jobs and the
stretches on the card.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, NamedTuple, Sequence, Tuple

from benchmark import tracing

CLOCK = "simka.clock"
UNSPANNED = "unspanned"
WAIT_H2D, DISPATCH = "simka.ingest.wait_h2d", "simka.ingest.dispatch"
H2D = "simka.ingest.h2d"
# the spans in which the join waits for the device
SYNC = "simka.sync."


class Span(NamedTuple):
    """A program span on the trace's clock (us)."""

    start: float
    end: float
    name: str
    depth: int  # 0 for a root of its thread
    main: bool  # on the thread of its job's root


def _depths(records: Sequence[tuple]) -> List[int]:
    depth: List[int] = []
    for *_, parent in records:  # a parent opens before its children
        depth.append(0 if parent < 0 else depth[parent] + 1)
    return depth


def map_spans(clock_events: Sequence[Tuple[float, float]],
              jobs: Sequence[Sequence[tuple]]) -> List[Span]:
    """Every job's records (``jobs[j]``: its list of span records, its
    root first) on the trace's clock: ``clock_events[j]`` is the trace's
    (start, end) in us of job j's ``simka.clock`` range."""
    if len(clock_events) != len(jobs):
        raise ValueError(f"{len(clock_events)} clock events for "
                         f"{len(jobs)} jobs")
    out = []
    for (cs, ce), records in zip(clock_events, jobs):
        (s, e), = [(r[2], r[3]) for r in records if r[0] == CLOCK]
        off = (cs + ce) / 2 - (s + e) / 2e3
        main = records[0][1]
        for (name, tid, s, e, _), d in zip(records, _depths(records)):
            out.append(Span(s / 1e3 + off, e / 1e3 + off, name, d,
                            tid == main))
    return out


def clock_events(prof) -> List[Tuple[float, float]]:
    """The (start, end) in us of the profile's host ``simka.clock``
    ranges, in order."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return sorted((e.time_range.start, e.time_range.end)
                  for e in prof.events()
                  if e.name == CLOCK and e.device_type != cuda)


def _innermost(spans: Sequence[Span]) -> List[Tuple[float, float, str]]:
    """The main thread's spans as disjoint (start, end, name) pieces,
    each named by the innermost span open over it."""
    main = sorted((s for s in spans if s.main), key=lambda s: s.start)
    times = sorted({t for s in main for t in (s.start, s.end)})
    out, active, i = [], [], 0
    for a, b in zip(times, times[1:]):
        while i < len(main) and main[i].start <= a:
            active.append(main[i])
            i += 1
        active = [s for s in active if s.end > a]
        if active:
            top = max(active, key=lambda s: (s.depth, s.start))
            out.append((a, b, top.name))
    return out


def statistics_spans(trace: tracing.Trace) -> List[Tuple[float, float]]:
    """Each traced job's ``bench.statistics`` span (us)."""
    return [(s, ms) for (s, _), (ms, _) in zip(trace.jobs, trace.matrices)]


def idle_by_span(idle: Sequence[Tuple[float, float]], spans: Sequence[Span],
                 stats: Sequence[Tuple[float, float]]
                 ) -> Tuple[Dict[str, float], float]:
    """The idle stretches ``idle`` (us), split by the main thread's
    ``spans``: (seconds by span name, ``unspanned`` included; the
    unspanned seconds inside the spans ``stats``)."""
    pieces = _innermost(spans)
    starts = [p[0] for p in pieces]
    out: Dict[str, float] = {}
    inside = 0.0

    def add(name, a, b):
        nonlocal inside
        out[name] = out.get(name, 0.0) + (b - a) / 1e6
        if name == UNSPANNED:
            inside += sum(max(0.0, min(b, e) - max(a, s))
                          for s, e in stats) / 1e6

    for s, e in idle:
        t = s
        j = max(bisect.bisect_right(starts, s) - 1, 0)
        while j < len(pieces) and pieces[j][0] < e:
            a, b, name = pieces[j]
            a, b = max(a, s), min(b, e)
            if b > a:
                if a > t:
                    add(UNSPANNED, t, a)
                add(name, a, b)
                t = b
            j += 1
        if e > t:
            add(UNSPANNED, t, e)
    return out, inside


def readings(trace: tracing.Trace, idle: Sequence[Tuple[float, float]],
             clocks: Sequence[Tuple[float, float]],
             jobs: Sequence[dict]) -> dict:
    """The six numbers the program's spans give over the traced jobs
    (``jobs``: each job's observer; ``clocks``: their ``simka.clock``
    events; ``idle``: the trace's idle stretches): the main thread's
    wait for shipped batches and the join's waits for the device (s a
    job), the copies' rate (GB/s: the counter ``h2d_bytes`` over the
    ``simka.ingest.h2d`` spans), and the idle shares (% of the traced
    window) under the wait for batches, the dispatch and the join
    (None unless the trace is complete)."""
    by_name: Dict[str, float] = {}
    for obs in jobs:
        for name, _, s, e, _ in obs["spans"]:
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
    n = len(jobs)
    join_wait = sum(v for k, v in by_name.items() if k.startswith(SYNC))
    h2d_bytes = sum(obs["counters"]["h2d_bytes"] for obs in jobs)
    out = {"h2d_wait_s": by_name.get(WAIT_H2D, 0.0) / n,
           "join_wait_s": join_wait / n,
           "h2d_gbps": (h2d_bytes / by_name[H2D] / 1e9
                        if by_name.get(H2D) else None)}
    by_span, _ = idle_by_span(idle, map_spans(
        clocks, [obs["spans"] for obs in jobs]), statistics_spans(trace))
    window = trace.window_s()
    join = sum(v for k, v in by_span.items()
               if k.startswith(("simka.join", SYNC)))
    out.update(
        idle_h2d_wait_share=100.0 * by_span.get(WAIT_H2D, 0.0) / window,
        idle_dispatch_share=100.0 * by_span.get(DISPATCH, 0.0) / window,
        idle_join_share=100.0 * join / window)
    if not trace.complete():
        for key in ("idle_h2d_wait_share", "idle_dispatch_share",
                    "idle_join_share"):
            out[key] = None
    return out
