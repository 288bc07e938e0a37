"""Structured run metrics: spans, the stage timers summed from them,
and ``simka_metrics.json``.

The reference's observability is per-job log files and progress bars
(SURVEY.md §5); this is the structured replacement: every pipeline run
emits a ``simka_metrics.json`` with its stage times and counters,
suitable for dashboards or regression tracking.

``span`` is the one timer. It marks a layer boundary inside a job
(``core.pipeline``, ``ops.countjoin``, ``core.distances``) and a stage
or step of every route (``core.pipeline``, ``core.sweep``,
``parallel.multihost``). Where the ``Spans`` keeps records it records
the span and adds its nanoseconds to its name's total; where it keeps
none, only a span that a stage timer sums (``TIMED``) is timed, and
every other site does nothing, as with None. Every time is
``time.perf_counter_ns``, one clock for every thread of the process;
``clock_anchor`` places that clock on a ``torch.profiler`` trace.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, Optional

# the name of the empty profiler range that ``clock_anchor`` opens
CLOCK = "simka.clock"
# the in-memory job's stage timers (``Spans.stage_timers``, seconds),
# each the sum of its spans: the parse worker's pulls, the
# ship worker's copies, the main thread's dispatch of each batch, the
# join (from the ingest's end to the statistics: its device waits hold
# the extraction backlog), the main thread's waits for shipped batches,
# the join's waits for the device, and the join's host sums of the
# Kullback-Leibler limbs (one Python sum an N x N entry)
STAGE_SPANS = {
    "parse_pack_s": ("simka.ingest.parse",),
    "h2d_s": ("simka.ingest.h2d",),
    "extract_dispatch_s": ("simka.ingest.dispatch",),
    "join_s": ("simka.join",),
    "h2d_wait_s": ("simka.ingest.wait_h2d",),
    "join_wait_s": ("simka.sync.check", "simka.sync.solid_count",
                    "simka.sync.segments", "simka.sync.kl",
                    "simka.sync.to_numpy"),
    "kl_host_s": ("simka.join.kl_host",),
}
# the out-of-core route's stage timers (seconds): the ingest's, as in
# memory; the count phase (the ingest with every sample's spectrum and
# spill); each sample's spectrum and spill (on a worker thread on the
# host tiers); the sweep's range loads and joins
OUT_OF_CORE_SPANS = {
    "spectrum_s": ("simka.spectra.spectrum",),
    "spill_s": ("simka.spectra.spill",),
    "parse_pack_s": ("simka.ingest.parse",),
    "h2d_s": ("simka.ingest.h2d",),
    "extract_dispatch_s": ("simka.ingest.dispatch",),
    "count_s": ("simka.spectra",),
    "range_load_s": ("simka.sweep.load",),
    "range_join_s": ("simka.sweep.join",),
}
# one sample's steps on the -out-tmp route (``per_sample``, seconds): its
# checkpoint's load, its count, its checkpoint's save, its spill into
# the sweep's files
SAMPLE_SPANS = {
    "load_s": "simka.sample.load",
    "count_s": "simka.sample.count",
    "save_s": "simka.sample.save",
    "spill_s": "simka.sample.spill",
}
# the -out-tmp sweep's timers (the ``sweep_<timer>`` counters, seconds):
# the range loads and joins, and ``SpectrumSpill``'s cuts on the device
# and file writes
SWEEP_SPANS = {
    "range_load_s": ("simka.sweep.load",),
    "range_join_s": ("simka.sweep.join",),
    "partition_s": ("simka.sweep.partition",),
    "write_s": ("simka.sweep.write",),
}
# ``simka_metrics.json``'s ``total_seconds`` and ``stages``
RUN = "simka.run"
RUN_STAGES = {
    "count": "simka.run.count",
    "merge": "simka.run.merge",
    "output": "simka.run.output",
}
# the spans timed where no records are kept: those of every stage timer
TIMED = frozenset(
    [n for timers in (STAGE_SPANS, OUT_OF_CORE_SPANS, SWEEP_SPANS)
     for names in timers.values() for n in names]
    + [*SAMPLE_SPANS.values(), *RUN_STAGES.values(), RUN])


class Spans:
    """What ``span`` records: the nanoseconds spent under each span
    name (``ns``; without records, each name of ``TIMED``), the job's
    counters (``counters``, counted on the job's own thread) and, when
    ``records`` is a list, each span as (name, thread id, start_ns,
    end_ns, parent), in the order the spans opened. ``parent`` is the
    index in ``records`` of the innermost span open on the same thread
    when the span opened, -1 for none; a worker thread of a pool made
    with ``pool_args`` starts under the span its maker had open.
    """

    def __init__(self, records: Optional[list] = None):
        self.records = records
        self.ns: Dict[str, int] = {}
        self.counters: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._local = threading.local()

    def seconds(self, *names: str) -> float:
        """The seconds spent under ``names``, summed."""
        return sum(self.ns.get(n, 0) for n in names) / 1e9

    def stage_timers(self, timers=STAGE_SPANS) -> Dict[str, float]:
        """The timers of ``timers`` (name: its span names), in seconds."""
        return {k: self.seconds(*names) for k, names in timers.items()}

    def count(self, name: str, value: int) -> None:
        self.counters[name] = self.counters.get(name, 0) + int(value)

    def add(self, other: "Spans") -> None:
        """Add ``other``'s span totals to this one's."""
        for name, ns in other.ns.items():
            self.ns[name] = self.ns.get(name, 0) + ns

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _adopt(self, parent: int) -> None:
        self._stack().append(parent)

    def pool_args(self) -> dict:
        """``ThreadPoolExecutor`` arguments under which the pool's
        threads record their spans under the caller's innermost open
        span."""
        if self.records is None:
            return {}
        stack = self._stack()
        return {"initializer": self._adopt,
                "initargs": (stack[-1] if stack else -1,)}


class _Span:
    __slots__ = ("spans", "name", "t0", "i", "parent")

    def __init__(self, spans: Spans, name: str):
        self.spans, self.name = spans, name

    def __enter__(self):
        sp = self.spans
        if sp.records is not None:
            stack = sp._stack()
            self.parent = stack[-1] if stack else -1
            with sp._lock:
                self.i = len(sp.records)
                sp.records.append(None)  # open
            stack.append(self.i)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        sp = self.spans
        with sp._lock:
            sp.ns[self.name] = sp.ns.get(self.name, 0) + t1 - self.t0
        if sp.records is not None:
            sp._stack().pop()
            sp.records[self.i] = (self.name, threading.get_ident(), self.t0,
                                  t1, self.parent)
        return False


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def span(name: str, spans: Optional[Spans]):
    """A context that records the span ``name`` into ``spans``; with
    None, or where ``spans`` keeps no records and no stage timer reads
    ``name``, the one shared context that does nothing."""
    if spans is None or (spans.records is None and name not in TIMED):
        return _NO_SPAN
    return _Span(spans, name)


def clock_anchor(spans: Optional[Spans]) -> None:
    """Where ``spans`` keeps records: the span ``CLOCK`` around one
    empty ``torch.profiler.record_function(CLOCK)``, so that a trace's
    event of that name, whose interval lies inside the span's, gives
    the offset from ``perf_counter_ns`` to the trace's clock. The range
    launches nothing, so it adds no device event to a trace."""
    if spans is None or spans.records is None:
        return
    import torch

    with span(CLOCK, spans), torch.profiler.record_function(CLOCK):
        pass


class Metrics:
    """What ``simka_metrics.json`` holds: ``counters`` (``count``,
    ``set``) and, from ``spans``, the run's seconds (the span ``RUN``,
    from the ``Metrics``' making to its ``save``) and those of each
    stage of ``RUN_STAGES`` that ran."""

    def __init__(self, spans: Spans):
        self.spans = spans
        self.counters: Dict[str, float] = {}
        self._run = span(RUN, spans)
        self._run.__enter__()

    def count(self, name: str, value: float) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + value

    def set(self, name: str, value) -> None:
        self.counters[name] = value

    def save(self, path: str) -> Dict:
        """Close the span ``RUN`` and write the metrics to ``path``."""
        self._run.__exit__(None, None, None)
        ns = self.spans.ns
        data = {
            "total_seconds": round(self.spans.seconds(RUN), 3),
            "stages": {k: round(self.spans.seconds(name), 3)
                       for k, name in RUN_STAGES.items() if name in ns},
            "counters": self.counters,
        }
        with open(path, "w") as f:
            json.dump(data, f, indent=2, sort_keys=True)
        return data
