"""Structured run metrics: per-stage wall clock, counters and spans.

The reference's observability is per-job log files and progress bars
(SURVEY.md §5); this is the structured replacement: every pipeline run
can emit a ``simka_metrics.json`` with stage timings and counters,
suitable for dashboards or regression tracking.

``span`` marks a layer boundary inside a job (``core.pipeline``,
``ops.countjoin``, ``core.distances``). Where the ``Spans`` keeps
records it records the span and adds its nanoseconds to its name's
total; where it keeps none, only a span that a stage timer sums
(``STAGE_SPANS``) is timed, and every other site does nothing, as with
None. Every time is ``time.perf_counter_ns``, one clock for every
thread of the process; ``clock_anchor`` places that clock on a
``torch.profiler`` trace.
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
# the spans timed where no records are kept
TIMED = frozenset(n for names in STAGE_SPANS.values() for n in names)


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

    def stage_timers(self) -> Dict[str, float]:
        """``STAGE_SPANS``' timers, in seconds."""
        return {k: self.seconds(*names) for k, names in STAGE_SPANS.items()}

    def count(self, name: str, value: int) -> None:
        self.counters[name] = self.counters.get(name, 0) + int(value)

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


class StageTimer:
    def __init__(self, metrics: "Metrics", stage: str):
        self.metrics = metrics
        self.stage = stage

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.metrics.timings[self.stage] = self.metrics.timings.get(
            self.stage, 0.0
        ) + (time.perf_counter() - self.t0)
        return False


class Metrics:
    def __init__(self):
        self.timings: Dict[str, float] = {}
        self.counters: Dict[str, float] = {}
        self._t_start = time.perf_counter()

    def stage(self, name: str) -> StageTimer:
        return StageTimer(self, name)

    def count(self, name: str, value: float) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + value

    def set(self, name: str, value) -> None:
        self.counters[name] = value

    def finalize(self) -> Dict:
        total = time.perf_counter() - self._t_start
        return {
            "total_seconds": round(total, 3),
            "stages": {k: round(v, 3) for k, v in self.timings.items()},
            "counters": self.counters,
        }

    def save(self, path: str) -> Dict:
        data = self.finalize()
        with open(path, "w") as f:
            json.dump(data, f, indent=2, sort_keys=True)
        return data
