"""The traced jobs: the device events of ``torch.profiler``, the
benchmark's host spans, and the program's launch counters, job by job.

``torch.profiler`` can lose the device events of launches made through
ctypes. So a kernel's device time counts only where, in every traced
job, the trace holds one event a launch that the program's counter
made; the device's idle share counts only where that holds for every
counted kernel and for the sort.
"""

from __future__ import annotations

import dataclasses
import importlib
import re
from typing import Dict, List, Optional, Tuple

from benchmark import yardstick

# the port's hand kernels: the pattern of their device events' names
# (csrc/*.cu's __global__ functions) and the launch counter the
# program keeps for each (module, attribute)
KERNELS = {
    "extract_kmers": (r"\bextract_kmers\b", ("simka_tpu_torch.ops.kmers",
                                             "launches")),
    "compact_rows": (r"\bcompact_onepass\b", ("simka_tpu_torch.ops.compact",
                                              "launches")),
    "run_counts": (r"\brun_counts\b", ("simka_tpu_torch.ops.countjoin",
                                       "run_counts_launches")),
    "segment_stats": (r"\bsegment_stats\b", ("simka_tpu_torch.ops.countjoin",
                                             "segment_stats_launches")),
    "pair_sums": (r"\bpair_(owner|global)_kernel\b",
                  ("simka_tpu_torch.ops.countjoin", "launches")),
}
# torch.sort's device kernels (cub's radix sort); the program keeps no
# counter of sorts, and one job makes one sort at k <= 31
SORT = r"RadixSort"
# the benchmark's host spans of one job, around the program's calls
STATISTICS, MATRICES = "bench.statistics", "bench.matrices"
SORT_OP = "aten::sort"

Interval = Tuple[float, float, str]


def launch_counts() -> Dict[str, int]:
    """The program's launch counters now."""
    out = {}
    for name, (_, (module, attr)) in KERNELS.items():
        out[name] = int(getattr(importlib.import_module(module), attr))
    return out


@dataclasses.dataclass
class Trace:
    """What the profiler saw of the traced jobs, in its microseconds."""

    device: List[Interval]  # every device event
    jobs: List[Tuple[float, float]]  # each job's host span
    matrices: List[Tuple[float, float]]  # each job's distance span
    sorts: List[float]  # host starts of the program's torch.sort calls
    launches: List[Dict[str, int]]  # each job's launches by kernel

    @property
    def window_us(self) -> Tuple[float, float]:
        return self.jobs[0][0], self.jobs[-1][1]

    def _per_job(self, pattern: str) -> List[List[Interval]]:
        rx = re.compile(pattern)
        return [[iv for iv in self.device if rx.search(iv[2])
                 and s <= iv[0] and iv[1] <= e] for s, e in self.jobs]

    def kernel_s(self, kernel: str) -> Optional[float]:
        """The kernel's device seconds over the traced jobs, or None
        unless every job's trace holds one event a counted launch (and
        some launch was counted)."""
        per_job = self._per_job(KERNELS[kernel][0])
        counts = [n[kernel] for n in self.launches]
        if not any(counts) or [len(e) for e in per_job] != counts:
            return None
        return sum(e - s for evs in per_job for s, e, _ in evs) / 1e6

    def sort_s(self) -> Optional[float]:
        """The sort's device seconds over the traced jobs, or None unless
        every job's trace holds the same number (> 0) of its kernels."""
        per_job = self._per_job(SORT)
        if len({len(e) for e in per_job}) != 1 or not per_job[0]:
            return None
        return sum(e - s for evs in per_job for s, e, _ in evs) / 1e6

    def complete(self) -> bool:
        """Every counted launch and every sort is in the trace."""
        return self.sort_s() is not None and all(
            self.kernel_s(k) is not None or not any(
                n[k] for n in self.launches) for k in KERNELS)

    def _clipped(self) -> List[Interval]:
        lo, hi = self.window_us
        return [(max(s, lo), min(e, hi), n) for s, e, n in self.device
                if e > lo and s < hi]

    def busy_s(self) -> float:
        """Seconds of the traced window in which the device ran an event."""
        return yardstick.union_us(self._clipped()) / 1e6

    def window_s(self) -> float:
        lo, hi = self.window_us
        return (hi - lo) / 1e6

    def label(self, t: float) -> str:
        """What the host was doing at ``t``: the job's ingest (before its
        sort), its join, its distances, or the time between jobs."""
        for j, (s, e) in enumerate(self.jobs):
            if s <= t <= e:
                ms, me = self.matrices[j]
                if ms <= t <= me:
                    return "matrices"
                started = [x for x in self.sorts if s <= x <= t]
                return "join" if started else "ingest"
        return "between jobs"

    def idle_gaps(self) -> List[Tuple[str, float]]:
        """(what the host was doing, seconds) of each stretch of the
        traced window in which the device ran nothing."""
        lo, hi = self.window_us
        gaps, end = [], lo
        for s, e, _ in sorted(self._clipped()):
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        if hi > end:
            gaps.append((end, hi))
        return [(self.label((s + e) / 2), (e - s) / 1e6) for s, e in gaps]

    def breakdown(self, n: int = 10) -> dict:
        """The device operations with the most time and the longest idle
        stretches, by what the host was doing: seconds over the traced
        window."""
        ops = [[name[:160], t / 1e6] for t, _, name in
               yardstick.top_events(self._clipped(), n)]
        by_label: Dict[str, float] = {}
        gaps = self.idle_gaps()
        for label, sec in gaps:
            by_label[label] = by_label.get(label, 0.0) + sec
        idle = [[f"all idle: {k}", v] for k, v in
                sorted(by_label.items(), key=lambda kv: -kv[1])]
        longest = sorted(gaps, key=lambda g: -g[1])[:max(0, n - len(idle))]
        idle += [[f"longest: {label}", sec] for label, sec in longest]
        return {"device_ops": ops, "idle_gaps": idle[:n]}


def from_profile(prof, launches: List[Dict[str, int]]) -> Trace:
    """The ``Trace`` of a finished ``torch.profiler.profile`` over jobs
    whose launches by kernel were ``launches``."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, jobs, mats, sorts = [], [], [], []
    for e in prof.events():
        s, t, name = e.time_range.start, e.time_range.end, e.name
        if e.device_type == cuda:
            if not name.startswith("bench."):  # the spans' device shadows
                device.append((s, t, name))
        elif name == STATISTICS:
            jobs.append((s, t))
        elif name == MATRICES:
            mats.append((s, t))
        elif name == SORT_OP:
            sorts.append(s)
    jobs.sort()
    mats.sort()
    if len(jobs) != len(launches) or len(mats) != len(jobs):
        raise RuntimeError(f"the trace holds {len(jobs)} jobs' spans, "
                           f"{len(launches)} were traced")
    # a job's span: from its statistics to the end of its distances
    spans = [(s, me) for (s, _), (_, me) in zip(jobs, mats)]
    return Trace(device, spans, mats, sorted(sorts), launches)
