"""Traced jobs with the program's spans, and the cost of recording them,
on the card: what the harness cannot yet measure, since its jobs record
no span records (``harness.Runner.job`` passes ``observer={}``).

``job`` and ``traced_jobs`` make a cell's comparisons as
``harness.Runner.job`` and the harness's traced loop do, with the
program's spans recorded into the observer; ``idle_intervals`` gives the
trace's idle stretches as ``tracing.Trace.idle_gaps`` finds them.
``benchmark/spans.py`` attributes those stretches to the spans. This
file goes once the harness's jobs carry the spans and ``Trace`` gives
its idle stretches.

    python3 -m benchmark.span_runs --workload cami_high.default_dist \\
        --seed 7 --jobs 8 --rounds 8

prints one JSON line: the idle attribution of ``--jobs`` traced jobs,
the six readings of ``spans.readings``, whether the device events of
traced jobs are the same without records, and the cost of recording:
job walls under no observer, an observer without records (what the
harness's jobs pass) and one with records, the profiler off, in rounds
of the three and then the three reversed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

from benchmark import spans, tracing

MODES = ("none", "totals", "records")


def idle_intervals(trace: tracing.Trace) -> List[Tuple[float, float]]:
    """The stretches (us) of the traced window in which the device ran
    nothing: those whose lengths ``Trace.idle_gaps`` gives."""
    lo, hi = trace.window_us
    gaps, end = [], lo
    for s, e, _ in sorted(trace.device):
        s, e = max(s, lo), min(e, hi)
        if e <= lo or s >= hi:
            continue
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if hi > end:
        gaps.append((end, hi))
    return gaps


def job(runner, mode: str = "records", bench_spans: bool = False):
    """One comparison as ``harness.Runner.job`` makes it, the observer
    by ``mode`` (``MODES``: None, ``{}``, or one with a ``"spans"``
    list, the distances' span recorded into it too): (wall seconds,
    observer)."""
    import torch

    from simka_tpu_torch.core import distances, pipeline
    from simka_tpu_torch.utils.metrics import Spans

    def bench(name):
        return (torch.profiler.record_function(name) if bench_spans
                else contextlib.nullcontext())

    obs = {"none": None, "totals": {}, "records": {"spans": []}}[mode]
    t0 = time.perf_counter()
    with bench(tracing.STATISTICS):
        stats = pipeline.compute_statistics(
            runner.sources, runner.ids, runner.sconfig, runner.device,
            batch_reads=runner.batch_reads, observer=obs)
    with bench(tracing.MATRICES):
        distances.compute_all_matrices(
            stats, spans=Spans(obs["spans"]) if mode == "records" else None)
    return time.perf_counter() - t0, obs


def traced_jobs(runner, n: int, record: bool = True):
    """``n`` jobs under ``torch.profiler`` as the harness traces them:
    (their ``Trace``, the profile's clock events, each job's
    observer)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    launches, observers = [], []
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            before = tracing.launch_counts()
            observers.append(
                job(runner, "records" if record else "totals", True)[1])
            after = tracing.launch_counts()
            launches.append({k: after[k] - before[k] for k in after})
    return (tracing.from_profile(prof, launches), spans.clock_events(prof),
            observers)


def cost(runner, rounds: int, jobs_a_turn: int) -> dict:
    """Job walls under each of ``MODES``, the profiler off, in rounds
    of the three, every other round reversed: each mode's turn means
    (s), their medians, and the median over rounds of each mode's turn
    over the round's ``none`` turn."""
    walls: Dict[str, List[float]] = {m: [] for m in MODES}
    for r in range(rounds):
        for mode in (MODES if r % 2 == 0 else MODES[::-1]):
            walls[mode].append(statistics.mean(
                job(runner, mode)[0] for _ in range(jobs_a_turn)))
    return {
        "turn_means_s": walls,
        "median_s": {m: statistics.median(v) for m, v in walls.items()},
        "median_ratio_to_none": {
            m: statistics.median(a / b for a, b in zip(v, walls["none"]))
            for m, v in walls.items()},
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--jobs", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--jobs-a-turn", type=int, default=5)
    a = ap.parse_args(argv)

    import torch

    from benchmark import community, harness, registry

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = registry.cell(registry.spec(), a.workload)
    runner = harness.Runner(registry.config(cell["config"]),
                            registry.traffic(cell["traffic"]), device)
    runner.load(community.draw_community(a.seed, device,
                                         **runner.community))
    for _ in range(harness.WARMUP_JOBS):
        job(runner)
    out = {"workload": a.workload, "seed": a.seed,
           "device": torch.cuda.get_device_name(device)}
    if a.rounds:
        out["cost"] = cost(runner, a.rounds, a.jobs_a_turn)
    trace, clocks, observers = traced_jobs(runner, a.jobs)
    idle = idle_intervals(trace)
    by_span, inside = spans.idle_by_span(
        idle, spans.map_spans(clocks, [o["spans"] for o in observers]),
        spans.statistics_spans(trace))
    window = trace.window_s()
    out.update(
        complete=trace.complete(), window_s=window,
        idle_share=100.0 * (1.0 - trace.busy_s() / window),
        idle_by_span_s=dict(sorted(by_span.items(), key=lambda kv: -kv[1])),
        unspanned_in_statistics_s=inside,
        readings=spans.readings(trace, idle, clocks, observers),
        stage_timers={k: sum(o["stage_timers"][k] for o in observers)
                      / len(observers)
                      for k in observers[0]["stage_timers"]},
        counters=observers[0]["counters"],
        breakdown=trace.breakdown())
    # the device events of traced jobs that record no program span
    plain, _, _ = traced_jobs(runner, a.jobs, record=False)
    out["device_names_equal"] = (sorted(n for *_, n in trace.device)
                                 == sorted(n for *_, n in plain.device))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
