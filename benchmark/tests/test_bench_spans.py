"""The program's spans against the trace (``benchmark/spans.py``,
``benchmark/span_runs.py``) and the readers that read the program's
span sums.

- On a synthetic profile the idle stretches are those ``idle_gaps``
  measures, and their attribution is a partition: over every label,
  ``unspanned`` included, it sums to the idle time that ``idle_share``
  reads, and each idle stretch goes to the innermost main-thread span
  open over it.
- The readers that were there, and ``breakdown()``, read the same with
  and without the program's events in the profile.
- The new readers read nothing from jobs whose observer has no such
  timer (the parent's), and the idle shares nothing from an incomplete
  trace.
- On the CPU, a toy job's real spans map onto its real profile: the
  attribution covers the window's idle time and leaves next to nothing
  of the job unspanned; the cost of recording is measured under each
  observer.
- On the card (``cuda``): traced jobs that record spans leave the
  trace's device events as they are.
"""

from types import SimpleNamespace

import pytest
import torch

from benchmark import community, harness, registry, span_runs, spans, tracing
from benchmark.tests import toy

CUDA = torch.autograd.DeviceType.CUDA
HOST = torch.autograd.DeviceType.CPU
BASE_NS = 5_000_000_000  # the program's clock where the trace's is 0
LAUNCHES = {"extract_kmers": 1, "compact_rows": 1, "run_counts": 1,
            "segment_stats": 1, "pair_sums": 1}
DEVICE = [("void extract_kmers<1>", 100, 150),
          ("Memcpy HtoD (Pageable -> Device)", 160, 300),
          ("cub::DeviceRadixSortOnesweepKernel", 620, 700),
          ("run_counts<Cols>", 705, 708),
          ("compact_onepass<unsigned char>", 710, 720),
          ("segment_stats<int>", 722, 726),
          ("pair_owner_kernel<true>", 730, 740)]
MAIN, WORKER = 1, 2
# (name, thread, start us, end us, parent)
RECORDS = [("simka.job", MAIN, 10, 990, -1),
           ("simka.clock", MAIN, 12, 14, 0),
           ("simka.ingest", MAIN, 20, 500, 0),
           ("simka.ingest.wait_h2d", MAIN, 30, 100, 2),
           ("simka.ingest.h2d", WORKER, 40, 300, 2),
           ("simka.ingest.dispatch", MAIN, 100, 160, 2),
           ("simka.ingest.wait_h2d", MAIN, 160, 400, 2),
           ("simka.ingest.dispatch", MAIN, 400, 450, 2),
           ("simka.join", MAIN, 500, 980, 0),
           ("simka.join.check", MAIN, 510, 590, 8),
           ("simka.sync.check", MAIN, 520, 585, 9),
           ("simka.join.sort", MAIN, 600, 610, 8)]
# what the idle stretches of the window [0, 1100] go to, in us
WANT = {"unspanned": 10 + 10 + 100, "simka.job": 8 + 10, "simka.clock": 2,
        "simka.ingest": 10 + 50, "simka.ingest.wait_h2d": 70 + 100,
        "simka.ingest.dispatch": 10 + 50,
        "simka.join": 10 + 10 + 10 + 5 + 2 + 2 + 4 + 240,
        "simka.join.check": 10 + 5, "simka.sync.check": 65,
        "simka.join.sort": 10}


def _event(name, start, end, device=HOST):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start, end=end))


class _Profile:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def _events(program: bool):
    """One traced job: the benchmark's spans, its sort, the device
    events, and with ``program`` the program's profiler range and the
    host events of its spans."""
    evs = [_event(tracing.STATISTICS, 0, 1000),
           _event(tracing.MATRICES, 1000, 1100),
           _event(tracing.SORT_OP, 600, 605)]
    evs += [_event(n, s, e, CUDA) for n, s, e in DEVICE]
    if program:
        evs.append(_event(spans.CLOCK, 12.5, 13.5))
        evs += [_event(r[0], r[2], r[3]) for r in RECORDS
                if r[0] != spans.CLOCK]
    return evs


def _records():
    return [(n, t, s * 1000 + BASE_NS, e * 1000 + BASE_NS, p)
            for n, t, s, e, p in RECORDS]


def _trace(program=True):
    return tracing.from_profile(_Profile(_events(program)), [LAUNCHES])


def test_the_idle_attribution_is_a_partition_of_the_idle_time():
    trace = _trace()
    stretches = span_runs.idle_intervals(trace)
    assert [(e - s) / 1e6 for s, e in stretches] == [
        sec for _, sec in trace.idle_gaps()]
    mapped = spans.map_spans([(12.5, 13.5)], [_records()])
    idle, inside = spans.idle_by_span(stretches, mapped,
                                      spans.statistics_spans(trace))
    total = trace.window_s() - trace.busy_s()
    assert abs(sum(idle.values()) - total) < 1e-9
    assert set(idle) == set(WANT)
    for name, us in WANT.items():
        assert idle[name] == pytest.approx(us / 1e6, abs=1e-12), name
    # before the job's root, and after it until the distances
    assert inside == pytest.approx(20 / 1e6, abs=1e-12)


def test_the_clock_span_sets_the_offset():
    mapped = spans.map_spans([(112.5, 113.5)], [_records()])
    job, clock = mapped[0], mapped[1]
    assert (job.start, job.end) == pytest.approx((110, 1090))
    assert (clock.start, clock.end) == pytest.approx((112, 114))
    assert [s.depth for s in mapped[:4]] == [0, 1, 1, 2]
    assert [s.main for s in mapped[3:5]] == [True, False]
    with pytest.raises(ValueError):
        spans.map_spans([], [_records()])


def _context(trace, jobs):
    shapes = {"k": 21, "window_slots": 5000, "instances": 4000,
              "solid_rows": 900, "packed_bytes": 2000, "valid_bytes": 300,
              "batches": 1, "kmers": 700, "n_banks": 4, "pairs": 500,
              "sample_counts": 40, "simple": True, "complex": True}
    return harness.Context(3.0, 1.0, jobs, 1.1, 1 << 30, trace, jobs,
                           shapes)


def _job(timers):
    return harness.Job(0.0011, 0.0001, timers, "in-memory")


PARENT_TIMERS = {"parse_pack_s": 1e-5, "h2d_s": 2e-4,
                 "extract_dispatch_s": 6e-5, "join_s": 4.8e-4}
NEW = ("h2d_wait_s", "h2d_gbps", "join_wait_s")


def test_the_readers_that_were_there_read_the_same_with_program_spans():
    bench = registry.spec()
    job = _job(PARENT_TIMERS)
    with_, without = _context(_trace(True), [job]), _context(
        _trace(False), [job])
    assert with_.trace == without.trace
    assert with_.trace.breakdown() == without.trace.breakdown()
    read = 0
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in NEW:
            continue
        f = registry.reader(m["name"])
        assert f(with_) == f(without), m["name"]
        read += f(with_) is not None
    assert read >= 10  # the kernels' shares and the timers among them


def test_the_new_readers_read_nothing_from_jobs_without_their_timers():
    ctx = _context(_trace(), [_job(PARENT_TIMERS)])
    for name in ("h2d_wait_s", "join_wait_s"):
        assert registry.reader(name)(ctx) is None
    assert registry.reader("h2d_gbps")(_context(_trace(), [_job({})])) is None
    timers = {**PARENT_TIMERS, "h2d_wait_s": 1.7e-4, "join_wait_s": 6.5e-5}
    ctx = _context(_trace(), [_job(timers), _job(timers)])
    assert registry.reader("h2d_wait_s")(ctx) == pytest.approx(1.7e-4)
    assert registry.reader("join_wait_s")(ctx) == pytest.approx(6.5e-5)
    assert registry.reader("h2d_gbps")(ctx) == pytest.approx(2300 / 2e-4
                                                              / 1e9)


def test_the_idle_shares_read_nothing_from_an_incomplete_trace():
    obs = {"spans": _records(), "counters": {"h2d_bytes": 2300}}
    trace = _trace()
    got = spans.readings(trace, span_runs.idle_intervals(trace),
                         [(12.5, 13.5)], [obs])
    assert got["idle_h2d_wait_share"] == pytest.approx(100 * 170 / 1100)
    assert got["idle_dispatch_share"] == pytest.approx(100 * 60 / 1100)
    assert got["idle_join_share"] == pytest.approx(
        100 * (WANT["simka.join"] + 15 + 65 + 10) / 1100)
    assert got["h2d_wait_s"] == pytest.approx(310e-6)
    assert got["h2d_gbps"] == pytest.approx(2300 / 260e-6 / 1e9)
    lost = dict(LAUNCHES, run_counts=2)  # a counted launch not traced
    trace = tracing.from_profile(_Profile(_events(True)), [lost])
    got = spans.readings(trace, span_runs.idle_intervals(trace),
                         [(12.5, 13.5)], [obs])
    assert got["idle_join_share"] is None and got["h2d_wait_s"] > 0


def _runner(tmp_path, device, cell="toy.default_dist"):
    d = toy.bench_dir(tmp_path)
    bench = toy.bench()
    c = registry.cell(bench, cell)
    runner = harness.Runner(registry.config(c["config"], d),
                            registry.traffic(c["traffic"], d), device)
    runner.load(community.draw_community(7, device, **runner.community))
    return runner


def test_a_toy_jobs_spans_map_onto_its_cpu_profile(tmp_path):
    runner = _runner(tmp_path, torch.device("cpu"))
    acts = [torch.profiler.ProfilerActivity.CPU]
    observers = []
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(2):
            observers.append(span_runs.job(runner, "records", True)[1])
    launches = [dict.fromkeys(tracing.KERNELS, 0)] * 2
    trace = tracing.from_profile(prof, launches)
    clocks = spans.clock_events(prof)
    mapped = spans.map_spans(clocks, [o["spans"] for o in observers])
    idle, inside = spans.idle_by_span(span_runs.idle_intervals(trace),
                                      mapped, spans.statistics_spans(trace))
    # no device events on the CPU: the whole window is idle
    assert sum(idle.values()) == pytest.approx(trace.window_s(), abs=1e-9)
    assert idle["simka.ingest.dispatch"] > 0 and idle["simka.join.sort"] > 0
    assert idle["simka.matrices"] > 0
    assert inside < 0.05 * trace.window_s()
    # each job's program root lies inside its bench.statistics span
    roots = [s for s in mapped if s.name == "simka.job"]
    for root, (start, _), (m_start, _) in zip(roots, trace.jobs,
                                              trace.matrices):
        assert start - 20 <= root.start and root.end <= m_start + 20


def test_the_cost_of_recording_is_measured_under_each_observer(tmp_path):
    runner = _runner(tmp_path, torch.device("cpu"))
    got = span_runs.cost(runner, 2, 1)
    assert set(got["turn_means_s"]) == set(span_runs.MODES)
    assert all(len(v) == 2 and min(v) > 0
               for v in got["turn_means_s"].values())
    assert got["median_ratio_to_none"]["none"] == 1.0
    _, obs = span_runs.job(runner, "totals")
    assert "spans" not in obs and obs["stage_timers"]["join_s"] > 0
    assert span_runs.job(runner, "none")[1] is None


@pytest.mark.cuda
def test_recording_spans_leaves_the_device_events_as_they_are(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    runner = _runner(tmp_path, torch.device("cuda", 0))
    for _ in range(2):
        span_runs.job(runner)
    names = {}
    for record in (True, False, True):
        trace, clocks, observers = span_runs.traced_jobs(runner, 3, record)
        names.setdefault(record, []).append(
            sorted(n for _, _, n in trace.device))
        assert len(clocks) == (3 if record else 0)
    assert names[True][0] == names[False][0] == names[True][1]
    assert not any(n.startswith("simka.") for n in names[True][0])
