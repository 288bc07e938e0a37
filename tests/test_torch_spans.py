"""The spans and counters of the port's in-memory job on the CPU
(``utils.metrics``, ``core.pipeline``, ``ops.countjoin``,
``core.distances``), on reads made from a seed.

- Without a ``"spans"`` list in the observer nothing is recorded: with
  no observer no span site makes a span, and none enters
  ``torch.profiler.record_function``.
- With one, a one-device job and a job over [cpu] x 2 record every span
  of their layers, each under its parent and on its thread (the
  workers' parse and copy spans on threads of their own, under
  ``simka.ingest``), inside its parent's interval.
- The stage timers are sums of their spans, with and without records,
  on the in-memory route and on the others (the out-of-core route on
  the device and host-memory tiers, the -out-tmp route with the sweep:
  its stages, sweep timers and each sample's steps); without records
  the in-memory job times no other span; the counter ``h2d_bytes``
  counts the batches' bytes, ``ingest_batches`` the batches,
  ``pair_groups`` the pair kernel's sample groups (none on the CPU), and
  ``h2d_pinned_in`` no copy on the CPU.
- Under a CPU ``torch.profiler``, the ``simka.clock`` span places the
  program's clock on the trace's: a span around a torch op, moved by
  the offset, holds the op's event to within 20 us.
"""

import json

import numpy as np
import pytest
import torch

from simka_tpu_torch.config import SimkaConfig
from simka_tpu_torch.core import distances, pipeline
from simka_tpu_torch.ops import countjoin
from simka_tpu_torch.utils import metrics
from simka_tpu_torch.utils.community import write_community

CPU = torch.device("cpu")
K = 21
BATCH_READS = 64
N_SAMPLES = 3
CONFIG = SimkaConfig(kmer_size=K, abundance_min=2, simple_dist=True,
                     complex_dist=True, verbose=False)
# each span's parent, by name, where the job is on one device
PARENTS = {
    "simka.job": None,
    "simka.clock": "simka.job",
    "simka.ingest": "simka.job",
    "simka.ingest.wait_parse": "simka.ingest",
    "simka.ingest.wait_h2d": "simka.ingest",
    "simka.ingest.dispatch": "simka.ingest",
    "simka.ingest.parse": "simka.ingest",
    "simka.ingest.h2d": "simka.ingest",
    "simka.join": "simka.job",
    "simka.join.concat": "simka.join",
    "simka.join.check": "simka.join",
    "simka.sync.check": "simka.join.check",
    "simka.join.sort": "simka.join",
    "simka.join.run_counts": "simka.join",
    "simka.sync.solid_count": "simka.join.run_counts",
    "simka.join.compact": "simka.join",
    "simka.join.segments": "simka.join",
    "simka.sync.segments": "simka.join.segments",
    "simka.join.pair_sums": "simka.join",
    "simka.join.finish": "simka.join",
    "simka.sync.kl": "simka.join.finish",
    "simka.join.kl_host": "simka.join.finish",
    "simka.join.host_stats": "simka.join",
    "simka.sync.to_numpy": "simka.join.host_stats",
    "simka.matrices": None,
}
# the sharded join records its own steps but not the one-device join's
SHARDED = {n: p for n, p in PARENTS.items()
           if not n.startswith(("simka.join.", "simka.sync."))
           or n in ("simka.join.host_stats", "simka.sync.to_numpy")}
WORKER_SPANS = ("simka.ingest.parse", "simka.ingest.h2d")


def _samples(seed: int):
    """Reads of 80 bases from one 3,000-base genome, 150 a sample."""
    rng = np.random.default_rng(seed)
    genome = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 3000)]
    return [[genome[p:p + 80].tobytes()
             for p in rng.integers(0, 3000 - 80, 150)]
            for _ in range(N_SAMPLES)]


def _job(observer, shards=None, seed=3):
    ids = [f"S{s}" for s in range(N_SAMPLES)]
    stats = pipeline.compute_statistics(
        _samples(seed), ids, CONFIG, CPU, batch_reads=BATCH_READS,
        observer=observer, shards=shards)
    spans = None
    if observer is not None and "spans" in observer:
        spans = metrics.Spans(observer["spans"])
    return stats, distances.compute_all_matrices(stats, spans=spans)


def _seconds(records, name):
    return sum(e - s for n, _, s, e, _ in records if n == name) / 1e9


def test_a_span_without_a_recorder_is_one_shared_context():
    a, b = metrics.span("simka.join", None), metrics.span("simka.x", None)
    assert a is b and type(a).__slots__ == ()
    with a as entered:
        assert entered is a


@pytest.mark.parametrize("observer", [None, {}], ids=["none", "empty"])
def test_without_a_spans_list_nothing_is_recorded(observer, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    if observer is None:  # no span site makes a span
        monkeypatch.setattr(metrics._Span, "__init__", refuse)
    stats, _ = _job(observer)
    assert stats.nb_distinct_kmers > 0
    if observer is not None:
        assert "spans" not in observer and observer["route"] == "in-memory"
        assert observer["stage_timers"]["join_s"] > 0
        assert observer["counters"]["h2d_bytes"] > 0


@pytest.mark.parametrize("shards,parents", [(None, PARENTS),
                                            ([CPU] * 2, SHARDED)],
                         ids=["one-device", "cpu-x2"])
def test_every_span_is_recorded_under_its_parent(shards, parents):
    obs = {"spans": []}
    _job(obs, shards)
    records = obs["spans"]
    assert all(isinstance(r, tuple) and len(r) == 5 for r in records)
    names = [r[0] for r in records]
    assert set(names) == set(parents)
    main = records[0][1]
    assert records[0][0] == "simka.job" and records[0][4] == -1
    workers = {}
    for name, tid, start, end, parent in records:
        assert start <= end
        want = parents[name]
        if want is None:
            assert parent == -1, name
            continue
        p_name, p_tid, p_start, p_end, _ = records[parent]
        assert p_name == want, name
        assert p_start <= start and end <= p_end, name
        if name in WORKER_SPANS:
            workers.setdefault(name, set()).add(tid)
        else:
            assert tid == main == p_tid, name
    # one worker thread a stage, neither the main thread
    assert all(len(t) == 1 for t in workers.values())
    assert len({main, *workers["simka.ingest.parse"],
                *workers["simka.ingest.h2d"]}) == 3
    assert names.count("simka.ingest.parse") == names.count(
        "simka.ingest.h2d") + 1  # the last pull finds the stream's end
    assert names.count("simka.clock") == 1


def _recording(monkeypatch):
    """Every ``Spans`` the pipeline makes keeps records; returns them,
    in the order made."""
    made = []

    class Recording(metrics.Spans):
        def __init__(self, records=None):
            super().__init__([] if records is None else records)
            made.append(self)

    monkeypatch.setattr(pipeline, "Spans", Recording)
    return made


def _in_memory_timers(shards, monkeypatch, tmp_path):
    obs = {"spans": []}
    _job(obs, shards)
    timers, records = obs["stage_timers"], obs["spans"]
    for key, name in (("parse_pack_s", "simka.ingest.parse"),
                      ("h2d_s", "simka.ingest.h2d"),
                      ("extract_dispatch_s", "simka.ingest.dispatch"),
                      ("join_s", "simka.join"),
                      ("h2d_wait_s", "simka.ingest.wait_h2d")):
        assert timers[key] == pytest.approx(_seconds(records, name),
                                            rel=1e-12), key
        assert timers[key] > 0, key
    syncs = {r[0] for r in records if r[0].startswith("simka.sync.")}
    assert syncs == ({"simka.sync.to_numpy"} if shards else {
        "simka.sync.check", "simka.sync.solid_count", "simka.sync.segments",
        "simka.sync.kl", "simka.sync.to_numpy"})
    assert timers["join_wait_s"] == pytest.approx(
        sum(_seconds(records, n) for n in syncs), rel=1e-12)
    assert 0 < timers["join_wait_s"] < timers["join_s"]
    # the KL limbs' host sums: the one-device join's finish alone
    assert timers["kl_host_s"] == pytest.approx(
        _seconds(records, "simka.join.kl_host"), rel=1e-12)
    assert (timers["kl_host_s"] > 0) == (shards is None)


def _out_of_core_timers(tier, monkeypatch, tmp_path):
    made = _recording(monkeypatch)
    obs = {}
    pipeline.compute_statistics_out_of_core(
        _samples(3), [f"S{s}" for s in range(N_SAMPLES)], CONFIG, CPU,
        batch_reads=BATCH_READS, observer=obs, tier=tier)
    route, *steps = made
    assert len(steps) == N_SAMPLES and obs["spill_tier"] == tier
    records = [r for sp in made for r in sp.records]
    timers = obs["stage_timers"]
    assert set(timers) == set(metrics.OUT_OF_CORE_SPANS)
    for key, names in metrics.OUT_OF_CORE_SPANS.items():
        assert timers[key] == pytest.approx(
            sum(_seconds(records, n) for n in names), rel=1e-12), key
        assert timers[key] > 0, key
    # each sample's steps are its own spans, inside the count phase
    (c0, c1), = [(r[2], r[3]) for r in route.records
                 if r[0] == "simka.spectra"]
    for step, got in zip(steps, obs["per_sample"]):
        want = {"spectrum_s": "simka.spectra.spectrum"}
        if tier != "device":
            want["spill_s"] = "simka.spectra.spill"
        assert set(got) == {"id", "rows", *want}
        for key, name in want.items():
            assert got[key] == round(_seconds(step.records, name), 4), key
        assert all(c0 <= r[2] <= r[3] <= c1 for r in step.records)


def _out_tmp_timers(_, monkeypatch, tmp_path):
    made = _recording(monkeypatch)
    inp = write_community(str(tmp_path / "c"), seed=5, n_samples=N_SAMPLES,
                          n_genomes=2, genome_len=2000,
                          reads_per_sample=150)
    out = tmp_path / "out"
    pipeline.run_simka(SimkaConfig(
        input_filename=inp, output_dir=str(out), kmer_size=K,
        abundance_min=2, simple_dist=True, complex_dist=True,
        verbose=False, output_tmp_dir=str(tmp_path / "tmp"),
        sweep_ranges=3), "cpu")
    with open(out / "simka_metrics.json") as f:
        m = json.load(f)
    run, *steps = made
    assert len(steps) == N_SAMPLES
    assert m["total_seconds"] == round(_seconds(run.records, metrics.RUN),
                                       3)
    assert m["stages"] == {k: round(_seconds(run.records, n), 3)
                           for k, n in metrics.RUN_STAGES.items()}
    c = m["counters"]
    for key, (name,) in metrics.SWEEP_SPANS.items():
        assert c[f"sweep_{key}"] == round(_seconds(run.records, name), 4)
        assert c[f"sweep_{key}"] > 0, key
    for step, got in zip(steps, c["per_sample"]):
        assert set(got) == {"id", "resumed", "rows", *metrics.SAMPLE_SPANS}
        for key, name in metrics.SAMPLE_SPANS.items():
            assert got[key] == round(_seconds(step.records, name), 4), key


ROUTES = {
    "one-device": (_in_memory_timers, None),
    "cpu-x2": (_in_memory_timers, [CPU] * 2),
    "out-of-core-device": (_out_of_core_timers, "device"),
    "out-of-core-ram": (_out_of_core_timers, "ram"),
    "out-tmp-sweep": (_out_tmp_timers, None),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_stage_timers_are_sums_of_their_spans(route, monkeypatch, tmp_path):
    check, arg = ROUTES[route]
    check(arg, monkeypatch, tmp_path)


def test_without_records_only_the_stage_timers_spans_are_timed(monkeypatch):
    made = []

    class Kept(metrics.Spans):
        def __init__(self, records=None):
            super().__init__(records)
            made.append(self)

    monkeypatch.setattr(pipeline, "Spans", Kept)
    obs = {}
    _job(obs)
    sp, = made
    assert sp.records is None and set(sp.ns) == {
        n for names in metrics.STAGE_SPANS.values() for n in names}
    assert obs["stage_timers"] == sp.stage_timers()
    assert set(obs["stage_timers"]) == set(metrics.STAGE_SPANS)
    for name in set(PARENTS) - metrics.TIMED:
        assert metrics.span(name, sp) is metrics.span(name, None), name


def _batches():
    """Each host batch of the job's samples, as the stream yields them."""
    return list(pipeline._packed_batch_stream(
        _samples(3), [""] * N_SAMPLES, K, [0] * N_SAMPLES, None,
        BATCH_READS))


@pytest.mark.parametrize("shards", [None, [CPU] * 2],
                         ids=["one-device", "cpu-x2"])
def test_counters_count_the_batches_and_the_rows(shards):
    obs = {}
    _job(obs, shards)
    batches = _batches()
    # each batch once, however many shards share its device; the
    # one-device join's plain pair sums launch no kernel: no group; a
    # CPU device copies nothing page-locked
    want = {"h2d_bytes": sum(p.nbytes + v.nbytes for _, p, v, _ in batches),
            "ingest_batches": len(batches), "h2d_pinned_in": 0}
    if shards is None:
        want["pair_groups"] = 0
    assert obs["counters"] == want
    assert len(batches) == N_SAMPLES * -(-150 // BATCH_READS)


def _mapped(records, clock_event):
    """The records on the trace's clock (us): the offset makes the
    ``simka.clock`` span's midpoint the clock event's."""
    (s, e), = [(r[2], r[3]) for r in records if r[0] == metrics.CLOCK]
    off = (clock_event.time_range.start + clock_event.time_range.end) / 2 \
        - (s + e) / 2e3
    return {r[0]: (r[2] / 1e3 + off, r[3] / 1e3 + off) for r in records}


def test_the_clock_span_maps_program_spans_onto_the_trace():
    obs = {"spans": []}
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        _job(obs)
    events = prof.events()
    clock, = [e for e in events if e.name == metrics.CLOCK]
    spans = _mapped(obs["spans"], clock)
    sort, = [e for e in events if e.name == "aten::sort"]
    s, e = spans["simka.join.sort"]
    assert s - 20 <= sort.time_range.start <= sort.time_range.end <= e + 20
    # the job's own span holds every event of the job's thread
    s, e = spans["simka.job"]
    for ev in events:
        if ev.name in ("aten::sort", "aten::cat", metrics.CLOCK):
            assert s - 20 <= ev.time_range.start
            assert ev.time_range.end <= e + 20


def test_spans_of_many_threads_keep_their_slots():
    """Threads that open and close spans at once each get a slot of
    their own, with every record closed and nested on its thread."""
    import sys
    import threading

    records = []
    sp = metrics.Spans(records)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(200):
                with metrics.span("outer", sp), metrics.span("inner", sp):
                    pass

        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert len(records) == 8 * 200 * 2
    assert all(r is not None for r in records)
    for name, tid, _, _, parent in records:
        if name == "inner":
            assert records[parent][0] == "outer"
            assert records[parent][1] == tid
        else:
            assert parent == -1
    for name in ("outer", "inner"):  # no total lost an update
        assert sp.ns[name] == sum(e - s for n, _, s, e, _ in records
                                  if n == name)


def test_count_join_stats_records_nothing_by_default(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span made")

    monkeypatch.setattr(metrics._Span, "__init__", refuse)
    rng = np.random.default_rng(1)
    words = torch.from_numpy(rng.integers(0, 1 << 20, 500))
    sid = torch.from_numpy(rng.integers(0, 3, 500).astype(np.int32))
    js = countjoin.count_join_stats(words, sid, 1, 100, n_banks=3,
                                    kmer_bits=42, complex_=True)
    assert int(js.nb_distinct) > 0
