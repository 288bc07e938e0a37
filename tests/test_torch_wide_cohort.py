"""The benchmark's wide cohort (``benchmark/configs/cami2_mouse_gut_k21.json``,
64 samples) on the port, from reads made from a seed:

- the program's CPU path, fed as the harness feeds it (``harness.Runner``:
  the program's parser and packer, then replayed batches, two a
  sample), against the plain reference (``benchmark/reference.py``) at
  the cell's N, k and read length, for both traffic mixes;
- the pair kernel's plan at N = 64 and N = 100 with every channel at an
  H100's budget: the shared form in sample groups;
- what a job's observer holds (the counters ``ingest_batches`` and
  ``pair_groups``, the stage timer ``kl_host_s``), and that a job with
  no observer records nothing;
- the readers of the per-layer metrics the cell adds, on a toy
  ``harness.Context``;
- on the card (``cuda``-marked, skipped without one): the pair kernel's
  grouped shared form at N = 64 against its global form and the plain
  version, and a wide job's recorded ``pair_groups`` against the plan.

The file imports no JAX, so its ``cuda`` tests run on the card."""

import numpy as np
import pytest
import torch

from benchmark import community, harness, reference, registry, yardstick
from simka_tpu_torch.core import pipeline
from simka_tpu_torch.ops import countjoin
from simka_tpu_torch.utils import metrics

CPU = torch.device("cpu")
CONFIG = "cami2_mouse_gut_k21"
N = 64
# the toy cohort: the cell's configuration with small genomes and a few
# hundred reads a sample, in batches of fewer reads than a sample has
TOY_COMMUNITY = {"elements": [[6, 2000]], "reads_per_sample": 300}
TOY_BATCH_READS = 256
# bytes of partials a CTA of the pair kernel may hold on an H100 with the
# KL limbs on (csrc/pair_sums.cu, simka_pair_sums_budget): the 227 KiB
# opt-in shared memory less 128 static bytes and the row stage and K
BUDGET_H100 = {64: 198_784, 100: 198_352}


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """torch on one CPU thread for this module, restored after it. A
    job's three threads (the main, parse and ship threads) each open a
    team of torch's default threads, one a core, for every CPU op; where
    other processes share the cores, the teams' barriers wait on
    descheduled threads: a 64-sample case took minutes beside five
    8-thread loads that takes seconds alone, and seconds on one thread
    beside them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _runner(mix: str, device=CPU):
    cfg = registry.config(CONFIG)
    cfg = {**cfg, "community": {**cfg["community"], **TOY_COMMUNITY},
           "batch_reads": TOY_BATCH_READS}
    return harness.Runner(cfg, registry.traffic(mix), device)


def _loaded(mix: str, seed: int, device=CPU):
    runner = _runner(mix, device)
    samples = community.draw_community(seed, device, **runner.community)
    runner.load(samples)
    return runner, samples


@pytest.mark.parametrize("mix", ["default_dist", "all_dist"])
def test_the_cpu_path_agrees_with_the_reference_at_64_samples(mix):
    runner, samples = _loaded(mix, 2**31 + 64)
    assert runner.k == 21 and len(runner.sources) == N
    assert [len(s.batches) for s in runner.sources] == [2] * N
    job, stats, mats = runner.job(spans=False)
    assert job.error is None and job.route == "in-memory"
    o = runner.options
    simple, complex_ = bool(o.get("simple_dist")), bool(o.get("complex_dist"))
    ref, ref_mats = reference.answer(
        samples, runner.k, o["abundance_min"], o["abundance_max"], simple,
        complex_, CPU)
    assert ref["shapes"]["n_banks"] == N and ref["shapes"]["pairs"] > 0
    assert set(mats) == set(ref_mats)
    got = reference.compare(stats, mats, ref, ref_mats, simple, complex_)
    assert got["stat_mismatch"] == 0
    assert got["matrix_gap"] <= 1e-15


@pytest.mark.parametrize("n_banks,groups", [
    (64, (0, 20, 64)),
    (100, (0, 15, 32, 54, 100)),
])
def test_every_channel_at_a_wide_n_takes_sample_groups_on_an_h100(n_banks,
                                                                   groups):
    budget = BUDGET_H100[n_banks]
    plan = countjoin.pair_plan(n_banks, 13, True, budget, n_banks)
    assert plan.form == "shared" and plan.groups == groups
    assert plan.team_warps == countjoin.PAIR_WARPS  # one team
    assert 0 < plan.smem <= budget
    assert countjoin.pair_groups(plan) == len(groups) - 1 >= 2


def test_pair_groups_counts_a_plans_sample_groups():
    assert countjoin.pair_groups(None) == 0
    assert countjoin.pair_groups(countjoin.GLOBAL_PLAN) == 0
    assert countjoin.pair_groups(
        countjoin.pair_plan(8, 4, False, 214_000, 8)) == 1


@pytest.mark.parametrize("mix", ["default_dist", "all_dist"])
def test_a_wide_jobs_observer_holds_its_batches_groups_and_kl_time(mix):
    runner, _ = _loaded(mix, 7)
    obs: dict = {}
    pipeline.compute_statistics(runner.sources, runner.ids, runner.sconfig,
                                CPU, batch_reads=TOY_BATCH_READS,
                                observer=obs)
    assert obs["route"] == "in-memory"
    # two batches a sample; the plain pair sums launch no kernel
    assert obs["counters"]["ingest_batches"] == 2 * N
    assert obs["counters"]["pair_groups"] == 0
    kl_host_s = obs["stage_timers"]["kl_host_s"]
    assert (kl_host_s > 0) == (mix == "all_dist")
    assert kl_host_s < obs["stage_timers"]["join_s"]


def test_a_wide_job_without_an_observer_records_nothing(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span or a recorder was made")

    runner, _ = _loaded("all_dist", 7)
    monkeypatch.setattr(metrics._Span, "__init__", refuse)
    monkeypatch.setattr(pipeline, "Spans", refuse)
    monkeypatch.setattr(metrics.Spans, "count", refuse)
    stats = pipeline.compute_statistics(
        runner.sources, runner.ids, runner.sconfig, CPU,
        batch_reads=TOY_BATCH_READS)
    assert stats.nb_distinct_kmers > 0


class _Trace:
    """A trace that gives the pair kernel's device seconds alone."""

    def __init__(self, pair_s):
        self.pair_s = pair_s

    def kernel_s(self, name):
        return self.pair_s if name == "pair_sums" else None


def _context(jobs, trace=None, batches=64):
    shapes = {"k": 21, "batches": batches, "solid_rows": 9000,
              "kmers": 7000, "n_banks": N, "pairs": 5000,
              "sample_counts": 400, "simple": True, "complex": True}
    return harness.Context(3.0, 1.0, jobs, 1.1, 1 << 30, trace, jobs, shapes)


def _job(**timers):
    return harness.Job(0.2, 0.01, timers, "in-memory")


def test_kl_host_s_reads_the_traced_jobs_mean_and_nothing_without_it():
    read = registry.reader("kl_host_s")
    assert read(_context([_job(kl_host_s=0.010), _job(kl_host_s=0.014)])
                ) == pytest.approx(0.012)
    # a job of a program without the timer
    assert read(_context([_job(kl_host_s=0.01), _job(join_s=0.05)])) is None
    assert read(_context([])) is None


def test_dispatch_per_batch_ms_is_a_jobs_dispatch_over_its_batches():
    read = registry.reader("dispatch_per_batch_ms")
    jobs = [_job(extract_dispatch_s=0.030), _job(extract_dispatch_s=0.034)]
    assert read(_context(jobs, batches=64)) == pytest.approx(0.5)
    assert read(_context(jobs, batches=30)) == pytest.approx(32 / 30)
    assert read(_context(jobs, batches=0)) is None
    assert read(_context([_job(join_s=0.05)])) is None


def test_wide_pair_sums_roofline_reads_as_pair_sums_roofline():
    read = registry.reader("wide_pair_sums_roofline")
    jobs = [_job(), _job()]
    ctx = _context(jobs, _Trace(0.004))
    ms, _ = yardstick.pair_sums_bound(9000, 7000, N, 5000,
                                      yardstick.pair_channels(True, True),
                                      True, 400)
    assert read(ctx) == pytest.approx(100.0 * ms / 1e3 * 2 / 0.004)
    assert read(ctx) == registry.reader("pair_sums_roofline")(ctx)
    assert read(_context(jobs, _Trace(None))) is None
    assert read(_context(jobs, None)) is None


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _seed_rows(n_segs: int, cmax: int, seed: int, dev):
    """Solid rows of ``n_segs`` k-mers over N samples in (k-mer, sample)
    order, as (sid, count, starts, seg_len, K): singletons, every sample
    and 2..N samples; counts in [1, cmax], one in 20 at cmax."""
    rng = np.random.default_rng(seed)
    kind = rng.choice(3, size=n_segs, p=(0.1, 0.4, 0.5))
    kind[:2] = (0, 1)
    lens = np.where(kind == 0, N, np.where(
        kind == 1, 1, rng.integers(2, N + 1, size=n_segs)))
    sid = np.concatenate([np.sort(rng.choice(N, n, replace=False))
                          for n in lens])
    count = rng.integers(1, cmax + 1, size=sid.size)
    count[rng.random(sid.size) < 0.05] = cmax
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    K = np.zeros(N, np.int64)
    np.add.at(K, sid, count)
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in (
        sid.astype(np.int64), count.astype(np.int64), starts, lens,
        K.astype(np.float64)))


def _every_channel(dev):
    flat = {n: torch.zeros(N * N, dtype=torch.int64, device=dev)
            for n in countjoin.PAIR_CHANNELS}
    kl = torch.zeros((N * N, 1 + countjoin.KL_FRAC_LIMBS),
                     dtype=torch.int64, device=dev)
    wall = torch.zeros(N * N, dtype=torch.int64, device=dev)
    return flat, kl, wall


@pytest.mark.cuda
def test_two_group_shared_form_matches_global_and_plain_on_cuda():
    from simka_tpu_torch.ops import _kernels

    dev = _card()
    rows = _seed_rows(3000, (1 << 31) - 1, 64, dev)
    d_max = int(rows[3].max())
    outs = [_every_channel(dev) for _ in range(3)]
    with torch.cuda.device(dev):
        budget = _kernels.lib().simka_pair_sums_budget(N, 1)
    before = countjoin.launches
    plan = countjoin.pair_sums(*rows, outs[0][0], outs[0][1], d_max=d_max,
                               whittaker_all=outs[0][2])
    countjoin._launch_pair_sums(*rows, *outs[1], countjoin.GLOBAL_PLAN)
    countjoin._pair_sums_plain(*rows, outs[2][0], outs[2][1], d_max=d_max,
                               whittaker_all=outs[2][2])
    torch.cuda.synchronize()
    assert countjoin.launches == before + 2
    assert plan == countjoin.pair_plan(N, 13, True, budget, d_max)
    if torch.cuda.get_device_name(dev).startswith("NVIDIA H100"):
        assert budget == BUDGET_H100[N]
    assert plan.form == "shared" and countjoin.pair_groups(plan) >= 2
    for other in outs[1:]:
        for name in countjoin.PAIR_CHANNELS:
            assert torch.equal(outs[0][0][name], other[0][name]), name
        assert torch.equal(outs[0][1], other[1])
        assert torch.equal(outs[0][2], other[2])
    assert outs[0][0]["whittaker"].any() and outs[0][1].any()


@pytest.mark.cuda
def test_a_wide_job_on_the_card_records_its_plans_groups():
    from simka_tpu_torch.ops import _kernels

    dev = _card()
    runner, _ = _loaded("all_dist", 11, dev)
    obs: dict = {}
    pipeline.compute_statistics(runner.sources, runner.ids, runner.sconfig,
                                dev, batch_reads=TOY_BATCH_READS,
                                observer=obs)
    with torch.cuda.device(dev):
        budget = _kernels.lib().simka_pair_sums_budget(N, 1)
    # the plan depends on the longest segment only past a chunk's rows
    plan = countjoin.pair_plan(N, 13, True, budget, N)
    assert obs["route"] == "in-memory"
    assert obs["counters"]["ingest_batches"] == 2 * N
    assert obs["counters"]["pair_groups"] == countjoin.pair_groups(plan) >= 2
    assert obs["stage_timers"]["kl_host_s"] > 0
