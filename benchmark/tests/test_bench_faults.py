"""A run with the timed path broken underneath reads not correct, once
for each fault a cell of this benchmark can have, and so does the
control: the reference one precision lower in the program's place. (The
exchange between chips is no fault here: every cell runs on one chip.)
"""

import numpy as np
import pytest
import torch

from benchmark import control, harness
from benchmark.tests import toy
from simka_tpu_torch.core import distances, pipeline, stats
from simka_tpu_torch.ops import countjoin


def run(cell, tmp_path):
    return harness.run_cell(cell, 2**31 + 3, 0.1, False, torch.device("cpu"),
                            t_start=0.0, bench=toy.bench(),
                            bench_dir=toy.bench_dir(tmp_path))


def unchanged_state(mp):
    """The pair sums return their zeroed accumulators untouched."""
    mp.setattr(countjoin, "pair_sums", lambda *a, **kw: None)


def half_the_batch(mp):
    """Each ingest batch keeps the first half of its k-mers."""
    orig = pipeline.extract_windows

    def half(*a, **kw):
        words, sid, hist = orig(*a, **kw)
        n = sid.shape[0] // 2
        return tuple(w[:n] for w in words), sid[:n], hist

    mp.setattr(pipeline, "extract_windows", half)


def altered_matrix(mp):
    """One distance of one matrix off by a millionth where it is made."""
    orig = distances.compute_all_matrices

    def altered(st):
        mats = orig(st)
        m = mats["mat_abundance_braycurtis"]
        m[0, 1] += 1e-6
        return mats

    mp.setattr(distances, "compute_all_matrices", altered)


def altered_count(mp):
    """One pair's shared-count sum off by one where it is made."""
    orig = stats.SimkaStatistics.from_join_stats

    def altered(cls, *a, **kw):
        st = orig(*a, **kw)
        st.bray_numerator[0, 1] += 1
        return st

    mp.setattr(stats.SimkaStatistics, "from_join_stats",
               classmethod(altered))


@pytest.mark.parametrize("fault", [unchanged_state, half_the_batch,
                                   altered_matrix, altered_count])
@pytest.mark.parametrize("cell", toy.CELLS)
def test_a_broken_path_reads_not_correct(cell, fault, monkeypatch, tmp_path):
    fault(monkeypatch)
    r = run(cell, tmp_path)
    assert r["correct"] is False
    assert (r["checks"]["stat_mismatch"]["value"] > 0
            or r["checks"]["matrix_gap"]["value"]
            > r["checks"]["matrix_gap"]["limit"])


@pytest.mark.parametrize("cell", toy.CELLS)
def test_the_control_reads_not_correct_and_the_program_does(cell, tmp_path):
    d = toy.bench_dir(tmp_path)
    limit = harness.registry.limits(cell, d)["matrix_gap"]
    for seed in (5, 6, 7):
        r = control.readings(cell, seed, torch.device("cpu"), True,
                             toy.bench(), d)
        assert r["control"]["matrix_gap"] > 100 * limit
        assert r["program"]["matrix_gap"] <= limit / 1e4
        assert r["program"]["stat_mismatch"] == 0


def test_a_job_of_the_window_that_raises_is_a_failed_job(monkeypatch,
                                                         tmp_path):
    orig, calls = distances.compute_all_matrices, []

    def boom(st):  # past the set-up's warm-up jobs
        calls.append(1)
        if len(calls) > harness.WARMUP_JOBS:
            raise RuntimeError("planted")
        return orig(st)

    monkeypatch.setattr(distances, "compute_all_matrices", boom)
    r = run("toy.default_dist", tmp_path)
    assert r["correct"] is False and r["failed"] == r["attempted"] > 0
    assert np.isfinite(r["checks"]["failed_jobs"]["value"])


def test_a_job_off_the_in_memory_route_is_a_failed_job(monkeypatch, tmp_path):
    orig = pipeline.compute_statistics

    def restarted(*a, observer=None, **kw):
        st = orig(*a, observer=observer, **kw)
        observer["route"] = "restart"
        return st

    monkeypatch.setattr(pipeline, "compute_statistics", restarted)
    r = run("toy.default_dist", tmp_path)
    assert r["correct"] is False and r["failed"] == r["attempted"]
