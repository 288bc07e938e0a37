"""The plain reference against a per-k-mer oracle written out in Python,
and the program's CPU path against the reference through whole runs of
a toy cell, for both traffic mixes."""

import itertools
import math
from collections import defaultdict

import numpy as np
import pytest
import torch

from benchmark import community, harness, reference
from benchmark.tests import toy

COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}
CODE = {"A": 0, "C": 1, "G": 2, "T": 3}


def canonical(kmer: str) -> int:
    fwd = rc = 0
    for ch in kmer:
        fwd = 4 * fwd + CODE[ch]
    for ch in reversed(kmer):
        rc = 4 * rc + CODE[COMP[ch]]
    return min(fwd, rc)


def wrap(x: int, y: int) -> int:
    low = (x - y) % (1 << 32)
    return abs(low - (1 << 32) if low >= 1 << 31 else low)


def oracle(samples, k, amin, amax):
    """Simka's statistics k-mer by k-mer, in Python integers and floats."""
    N = len(samples)
    counts = [defaultdict(int) for _ in range(N)]
    for s, reads in enumerate(samples):
        for r in reads:
            r = r.tobytes().decode()
            for i in range(len(r) - k + 1):
                w = r[i:i + k]
                if set(w) <= set("ACGT"):
                    counts[s][canonical(w)] += 1
    solid = [{km: c for km, c in cs.items() if amin <= c <= amax}
             for cs in counts]
    kmers = sorted(set().union(*solid))
    K = [sum(s.values()) for s in solid]
    o = {n: np.zeros((N, N), np.int64) for n in (
        "shared_kmers", "shared_distinct", "bray_numerator", "hellinger",
        "whittaker")}
    o["chord_ninj"] = np.zeros((N, N))
    o["kullback_leibler"] = np.zeros((N, N))
    for km in kmers:
        x = [s.get(km, 0) for s in solid]
        for i, j in itertools.permutations(range(N), 2):
            if x[i] and x[j]:
                o["shared_kmers"][i, j] += x[i]
                o["shared_distinct"][i, j] += 1
                o["bray_numerator"][i, j] += min(x[i], x[j])
                o["chord_ninj"][i, j] += x[i] * x[j]
                o["hellinger"][i, j] += math.isqrt(x[i] * x[j])
            if x[i] or x[j]:
                o["whittaker"][i, j] += wrap(x[i] * K[j], x[j] * K[i])
                for a, b in ((i, j), (j, i)):
                    if x[a]:
                        o["kullback_leibler"][i, j] += x[a] / K[a] * math.log(
                            2 * x[a] * K[b] / (x[a] * K[b] + x[b] * K[a]))
    for i in range(N):
        o["shared_kmers"][i, i] = o["bray_numerator"][i, i] = K[i]
        o["shared_distinct"][i, i] = len(solid[i])
    o.update(
        nb_distinct_kmers=len(kmers),
        nb_shared_kmers=sum(
            1 for km in kmers if sum(km in s for s in solid) >= 2),
        dataset_nb_reads=np.array([len(r) for r in samples]),
        distinct_per_bank=np.array([len(s) for s in solid]),
        solid_per_bank=np.array(K),
        chord_n2_per_bank=np.array([sum(c * c for c in s.values())
                                    for s in solid]))
    return o


@pytest.mark.parametrize("k, amin, amax", [(5, 1, 999), (9, 2, 4), (21, 2, 9)])
def test_reference_statistics_match_the_oracle(k, amin, amax):
    samples = community.draw_community(
        4, torch.device("cpu"), n_samples=3, elements=[[2, 300]],
        lognormal_mu=1.0, lognormal_sigma=2.0, reads_per_sample=60,
        read_len=30, n_frac=0.02)
    got = reference.statistics(samples, k, amin, amax, True, True,
                               torch.device("cpu"))
    want = oracle(samples, k, amin, amax)
    for name, v in want.items():
        if name == "kullback_leibler":
            np.testing.assert_allclose(got[name], v, rtol=1e-12, atol=1e-12)
        else:
            np.testing.assert_array_equal(got[name], v, err_msg=name)
    assert got["shapes"]["solid_rows"] == int(want["distinct_per_bank"].sum())
    assert got["shapes"]["kmers"] == want["nb_distinct_kmers"]


def test_instance_keys_skip_windows_with_other_bases():
    reads = np.frombuffer(b"ACGTNACGTT", np.uint8).reshape(1, -1).copy()
    keys = reference.instance_keys(torch.from_numpy(reads), 4, 1, 2)
    want = [canonical("ACGT"), canonical("ACGT"), canonical("CGTT")]
    assert sorted((keys >> 2).tolist()) == sorted(want)
    assert set((keys & 3).tolist()) == {1}


@pytest.mark.parametrize("cell", toy.CELLS)
def test_the_programs_cpu_path_agrees_with_the_reference(cell, tmp_path):
    r = harness.run_cell(cell, 2**31 + 11, 0.2, False, torch.device("cpu"),
                         t_start=0.0, bench=toy.bench(),
                         bench_dir=toy.bench_dir(tmp_path))
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert r["checks"]["stat_mismatch"]["value"] == 0
    assert r["checks"]["matrix_gap"]["value"] <= 1e-15


def test_the_reference_writes_every_matrix_of_the_traffic():
    samples = community.draw_community(
        1, torch.device("cpu"), n_samples=3, elements=[[2, 300]],
        lognormal_mu=1.0, lognormal_sigma=2.0, reads_per_sample=60,
        read_len=30, n_frac=0.02)
    for simple, complex_, n in ((False, False, 15), (True, True, 21)):
        _, mats = reference.answer(samples, 9, 2, 99, simple, complex_,
                                   torch.device("cpu"))
        assert len(mats) == n
        for m in mats.values():
            assert m.shape == (3, 3) and np.all(np.diag(m) == 0)
