"""The port's count_join_stats against simka_tpu's on random instance
streams (E = 2^14, shaped like __graft_entry__.entry): every integer
JoinStats field exactly equal, chord within 1e-6 relative and
Kullback-Leibler within the reference's f32 panel-sum error bound
(see FLOAT_RTOL). hi_bits 10 is k=21 (packed single-key sort); hi_bits 30 is
k=31, packed at N=2 and multi-key above; multi-word streams are
k > 31."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simka_tpu.ops.countjoin import SPLIT_MIN_BANKS
from simka_tpu.ops.countjoin import count_join_stats as count_join_ref
from simka_tpu.ops.countjoin import count_join_stats_split as count_join_split_ref
from simka_tpu.ops.countjoin import (
    join_stats_from_spectra as join_stats_from_spectra_ref,
)
from simka_tpu_torch.ops import countjoin
from simka_tpu_torch.ops import kmers as tk

E = 1 << 14


def _instances(n_banks: int, hi_bits: int, seed: int):
    """uint32 (hi, lo) and int32 sid with many repeated (k-mer, sample)
    pairs: few distinct lo values and hi values, so counts reach
    the abundance bounds and k-mers are shared across samples."""
    rng = np.random.default_rng(seed)
    hi = rng.integers(0, 4, size=E, dtype=np.uint64)
    hi |= np.uint64(1 << (hi_bits - 1))  # top payload bit in use
    lo = rng.integers(0, 1 << 11, size=E, dtype=np.uint64)
    lo |= np.uint64(1 << 31)
    sid = rng.integers(0, n_banks, size=E).astype(np.int32)
    return hi.astype(np.uint32), lo.astype(np.uint32), sid


@pytest.mark.parametrize("amin,amax", [(0, 999_999_999), (2, 999_999_999), (2, 3)])
@pytest.mark.parametrize(
    "n_banks,hi_bits", [(2, 10), (5, 10), (16, 10), (2, 30), (5, 30), (16, 30)]
)
def test_count_join_stats_matches_jax(n_banks, hi_bits, amin, amax):
    hi, lo, sid = _instances(n_banks, hi_bits, 100 * n_banks + hi_bits)
    want = count_join_ref(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(sid),
        jnp.int32(amin), jnp.int64(amax),
        n_banks=n_banks, hi_bits=hi_bits,
    )
    kmer = (hi.astype(np.int64) << 32) | lo.astype(np.int64)
    got = countjoin.count_join_stats(
        torch.from_numpy(kmer), torch.from_numpy(sid), amin, amax,
        n_banks=n_banks, kmer_bits=32 + hi_bits,
    ).to_numpy()
    packed = 32 + hi_bits + countjoin._sbits(n_banks) <= 63
    assert packed == (hi_bits == 10 or n_banks == 2)
    for name in want._fields:
        w = np.asarray(getattr(want, name))
        g = getattr(got, name)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert int(got.nb_shared) > 0


def test_empty_stream_gives_zeros():
    js = countjoin.count_join_stats(
        torch.empty(0, dtype=torch.int64), torch.empty(0, dtype=torch.int32),
        2, 10, n_banks=3, kmer_bits=42,
    ).to_numpy()
    assert int(js.nb_distinct) == 0 and int(js.max_count) == 0
    assert js.shared_distinct.shape == (3, 3) and not js.shared_distinct.any()


@pytest.mark.parametrize(
    "kmer,sid",
    [([1, 1 << 42], [0, 0]), ([1, -1], [0, 0]), ([1, 2], [0, 3])],
)
def test_out_of_range_rows_raise(kmer, sid):
    with pytest.raises(ValueError):
        countjoin.count_join_stats(
            torch.tensor(kmer, dtype=torch.int64),
            torch.tensor(sid, dtype=torch.int32),
            0, 10, n_banks=3, kmer_bits=42,
        )


# The reference sums the float channels as hi + lo f32 halves, each
# summed in f32 over 8192-row panels (_pair_bin_float); the port sums
# chord in int64 and Kullback-Leibler in fixed point, exactly. Chord's
# integer terms keep the reference's panel sums exact at these sizes
# (1e-6 is the PARITY.md determinism bound). Its Kullback-Leibler terms
# are not integers but are never negative (p log(2p/(p+q)) + q
# log(2q/(p+q)) >= 0), and an f32 sum of m >= 0 terms in any order is
# within (m - 1) 2^-24 of the exact sum, relative (zero terms of other
# pairs add no rounding); with m <= 8192 rows a panel, the panel sums
# added in f64 and the lo halves carrying v - f32(v), the reference's KL
# is within 8192 x 2^-24 = 2^-11 of the exact sum. The port's is that
# exact sum (test_kl_is_exact, to 1e-14), so the parity bound is the
# reference's own error bound; it has reached 5.7e-6 on these streams.
FLOAT_RTOL = {"chord_ninj": 1e-6, "kullback_leibler": 8192 * 2.0**-24}


def _assert_stats_match(got, want):
    """Integer fields exact; chord and KL within FLOAT_RTOL."""
    for name in want._fields:
        w = np.asarray(getattr(want, name))
        g = getattr(got, name)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name in FLOAT_RTOL:
            np.testing.assert_allclose(g, w, rtol=FLOAT_RTOL[name], atol=0,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("amin", [0, 2])
@pytest.mark.parametrize(
    "n_banks,hi_bits", [(3, 10), (3, 30), (16, 10), (16, 30), (40, 30)]
)
def test_all_channels_match_jax(n_banks, hi_bits, amin):
    hi, lo, sid = _instances(n_banks, hi_bits, 7 * n_banks + hi_bits + amin)
    args = (jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(sid),
            jnp.int32(amin), jnp.int64(999_999_999))
    kw = dict(n_banks=n_banks, hi_bits=hi_bits, simple=True, complex_=True)
    kmer = (hi.astype(np.int64) << 32) | lo.astype(np.int64)
    got = countjoin.count_join_stats(
        torch.from_numpy(kmer), torch.from_numpy(sid), amin, 999_999_999,
        n_banks=n_banks, kmer_bits=32 + hi_bits, simple=True, complex_=True,
    ).to_numpy()
    _assert_stats_match(got, count_join_ref(*args, **kw))
    if n_banks >= SPLIT_MIN_BANKS:
        # the reference's own pipeline joins this wide N split
        _assert_stats_match(got, count_join_split_ref(*args, **kw))
    for name in ("hellinger", "chord_ninj", "whittaker", "whittaker_all",
                 "whittaker_s12", "kullback_leibler"):
        assert getattr(got, name).any(), name


def _multiword_instances(k: int, n_banks: int, seed: int):
    """Port words of k-mers with every word in use, few distinct
    values (so counts pass the abundance filter and k-mers are
    shared), and sample ids."""
    rng = np.random.default_rng(seed)
    nw = tk.n_words(k)
    top_bits = 2 * k - 62 * (nw - 1)
    distinct = [
        rng.integers(0, 1 << (top_bits if i == 0 else 62), size=600,
                     dtype=np.int64)
        for i in range(nw)
    ]
    distinct[-1][:300] = distinct[-1][300:]  # words equal but one
    pick = rng.integers(0, 600, size=E)
    words = tuple(torch.from_numpy(d[pick]) for d in distinct)
    sid = rng.integers(0, n_banks, size=E).astype(np.int32)
    return words, sid


@pytest.mark.parametrize("k,n_banks", [(32, 5), (33, 3), (63, 16), (127, 5)])
def test_multiword_stream_matches_jax(k, n_banks):
    words, sid = _multiword_instances(k, n_banks, k)
    ref_words = tk.uint32_words(words, k)
    assert len(ref_words) == tk.n_uint32_words(k)
    want = count_join_ref(
        tuple(jnp.asarray(w.numpy().astype(np.uint32)) for w in ref_words[:-1]),
        jnp.asarray(ref_words[-1].numpy().astype(np.uint32)),
        jnp.asarray(sid), jnp.int32(2), jnp.int64(999_999_999),
        n_banks=n_banks, hi_bits=32, simple=True, complex_=True,
    )
    got = countjoin.count_join_stats(
        words, torch.from_numpy(sid), 2, 999_999_999, n_banks=n_banks,
        kmer_bits=2 * k, simple=True, complex_=True,
    ).to_numpy()
    _assert_stats_match(got, want)
    assert int(got.nb_shared) > 0


def test_channels_in_the_whittaker_wrap_regime():
    """Counts up to 2^20: count x solid-total products pass 2^32, so
    the Whittaker terms wrap to int32 as the reference's do. Rows go
    straight to stats_from_rows, against join_stats_from_spectra."""
    rng = np.random.default_rng(5)
    N, n_k = 6, 2000
    kmer = np.sort(rng.choice(1 << 40, size=n_k, replace=False))
    present = rng.random((n_k, N)) < 0.5
    present[:, 0] = True
    ki, si = np.nonzero(present)  # (k-mer, sample) ascending
    count = rng.integers(1, 1 << 20, size=ki.shape[0]).astype(np.int32)
    words = (torch.from_numpy(kmer[ki].astype(np.int64)),)
    got = countjoin.stats_from_rows(
        words, torch.from_numpy(si.astype(np.int32)),
        torch.from_numpy(count), n_banks=N, simple=True, complex_=True,
    ).to_numpy()
    v = kmer[ki].astype(np.uint64)
    want = join_stats_from_spectra_ref(
        (jnp.asarray((v >> np.uint64(32)).astype(np.uint32)),
         jnp.asarray(v.astype(np.uint32))),
        jnp.asarray(si.astype(np.int32)), jnp.asarray(count),
        jnp.int32(0), jnp.int64(999_999_999),
        n_banks=N, simple=True, complex_=True, hi_bits=8,
    )
    _assert_stats_match(got, want)
    assert (count.astype(np.float64) * got.solid_per_bank.max() > 2**32).any()


def test_pair_channels_are_deterministic():
    """Two runs give the same bits in every field (the float channels
    are order-independent sums)."""
    hi, lo, sid = _instances(16, 30, 11)
    kmer = torch.from_numpy((hi.astype(np.int64) << 32) | lo.astype(np.int64))
    runs = [
        countjoin.count_join_stats(
            kmer, torch.from_numpy(sid), 0, 999_999_999, n_banks=16,
            kmer_bits=62, simple=True, complex_=True,
        ).to_numpy()
        for _ in range(2)
    ]
    for name in runs[0]._fields:
        assert np.array_equal(getattr(runs[0], name), getattr(runs[1], name))


def test_kl_limbs_sum_exactly():
    rng = np.random.default_rng(2)
    x = np.concatenate([rng.normal(size=500) * 10.0 ** rng.integers(
        -12, 2, size=500), [0.0, -0.0, 1e-30, 40.5]])
    limbs = countjoin._kl_limbs(torch.from_numpy(x))
    total = limbs.sum(0, keepdim=True)
    got = countjoin._kl_from_limbs(total).item()
    want = float(math.fsum(x))
    assert abs(got - want) <= 1e-15 * max(abs(want), 1.0)
    # each term alone round-trips
    back = countjoin._kl_from_limbs(limbs).numpy()
    np.testing.assert_array_equal(back[:-2], x[:-2])


@pytest.mark.parametrize("n_banks,hi_bits", [(3, 30), (16, 10)])
def test_kl_is_exact(n_banks, hi_bits):
    """The port's Kullback-Leibler pair sums equal math.fsum of the f64
    pair terms (SimkaAlgorithm.hpp:437-446) over every co-present pair,
    to 1e-14 relative (the terms' own last-bit log differences); the
    reference's f32 panel sums stray by up to ~6e-6 on the same rows."""
    hi, lo, sid = _instances(n_banks, hi_bits, 7 * n_banks + hi_bits)
    kmer = torch.from_numpy((hi.astype(np.int64) << 32) | lo.astype(np.int64))
    rows = countjoin.solid_rows((kmer,), torch.from_numpy(sid), 0,
                                999_999_999, n_banks=n_banks,
                                kmer_bits=32 + hi_bits)
    got = countjoin.stats_from_rows(*rows, n_banks=n_banks, simple=True,
                                    complex_=True).kullback_leibler.numpy()
    k = rows[0][0].numpy()
    s = rows[1].numpy().astype(np.int64)
    c = rows[2].numpy().astype(np.float64)
    K = np.bincount(s, weights=c, minlength=n_banks)
    seg = np.cumsum(np.r_[True, k[1:] != k[:-1]])
    terms = {}
    for d in range(1, len(k)):
        r = np.nonzero(seg[d:] == seg[:-d])[0]
        if not len(r):
            break
        a, b = s[r], s[r + d]
        xy, yx = c[r] * K[b], c[r + d] * K[a]
        v = (c[r] / K[a] * np.log(2.0 * xy / (xy + yx))
             + c[r + d] / K[b] * np.log(2.0 * yx / (xy + yx)))
        for i, j, t in zip(a, b, v):
            terms.setdefault((i, j), []).append(t)
    want = np.zeros((n_banks, n_banks))
    for (i, j), t in terms.items():
        want[i, j] = math.fsum(t)
    assert len(terms) == n_banks * (n_banks - 1) // 2
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=0)
