"""The port's per-sample spectrum (ops/spectrum.py) and its join from
spectra (ops/countjoin.py::join_stats_from_spectra) against simka_tpu's
on the same rows. Spectra: words, in simka_tpu's uint32 layout, and
counts exactly equal, at k on one to three int64 words and at the
uint32 layout's edges (k = 32 and 64 carry its extra word). The join:
every integer JoinStats field exactly equal, chord (f64) within 1e-9
relative, and Kullback-Leibler within the reference's own f32 error
bound (tests/test_torch_countjoin.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simka_tpu.ops import spectrum as ref_spectrum
from simka_tpu.ops.countjoin import (
    join_stats_from_spectra as ref_join,
    join_stats_from_spectra_split as ref_join_split,
)
from simka_tpu_torch.ops import kmers as tk
from simka_tpu_torch.ops import spectrum
from simka_tpu_torch.ops.countjoin import join_stats_from_spectra

KS = (21, 31, 32, 33, 63, 64)
RTOL = {"chord_ninj": 1e-9, "kullback_leibler": 8192 * 2.0**-24}


def _table(k: int, distinct: int, rng) -> tuple:
    """``distinct`` k-mers as port words, every word in use; half of
    them equal to another but for their last word."""
    nw = tk.n_words(k)
    top = 2 * k - 62 * (nw - 1)
    table = [rng.integers(0, 1 << (top if i == 0 else 62), size=distinct,
                          dtype=np.int64) for i in range(nw)]
    for w in table[:-1]:
        w[: distinct // 2] = w[distinct // 2:]
    return table


def _stream(table, E: int, rng) -> tuple:
    """[E] instances drawn with repeats from the table."""
    pick = rng.integers(0, len(table[0]), size=E)
    return tuple(torch.from_numpy(t[pick]) for t in table)


def _ref_words(words, k):
    """The port's words as simka_tpu's uint32 numpy words."""
    return tuple(w.numpy().astype(np.uint32) for w in tk.uint32_words(words, k))


def _assert_spectrum_equal(got, want, k):
    g_words, g_counts = got
    w_words, w_counts = want
    assert g_counts.dtype == torch.int32
    g32 = _ref_words(g_words, k)
    assert len(g32) == len(w_words) == tk.n_uint32_words(k)
    for g, w in zip(g32, w_words):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(g_counts.numpy(), w_counts)


@pytest.mark.parametrize("k", KS)
def test_count_spectrum_matches_jax(k):
    rng = np.random.default_rng(k)
    words = _stream(_table(k, 700, rng), 1 << 13, rng)
    got = spectrum.count_spectrum(words, k)
    want = ref_spectrum.count_spectrum(*_ref_words(words, k))
    _assert_spectrum_equal(got, want, k)
    assert int(got[1].max()) > 1 and int(got[1].sum()) == 1 << 13
    # the host layout (the checkpoint's) round-trips to the port's words
    host_words, host_counts = spectrum.to_host(got, k)
    np.testing.assert_array_equal(host_counts, want[1])
    back = spectrum.words_from_host(host_words, k, torch.device("cpu"))
    assert len(back) == tk.n_words(k)
    assert all(torch.equal(a, b) for a, b in zip(back, got[0]))


@pytest.mark.parametrize("k", KS)
def test_merge_spectra_matches_jax_and_the_joint_count(k):
    """Three partial spectra over overlapping k-mers merge to the count
    of their joint stream."""
    rng = np.random.default_rng(100 + k)
    table = _table(k, 500, rng)
    streams = [_stream(table, E, rng) for E in (3000, 1, 4100)]
    partials = [spectrum.count_spectrum(s, k) for s in streams]
    got = spectrum.merge_spectra(partials)
    joint = spectrum.count_spectrum(
        tuple(torch.cat(ws) for ws in zip(*streams)), k)
    want = ref_spectrum.merge_spectra([
        (_ref_words(w, k), c.numpy().astype(np.int64)) for w, c in partials
    ])
    _assert_spectrum_equal(got, want, k)
    for g, j in zip((*got[0], got[1]), (*joint[0], joint[1])):
        assert torch.equal(g, j)


@pytest.mark.parametrize("k", KS)
def test_empty_stream_gives_an_empty_spectrum(k):
    empty = tuple(torch.empty(0, dtype=torch.int64)
                  for _ in range(tk.n_words(k)))
    words, counts = spectrum.count_spectrum(empty, k)
    assert len(words) == tk.n_words(k) and counts.shape == (0,)
    words, counts = spectrum.merge_spectra([(words, counts)] * 3)
    assert len(words) == tk.n_words(k) and counts.shape == (0,)
    assert len(tk.uint32_words(words, k)) == tk.n_uint32_words(k)


def _spectra_rows(n_banks: int, k: int, seed: int):
    """One row per (distinct k-mer, sample), shuffled: each sample holds
    a random half of a shared table, counts 1..60."""
    rng = np.random.default_rng(seed)
    table = _table(k, 900, rng)
    ki, si = np.nonzero(rng.random((900, n_banks)) < 0.5)
    order = rng.permutation(len(ki))
    ki, si = ki[order], si[order]
    words = tuple(torch.from_numpy(t[ki]) for t in table)
    counts = rng.integers(1, 61, size=len(ki)).astype(np.int32)
    return words, si.astype(np.int32), counts


@pytest.mark.parametrize("amin", [0, 2])
@pytest.mark.parametrize("n_banks,k", [(3, 21), (3, 31), (3, 63), (40, 21),
                                       (40, 33)])
def test_join_stats_from_spectra_matches_jax(n_banks, k, amin):
    """N=3 against join_stats_from_spectra, N=40 against its split form
    (which the reference takes from N >= 33); amax 40 drops rows."""
    words, sid, counts = _spectra_rows(n_banks, k, 13 * n_banks + k + amin)
    amax = 40
    got = join_stats_from_spectra(
        words, torch.from_numpy(sid), torch.from_numpy(counts), amin, amax,
        n_banks=n_banks, kmer_bits=2 * k, simple=True, complex_=True,
    ).to_numpy()
    join = ref_join_split if n_banks >= 33 else ref_join
    want = join(
        tuple(jnp.asarray(w) for w in _ref_words(words, k)),
        jnp.asarray(sid), jnp.asarray(counts), jnp.int32(amin),
        jnp.int64(amax), n_banks=n_banks, simple=True, complex_=True,
        hi_bits=max(0, 2 * k - 32) if k <= 31 else 32,
    )
    for name in want._fields:
        w = np.asarray(getattr(want, name))
        g = getattr(got, name)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name in RTOL:
            np.testing.assert_allclose(g, w, rtol=RTOL[name], atol=0,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert int(got.nb_shared) > 0 and int(got.max_count) == amax
    assert got.kullback_leibler.any() and got.whittaker_all.any()
