"""The port's count_join_stats against simka_tpu's on random instance
streams (E = 2^14, shaped like __graft_entry__.entry): every JoinStats
field exactly equal. hi_bits 10 is k=21 (packed single-key sort);
hi_bits 30 is k=31, packed at N=2 and multi-key at N=5 and 16."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simka_tpu.ops.countjoin import count_join_stats as count_join_ref
from simka_tpu_torch.ops import countjoin

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
