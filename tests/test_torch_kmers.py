"""The port's k-mer ops (simka_tpu_torch.ops.kmers) against the JAX
package's, on the same numpy inputs: exact equality (all integer)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simka_tpu.io.bank import encode_batch
from simka_tpu.ops import kmers as jk
from simka_tpu.ops.kmers import pack_codes_host as pack_ref
from simka_tpu_torch.io.packed import pack_codes_host
from simka_tpu_torch.ops import kmers as tk


def _ragged_codes(seed: int, n: int = 23, max_len: int = 70):
    """A code batch of ragged reads with N bases, width a multiple of 8."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGTN", np.uint8)
    p = [0.245, 0.245, 0.245, 0.245, 0.02]
    reads = [
        bytes(rng.choice(bases, size=int(rng.integers(3, max_len)), p=p))
        for _ in range(n)
    ]
    width = -(-max_len // 8) * 8
    codes, _ = encode_batch(reads, max_len=width)
    return codes


@pytest.mark.parametrize("k", [5, 21, 31])
@pytest.mark.parametrize("seed", [0, 1])
def test_extract_packed_matches_jax(k, seed):
    packed, vb = pack_ref(_ragged_codes(seed))
    j_hi, j_lo = jk.extract_packed(jnp.asarray(packed), jnp.asarray(vb), k)
    t_hi, t_lo = tk.extract_packed(
        torch.from_numpy(packed), torch.from_numpy(vb), k
    )
    np.testing.assert_array_equal(t_hi.numpy(), np.asarray(j_hi, np.int64))
    np.testing.assert_array_equal(t_lo.numpy(), np.asarray(j_lo, np.int64))
    assert (np.asarray(j_hi) != jk.SENTINEL).any()
    assert (np.asarray(j_hi) == jk.SENTINEL).any()


@pytest.mark.parametrize("k", [1, 5, 21, 31])
def test_extract_canonical_kmers_matches_jax(k):
    codes = _ragged_codes(7, max_len=40)
    j_hi, j_lo, j_valid = jk.extract_canonical_kmers(jnp.asarray(codes), k)
    t_hi, t_lo, t_valid = tk.extract_canonical_kmers(
        torch.from_numpy(codes), k
    )
    np.testing.assert_array_equal(t_hi.numpy(), np.asarray(j_hi, np.int64))
    np.testing.assert_array_equal(t_lo.numpy(), np.asarray(j_lo, np.int64))
    np.testing.assert_array_equal(t_valid.numpy(), np.asarray(j_valid))


def test_extract_rejects_k_above_31():
    # k <= 127 is the reference's range (gatb-core's k-mer spans); 128
    # is refused, as simka_tpu's SimkaConfig refuses it
    packed, vb = pack_ref(_ragged_codes(0, max_len=200))
    with pytest.raises(NotImplementedError):
        tk.extract_packed(
            torch.from_numpy(packed), torch.from_numpy(vb), 128, multi=True
        )


@pytest.mark.parametrize("k", [32, 33, 48, 63, 64, 75, 127])
def test_extract_packed_multi_matches_jax(k):
    codes = _ragged_codes(k, n=29, max_len=180)
    packed, vb = pack_ref(codes)
    want = jk.extract_packed(
        jnp.asarray(packed), jnp.asarray(vb), k, multi=True
    )
    got = tk.extract_packed(
        torch.from_numpy(packed), torch.from_numpy(vb), k, multi=True
    )
    assert len(got) == len(want) == tk.n_uint32_words(k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w, np.int64))
    top = np.asarray(want[0])
    assert (top != jk.SENTINEL).any() and (top == jk.SENTINEL).any()
    # the port's own words: n_words(k) words of at most 62 bits
    words, valid = tk.canonical_kmers(torch.from_numpy(codes), k)
    assert len(words) == tk.n_words(k) == -(-k // 31)
    top_bits = 2 * k - 62 * (len(words) - 1)
    for i, w in enumerate(words):
        v = w[valid]
        assert int(v.min()) >= 0
        assert int(v.max()) < 1 << (top_bits if i == 0 else 62)


def _low_complexity_codes(seed: int, n: int = 40, length: int = 150):
    """Reads half of two-base repeats, half random: Shannon indices
    from 0 up to 2, with exact values such as 1.0 and 1.5 at k a
    multiple of 4."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    reads = []
    for i in range(n):
        if i % 2:
            reads.append(bytes(rng.choice(acgt, size=length)))
        else:
            pat = rng.choice(acgt, size=4)
            reads.append(bytes(np.tile(pat, length // 4 + 1)[:length]))
    codes, _ = encode_batch(reads, max_len=-(-length // 8) * 8)
    return codes


@pytest.mark.parametrize("k", [5, 21, 31, 32, 33, 63, 64, 127])
def test_kmer_shannon_index_matches_jax(k):
    codes = _low_complexity_codes(k)
    if k <= 31:
        hi, lo, valid = jk.extract_canonical_kmers(jnp.asarray(codes), k)
        ref_words = (hi, lo)
    else:
        ref_words, valid = jk.extract_canonical_kmers_multi(
            jnp.asarray(codes), k
        )
    want = np.asarray(jk.kmer_shannon_index_words(ref_words, k))
    words, t_valid = tk.canonical_kmers(torch.from_numpy(codes), k)
    got = tk.kmer_shannon_index_words(words, k).numpy()
    ok = np.asarray(valid)
    np.testing.assert_array_equal(t_valid.numpy(), ok)
    assert got.dtype == want.dtype == np.float32
    got, want = got[ok], want[ok]
    # XLA's f32 log is off by an ulp at some frequencies c / k; the
    # port's is correctly rounded: within 2 ulp of 2.0, and exact at
    # the indices built from frequencies 0, 1/4, 1/2 and 1
    np.testing.assert_allclose(got, want, rtol=0, atol=2 * np.spacing(
        np.float32(1.0)))
    exact = np.isin(want, np.float32([0.0, 1.0, 1.5, 2.0]))
    np.testing.assert_array_equal(got[exact], want[exact])
    assert (got != want).mean() < 0.1
    assert len(np.unique(want)) > 3
    if k % 4 == 0:
        assert np.isin([1.0, 1.5], want).all()


@pytest.mark.parametrize("k", [21, 32, 63])
def test_mix_hash_words_matches_reference_histogram_hash(k):
    codes = _ragged_codes(k, n=17, max_len=120)
    packed, vb = pack_ref(codes)
    ref = jk.extract_packed(
        jnp.asarray(packed), jnp.asarray(vb), k, multi=k > 31
    )
    h = ref[0]
    for w in ref[1:]:
        h = jk.mix_hash(h, w)
    port = tk.extract_packed(
        torch.from_numpy(packed), torch.from_numpy(vb), k, multi=k > 31
    )
    np.testing.assert_array_equal(
        tk.mix_hash_words(port).numpy(), np.asarray(h, np.int64)
    )


def test_mix_hash_matches_jax():
    rng = np.random.default_rng(3)
    hi = rng.integers(0, 1 << 32, size=4096, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 1 << 32, size=4096, dtype=np.uint64).astype(np.uint32)
    hi[:4] = [0, 0xFFFFFFFF, 0, 0xFFFFFFFF]
    lo[:4] = [0, 0, 0xFFFFFFFF, 0xFFFFFFFF]
    want = np.asarray(jk.mix_hash(jnp.asarray(hi), jnp.asarray(lo)), np.int64)
    got = tk.mix_hash(
        torch.from_numpy(hi.astype(np.int64)),
        torch.from_numpy(lo.astype(np.int64)),
    )
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_codes_host_matches_original(seed):
    codes = _ragged_codes(seed)
    for got, want in zip(pack_codes_host(codes), pack_ref(codes)):
        np.testing.assert_array_equal(got, want)
