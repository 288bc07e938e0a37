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
    packed, vb = pack_ref(_ragged_codes(0))
    with pytest.raises(NotImplementedError):
        tk.extract_packed(torch.from_numpy(packed), torch.from_numpy(vb), 33)


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
