"""Vectorized MurmurHash3_x64_128 (Austin Appleby's public-domain
algorithm) specialized for 8-byte keys.

SimkaMin hashes the 8-byte little-endian canonical k-mer value with a
user seed and keeps the low 64 bits h1 (reference
src/simkaMin/SimkaMinCount.hpp:248-250). For len = 8 the algorithm has
no 16-byte body blocks -- just the k1 tail mix and finalization --
which vectorizes to a handful of uint64 numpy ops.
"""

from __future__ import annotations

import numpy as np

_C1 = np.uint64(0x87C37B91114253D5)
_C2 = np.uint64(0x4CF5AD432745937F)
_F1 = np.uint64(0xFF51AFD7ED558CCD)
_F2 = np.uint64(0xC4CEB9FE1A85EC53)


def _rotl64(x: np.ndarray, r: int) -> np.ndarray:
    r = np.uint64(r)
    return (x << r) | (x >> (np.uint64(64) - r))


def _fmix64(h: np.ndarray) -> np.ndarray:
    h = h ^ (h >> np.uint64(33))
    h = h * _F1
    h = h ^ (h >> np.uint64(33))
    h = h * _F2
    h = h ^ (h >> np.uint64(33))
    return h


def murmur3_u64(values: np.ndarray, seed: int) -> np.ndarray:
    """h1 of MurmurHash3_x64_128 over each uint64 (as 8 LE bytes)."""
    with np.errstate(over="ignore"):
        values = np.asarray(values, dtype=np.uint64)
        h1 = np.full(values.shape, np.uint64(seed))
        h2 = np.full(values.shape, np.uint64(seed))

        k1 = values * _C1
        k1 = _rotl64(k1, 31)
        k1 = k1 * _C2
        h1 = h1 ^ k1

        length = np.uint64(8)
        h1 = h1 ^ length
        h2 = h2 ^ length
        h1 = h1 + h2
        h2 = h2 + h1
        h1 = _fmix64(h1)
        h2 = _fmix64(h2)
        h1 = h1 + h2
        # h2 += h1 omitted: only h1 is used
    return h1
