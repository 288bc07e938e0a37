"""The benchmark's fixed arithmetic: the card's peaks, the least time a
kernel could take for its bytes and operations, and the device-trace
arithmetic. Later changes to the program cannot move this yardstick.

Frozen copies, from commit 04a1e524cdc5937c3e98edbd932966ee851fe027:

- ``bound``, ``compact_bytes``, ``pair_sums_bound``, the peaks and the
  pair kernel's operation counts: ``chip_smoke.py`` (``bound`` :385,
  ``compact_bytes`` :391, ``pair_sums_bound`` :2970, the constants
  :318-323 and :2683-2691); ``compact_bytes`` takes a row width and
  counts here in place of tensors.
- the extraction's bytes: ``chip_smoke.py::time_extract_kmers`` (:3604).
- ``union_us``, ``top_events``: ``simka_tpu_torch/profiling/trace.py``
  (:39, :50).

The sort's bound is new: 16 B a key, each 8-byte key read once and
written once.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Iterable, List, Tuple

# published peaks of one H100 SXM (NVIDIA's H100 datasheet)
HBM_BYTES_PER_S = 3.35e12
# 32-bit integer instructions: 64 integer lanes an SM, a quarter of the
# datasheet's 67 TFLOP/s float32 rate (128 lanes, an FMA two operations)
INT32_OPS_PER_S = 67e12 / 4
# the pair kernel's 32-bit integer instructions a pair and channel, and
# a whittaker_all term: one 64-bit add each (the index arithmetic, the
# loads and the products are not counted: the bound stays a floor)
PAIR_SUMS_INT_OPS = 2
# the f64 operations a pair of the complex channels takes, a division
# and a log one each (the floor of every channel)
PAIR_SUMS_F64_OPS = 32
# f64 instructions a second: the datasheet's 34 TFLOP/s FP64 outside the
# tensor cores (64 f64 lanes an SM), an FMA two operations
F64_OPS_PER_S = 34e12 / 2
# the pair kernel's output channels: ab, ba, distinct, bray; hellinger
# and chord with the simple distances; whittaker, s12 and the five
# Kullback-Leibler limbs with the complex ones
PAIR_CHANNELS_DEFAULT = 4
PAIR_CHANNELS_SIMPLE = 2
PAIR_CHANNELS_COMPLEX = 2 + 5

Interval = Tuple[float, float, str]  # start us, end us, name


def bound(nbytes: float, ops: float = 0.0,
          ops_rate: float = INT32_OPS_PER_S):
    """(least ms the card could take, "bytes" or "operations")."""
    b, o = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_rate * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


def compact_bytes(row_bytes: int, E: int, n: int, fill: bool) -> int:
    """The mask read once, each kept row read once, each output row
    written once."""
    return E + n * row_bytes + (E if fill else n) * row_bytes


def extract_bytes(packed_bytes: int, valid_bytes: int, windows: int,
                  n_words: int) -> int:
    """One extraction launch with the histogram: the packed codes and
    validity read once, the words, mask and counts written once."""
    return packed_bytes + valid_bytes + windows * (8 * n_words + 1) + 8 * 17


def sort_bytes(keys: int) -> int:
    """One sort of 8-byte keys: each read once and written once."""
    return 16 * keys


def pair_channels(simple: bool, complex_: bool) -> int:
    return (PAIR_CHANNELS_DEFAULT + simple * PAIR_CHANNELS_SIMPLE
            + complex_ * PAIR_CHANNELS_COMPLEX)


def pair_sums_bound(n: int, S: int, N: int, pairs: int, n_chans: int,
                    complex_: bool, sample_counts: int) -> tuple:
    """(bound ms, "bytes" or "operations") of one pair_sums call: rows
    and segments read once, outputs written once; the larger of the
    32-bit integer instructions (PAIR_SUMS_INT_OPS a pair and channel
    and a whittaker_all term) at INT32_OPS_PER_S and the f64 floor
    (PAIR_SUMS_F64_OPS a pair) at F64_OPS_PER_S. A whittaker_all term
    |w32(c K_j)| depends on (c, j) alone, so A[a][.] needs N terms for
    each distinct (sample, count) of the rows, ``sample_counts`` of
    them, each added times its rows (the rows are read in the bytes)."""
    nbytes = 16 * n + 16 * S + 8 * N + (n_chans + complex_) * N * N * 8
    int_ops = (pairs * n_chans + complex_ * sample_counts * N
               ) * PAIR_SUMS_INT_OPS
    f64_ms = complex_ * pairs * PAIR_SUMS_F64_OPS / F64_OPS_PER_S * 1e3
    b_ms, b_by = bound(nbytes, int_ops, INT32_OPS_PER_S)
    return (f64_ms, "operations") if f64_ms > b_ms else (b_ms, b_by)


def union_us(intervals: Iterable[Interval]) -> float:
    """Length of the union of the intervals."""
    total, end = 0.0, float("-inf")
    for s, e, _ in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def top_events(intervals: List[Interval], n: int = 12) -> list:
    """[(total us, count, name)] of the ``n`` names with most time."""
    by_name = defaultdict(lambda: [0.0, 0])
    for s, e, name in intervals:
        by_name[name][0] += e - s
        by_name[name][1] += 1
    rows = [(t, c, name) for name, (t, c) in by_name.items()]
    return sorted(rows, reverse=True)[:n]
