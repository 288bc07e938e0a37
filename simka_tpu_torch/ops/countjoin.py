"""K-mer counting + cross-sample join + default distance statistics.

The torch counterpart of ``simka_tpu.ops.countjoin.count_join_stats``
for the default distance channels:

  1. sort the (k-mer, sample) instances so equal pairs are adjacent;
     run lengths give each sample's count of each k-mer;
  2. the per-sample abundance filter (amin <= count <= amax) keeps one
     row per solid (k-mer, sample), made contiguous by the stable
     compaction (``ops.compact``) -- order stays (k-mer, sample)
     ascending;
  3. per-bank totals, then segments of equal k-mers;
  4. pair sums in direct form: for each offset d, rows i and i + d of
     one segment are a co-present pair (a, b) with a < b, added into
     flat [N * N] int64 sums with ``index_add_``.

Every default channel is an exact integer sum, so results equal the
reference bit for bit on any device.

K-mers travel as ONE int64 each (k <= 31: 2k <= 62 bits). Two sort
paths, chosen as in the reference:
  - packed: when 2k + sbits <= 63 (sbits = bits of N - 1, at least 1),
    one int64 key ``(kmer << sbits) | sid`` sorts in one pass -- k=21
    up to N = 2^21, k=31 only at N <= 2;
  - multi-key: otherwise. torch has no multi-key sort, so a stable
    sort by k-mer follows a sort by sample id, which gives the
    lexicographic (k-mer, sample) order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class JoinStats(NamedTuple):
    """Raw sufficient statistics (``simka_tpu.ops.countjoin.JoinStats``).

    Pairwise arrays hold UPPER-TRIANGLE pair sums (a < b);
    symmetrisation and the diagonal happen in
    ``core.stats.SimkaStatistics.from_join_stats``. The simple and
    complex channels are zeros: the port computes the default
    distances only.
    """

    nb_distinct: torch.Tensor  # scalar i64: distinct k-mers in the union
    nb_shared: torch.Tensor  # scalar i64: distinct k-mers in >= 2 banks
    distinct_per_bank: torch.Tensor  # [N] i64
    solid_per_bank: torch.Tensor  # [N] i64
    chord_n2_per_bank: torch.Tensor  # [N] i64 (sum of count^2)
    shared_kmers_ab: torch.Tensor  # [N, N] i64 upper: sum C_a over pairs
    shared_kmers_ba: torch.Tensor  # [N, N] i64 upper: sum C_b over pairs
    shared_distinct: torch.Tensor  # [N, N] i64 upper: co-present count
    bray_numerator: torch.Tensor  # [N, N] i64 upper: sum min(Ca, Cb)
    chord_ninj: torch.Tensor  # [N, N] f64 (simple; zeros)
    hellinger: torch.Tensor  # [N, N] i64 (simple; zeros)
    whittaker: torch.Tensor  # [N, N] i64 (complex; zeros)
    whittaker_all: torch.Tensor  # [N, N] i64 (complex; zeros)
    whittaker_s12: torch.Tensor  # [N, N] i64 (complex; zeros)
    kullback_leibler: torch.Tensor  # [N, N] f64 (complex; zeros)
    max_count: torch.Tensor  # scalar i64: max per-(kmer, bank) count

    def to_numpy(self) -> "JoinStats":
        """The same tuple with every field a numpy array on the host."""
        return JoinStats(*(t.cpu().numpy() for t in self))


def _sbits(n_banks: int) -> int:
    return max(1, (n_banks - 1).bit_length())


def _run_counts(boundary: torch.Tensor) -> torch.Tensor:
    """int32 run length at each run's first row (0 elsewhere)."""
    E = boundary.shape[0]
    starts = boundary.nonzero().squeeze(1)
    ends = torch.cat([starts[1:], starts.new_tensor([E])])
    count = torch.zeros(E, dtype=torch.int32, device=boundary.device)
    count[starts] = (ends - starts).to(torch.int32)
    return count


def _first_of_run(*cols: torch.Tensor) -> torch.Tensor:
    """Rows that differ from their predecessor in any column."""
    E = cols[0].shape[0]
    diff = torch.ones(E, dtype=torch.bool, device=cols[0].device)
    if E > 1:
        changed = torch.zeros(E - 1, dtype=torch.bool, device=cols[0].device)
        for c in cols:
            changed |= c[1:] != c[:-1]
        diff[1:] = changed
    return diff


def solid_rows(
    kmer: torch.Tensor,
    sid: torch.Tensor,
    abundance_min: int,
    abundance_max: int,
    *,
    n_banks: int,
    kmer_bits: int,
):
    """Sort + run-length count + abundance filter.

    Returns (kmer, sid, count): one row per solid (k-mer, sample), in
    (k-mer, sample)-ascending order, as int64 / int64 / int32.
    """
    from simka_tpu_torch.ops.compact import compact_rows

    sbits = _sbits(n_banks)
    if kmer_bits + sbits <= 63:
        # packed path: one int64 key carries (kmer, sid)
        key = torch.sort((kmer << sbits) | sid.to(torch.int64)).values
        boundary = _first_of_run(key)
        count = _run_counts(boundary)
        kept = boundary & (count >= abundance_min) & (count <= abundance_max)
        n = int(kept.sum())
        key_c, cnt_c = compact_rows((key, count), kept, fills=(-1, 0))
        key_c = key_c[:n]
        return key_c >> sbits, key_c & ((1 << sbits) - 1), cnt_c[:n]

    # multi-key path: (kmer, sid) lexicographic order from a stable
    # sort by k-mer over rows already ordered by sample id
    by_sid = torch.sort(sid.to(torch.int64), stable=True)
    kmer1 = kmer[by_sid.indices]
    by_kmer = torch.sort(kmer1, stable=True)
    kmer2 = by_kmer.values
    sid2 = by_sid.values[by_kmer.indices]
    del kmer1, by_sid, by_kmer
    boundary = _first_of_run(kmer2, sid2)
    count = _run_counts(boundary)
    kept = boundary & (count >= abundance_min) & (count <= abundance_max)
    n = int(kept.sum())
    k_c, s_c, c_c = compact_rows(
        (kmer2, sid2, count), kept, fills=(-1, 0, 0)
    )
    return k_c[:n], s_c[:n], c_c[:n]


def stats_from_rows(kmer, sid, count, *, n_banks: int) -> JoinStats:
    """Per-bank totals, segments and default pair sums over solid rows
    in (k-mer, sample)-ascending order."""
    N = n_banks
    dev = kmer.device
    i64 = torch.int64
    sid = sid.to(i64)
    c64 = count.to(i64)
    n = kmer.shape[0]

    def per_bank(values):
        return torch.zeros(N, dtype=i64, device=dev).index_add_(0, sid, values)

    distinct_per_bank = per_bank(torch.ones_like(c64))
    solid_per_bank = per_bank(c64)
    chord_n2_per_bank = per_bank(c64 * c64)

    newk = _first_of_run(kmer)
    seg = torch.cumsum(newk, 0)
    starts = newk.nonzero().squeeze(1)
    seg_len = torch.cat([starts[1:], starts.new_tensor([n])]) - starts
    nb_distinct = torch.tensor(starts.shape[0], dtype=i64, device=dev)
    nb_shared = (seg_len >= 2).sum().to(i64)
    d_max = int(seg_len.max()) if n else 0

    flat = {
        name: torch.zeros(N * N, dtype=i64, device=dev)
        for name in ("ab", "ba", "distinct", "bray")
    }
    for d in range(1, d_max):
        pair = (seg[d:] == seg[:-d]).nonzero().squeeze(1)
        a, b = sid[pair], sid[pair + d]
        ca, cb = c64[pair], c64[pair + d]
        idx = a * N + b
        flat["ab"].index_add_(0, idx, ca)
        flat["ba"].index_add_(0, idx, cb)
        flat["distinct"].index_add_(0, idx, torch.ones_like(ca))
        flat["bray"].index_add_(0, idx, torch.minimum(ca, cb))

    zeros_i = torch.zeros((N, N), dtype=i64, device=dev)
    zeros_f = torch.zeros((N, N), dtype=torch.float64, device=dev)
    return JoinStats(
        nb_distinct=nb_distinct,
        nb_shared=nb_shared,
        distinct_per_bank=distinct_per_bank,
        solid_per_bank=solid_per_bank,
        chord_n2_per_bank=chord_n2_per_bank,
        shared_kmers_ab=flat["ab"].view(N, N),
        shared_kmers_ba=flat["ba"].view(N, N),
        shared_distinct=flat["distinct"].view(N, N),
        bray_numerator=flat["bray"].view(N, N),
        chord_ninj=zeros_f,
        hellinger=zeros_i,
        whittaker=zeros_i.clone(),
        whittaker_all=zeros_i.clone(),
        whittaker_s12=zeros_i.clone(),
        kullback_leibler=zeros_f.clone(),
        max_count=(c64.max() if n else torch.zeros((), dtype=i64, device=dev)),
    )


def count_join_stats(
    kmer: torch.Tensor,
    sid: torch.Tensor,
    abundance_min: int,
    abundance_max: int,
    *,
    n_banks: int,
    kmer_bits: int,
) -> JoinStats:
    """All default-channel sufficient statistics of an instance stream.

    Args:
      kmer: [E] int64 canonical k-mers, each in [0, 2^kmer_bits).
      sid: [E] int32 or int64 sample index of each instance, in
        [0, n_banks).
      abundance_min/max: per-sample solidity bounds (keep
        amin <= count <= amax).
      n_banks: number of samples N.
      kmer_bits: bits of a k-mer value, 2k for k <= 31 (at most 62).

    The stream holds real instances only: there is no invalid-window
    sentinel in int64, so a value outside [0, 2^kmer_bits) -- or a
    sample id outside [0, n_banks) -- raises ValueError.
    """
    if not 1 <= kmer_bits <= 62:
        raise NotImplementedError(
            f"kmer_bits={kmer_bits}: the port handles k <= 31 "
            "(k > 31 is ROADMAP queue 1, item 7)"
        )
    if kmer.dtype != torch.int64 or kmer.shape != sid.shape:
        raise ValueError("kmer must be int64 and shaped like sid")
    if kmer.numel():
        bounds = torch.stack([
            kmer.min(), kmer.max(), sid.min().to(torch.int64),
            sid.max().to(torch.int64),
        ]).tolist()
        if bounds[0] < 0 or bounds[1] >> kmer_bits:
            raise ValueError(
                f"k-mer values outside [0, 2^{kmer_bits}): invalid "
                "windows must be dropped before the join"
            )
        if bounds[2] < 0 or bounds[3] >= n_banks:
            raise ValueError(f"sample ids outside [0, {n_banks})")
    rows = solid_rows(
        kmer, sid, abundance_min, abundance_max,
        n_banks=n_banks, kmer_bits=kmer_bits,
    )
    return stats_from_rows(*rows, n_banks=n_banks)
