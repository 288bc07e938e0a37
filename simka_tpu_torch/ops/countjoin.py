"""K-mer counting + cross-sample join + distance statistics.

The torch counterpart of ``simka_tpu.ops.countjoin.count_join_stats``:

  1. sort the (k-mer, sample) instances so equal pairs are adjacent;
     run lengths give each sample's count of each k-mer;
  2. the per-sample abundance filter (amin <= count <= amax) keeps one
     row per solid (k-mer, sample), made contiguous by the stable
     compaction (``ops.compact``) -- order stays (k-mer, sample)
     ascending (the run lengths and the filter: ``run_counts``);
  3. per-bank totals and the segments of equal k-mers, their starts
     in order (one pass, ``segment_stats``);
  4. pair sums in direct form: every two rows of one segment are a
     co-present pair (a, b) with a < b, added into flat [N * N] int64
     sums, with Whittaker's all-rows sums in the same pass
     (``pair_sums``: on a CUDA tensor the hand-written kernel of
     ``csrc/pair_sums.cu``, on a CPU tensor its plain torch version,
     ``_pair_sums_plain``, one offset d at a time with ``index_add_``,
     and ``_whittaker_all``).

``run_counts`` and ``segment_stats`` launch the hand-written kernels of
``csrc/runs.cu`` on CUDA tensors and take their plain torch versions
(``_run_counts_plain``, ``_segment_stats_plain``) on CPU tensors.

Every integer channel is an exact sum, so it equals the reference bit
for bit on any device. The two float channels are made
order-independent, so that every device and every run gives the same
bits: chord is an int64 sum of products converted once, and
Kullback-Leibler sums its f64 terms as fixed-point int64 limbs,
rounded once on the host (``_kl_limbs``). The reference sums both as
f32 halves over 8192-row panels: chord's integer terms keep those sums
exact at moderate counts, KL's round, up to ~6e-6 relative off the
exact sum (ROADMAP.md, section 3).

K-mers are the big-endian int64 word tuples of ``ops.kmers`` (one
word for k <= 31). Two sort paths, chosen as in the reference:
  - packed: one word and 2k + sbits <= 63 (sbits = bits of N - 1, at
    least 1): one int64 key ``(kmer << sbits) | sid`` sorts in one
    sort -- k=21 up to N = 2^21, k=31 only at N <= 2 -- on CUDA the
    keys-only radix sort of ``csrc/sort.cu`` over its 2k + sbits used
    bits, which forms the key itself (``ops.sort.sort_packed_keys``);
  - multi-key: otherwise. torch has no multi-key sort, so stable
    sorts chain from the least significant key (the sample id) up to
    the first word, which gives the lexicographic (k-mer, sample)
    order.

``join_stats_from_spectra`` starts from counted rows instead (the
-out-tmp path's per-sample spectra): the abundance filter compacts
them first, then the same sort and pair sums follow. Its raw form
(``_raw_join_from_spectra``) keeps chord as its int64 sum and KL as
its limb sums, so the out-of-core sweep (``core.sweep``) adds the
stats of its hash ranges exactly and converts them once (``_finish``);
there ``solid_override`` gives every range the whole samples' solid
totals.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence, Union

import torch

from simka_tpu_torch.ops.kmers import WORD_BASES
from simka_tpu_torch.ops.sort import sort_packed_keys
from simka_tpu_torch.utils.metrics import span

# Whittaker A is accumulated over blocks of this many banks j (the
# reference's block width) and of this many rows, which bound its
# [rows, JB] temporaries.
WHITTAKER_JB = 8
WHITTAKER_ROWS = 1 << 24

# Kullback-Leibler terms as fixed point: an integer limb and
# KL_FRAC_LIMBS fractional limbs of KL_LIMB_BITS bits (resolution
# 2^-112, far below an f64 term's last bit). A limb is < 2^28, so a
# pair bin's int64 sums hold up to 2^35 pairs.
KL_LIMB_BITS = 28
KL_FRAC_LIMBS = 4

_TWO32 = 2.0**32

# the pair channels of ``pair_sums`` in the kernel's order
# (csrc/pair_sums.cu): the default four, the simple two, the complex
# two; the KL limbs follow as channels 8..12
PAIR_CHANNELS = ("ab", "ba", "distinct", "bray", "hellinger", "chord",
                 "whittaker", "s12")

# kernel launches on the CUDA path (the CPU path does not count): the
# pair kernel's, run_counts' and segment_stats'
launches = 0
run_counts_launches = 0
segment_stats_launches = 0
INT32_MAX = (1 << 31) - 1


class JoinStats(NamedTuple):
    """Raw sufficient statistics (``simka_tpu.ops.countjoin.JoinStats``).

    Pairwise arrays hold UPPER-TRIANGLE pair sums (a < b);
    symmetrisation and the diagonal happen in
    ``core.stats.SimkaStatistics.from_join_stats``. The simple and
    complex channels are zeros unless asked for.
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
    chord_ninj: torch.Tensor  # [N, N] f64 upper: sum Ca*Cb (simple)
    hellinger: torch.Tensor  # [N, N] i64 upper: sum isqrt(Ca*Cb) (simple)
    whittaker: torch.Tensor  # [N, N] i64 upper: wrapped |Ca*Kb - Cb*Ka|
    whittaker_all: torch.Tensor  # [N, N] i64 ordered: all rows (complex)
    whittaker_s12: torch.Tensor  # [N, N] i64 upper (complex)
    kullback_leibler: torch.Tensor  # [N, N] f64 upper pair terms (complex)
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


def _run_counts_plain(cols, abundance_min: int, abundance_max: int):
    """The plain torch version of the run-count kernel."""
    boundary = _first_of_run(*cols)
    count = _run_counts(boundary)
    keep = boundary & (count >= abundance_min) & (count <= abundance_max)
    return count, keep, keep.sum()


def _key_columns(what: str, cols, max_cols: int):
    """``cols`` as a tuple, once they are 1 to ``max_cols`` [E] int32 or
    int64 columns on one device (contiguous on CUDA); ValueError
    otherwise. Returns (cols, E, device)."""
    cols = tuple(cols)
    if not 1 <= len(cols) <= max_cols:
        raise ValueError(f"{what}: 1 to {max_cols} key columns")
    E, dev = cols[0].shape[0], cols[0].device
    for c in cols:
        if (c.dim() != 1 or c.shape[0] != E or c.device != dev
                or c.dtype not in (torch.int32, torch.int64)):
            raise ValueError(f"{what}: key columns must be [E] int32/int64 "
                             "on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    if dev.type == "cuda" and not all(c.is_contiguous() for c in cols):
        raise ValueError(f"{what} needs contiguous tensors on CUDA")
    return cols, E, dev


def run_counts(cols: Sequence[torch.Tensor], abundance_min: int = 1,
               abundance_max: int = INT32_MAX):
    """Run lengths of rows sorted on the key columns ``cols`` (1 to 8
    [E] int32/int64 columns; a run: equal rows in every column).

    Returns (count [E] int32: the run length at each run's first row, 0
    elsewhere; keep [E] bool: first rows with abundance_min <= count <=
    abundance_max; the kept total, a 0-dim int64 tensor on the rows'
    device). With the default bounds keep is the first-of-run mask.

    On CUDA tensors this launches the kernel of ``csrc/runs.cu`` once
    (one pass, no scratch) or raises; on CPU tensors it is the plain
    version (``_first_of_run`` + ``_run_counts``), bit for bit the same.
    """
    global run_counts_launches
    cols, E, dev = _key_columns("run_counts", cols, 8)
    if dev.type == "cpu":
        return _run_counts_plain(cols, abundance_min, abundance_max)
    if E == 0:
        return (torch.empty(0, dtype=torch.int32, device=dev),
                torch.empty(0, dtype=torch.bool, device=dev),
                torch.zeros((), dtype=torch.int64, device=dev))
    from simka_tpu_torch.ops import _kernels

    lib = _kernels.lib()
    count = torch.empty(E, dtype=torch.int32, device=dev)
    keep = torch.empty(E, dtype=torch.bool, device=dev)
    total = torch.empty(1, dtype=torch.int64, device=dev)
    n = len(cols)
    ptrs = (ctypes.c_void_p * n)(*[c.data_ptr() for c in cols])
    sizes = (ctypes.c_int * n)(*[c.element_size() for c in cols])
    with torch.cuda.device(dev):
        code = lib.simka_run_counts(
            ctypes.addressof(ptrs), ctypes.addressof(sizes), n, E,
            int(abundance_min), int(abundance_max), count.data_ptr(),
            keep.data_ptr(), total.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check(code, "run_counts")
    run_counts_launches += 1
    return count, keep, total[0]


def _segment_stats_plain(words, sid, count, n_banks: int):
    """The plain torch version of the segment kernel; ``starts`` of
    exactly nb_distinct + 1 entries."""
    N = n_banks
    dev = sid.device
    i64 = torch.int64
    sid = sid.to(i64)
    c64 = count.to(i64)
    n = sid.shape[0]
    bins = torch.zeros((3, N), dtype=i64, device=dev)
    for row, values in zip(bins, (torch.ones_like(c64), c64, c64 * c64)):
        row.index_add_(0, sid, values)
    first = torch.cat([_first_of_run(*words).nonzero().squeeze(1),
                       torch.tensor([n], dtype=i64, device=dev)])
    seg_len = first[1:] - first[:-1]
    zero = torch.zeros((), dtype=i64, device=dev)
    scalars = torch.stack([
        torch.tensor(seg_len.shape[0], dtype=i64, device=dev),
        (seg_len >= 2).sum().to(i64),
        seg_len.max() if n else zero,
        c64.max() if n else zero,
    ])
    return bins, first, scalars


def segment_stats(words: Sequence[torch.Tensor], sid: torch.Tensor,
                  count: torch.Tensor, *, n_banks: int):
    """Per-bank totals and the segments of equal k-mers over solid rows
    in (k-mer, sample)-ascending order (``simka_tpu``'s per-bank
    ``binned_sum`` x 3 and ``_segment_rows``), in one pass.

    Args:
      words: 1 to 5 [n] int64 word columns; sid, count: [n] int32 or
        int64, sid in [0, n_banks).

    Returns (bins [3, N] int64: distinct_per_bank, solid_per_bank and
    chord_n2_per_bank; starts int64: starts[j] the first row of the j-th
    k-mer for j < nb_distinct and starts[nb_distinct] = n -- on CUDA of
    capacity n + 1, the entries past nb_distinct not specified, on the
    CPU exactly nb_distinct + 1 entries;
    scalars [4] int64: nb_distinct, nb_shared (k-mers of >= 2 rows),
    d_max (the longest segment) and max_count), on the rows' device.

    On CUDA tensors this launches the kernel of ``csrc/runs.cu`` once
    (one pass, the starts in order by decoupled look-back) or raises; on
    CPU tensors it is the plain version, bit for bit the same.
    """
    global segment_stats_launches
    words, n, dev = _key_columns("segment_stats", words, 5)
    _key_columns("segment_stats", (sid, count), 2)
    if any(w.dtype != torch.int64 for w in words) or sid.shape[0] != n \
            or sid.device != dev:
        raise ValueError("segment_stats: int64 words, and sid and count "
                         "of their length on their device")
    if dev.type == "cpu":
        return _segment_stats_plain(words, sid, count, n_banks)
    N = n_banks
    i64 = torch.int64
    bins = torch.zeros((3, N), dtype=i64, device=dev)
    first = torch.empty(n + 1, dtype=i64, device=dev)
    scalars = torch.zeros(4, dtype=i64, device=dev)
    if n == 0:
        first.zero_()
        return bins, first, scalars
    from simka_tpu_torch.ops import _kernels

    lib = _kernels.lib()
    # [ticket counter, one status word a tile]
    scratch = torch.empty(1 + -(-n // lib.simka_runs_tile_rows()),
                          dtype=i64, device=dev)
    ptrs = (ctypes.c_void_p * len(words))(*[w.data_ptr() for w in words])
    with torch.cuda.device(dev):
        code = lib.simka_segment_stats(
            ctypes.addressof(ptrs), len(words), n, sid.data_ptr(),
            sid.element_size(), count.data_ptr(), count.element_size(), N,
            bins.data_ptr(), scalars.data_ptr(),
            first.data_ptr(), scratch.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check(code, "segment_stats")
    segment_stats_launches += 1
    return bins, first, scalars


def _lex_order(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Permutation sorting rows by ``keys`` lexicographically (first
    key most significant): stable sorts from the last key up."""
    perm = None
    for key in reversed(keys):
        col = key if perm is None else key[perm]
        order = torch.sort(col, stable=True).indices
        perm = order if perm is None else perm[order]
    return perm


def solid_rows(
    words: Sequence[torch.Tensor],
    sid: torch.Tensor,
    abundance_min: int,
    abundance_max: int,
    *,
    n_banks: int,
    kmer_bits: int,
    spans=None,
):
    """Sort + run-length count + abundance filter.

    Returns (words, sid, count): one row per solid (k-mer, sample), in
    (k-mer, sample)-ascending order; int64 words, an int64 or int32
    sid and an int32 count. Every word lies in its ``kmer_bits`` range
    and every sample id in [0, n_banks) (``_checked_rows``; the
    extraction's words are): the packed sort sorts only the key's used
    bits. Spans (``spans``): ``simka.join.sort``, then
    ``_compact_solid``'s.
    """
    nw = len(words)
    sbits = _sbits(n_banks)
    if nw == 1 and kmer_bits + sbits <= 63:
        # packed path: one int64 key carries (kmer, sid), sorted over its
        # kmer_bits + sbits used bits (``ops.sort``)
        with span("simka.join.sort", spans):
            key = sort_packed_keys(words[0], sid, sbits, kmer_bits + sbits)
        key_c, cnt_c = _compact_solid((key,), abundance_min, abundance_max,
                                      (-1,), spans)
        return (key_c >> sbits,), key_c & ((1 << sbits) - 1), cnt_c

    # multi-key path (one bank: the sample id is no key)
    with span("simka.join.sort", spans):
        perm = _lex_order((*words, sid) if n_banks > 1 else words)
        words = tuple(w[perm] for w in words)
        sid = sid[perm]
        del perm
    cols = _compact_solid((*words, sid), abundance_min, abundance_max,
                          (-1,) * nw + (0,), spans)
    return cols[:nw], cols[nw], cols[nw + 1]


def _compact_solid(cols, abundance_min: int, abundance_max: int, fills,
                   spans):
    """Sorted key columns ``cols`` and their run counts, compacted to
    the solid rows: (*cols, count). Spans: ``simka.join.run_counts``,
    whose count of solid rows waits for the device
    (``simka.sync.solid_count``), and ``simka.join.compact``."""
    from simka_tpu_torch.ops.compact import compact_rows

    with span("simka.join.run_counts", spans):
        count, kept, n = run_counts(cols, abundance_min, abundance_max)
        with span("simka.sync.solid_count", spans):
            n = int(n)
    with span("simka.join.compact", spans):
        return compact_rows((*cols, count), kept, fills=(*fills, 0), n=n)


def _abs_wrap32(prod: torch.Tensor) -> torch.Tensor:
    """|int32 reinterpretation of (u64)(double product)| as int64: the
    reference's Whittaker accumulator (``_abs_wrap32``). The floor
    modulo of an integer-valued f64 is exact."""
    low = torch.remainder(prod, _TWO32)
    return torch.abs(torch.where(low >= 2.0**31, low - _TWO32, low)).to(
        torch.int64
    )


def _whittaker_all(sid, c64, K, n_banks: int) -> torch.Tensor:
    """A[i][j] = sum over solid rows (k, i, c) of |int32(u64(c * K_j))|
    (``_whittaker_all_banks``), blocked over banks j and rows."""
    N = n_banks
    out = torch.zeros((N, N), dtype=torch.int64, device=sid.device)
    Kf = K.to(torch.float64)
    for r0 in range(0, sid.shape[0], WHITTAKER_ROWS):
        s = sid[r0 : r0 + WHITTAKER_ROWS]
        c = c64[r0 : r0 + WHITTAKER_ROWS].to(torch.float64)
        for j0 in range(0, N, WHITTAKER_JB):
            v = _abs_wrap32(c[:, None] * Kf[None, j0 : j0 + WHITTAKER_JB])
            out[:, j0 : j0 + WHITTAKER_JB].index_add_(0, s, v)
    return out


def _kl_limbs(x: torch.Tensor) -> torch.Tensor:
    """[P] f64 -> [P, 1 + KL_FRAC_LIMBS] int64 fixed-point limbs of x
    truncated toward zero at 2^-112: the limbs of |x| (its floor, then
    successive KL_LIMB_BITS-bit fractional digits), each times the
    sign of x. Every step is exact (a non-negative float minus its
    floor, scaling by a power of two), so limb sums are the exact sum
    of the truncated terms, in any order."""
    r = torch.abs(x)
    whole = torch.floor(r)
    r = r - whole
    limbs = [whole]
    for _ in range(KL_FRAC_LIMBS):
        r = r * float(1 << KL_LIMB_BITS)
        q = torch.floor(r)
        r = r - q
        limbs.append(q)
    return (torch.stack(limbs, 1) * torch.sign(x)[:, None]).to(torch.int64)


def _kl_from_limbs(sums: torch.Tensor, spans=None) -> torch.Tensor:
    """[M, 1 + KL_FRAC_LIMBS] int64 limb sums -> [M] f64, each the
    exact fixed-point total rounded once (Python's int division rounds
    correctly). The read of the sums waits for the device
    (``simka.sync.kl``)."""
    bits = KL_LIMB_BITS * KL_FRAC_LIMBS
    with span("simka.sync.kl", spans):
        rows = sums.cpu().tolist()
    vals = [
        sum(v << (KL_LIMB_BITS * (KL_FRAC_LIMBS - j))
            for j, v in enumerate(row)) / (1 << bits)
        for row in rows
    ]
    return torch.tensor(vals, dtype=torch.float64, device=sums.device)


def _pair_sums_plain(sid, count, starts, seg_len, K, flat, kl, *,
                     d_max: int, whittaker_all=None) -> None:
    """The plain torch version of ``pair_sums``: for each offset
    d < d_max, rows i and i + d of one segment are a pair, gathered
    with one ``nonzero`` and added with one ``index_add_`` a channel;
    Whittaker's all-rows sums by ``_whittaker_all``."""
    N = K.shape[0]
    i64, f64 = torch.int64, torch.float64
    seg = torch.repeat_interleave(
        torch.arange(starts.shape[0], device=sid.device), seg_len,
        output_size=sid.shape[0])
    c64, Kf = count, K
    simple, complex_ = "hellinger" in flat, "whittaker" in flat
    if whittaker_all is not None:
        whittaker_all += _whittaker_all(sid, c64, Kf, N).view(-1)
    for d in range(1, d_max):
        pair = (seg[d:] == seg[:-d]).nonzero().squeeze(1)
        a, b = sid[pair], sid[pair + d]
        ca, cb = c64[pair], c64[pair + d]
        idx = a * N + b
        flat["ab"].index_add_(0, idx, ca)
        flat["ba"].index_add_(0, idx, cb)
        flat["distinct"].index_add_(0, idx, torch.ones_like(ca))
        flat["bray"].index_add_(0, idx, torch.minimum(ca, cb))
        if simple:
            prod = ca * cb
            flat["hellinger"].index_add_(
                0, idx, torch.floor(torch.sqrt(prod.to(f64))).to(i64)
            )
            flat["chord"].index_add_(0, idx, prod)
        if complex_:
            # Whittaker's pair term wraps the difference of the two
            # rounded double products to int32 (SimkaAlgorithm.hpp:481)
            caf, cbf = ca.to(f64), cb.to(f64)
            Ka, Kb = Kf[a], Kf[b]
            xY, yX = caf * Kb, cbf * Ka
            low = torch.remainder(
                torch.remainder(xY, _TWO32) - torch.remainder(yX, _TWO32),
                _TWO32,
            ).to(i64)
            flat["whittaker"].index_add_(
                0, idx, torch.abs(torch.where(low >= 1 << 31, low - (1 << 32),
                                              low))
            )
            flat["s12"].index_add_(0, idx, _abs_wrap32(xY) + _abs_wrap32(yX))
            # Kullback-Leibler pair term (SimkaAlgorithm.hpp:437-446);
            # only co-present pairs are gathered, so no term is masked
            den = xY + yX
            d1 = (caf / torch.clamp(Ka, min=1.0)) * torch.log(2.0 * xY / den)
            d2 = (cbf / torch.clamp(Kb, min=1.0)) * torch.log(2.0 * yX / den)
            kl.index_add_(0, idx, _kl_limbs(d1 + d2))


# csrc/pair_sums.cu's warps a CTA (kWarps), rows a chunk (kChunk) and
# sample groups a launch of the shared form (kMaxGroups)
PAIR_WARPS = 16
PAIR_CHUNK_ROWS = 1024
PAIR_MAX_GROUPS = 8


class PairPlan(NamedTuple):
    """How one launch of ``csrc/pair_sums.cu`` lays out its partials.

    ``form`` "shared": each CTA holds the partials of the samples
    ``groups[g] <= a < groups[g + 1]`` of its group g (every channel's
    bins (a, b), b > a, and whittaker_all's row A[a]), one copy for
    each team of ``team_warps`` warps (``PAIR_WARPS // team_warps``
    copies); ``warp_bounds[g]`` gives each warp of a team its samples.
    ``smem``: the bytes of partials a CTA. "global": every add goes
    straight into the outputs (the other fields are empty)."""

    form: str
    groups: tuple
    team_warps: int
    warp_bounds: tuple
    smem: int


GLOBAL_PLAN = PairPlan("global", (), 0, (), 0)


def _warp_split(weights: Sequence[int], lo: int, hi: int, warps: int) -> tuple:
    """Sample bounds of ``warps`` contiguous ranges of [lo, hi), cut at
    equal shares of the samples' weights (a sample goes to the warp of
    the weight before it)."""
    total = sum(weights[lo:hi])
    owner, before = [], 0
    for a in range(lo, hi):
        owner.append(before * warps // total if total else 0)
        before += weights[a]
    return (lo, *(lo + sum(o < k for o in owner) for k in range(1, warps)),
            hi)


def pair_plan(n_banks: int, n_slots: int, whittaker_all: bool, budget: int,
              d_max: int = 0) -> PairPlan:
    """The kernel's plan at N = ``n_banks`` for ``n_slots`` channels (and
    whittaker_all's rows when ``whittaker_all``) when a CTA may hold
    ``budget`` bytes of partials (``simka_pair_sums_budget``).

    A sample a takes 8 (n_slots (N - 1 - a) + N whittaker_all) bytes.
    The shared form with one group and as many copies (teams) as fit,
    16, 8, 4, 2 or 1; else one copy and the samples cut into the fewest
    groups, at most PAIR_MAX_GROUPS, of equal bytes (``_warp_split``)
    that each fit; else (or when a segment can pass a chunk, ``d_max``
    or N > PAIR_CHUNK_ROWS) the global form. Within a group, the team's
    warps take equal bytes too."""
    N = n_banks
    if (max(d_max, N) > PAIR_CHUNK_ROWS or budget <= 0 or N < 1
            or n_slots + whittaker_all == 0):
        return GLOBAL_PLAN
    per = [8 * (n_slots * (N - 1 - a) + (N if whittaker_all else 0))
           for a in range(N)]
    total = sum(per)
    teams = PAIR_WARPS
    while teams >= 1:
        if teams * total <= budget:
            wt = PAIR_WARPS // teams
            return PairPlan("shared", (0, N), wt, (_warp_split(per, 0, N, wt),),
                            teams * total)
        teams //= 2
    for n_groups in range(2, PAIR_MAX_GROUPS + 1):
        bounds = _warp_split(per, 0, N, n_groups)
        spans = list(zip(bounds, bounds[1:]))
        if all(lo < hi and sum(per[lo:hi]) <= budget for lo, hi in spans):
            return PairPlan("shared", bounds, PAIR_WARPS,
                            tuple(_warp_split(per, lo, hi, PAIR_WARPS)
                                  for lo, hi in spans),
                            max(sum(per[lo:hi]) for lo, hi in spans))
    return GLOBAL_PLAN


def _kernel_channels(flat) -> list:
    """The kernel's channel numbers on in ``flat`` (PAIR_CHANNELS'
    index; the KL limbs 8..12 with the complex channels)."""
    chans = [c for c, name in enumerate(PAIR_CHANNELS) if name in flat]
    if "whittaker" in flat:
        chans += [len(PAIR_CHANNELS) + j for j in range(1 + KL_FRAC_LIMBS)]
    return chans


def _pair_sums_cuda(sid, count, starts, seg_len, K, flat, kl, wall, *,
                    d_max: int) -> None:
    """The kernel of ``csrc/pair_sums.cu`` in one launch, planned by
    ``pair_plan`` from the card's shared memory."""
    from simka_tpu_torch.ops import _kernels

    with torch.cuda.device(sid.device):
        budget = _kernels.lib().simka_pair_sums_budget(
            K.shape[0], int("whittaker" in flat))
    if budget < 0:
        raise RuntimeError("pair_sums: the device's shared memory could not "
                           "be read")
    plan = pair_plan(K.shape[0], len(_kernel_channels(flat)),
                     wall is not None, budget, d_max)
    _launch_pair_sums(sid, count, starts, seg_len, K, flat, kl, wall, plan)


def _launch_pair_sums(sid, count, starts, seg_len, K, flat, kl, wall,
                      plan: PairPlan) -> None:
    """One launch of the kernel with ``plan`` over the channels of
    ``flat`` (and whittaker_all into ``wall`` unless None).
    ``chip_smoke.py`` also calls it to time the global form."""
    global launches
    from simka_tpu_torch.ops import _kernels

    lib = _kernels.lib()
    chans = _kernel_channels(flat)
    n_all = len(PAIR_CHANNELS) + 1 + KL_FRAC_LIMBS
    outs = (ctypes.c_void_p * (n_all + 1))()
    for c, name in enumerate(PAIR_CHANNELS):
        if name in flat:
            outs[c] = flat[name].data_ptr()
    for j in range(1 + KL_FRAC_LIMBS):
        outs[len(PAIR_CHANNELS) + j] = kl.data_ptr() + 8 * j
    if wall is not None:
        outs[n_all] = wall.data_ptr()
    slot = (ctypes.c_int * n_all)(*([-1] * n_all))
    for s, c in enumerate(chans):
        slot[c] = s
    shared = plan.form == "shared"
    groups = len(plan.groups) - 1 if shared else 0
    bounds = (ctypes.c_int * max(1, groups + 1))(*plan.groups)
    warp_bounds = (ctypes.c_int * max(1, groups * (plan.team_warps + 1)))(
        *(a for wb in plan.warp_bounds for a in wb))
    with torch.cuda.device(sid.device):
        stream = torch.cuda.current_stream(sid.device).cuda_stream
        code = lib.simka_pair_sums(
            sid.data_ptr(), count.data_ptr(), starts.data_ptr(),
            seg_len.data_ptr(), sid.shape[0], starts.shape[0], K.data_ptr(),
            K.shape[0], ctypes.addressof(outs), ctypes.addressof(slot),
            int(shared), groups, plan.team_warps, ctypes.addressof(bounds),
            ctypes.addressof(warp_bounds), stream)
    _kernels.check(code, "pair_sums")
    launches += 1


def pair_sums(sid, count, starts, seg_len, K, flat, kl, *,
              d_max: int, whittaker_all=None) -> None:
    """Add the pair terms of every two rows of one segment into ``flat``
    and ``kl`` (``simka_tpu``'s ``_pair_accumulate``), and Whittaker's
    all-rows sums into ``whittaker_all`` (its ``_whittaker_all_banks``).

    Args:
      sid, count: [n] int64 solid rows in (k-mer, sample)-ascending
        order (within a segment the sample ids ascend).
      starts, seg_len: [S] int64 first row and length of each segment
        of one k-mer, in order (starts[0] = 0, lengths summing to n).
      K: [N] float64 per-bank totals of the Whittaker and KL terms.
      flat: {name: [N * N] int64} the channels to add into, at
        a * N + b: ab, ba, distinct and bray; hellinger and chord for
        the simple distances; whittaker and s12 for the complex ones,
        which also add the KL limbs into ``kl``.
      kl: [N * N, 1 + KL_FRAC_LIMBS] int64 limb sums.
      d_max: the longest segment (at most N).
      whittaker_all: None, or [N * N] int64: adds, at a * N + j, the
        sum over the rows (a, c) of |int32(u64(c * K_j))| (every row,
        singletons too).

    On CUDA tensors this launches the kernel of ``csrc/pair_sums.cu``
    once or raises; on CPU tensors it is the plain version. Every
    channel is an integer sum, so the two agree bit for bit.
    """
    N = K.shape[0]
    dev = sid.device
    i64 = torch.int64
    cols = (sid, count, starts, seg_len)
    if (any(t.dtype != i64 or t.dim() != 1 or t.device != dev for t in cols)
            or K.dtype != torch.float64 or K.shape != (N,)
            or K.device != dev):
        raise ValueError("pair_sums: rows, starts and lengths must be 1-D "
                         "int64 and K [N] float64, on one device")
    if (not set(PAIR_CHANNELS[:4]) <= set(flat) <= set(PAIR_CHANNELS)
            or ("hellinger" in flat) != ("chord" in flat)
            or ("whittaker" in flat) != ("s12" in flat)):
        raise ValueError(f"pair_sums: channels {sorted(flat)}")
    outs = (*flat.values(), kl) + (
        () if whittaker_all is None else (whittaker_all,))
    if (any(t.dtype != i64 or t.device != dev for t in outs)
            or any(t.shape != (N * N,) for t in flat.values())
            or kl.shape != (N * N, 1 + KL_FRAC_LIMBS)
            or whittaker_all is not None
            and whittaker_all.shape != (N * N,)):
        raise ValueError("pair_sums: outputs must be int64 [N * N] and "
                         f"[N * N, {1 + KL_FRAC_LIMBS}] on the rows' device")
    if dev.type == "cpu":
        return _pair_sums_plain(sid, count, starts, seg_len, K, flat, kl,
                                d_max=d_max, whittaker_all=whittaker_all)
    if dev.type != "cuda":
        raise ValueError(f"pair_sums: unsupported device {dev}")
    if not all(t.is_contiguous() for t in (*cols, K, *outs)):
        raise ValueError("pair_sums needs contiguous tensors on CUDA")
    if sid.shape[0] == 0 or whittaker_all is None and (d_max < 2 or N < 2):
        return None  # no row, or no segment holds a pair
    return _pair_sums_cuda(sid, count, starts, seg_len, K, flat, kl,
                           whittaker_all, d_max=d_max)


def _segments(words, sid, count, n_banks: int, spans=None):
    """``segment_stats`` of solid rows and its one host read: (bins, scalars, d_max, starts, seg_len), the last
    two [nb_distinct] int64. The starts are copied out of the pass's
    buffer, one entry a row, so that the pair pass does not hold that
    buffer beside its own scratch: held, it raised the peak of the
    every-distance join at N = 100 (``chip_smoke.py`` phase 14b). The
    read waits for the device (``simka.sync.segments``)."""
    bins, starts, scalars = segment_stats(words, sid, count, n_banks=n_banks)
    read = scalars[[0, 2]]
    with span("simka.sync.segments", spans):
        n_segs, d_max = read.tolist()  # the one host read
    starts = starts[:n_segs + 1].clone()
    return bins, scalars, d_max, starts[:-1], starts[1:] - starts[:-1]


def _raw_stats_from_rows(
    words, sid, count, *, n_banks: int, simple: bool = False,
    complex_: bool = False, solid_override=None, spans=None,
) -> JoinStats:
    """Per-bank totals, segments and pair sums over solid rows in
    (k-mer, sample)-ascending order (``_stats_from_rows`` with
    ``_pair_accumulate``; the simple and complex channels only when
    asked for), in the raw form that sums exactly: every field as in
    ``JoinStats`` except ``chord_ninj``, still its int64 sum, and
    ``kullback_leibler``, its [N * N, 1 + KL_FRAC_LIMBS] int64 limb
    sums. Raw stats of disjoint k-mer sets add field by field
    (``max_count`` by max); ``_finish`` converts them once.

    ``solid_override``: [N] int64 per-bank solid totals to use as K in
    the Whittaker and KL terms instead of these rows' own (the sweep's
    whole-sample totals, ``simka_tpu``'s ``solid_override``); the
    returned ``solid_per_bank`` stays these rows' own. Spans
    (``spans``): ``simka.join.segments``, ``simka.join.pair_sums``."""
    N = n_banks
    dev = sid.device
    i64, f64 = torch.int64, torch.float64
    with span("simka.join.segments", spans):
        bins, scalars, d_max, starts, seg_len = _segments(words, sid, count,
                                                          N, spans)
    distinct_per_bank, solid_per_bank, chord_n2_per_bank = bins
    K = solid_per_bank if solid_override is None else solid_override.to(dev)

    names = ["ab", "ba", "distinct", "bray"]
    if simple:
        names += ["hellinger", "chord"]
    if complex_:
        names += ["whittaker", "s12"]
    with span("simka.join.pair_sums", spans):
        sid = sid.to(i64)
        c64 = count.to(i64)
        flat = {name: torch.zeros(N * N, dtype=i64, device=dev)
                for name in names}
        kl = torch.zeros((N * N, 1 + KL_FRAC_LIMBS), dtype=i64, device=dev)
        wall = torch.zeros(N * N, dtype=i64, device=dev) if complex_ else None
        # the global per-bank totals of the Whittaker and KL terms
        pair_sums(sid, c64, starts, seg_len, K.to(f64), flat, kl,
                  d_max=d_max, whittaker_all=wall)

    def pairs(name):
        if name in flat:
            return flat[name].view(N, N)
        return torch.zeros((N, N), dtype=i64, device=dev)

    return JoinStats(
        nb_distinct=scalars[0],
        nb_shared=scalars[1],
        distinct_per_bank=distinct_per_bank,
        solid_per_bank=solid_per_bank,
        chord_n2_per_bank=chord_n2_per_bank,
        shared_kmers_ab=pairs("ab"),
        shared_kmers_ba=pairs("ba"),
        shared_distinct=pairs("distinct"),
        bray_numerator=pairs("bray"),
        chord_ninj=pairs("chord"),
        hellinger=pairs("hellinger"),
        whittaker=pairs("whittaker"),
        whittaker_all=wall.view(N, N) if complex_ else pairs(
            "whittaker_all"),
        whittaker_s12=pairs("s12"),
        kullback_leibler=kl,
        max_count=scalars[3],
    )


def _add_raw(a: JoinStats, b: JoinStats) -> JoinStats:
    """Raw stats of two disjoint k-mer sets as one (the reference's
    SimkaStatistics::operator+=, SimkaDistance.cpp:156-213): every
    field summed, ``max_count`` a max."""
    return JoinStats(*(
        torch.maximum(x, y) if name == "max_count" else x + y
        for name, x, y in zip(JoinStats._fields, a, b)
    ))


def _finish(raw: JoinStats, complex_: bool, spans=None) -> JoinStats:
    """Raw stats as ``JoinStats``: chord converted to f64 once, KL's
    limb sums rounded once."""
    N = raw.solid_per_bank.shape[0]
    kl = raw.kullback_leibler
    return raw._replace(
        chord_ninj=raw.chord_ninj.to(torch.float64),
        kullback_leibler=(
            _kl_from_limbs(kl, spans).view(N, N) if complex_
            else torch.zeros((N, N), dtype=torch.float64, device=kl.device)
        ),
    )


def stats_from_rows(
    words, sid, count, *, n_banks: int, simple: bool = False,
    complex_: bool = False, solid_override=None, spans=None,
) -> JoinStats:
    """``JoinStats`` of solid rows in (k-mer, sample)-ascending order
    (``_raw_stats_from_rows``, converted in ``simka.join.finish``)."""
    raw = _raw_stats_from_rows(
        words, sid, count, n_banks=n_banks, simple=simple,
        complex_=complex_, solid_override=solid_override, spans=spans,
    )
    with span("simka.join.finish", spans):
        return _finish(raw, complex_, spans)


def count_join_stats(
    words: Union[torch.Tensor, Sequence[torch.Tensor]],
    sid: torch.Tensor,
    abundance_min: int,
    abundance_max: int,
    *,
    n_banks: int,
    kmer_bits: int,
    simple: bool = False,
    complex_: bool = False,
    spans=None,
) -> JoinStats:
    """All sufficient statistics of an instance stream.

    Args:
      words: the [E] int64 canonical k-mer words, most significant
        first (``ops.kmers``): ceil(kmer_bits / 62) of them, each in
        [0, 2^62) and the first in [0, 2^(kmer_bits - 62 (nw - 1)));
        one tensor stands for one word.
      sid: [E] int32 or int64 sample index of each instance, in
        [0, n_banks).
      abundance_min/max: per-sample solidity bounds (keep
        amin <= count <= amax).
      n_banks: number of samples N.
      kmer_bits: bits of a k-mer value, 2k (at most 254: k <= 127).
      simple/complex_: also compute the simple (hellinger, chord) and
        complex (Whittaker, Kullback-Leibler) channels.

    The stream holds real instances only: there is no invalid-window
    sentinel in int64, so a word outside its range -- or a sample id
    outside [0, n_banks) -- raises ValueError.

    ``spans`` (``utils.metrics.Spans``, or None) records the join's
    steps: ``simka.join.check``, ``.sort``, ``.run_counts``,
    ``.compact``, ``.segments``, ``.pair_sums`` and ``.finish``, each
    wait for the device inside its step as a ``simka.sync.*`` span.
    """
    with span("simka.join.check", spans):
        words = _checked_rows(words, sid, n_banks, kmer_bits, spans)
    rows = solid_rows(
        words, sid, abundance_min, abundance_max,
        n_banks=n_banks, kmer_bits=kmer_bits, spans=spans,
    )
    return stats_from_rows(
        *rows, n_banks=n_banks, simple=simple, complex_=complex_,
        spans=spans,
    )


def _checked_rows(words, sid, n_banks: int, kmer_bits: int, spans=None):
    """``words`` as a tuple, once every word is in its range and every
    sample id in [0, n_banks); ValueError otherwise. The read of the
    bounds waits for the device (``simka.sync.check``)."""
    words = (words,) if isinstance(words, torch.Tensor) else tuple(words)
    nw = len(words)
    word_bits = 2 * WORD_BASES
    if not 1 <= kmer_bits <= 254 or nw != -(-kmer_bits // word_bits):
        raise ValueError(
            f"kmer_bits={kmer_bits} with {nw} words: k-mers are 1..254 "
            f"bits in words of {word_bits}"
        )
    if any(w.dtype != torch.int64 or w.shape != sid.shape for w in words):
        raise ValueError("k-mer words must be int64 and shaped like sid")
    if sid.numel():
        bounds = torch.stack(
            [sid.min().to(torch.int64), sid.max().to(torch.int64)]
            + [f(w) for w in words for f in (torch.min, torch.max)]
        )
        with span("simka.sync.check", spans):
            bounds = bounds.tolist()
        top_bits = kmer_bits - word_bits * (nw - 1)
        for i in range(nw):
            lo, hi = bounds[2 + 2 * i], bounds[3 + 2 * i]
            if lo < 0 or hi >> (top_bits if i == 0 else word_bits):
                raise ValueError(
                    f"k-mer word {i} outside its {kmer_bits}-bit range: "
                    "invalid windows must be dropped before the join"
                )
        if bounds[0] < 0 or bounds[1] >= n_banks:
            raise ValueError(f"sample ids outside [0, {n_banks})")
    return words


def join_stats_from_spectra(
    words: Union[torch.Tensor, Sequence[torch.Tensor]],
    sid: torch.Tensor,
    counts: torch.Tensor,
    abundance_min: int,
    abundance_max: int,
    *,
    n_banks: int,
    kmer_bits: int,
    simple: bool = False,
    complex_: bool = False,
    solid_override=None,
) -> JoinStats:
    """All sufficient statistics of pre-counted per-sample spectra
    (``simka_tpu``'s ``join_stats_from_spectra``, and its split form,
    which the reference takes from N >= 33: the direct pair sums take
    any N).

    ``words``/``sid``/``counts`` hold one row per (distinct k-mer,
    sample), in any order: the concatenated spectra of the count
    phase (``ops.spectrum``). Words and sample ids as in
    ``count_join_stats``; ``counts`` int32. Rows with a count outside
    [abundance_min, abundance_max] are dropped by the stable
    compaction, the rest sorted by (k-mer, sample).
    ``solid_override`` as in ``_raw_stats_from_rows`` (one hash range
    of the sweep, ``core.sweep``).
    """
    return _finish(_raw_join_from_spectra(
        words, sid, counts, abundance_min, abundance_max, n_banks=n_banks,
        kmer_bits=kmer_bits, simple=simple, complex_=complex_,
        solid_override=solid_override,
    ), complex_)


def _raw_join_from_spectra(
    words, sid, counts, abundance_min: int, abundance_max: int, *,
    n_banks: int, kmer_bits: int, simple: bool, complex_: bool,
    solid_override=None,
) -> JoinStats:
    """``join_stats_from_spectra`` in the raw form of
    ``_raw_stats_from_rows``."""
    return _raw_stats_from_rows(
        *solid_rows_from_spectra(words, sid, counts, abundance_min,
                                 abundance_max, n_banks=n_banks,
                                 kmer_bits=kmer_bits),
        n_banks=n_banks, simple=simple, complex_=complex_,
        solid_override=solid_override,
    )


def solid_rows_from_spectra(
    words, sid, counts, abundance_min: int, abundance_max: int, *,
    n_banks: int, kmer_bits: int,
):
    """Spectrum rows (as ``join_stats_from_spectra`` takes them) as the
    solid rows ``_raw_stats_from_rows`` takes: the abundance filter by
    the stable compaction, then the (k-mer, sample) sort. Returns
    (words, sid, counts)."""
    from simka_tpu_torch.ops.compact import compact_rows

    words = _checked_rows(words, sid, n_banks, kmer_bits)
    nw = len(words)
    kept = (counts >= abundance_min) & (counts <= abundance_max)
    cols = compact_rows(
        (*words, sid, counts), kept, fills=(-1,) * nw + (0, 0),
        n=int(kept.sum()),
    )
    words, sid, counts = cols[:nw], cols[nw], cols[nw + 1]
    sbits = _sbits(n_banks)
    if nw == 1 and kmer_bits + sbits <= 63:
        key, order = torch.sort((words[0] << sbits) | sid.to(torch.int64))
        return (key >> sbits,), key & ((1 << sbits) - 1), counts[order]
    order = _lex_order((*words, sid))
    return tuple(w[order] for w in words), sid[order], counts[order]
