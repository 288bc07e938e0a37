"""K-mer counting + cross-sample join + distance statistics.

The torch counterpart of ``simka_tpu.ops.countjoin.count_join_stats``:

  1. sort the (k-mer, sample) instances so equal pairs are adjacent;
     run lengths give each sample's count of each k-mer;
  2. the per-sample abundance filter (amin <= count <= amax) keeps one
     row per solid (k-mer, sample), made contiguous by the stable
     compaction (``ops.compact``) -- order stays (k-mer, sample)
     ascending;
  3. per-bank totals, then segments of equal k-mers;
  4. pair sums in direct form: every two rows of one segment are a
     co-present pair (a, b) with a < b, added into flat [N * N] int64
     sums (``pair_sums``: on a CUDA tensor the hand-written kernel of
     ``csrc/pair_sums.cu``, on a CPU tensor its plain torch version,
     ``_pair_sums_plain``, one offset d at a time with ``index_add_``).

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
    pass -- k=21 up to N = 2^21, k=31 only at N <= 2;
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

# pair-kernel launches on the CUDA path (the CPU path does not count)
launches = 0


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
):
    """Sort + run-length count + abundance filter.

    Returns (words, sid, count): one row per solid (k-mer, sample), in
    (k-mer, sample)-ascending order; int64 words, an int64 or int32
    sid and an int32 count.
    """
    from simka_tpu_torch.ops.compact import compact_rows

    nw = len(words)
    sbits = _sbits(n_banks)
    if nw == 1 and kmer_bits + sbits <= 63:
        # packed path: one int64 key carries (kmer, sid)
        key = torch.sort((words[0] << sbits) | sid.to(torch.int64)).values
        boundary = _first_of_run(key)
        count = _run_counts(boundary)
        kept = boundary & (count >= abundance_min) & (count <= abundance_max)
        n = int(kept.sum())
        key_c, cnt_c = compact_rows((key, count), kept, fills=(-1, 0), n=n)
        return (key_c >> sbits,), key_c & ((1 << sbits) - 1), cnt_c

    # multi-key path (one bank: the sample id is no key)
    perm = _lex_order((*words, sid) if n_banks > 1 else words)
    words = tuple(w[perm] for w in words)
    sid = sid[perm]
    del perm
    boundary = _first_of_run(*words, sid)
    count = _run_counts(boundary)
    kept = boundary & (count >= abundance_min) & (count <= abundance_max)
    n = int(kept.sum())
    cols = compact_rows(
        (*words, sid, count), kept, fills=(-1,) * nw + (0, 0), n=n
    )
    return cols[:nw], cols[nw], cols[nw + 1]


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


def _kl_from_limbs(sums: torch.Tensor) -> torch.Tensor:
    """[M, 1 + KL_FRAC_LIMBS] int64 limb sums -> [M] f64, each the
    exact fixed-point total rounded once (Python's int division rounds
    correctly)."""
    bits = KL_LIMB_BITS * KL_FRAC_LIMBS
    vals = [
        sum(v << (KL_LIMB_BITS * (KL_FRAC_LIMBS - j))
            for j, v in enumerate(row)) / (1 << bits)
        for row in sums.cpu().tolist()
    ]
    return torch.tensor(vals, dtype=torch.float64, device=sums.device)


def _pair_sums_plain(sid, count, starts, seg_len, K, flat, kl, *,
                     d_max: int) -> None:
    """The plain torch version of ``pair_sums``: for each offset
    d < d_max, rows i and i + d of one segment are a pair, gathered
    with one ``nonzero`` and added with one ``index_add_`` a channel."""
    N = K.shape[0]
    i64, f64 = torch.int64, torch.float64
    seg = torch.repeat_interleave(
        torch.arange(starts.shape[0], device=sid.device), seg_len,
        output_size=sid.shape[0])
    c64, Kf = count, K
    simple, complex_ = "hellinger" in flat, "whittaker" in flat
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


def _pair_sums_cuda(sid, count, starts, seg_len, K, flat, kl) -> None:
    """The kernel of ``csrc/pair_sums.cu``: the channels in groups whose
    per-CTA partials fit the card's shared memory, one launch a group
    (one launch of every channel past the N where one does not fit)."""
    from simka_tpu_torch.ops import _kernels

    with torch.cuda.device(sid.device):
        slots = _kernels.lib().simka_pair_sums_slots(K.shape[0])
    if slots < 0:
        raise RuntimeError("pair_sums: the device's shared memory could not "
                           "be read")
    chans = [c for c, name in enumerate(PAIR_CHANNELS) if name in flat]
    if "whittaker" in flat:
        chans += [len(PAIR_CHANNELS) + j for j in range(1 + KL_FRAC_LIMBS)]
    _launch_pair_sums(sid, count, starts, seg_len, K, flat, kl,
                      pair_groups(chans, slots), shared=slots > 0)


def _launch_pair_sums(sid, count, starts, seg_len, K, flat, kl, groups, *,
                      shared: bool) -> None:
    """One launch of the kernel a group of channels (kernel channel
    numbers: PAIR_CHANNELS' index, the KL limbs 8..12), in shared
    partials or (``shared=False``, one group) straight into the outputs.
    ``chip_smoke.py`` also calls it to time other groupings."""
    global launches
    from simka_tpu_torch.ops import _kernels

    lib = _kernels.lib()
    n_all = len(PAIR_CHANNELS) + 1 + KL_FRAC_LIMBS
    outs = (ctypes.c_void_p * n_all)()
    for c, name in enumerate(PAIR_CHANNELS):
        if name in flat:
            outs[c] = flat[name].data_ptr()
    for j in range(1 + KL_FRAC_LIMBS):
        outs[len(PAIR_CHANNELS) + j] = kl.data_ptr() + 8 * j
    with torch.cuda.device(sid.device):
        stream = torch.cuda.current_stream(sid.device).cuda_stream
        for group in groups:
            slot = (ctypes.c_int * n_all)(*([-1] * n_all))
            for s, c in enumerate(group):
                slot[c] = s
            code = lib.simka_pair_sums(
                sid.data_ptr(), count.data_ptr(), starts.data_ptr(),
                seg_len.data_ptr(), sid.shape[0], starts.shape[0],
                K.data_ptr(), K.shape[0], ctypes.addressof(outs),
                ctypes.addressof(slot), int(shared), stream)
            _kernels.check(code, "pair_sums")
            launches += 1


def pair_groups(channels: Sequence[int], slots: int) -> list:
    """The kernel's launches over ``channels`` (kernel channel numbers):
    with 0 slots (the global form) or when all fit, one; else groups of
    ``slots`` (the channels one launch's shared partials hold), the KL
    limbs first so that their f64 term is computed in as few launches
    as the slots allow."""
    if slots <= 0 or len(channels) <= slots:
        return [list(channels)]
    order = sorted(channels, key=lambda c: c < len(PAIR_CHANNELS))
    return [order[g:g + slots] for g in range(0, len(order), slots)]


def pair_sums(sid, count, starts, seg_len, K, flat, kl, *,
              d_max: int) -> None:
    """Add the pair terms of every two rows of one segment into ``flat``
    and ``kl`` (``simka_tpu``'s ``_pair_accumulate``).

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

    On CUDA tensors this launches the kernel of ``csrc/pair_sums.cu``
    or raises; on CPU tensors it is the plain version. Every channel
    is an integer sum, so the two agree bit for bit.
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
    if not set(PAIR_CHANNELS[:4]) <= set(flat) <= set(PAIR_CHANNELS):
        raise ValueError(f"pair_sums: channels {sorted(flat)}")
    outs = (*flat.values(), kl)
    if (any(t.dtype != i64 or t.device != dev for t in outs)
            or any(t.shape != (N * N,) for t in flat.values())
            or kl.shape != (N * N, 1 + KL_FRAC_LIMBS)):
        raise ValueError("pair_sums: outputs must be int64 [N * N] and "
                         f"[N * N, {1 + KL_FRAC_LIMBS}] on the rows' device")
    if dev.type == "cpu":
        return _pair_sums_plain(sid, count, starts, seg_len, K, flat, kl,
                                d_max=d_max)
    if dev.type != "cuda":
        raise ValueError(f"pair_sums: unsupported device {dev}")
    if not all(t.is_contiguous() for t in (*cols, K, *outs)):
        raise ValueError("pair_sums needs contiguous tensors on CUDA")
    if d_max < 2 or N < 2:
        return None  # no segment holds a pair
    return _pair_sums_cuda(sid, count, starts, seg_len, K, flat, kl)


def _raw_stats_from_rows(
    words, sid, count, *, n_banks: int, simple: bool = False,
    complex_: bool = False, solid_override=None,
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
    returned ``solid_per_bank`` stays these rows' own."""
    N = n_banks
    dev = sid.device
    i64, f64 = torch.int64, torch.float64
    sid = sid.to(i64)
    c64 = count.to(i64)
    n = sid.shape[0]

    def per_bank(values):
        return torch.zeros(N, dtype=i64, device=dev).index_add_(0, sid, values)

    distinct_per_bank = per_bank(torch.ones_like(c64))
    solid_per_bank = per_bank(c64)
    chord_n2_per_bank = per_bank(c64 * c64)
    K = solid_per_bank if solid_override is None else solid_override.to(dev)

    newk = _first_of_run(*words)
    starts = newk.nonzero().squeeze(1)
    seg_len = torch.cat([starts[1:], starts.new_tensor([n])]) - starts
    nb_distinct = torch.tensor(starts.shape[0], dtype=i64, device=dev)
    nb_shared = (seg_len >= 2).sum().to(i64)
    d_max = int(seg_len.max()) if n else 0

    names = ["ab", "ba", "distinct", "bray"]
    if simple:
        names += ["hellinger", "chord"]
    if complex_:
        names += ["whittaker", "s12"]
    flat = {name: torch.zeros(N * N, dtype=i64, device=dev) for name in names}
    kl = torch.zeros((N * N, 1 + KL_FRAC_LIMBS), dtype=i64, device=dev)
    # the global per-bank totals of the Whittaker and KL terms
    pair_sums(sid, c64, starts, seg_len, K.to(f64), flat, kl, d_max=d_max)

    def pairs(name):
        if name in flat:
            return flat[name].view(N, N)
        return torch.zeros((N, N), dtype=i64, device=dev)

    return JoinStats(
        nb_distinct=nb_distinct,
        nb_shared=nb_shared,
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
        whittaker_all=(
            _whittaker_all(sid, c64, K, N) if complex_
            else pairs("whittaker_all")
        ),
        whittaker_s12=pairs("s12"),
        kullback_leibler=kl,
        max_count=(c64.max() if n else torch.zeros((), dtype=i64, device=dev)),
    )


def _add_raw(a: JoinStats, b: JoinStats) -> JoinStats:
    """Raw stats of two disjoint k-mer sets as one (the reference's
    SimkaStatistics::operator+=, SimkaDistance.cpp:156-213): every
    field summed, ``max_count`` a max."""
    return JoinStats(*(
        torch.maximum(x, y) if name == "max_count" else x + y
        for name, x, y in zip(JoinStats._fields, a, b)
    ))


def _finish(raw: JoinStats, complex_: bool) -> JoinStats:
    """Raw stats as ``JoinStats``: chord converted to f64 once, KL's
    limb sums rounded once."""
    N = raw.solid_per_bank.shape[0]
    kl = raw.kullback_leibler
    return raw._replace(
        chord_ninj=raw.chord_ninj.to(torch.float64),
        kullback_leibler=(
            _kl_from_limbs(kl).view(N, N) if complex_
            else torch.zeros((N, N), dtype=torch.float64, device=kl.device)
        ),
    )


def stats_from_rows(
    words, sid, count, *, n_banks: int, simple: bool = False,
    complex_: bool = False, solid_override=None,
) -> JoinStats:
    """``JoinStats`` of solid rows in (k-mer, sample)-ascending order
    (``_raw_stats_from_rows``, converted)."""
    return _finish(_raw_stats_from_rows(
        words, sid, count, n_banks=n_banks, simple=simple,
        complex_=complex_, solid_override=solid_override,
    ), complex_)


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
    """
    words = _checked_rows(words, sid, n_banks, kmer_bits)
    rows = solid_rows(
        words, sid, abundance_min, abundance_max,
        n_banks=n_banks, kmer_bits=kmer_bits,
    )
    return stats_from_rows(
        *rows, n_banks=n_banks, simple=simple, complex_=complex_
    )


def _checked_rows(words, sid, n_banks: int, kmer_bits: int):
    """``words`` as a tuple, once every word is in its range and every
    sample id in [0, n_banks); ValueError otherwise."""
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
        ).tolist()
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
