"""SimkaMin's device programs: MurmurHash3 of every canonical k-mer
instance, then the bottom-s selection, in torch around two hand
kernels.

The reference hashes every canonical k-mer instance with
MurmurHash3_x64_128 and keeps the s smallest distinct h1 values in a
streaming max-heap (SelectKmersCommand, SimkaMinCount.hpp:217-267,
311-338). ``simka_tpu.minhash.device`` does it as XLA programs; here:

- ``hash_kmer_words``: the hash and the keep test, one launch of the
  CUDA kernel ``csrc/minhash.cu`` on a CUDA tensor, the plain torch
  version ``hash_kmer_words_plain`` on a CPU tensor;
- the compaction of kept rows: ``ops.compact.compact_rows`` (the
  kernel ``csrc/compact.cu`` on the card);
- sorts, run lengths, per-sample ranks and the heap-quirk correction:
  torch ops.

Unsigned 64-bit values ride in int64. All ones (2^64 - 1) is -1
(``FULL64``); the unsigned order of hashes is the signed order of
``h ^ SIGN``; every sort is a stable ``torch.sort`` of that key, so
positions stay ascending within a run of equal hashes.

Lengths are exact: a batch keeps exactly its valid (or kept) windows,
so the streams hold real instances only. There is no padding to size
classes and no all-ones sentinel row, and a genuine all-ones hash is an
ordinary member, as in the reference's exact path.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from simka_tpu_torch import resolve_device
from simka_tpu_torch.ops import compact as _compact
from simka_tpu_torch.ops.countjoin import _first_of_run, run_counts
from simka_tpu_torch.ops.kmers import extract_kmers

FULL64 = -1  # 2^64 - 1 as int64 bits
SIGN = -(1 << 63)  # x ^ SIGN: signed order == x's unsigned order
MASK64 = (1 << 64) - 1

# kernel launches on the CUDA path (the CPU path does not count)
launches = 0

_C1 = 0x87C37B91114253D5
_C2 = 0x4CF5AD432745937F
_F1 = 0xFF51AFD7ED558CCD
_F2 = 0xC4CEB9FE1A85EC53
_M16 = 0xFFFF


def as_device(device) -> torch.device:
    """A ``torch.device``, or a name through ``resolve_device`` (which
    raises for "cuda" without a card)."""
    if isinstance(device, torch.device):
        return device
    return resolve_device(device)


# ---- the plain version: uint64 arithmetic in four 16-bit limbs ----------


def _limbs(x):
    """int64 tensor -> four 16-bit limbs, least significant first."""
    return [(x >> (16 * i)) & _M16 for i in range(4)]


def _const(c: int):
    return [(c >> (16 * i)) & _M16 for i in range(4)]


def _join(limbs) -> torch.Tensor:
    """Four 16-bit limbs -> the int64 of their 64 bits, no overflow:
    the top limb is sign-extended before it is scaled."""
    top = (limbs[3] ^ 0x8000) - 0x8000
    return top * (1 << 48) + (limbs[2] << 32) + (limbs[1] << 16) + limbs[0]


def _carry(cols):
    """Column sums (each below 2^36) -> limbs mod 2^64."""
    out, c = [], 0
    for v in cols:
        v = v + c
        out.append(v & _M16)
        c = v >> 16
    return out


def _mul(x, c: int):
    """x * c mod 2^64 for a 64-bit constant c: products of 16-bit
    limbs, each below 2^32."""
    cs = _const(c)
    cols = []
    for k in range(4):
        terms = [x[i] * cs[k - i] for i in range(k + 1) if cs[k - i]]
        cols.append(sum(terms[1:], terms[0]) if terms else x[0] * 0)
    return _carry(cols)


def _add(a, b):
    return _carry([x + y for x, y in zip(a, b)])


def _xor(a, b):
    return [x ^ y for x, y in zip(a, b)]


def _shr(x, n: int):
    """Logical right shift by 0 < n < 64."""
    q, r = divmod(n, 16)
    out = []
    for i in range(4):
        lo = x[i + q] >> r if i + q < 4 else x[0] * 0
        if r and i + q + 1 < 4:
            lo = lo | ((x[i + q + 1] << (16 - r)) & _M16)
        out.append(lo)
    return out


def _shl(x, n: int):
    """Left shift by 0 < n < 64, mod 2^64."""
    q, r = divmod(n, 16)
    out = []
    for i in range(4):
        hi = (x[i - q] << r) & _M16 if i - q >= 0 else x[0] * 0
        if r and i - q - 1 >= 0:
            hi = hi | (x[i - q - 1] >> (16 - r))
        out.append(hi)
    return out


def _fmix64(h):
    h = _xor(h, _shr(h, 33))
    h = _mul(h, _F1)
    h = _xor(h, _shr(h, 33))
    h = _mul(h, _F2)
    return _xor(h, _shr(h, 33))


def murmur3_plain(words: torch.Tensor, seed: int) -> torch.Tensor:
    """h1 of MurmurHash3_x64_128 over each int64 (its 8 little-endian
    bytes) with ``seed``, as int64 bits (``simka_tpu``'s
    ``murmur3_u64_device``), in int64 ops that never overflow."""
    x = _limbs(words)
    k1 = _mul(x, _C1)
    k1 = [a | b for a, b in zip(_shl(k1, 31), _shr(k1, 33))]  # rotl 31
    k1 = _mul(k1, _C2)
    s8 = _const((seed ^ 8) & MASK64)  # the seed xor the key's length, 8
    h1 = _add(_xor(k1, s8), s8)  # h1 = seed ^ k1 ^ 8; h1 += h2
    h2 = _add(h1, s8)  # h2 += h1
    return _join(_add(_fmix64(h1), _fmix64(h2)))


def hash_kmer_words_plain(words, valid, seed: int, thresh: int = FULL64):
    """The plain torch version of ``hash_kmer_words``."""
    h = torch.where(valid, murmur3_plain(words, seed), FULL64)
    keep = valid & ((h ^ SIGN) <= (thresh ^ SIGN))
    counts = torch.stack([valid.sum(), keep.sum()]).to(torch.int64)
    return h, keep, counts


def _hash_kmer_words_cuda(words, valid, seed, thresh):
    global launches
    from simka_tpu_torch.ops import _kernels

    lib = _kernels.lib()
    h = torch.empty_like(words)
    keep = torch.empty_like(valid)
    counts = torch.empty(2, dtype=torch.int64, device=words.device)
    with torch.cuda.device(words.device):
        code = lib.simka_murmur_kmers(
            words.data_ptr(), valid.data_ptr(), words.shape[0], seed,
            thresh & MASK64, h.data_ptr(), keep.data_ptr(),
            counts.data_ptr(),
            torch.cuda.current_stream(words.device).cuda_stream,
        )
    _kernels.check(code, "hash_kmer_words")
    launches += 1
    return h, keep, counts


def hash_kmer_words(words, valid, seed: int, thresh: int = FULL64):
    """Murmur-hash canonical k-mer words and apply the keep bound.

    Args:
      words: [E] int64, the port's one-word k-mers (k <= 31), which are
        the reference's ``(hi << 32) | lo``.
      valid: [E] bool.
      seed: the sketch seed, 0 <= seed < 2^64.
      thresh: the keep bound, an unsigned 64-bit value as int64 bits
        (FULL64, the default, keeps every valid window).

    Returns (h [E] int64: the uint64 h1 bits, FULL64 at invalid windows;
    keep [E] bool: valid and h <= thresh unsigned; counts [2] int64 on
    the device: valid and kept windows). On a CUDA tensor this launches
    the kernel of ``csrc/minhash.cu`` or raises; on a CPU tensor it is
    the plain version.
    """
    if words.dtype != torch.int64 or valid.dtype != torch.bool:
        raise ValueError(f"hash_kmer_words takes int64 words and bool "
                         f"validity, got {words.dtype}, {valid.dtype}")
    if words.dim() != 1 or valid.shape != words.shape or (
            valid.device != words.device):
        raise ValueError(f"hash_kmer_words: words {tuple(words.shape)} on "
                         f"{words.device}, valid {tuple(valid.shape)} on "
                         f"{valid.device}")
    if not 0 <= seed <= MASK64 or not SIGN <= thresh < -SIGN:
        raise ValueError(f"hash_kmer_words: seed {seed} or thresh {thresh} "
                         "out of range")
    if words.device.type == "cpu":
        return hash_kmer_words_plain(words, valid, seed, thresh)
    if words.device.type != "cuda":
        raise ValueError(f"hash_kmer_words: unsupported device {words.device}")
    if words.shape[0] == 0:
        return (torch.empty_like(words), torch.empty_like(valid),
                torch.zeros(2, dtype=torch.int64, device=words.device))
    if not (words.is_contiguous() and valid.is_contiguous()):
        raise ValueError("hash_kmer_words needs contiguous tensors on CUDA")
    return _hash_kmer_words_cuda(words, valid, seed, thresh)


def read_counts(counts: torch.Tensor) -> Tuple[int, int]:
    """The kernel's (valid, kept) counts on the host: on the card one
    non-blocking copy into pinned memory, waited for through an event
    recorded after it."""
    if counts.device.type != "cuda":
        nv, nk = counts.tolist()
        return nv, nk
    host = torch.empty(2, dtype=torch.int64, pin_memory=True)
    host.copy_(counts, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    nv, nk = host.tolist()
    return nv, nk


# ---- extraction + hash of one packed batch ------------------------------


def gatb_words(packed, validbits, k: int):
    """One packed batch in gatb-core's base codes -> the [B*W] int64
    canonical words (complement ``code ^ 2``) and their validity."""
    if not 1 <= k <= 31:
        raise ValueError(f"k={k}: SimkaMin sketches take 1 <= k <= 31")
    ex = extract_kmers(packed, validbits, k, comp_xor=2)
    return ex.words[0], ex.keep


def hash_valid_words(words, valid, seed: int):
    """(hashes, words) of the valid windows, in order."""
    h, keep, counts = hash_kmer_words(words, valid, seed)
    nv, _ = read_counts(counts)
    return _compact.compact_rows((h, words), keep, fills=(FULL64, FULL64),
                                 n=nv)


def hash_packed_batch(packed, validbits, k: int, seed: int,
                      thresh: int = FULL64):
    """Extract and hash one packed batch (``simka_tpu``'s
    ``hash_packed_batch``) and keep the windows whose hash is at most
    ``thresh`` (unsigned; FULL64, the default, keeps every valid one):
    (h [n_kept] int64 of the kept windows in stream order, compacted to
    the kernel's exact kept count; n_valid)."""
    words, valid = gatb_words(packed, validbits, k)
    h, keep, counts = hash_kmer_words(words, valid, seed, thresh)
    nv, nk = read_counts(counts)
    (h,) = _compact.compact_rows((h,), keep, fills=(FULL64,), n=nk)
    return h, nv


def hash_packed_sid_batch(packed, validbits, sid: int, thresh: int, k: int,
                          seed: int):
    """``hash_packed_batch`` of one batch of sample ``sid`` under the
    bottom-s prefilter's bound ``thresh`` (a hash above every sample's
    plausible s-th smallest can never enter a sketch,
    SimkaMinCount.hpp:324), its rows tagged with ``sid``.

    Returns (h [n_kept] int64, sid [n_kept] int32, n_valid, n_kept: the
    batch's tallies, which are the sample's).
    """
    h, nv = hash_packed_batch(packed, validbits, k, seed, thresh)
    nk = h.shape[0]
    sids = torch.full((nk,), sid, dtype=torch.int32, device=h.device)
    return h, sids, nv, nk


# ---- bottom-s selection --------------------------------------------------


def _sort_hashes(h):
    """Stable ascending sort of uint64 hashes: (sorted, positions)."""
    key, pos = torch.sort(h ^ SIGN, stable=True)
    return key ^ SIGN, pos


def _members(boundary, count, pos, use_filter: bool):
    """(member rows, heap-entry position) of a hash-sorted run layout:
    every distinct hash enters at its first occurrence; under -filter
    (exact >= 2) only hashes seen twice, at their SECOND occurrence
    (count initialised to 2, SimkaMinCount.hpp:353)."""
    if not use_filter:
        return boundary, pos
    second = torch.cat([pos[1:], pos[-1:]])
    return boundary & (count >= 2), second


def _first(keep, n: int):
    """``keep`` cut to its first n rows."""
    return keep & (torch.cumsum(keep, 0) <= n)


def sketch_prefix_device(h, *, sketch_size: int, use_filter: bool):
    """Bottom-s prefix of one sample's instance hash stream ``h`` [E]
    int64 (stream order), with occurrence positions.

    Returns (hashes [m] ascending, counts [m] int64, entry [m] int64,
    n_distinct), m = min(s, n_distinct): the heap-entry position of each
    member, the distinct members (>= 2 occurrences under -filter), and
    the streaming-heap quirk of the largest member applied when the
    sketch is full: once every smaller member has entered the full
    heap, h_max's occurrences stop counting (SimkaMinCount.hpp:324), so
    its count is its occurrences before the last smaller member's entry.
    """
    if h.shape[0] == 0:
        return h, h, h, 0
    hs, pos = _sort_hashes(h)
    count, boundary, _ = run_counts((hs,))
    keep, entry = _members(boundary, count, pos, use_filter)
    n_distinct = int(keep.sum())
    m = min(sketch_size, n_distinct)
    hashes, counts, ent = _compact.compact_rows(
        (hs, count, entry), _first(keep, m), fills=(FULL64, 0, 0), n=m)
    counts = counts.to(torch.int64)
    if m and n_distinct >= sketch_size:
        t_last = ent[: m - 1].max() if m >= 2 else 0
        idx = torch.arange(h.shape[0], device=h.device)
        n_before = ((h == hashes[m - 1]) & (idx < t_last)).sum()
        counts[m - 1] = torch.clamp(n_before, min=2 if use_filter else 1)
    return hashes, counts, ent, n_distinct


def sketch_stream_step(h, st_h, st_c, corr_h, corr_n, *, sketch_size: int):
    """Fold one super-batch ``h`` [E] (instance hashes in stream order)
    into the streaming bottom-s state (non-filter semantics).

    The state: ``st_h``/``st_c`` [m <= s] the members ascending and their
    carried counts; ``corr_h``/``corr_n`` (0-dim int64) the carried
    correction of the largest member. As in ``simka_tpu``: a member
    enters at its first occurrence, the member set changes in a batch
    iff an entry happened there, and only the final largest member
    loses occurrences, those after the last entry. So at each
    set-changing batch the correction is recomputed for the current
    largest member: its carried count plus its occurrences in this
    batch before the batch's last entry.

    Returns the new (st_h, st_c, corr_h, corr_n).
    """
    s = sketch_size
    E = h.shape[0]
    if E == 0:
        return st_h, st_c, corr_h, corr_n
    dev = h.device
    # the batch's bottom-s distinct prefix with counts and first positions
    hs, pos = _sort_hashes(h)
    count, boundary, n_runs = run_counts((hs,))
    nb = min(s, int(n_runs))
    bh, bc, bf = _compact.compact_rows(
        (hs, count, pos), _first(boundary, nb), fills=(FULL64, 0, 0), n=nb)
    # merge carried + batch; the stable sort keeps the carried row first
    # of an equal pair, so a boundary row on the batch side is NEW
    m = st_h.shape[0]
    mh = torch.cat([st_h, bh])
    key, order = torch.sort(mh ^ SIGN, stable=True)
    mh = key ^ SIGN
    mc = torch.cat([st_c, bc.to(torch.int64)])[order]
    mf = torch.cat([torch.zeros(m, dtype=torch.int64, device=dev), bf])[order]
    side = torch.cat([torch.zeros(m, dtype=torch.int32, device=dev),
                      torch.ones(nb, dtype=torch.int32, device=dev)])[order]
    bnd = _first_of_run(mh)
    has_next = torch.cat([~bnd[1:], bnd.new_zeros(1)])
    comb = mc + torch.where(has_next, torch.cat([mc[1:], mc.new_zeros(1)]),
                            0)
    n2 = min(s, int(bnd.sum()))
    nh, nc, new, nf = _compact.compact_rows(
        (mh, comb, side, mf), _first(bnd, n2), fills=(FULL64, 0, 0, 0), n=n2)
    new_in = new == 1
    changed = new_in.any()
    m_val = nh[n2 - 1]
    p_local = torch.where(new_in, nf, -1).max()
    pre_cnt = torch.where(st_h == m_val, st_c, 0).sum()
    idx = torch.arange(E, device=dev)
    batch_before = ((h == m_val) & (idx < p_local)).sum()
    corr_h = torch.where(changed, m_val, corr_h)
    corr_n = torch.where(changed, pre_cnt + batch_before, corr_n)
    return nh, nc, corr_h, corr_n


def sketch_multi_prefix(h, sid, *, n_samples: int, sketch_size: int,
                        use_filter: bool):
    """Bottom-s prefixes of every sample from one (sample, hash) order.

    Args: ``h`` [E] int64 instance hashes, each sample's in its stream
    order (interleaving between samples is free: positions are only
    compared within a sample); ``sid`` [E] int32 sample ids.

    Returns (hashes [n_out] int64, counts [n_out] int32, n_kept [N],
    n_before [N] numpy int64): sample n's prefix is the rows
    [sum_{m<n} min(n_kept[m], s), + min(n_kept[n], s)), hash-ascending;
    n_kept counts its distinct members; for a full sketch n_before is
    its largest member's occurrences before the last entry of the
    smaller ones, the count the caller gives that member.

    Two stable sorts (hash, then sample) put every run's positions in
    ascending order; per-sample ranks come from one cumulative sum and
    the per-sample offsets; the correction needs, per sample, the
    largest entry among the smaller members (one scatter max) and the
    h_max run's occurrences before it (one scatter add).
    """
    N, s = n_samples, sketch_size
    dev = h.device
    if h.shape[0] == 0:
        z = np.zeros(N, np.int64)
        return h, h.to(torch.int32), z, z.copy()
    order = torch.sort(h ^ SIGN, stable=True).indices
    order = order[torch.sort(sid[order], stable=True).indices]
    hs, ss, pos = h[order], sid[order].to(torch.int64), order
    del order
    count, boundary, _ = run_counts((hs, ss))
    keep, entry = _members(boundary, count, pos, use_filter)
    keep_i = keep.to(torch.int64)
    n_kept = torch.zeros(N, dtype=torch.int64, device=dev).scatter_add_(
        0, ss, keep_i)
    rank = (torch.cumsum(keep_i, 0) - keep_i) - (
        torch.cumsum(n_kept, 0) - n_kept)[ss]
    sel = (torch.clamp(n_kept, max=s) - 1)[ss]
    is_hmax = keep & (n_kept >= s)[ss] & (rank == sel)
    tl = torch.zeros(N, dtype=torch.int64, device=dev).scatter_reduce_(
        0, ss, torch.where(keep & (rank < sel), entry + 1, 0), "amax")
    run_id = torch.cumsum(boundary, 0)
    hrun = torch.full((N,), -1, dtype=torch.int64, device=dev)
    hrun.scatter_reduce_(0, ss, torch.where(is_hmax, run_id, -1), "amax")
    contrib = (run_id == hrun[ss]) & (pos + 1 < tl[ss])
    n_before = torch.zeros(N, dtype=torch.int64, device=dev).scatter_add_(
        0, ss, contrib.to(torch.int64))
    out_keep = keep & (rank < s)
    del rank, sel, is_hmax, run_id, contrib, entry, pos
    n_kept, n_before = torch.stack([n_kept, n_before]).cpu().numpy()
    n_out = int(np.minimum(n_kept, s).sum())
    hashes, counts = _compact.compact_rows((hs, count), out_keep,
                                           fills=(FULL64, 0), n=n_out)
    return hashes, counts, n_kept, n_before


def assemble_sketch_grid(hashes, counts, n_kept, n_before, *,
                         sketch_size: int, base_c: int):
    """The batched route's compacted prefixes (``sketch_multi_prefix``'s
    outputs) as the distance's exact-length sketch layout, on their
    device (``simka_tpu``'s ``assemble_sketch_grid``, without the
    [N, s_pad] padding).

    Returns (offsets [N] int64, lengths [N] int64, hashes [n_out] int64
    -- the stream as it is --, counts [n_out] int32, a corrected copy):
    sample i is rows [offsets[i], offsets[i] + lengths[i]), lengths[i] =
    min(n_kept[i], s). A full sample's last member gets the heap-quirk
    count max(base_c, n_before[i]), exactly as
    ``sketch.fetch_batched_sketches`` applies it on the host.
    """
    dev = hashes.device
    lens = np.minimum(np.asarray(n_kept, np.int64), sketch_size)
    offs = np.cumsum(lens) - lens
    fix = np.nonzero((np.asarray(n_kept) >= sketch_size) & (lens >= 1))[0]
    counts = counts.to(torch.int32, copy=True)
    if len(fix):
        at = torch.from_numpy(offs[fix] + lens[fix] - 1).to(dev)
        val = np.maximum(base_c, np.asarray(n_before, np.int64)[fix])
        counts[at] = torch.from_numpy(val).to(dev, torch.int32)
    return (torch.from_numpy(offs).to(dev), torch.from_numpy(lens).to(dev),
            hashes, counts)


def device_sketch_update(words, valid, *, seed: int, sketch_size: int):
    """One-program bottom-s sketch of a k-mer instance stream, order-free
    (``simka_tpu``'s ``device_sketch_update``: membership and total
    counts, no heap-quirk correction): (hashes [s] ascending, counts [s]
    int32), FULL64 / 0 in the slots past the distinct hashes."""
    h, _ = hash_valid_words(words, valid, seed)
    hs = _sort_hashes(h)[0]
    count, boundary, n_runs = run_counts((hs,))
    m = min(sketch_size, int(n_runs))
    out_h, out_c = _compact.compact_rows((hs, count), _first(boundary, m),
                                         fills=(FULL64, 0), n=m)
    pad = sketch_size - m
    return (torch.cat([out_h, out_h.new_full((pad,), FULL64)]),
            torch.cat([out_c, out_c.new_zeros(pad)]))
