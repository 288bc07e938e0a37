"""SimkaMin's sketch-pair distances on one device.

The reference walk (SimkaMinDistance.hpp:215-258; the host copy
``minhash/distance.py::sketch_pair_distance``) merges two ascending
hash lists and stops after min(s1, s2) union elements or when a list
runs out. As ``simka_tpu.minhash.device_distance`` shows, what it
processes is the union elements x with

    x <= t  and  rank(x) <= L,    t = min(A[lA - 1], B[lB - 1])
                                  (unsigned), L = min(lA, lB),

rank(x) the 1-based rank in the union; ranks rise with value, so
``processed`` = min(L, rank(t)) is the count of those elements. An
element x at index i of its own list X (other list Y) has union rank
``i + 1 + #(Y < x) - #(shared elements of X before i)``: one search in
Y and one cumulative sum of shared flags, on either side.

Every pair gives four integer tallies (``TALLIES``): processed
(distinct), shared_distinct, nb_kmers (the counts of processed elements
of both lists) and shared_kmers (min(cA, cB) over processed shared
elements). ``pair_tallies`` launches the CUDA kernel of
``csrc/min_distance.cu`` on CUDA tensors and runs the plain torch
version ``pair_tallies_plain`` on CPU tensors. ``distances_from_tallies``
turns the tallies into Jaccard and Bray-Curtis once, in float64 and
then float32 as the host walk does, so the kernel's matrices and the
plain version's agree bit for bit by construction.

The kernel is a merge path across CTAs: each pair's merged order (A
first on a tie, positions [0, min(#A<=t + #B<=t, 2L))) is cut into
segments of 4,096 positions; each segment finds its start by a
diagonal search, stages its spans of both lists in shared memory with a
one-element halo, and takes its rank offset (the shared values before
it) by a decoupled look-back over its pair's segments; tallies are
64-bit atomic sums. A pair's walk needs its processed + shared_distinct
members (12 B each); the kernel's bound is the larger of each sample's
longest needed prefix read once from device memory and the merge's
integer work, 4 32-bit instructions a needed member (``chip_smoke.py``
computes it from a run's tallies). The simple form it replaced (one CTA
a pair) took 147.55 ms at N=100 x s=1,000,000 and 10.15 ms at `min
pipeline`'s 28 pairs of 1,000,000 (NVIDIA H100 80GB HBM3, 700 W).

Sketches live in the exact-length layout: each side is (offsets [n],
lengths [n] int64, hashes int64 -- uint64 bits --, counts int32 --
uint32 bits --), sample i being rows [offsets[i], offsets[i] +
lengths[i]) of the two streams; no padding, so a genuine all-ones hash
is an ordinary member.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from simka_tpu_torch.minhash.device import SIGN, as_device

TALLIES = ("processed", "shared_distinct", "nb_kmers", "shared_kmers")
INT64_MAX = (1 << 63) - 1
U32 = 0xFFFFFFFF

# kernel launches on the CUDA path (the CPU path does not count)
launches = 0

# padded rows a side in one batch of the plain version
PLAIN_CHUNK_ROWS = 1 << 22

# the kernel's scratch (segment splits and status words) a launch at
# most: longer pair lists go in tiles of pairs
SCRATCH_BYTES = 1 << 26

Sketch = Tuple[np.ndarray, np.ndarray]
Layout = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


# ---- the plain version ---------------------------------------------------


def _padded(h, c, off, ln, width: int):
    """Rows [off, off + ln) of each pair's sample as [P, width] unsigned
    order keys (``h ^ SIGN``; INT64_MAX past the length, which sorts
    last and is never below a member) and counts (int64 of the uint32
    bits; 0 past the length), and the validity mask."""
    idx = torch.arange(width, device=h.device)
    valid = idx[None, :] < ln[:, None]
    if h.shape[0] == 0:
        return (torch.full(valid.shape, INT64_MAX, device=h.device),
                torch.zeros(valid.shape, dtype=torch.int64, device=h.device),
                valid)
    pos = (off[:, None] + idx[None, :]).clamp(max=h.shape[0] - 1)
    key = torch.where(valid, h[pos] ^ SIGN, INT64_MAX)
    cnt = torch.where(valid, c[pos].to(torch.int64) & U32, 0)
    return key, cnt, valid


def _ranked(kx, vx, ky, ly):
    """For each member of X's rows: (#(Y < x), in Y, union rank)."""
    below = torch.searchsorted(ky, kx)
    hit = torch.gather(ky, 1, below.clamp(max=ky.shape[1] - 1))
    shared = vx & (below < ly[:, None]) & (hit == kx)
    s = shared.to(torch.int64)
    idx = torch.arange(kx.shape[1], device=kx.device)
    rank = idx[None, :] + 1 + below - (torch.cumsum(s, 1) - s)
    return below, shared, rank


def _tallies_chunk(a, b):
    """[C, 4] tallies of C pairs, each side (hashes, counts, offsets,
    lengths) with [C] offsets and lengths."""
    (h1, c1, off1, la), (h2, c2, off2, lb) = a, b
    ka, ca, va = _padded(h1, c1, off1, la, max(int(la.max()), 1))
    kb, cb, vb = _padded(h2, c2, off2, lb, max(int(lb.max()), 1))
    below_a, sh_a, rank_a = _ranked(ka, va, kb, lb)
    _, _, rank_b = _ranked(kb, vb, ka, la)
    last = lambda k, ln: torch.gather(k, 1, (ln - 1).clamp(min=0)[:, None])
    t = torch.minimum(last(ka, la), last(kb, lb))
    n_a = (va & (ka <= t)).sum(1)
    n_b = (vb & (kb <= t)).sum(1)
    n_s = (sh_a & (ka <= t)).sum(1)
    processed = torch.minimum(torch.minimum(la, lb), n_a + n_b - n_s)
    processed = torch.where((la == 0) | (lb == 0), 0, processed)
    in_a = va & (rank_a <= processed[:, None])
    in_b = vb & (rank_b <= processed[:, None])
    sh_in = sh_a & in_a
    cb_at_a = torch.gather(cb, 1, below_a.clamp(max=cb.shape[1] - 1))
    nb = torch.where(in_a, ca, 0).sum(1) + torch.where(in_b, cb, 0).sum(1)
    sk = torch.where(sh_in, torch.minimum(ca, cb_at_a), 0).sum(1)
    return torch.stack([processed, sh_in.sum(1), nb, sk], 1)


def pair_tallies_plain(h1, c1, off1, len1, h2, c2, off2, len2, ii,
                       jj) -> torch.Tensor:
    """The plain torch version of ``pair_tallies``: pairs in batches of
    about ``PLAIN_CHUNK_ROWS`` padded rows a side, each batch a few
    ``torch.searchsorted`` and cumulative sums."""
    ii, jj = ii.long(), jj.long()
    la, lb = len1[ii], len2[jj]
    P = ii.shape[0]
    out = torch.zeros((P, 4), dtype=torch.int64, device=h1.device)
    if P == 0:
        return out
    widest = max(int(la.max()), int(lb.max()), 1)
    step = max(PLAIN_CHUNK_ROWS // widest, 1)
    for p0 in range(0, P, step):
        sl = slice(p0, p0 + step)
        out[sl] = _tallies_chunk((h1, c1, off1[ii[sl]], la[sl]),
                                 (h2, c2, off2[jj[sl]], lb[sl]))
    return out


# ---- the kernel ----------------------------------------------------------


def segments_bound(len1, len2, ii, jj, seg: int) -> torch.Tensor:
    """The most merge-path segments of ``seg`` positions a pair of
    (ii, jj) can take, ceil(min(lA + lB, 2 min(lA, lB)) / seg), as a
    device scalar (at least 1); indices are clamped into range, since
    the caller checks them in the same host read."""
    la = len1[ii.long().clamp(0, max(len1.shape[0] - 1, 0))]
    lb = len2[jj.long().clamp(0, max(len2.shape[0] - 1, 0))]
    m = torch.minimum(la + lb, 2 * torch.minimum(la, lb))
    return ((m + seg - 1) // seg).max().clamp(min=1)


def _pair_tallies_cuda(h1, c1, off1, len1, h2, c2, off2, len2, ii, jj,
                       k_max: int):
    """The kernel over the pairs, in tiles whose scratch stays within
    ``SCRATCH_BYTES``; ``k_max`` bounds the segments a pair
    (``segments_bound``). One launch of the entry point a tile."""
    global launches
    from simka_tpu_torch.ops import _kernels

    lib = _kernels.lib()
    dev = h1.device
    P = ii.shape[0]
    out = torch.empty((P, 4), dtype=torch.int64, device=dev)
    base = lib.simka_min_pair_scratch_words(0, k_max)
    per_pair = lib.simka_min_pair_scratch_words(1, k_max) - base
    tile = max(1, min(P, (SCRATCH_BYTES // 8 - base) // per_pair))
    scratch = torch.empty(lib.simka_min_pair_scratch_words(tile, k_max),
                          dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for p0 in range(0, P, tile):
            n = min(tile, P - p0)
            code = lib.simka_min_pair_tallies(
                *(t.data_ptr() for t in (h1, c1, off1, len1, h2, c2, off2,
                                         len2)),
                ii[p0:].data_ptr(), jj[p0:].data_ptr(), n, k_max,
                scratch.data_ptr(), out[p0:].data_ptr(), stream)
            _kernels.check(code, "pair_tallies")
            launches += 1
    return out


def pair_tallies(h1, c1, off1, len1, h2, c2, off2, len2, ii,
                 jj) -> torch.Tensor:
    """Tallies of the sketch pairs (ii[p] of side 1, jj[p] of side 2).

    Args:
      h1, c1, off1, len1: side 1 in the exact-length layout: hashes
        int64 (uint64 bits, ascending unsigned within a sample), counts
        int32 (uint32 bits), offsets and lengths [n1] int64.
      h2, c2, off2, len2: side 2, the same ([n2]).
      ii, jj: [P] int32 sample indices, in [0, n1) and [0, n2).

    Returns [P, 4] int64 (``TALLIES``), on the inputs' device. On CUDA
    tensors this launches the kernel of ``csrc/min_distance.cu`` or
    raises; on CPU tensors it is the plain version. One host read
    checks the indices (and, on CUDA, bounds the segments a pair).
    """
    ts = (h1, c1, off1, len1, h2, c2, off2, len2, ii, jj)
    want = (torch.int64, torch.int32, torch.int64, torch.int64) * 2 + (
        torch.int32, torch.int32)
    dev = h1.device
    for t, dt in zip(ts, want):
        if t.dtype != dt or t.dim() != 1 or t.device != dev:
            raise ValueError(
                f"pair_tallies: a {t.dtype} {tuple(t.shape)} tensor on "
                f"{t.device}; wants 1-D {[str(w) for w in want]} on {dev}")
    for h, c, off, ln in ((h1, c1, off1, len1), (h2, c2, off2, len2)):
        if c.shape != h.shape or off.shape != ln.shape:
            raise ValueError("pair_tallies: hashes and counts, or offsets "
                             "and lengths, differ in length")
    if ii.shape != jj.shape:
        raise ValueError("pair_tallies: ii and jj differ in length")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"pair_tallies: unsupported device {dev}")
    P = ii.shape[0]
    if P == 0:
        return torch.zeros((0, 4), dtype=torch.int64, device=dev)
    cuda = dev.type == "cuda"
    if cuda and not all(t.is_contiguous() for t in ts):
        raise ValueError("pair_tallies needs contiguous tensors on CUDA")
    read = [ii.min(), ii.max(), jj.min(), jj.max()]
    if cuda:
        from simka_tpu_torch.ops import _kernels

        read.append(segments_bound(len1, len2, ii, jj,
                                   _kernels.lib().simka_min_pair_segment()))
    lo1, hi1, lo2, hi2, *k_max = torch.stack(
        [x.long() for x in read]).tolist()
    if not (0 <= lo1 and hi1 < len1.shape[0] and 0 <= lo2
            and hi2 < len2.shape[0]):
        raise ValueError("pair_tallies: a pair index is out of range")
    if not cuda:
        return pair_tallies_plain(*ts)
    return _pair_tallies_cuda(*ts, k_max=k_max[0])


def distances_from_tallies(t: torch.Tensor):
    """(jaccard, braycurtis) float32 [P] from [P, 4] tallies: 1 -
    shared_distinct / processed and 1 - 2 shared_kmers / nb_kmers in
    float64, 1.0 where the divisor is 0 (an empty sketch processes
    nothing), as ``sketch_pair_distance``."""
    processed, sd, nb, sk = t.unbind(1)
    one = torch.ones_like(processed, dtype=torch.float64)
    jac = torch.where(processed == 0, one,
                      1.0 - sd.double() / processed.clamp(min=1).double())
    bc = torch.where(nb == 0, one,
                     1.0 - (2.0 * sk.double()) / nb.clamp(min=1).double())
    return jac.to(torch.float32), bc.to(torch.float32)


# ---- matrices ------------------------------------------------------------


def ship_sketches(sketches: Sequence[Sketch], device) -> Layout:
    """A list of (hashes uint64, counts uint32) sketches, trimmed and
    ascending, as the exact-length layout on ``device``: one copy of
    each stream."""
    dev = as_device(device)
    lens = np.array([len(h) for h, _ in sketches], np.int64)
    offs = np.cumsum(lens) - lens
    cat = lambda parts, dt: (np.concatenate(parts).astype(dt) if parts
                             else np.empty(0, dt))
    h = cat([np.asarray(h, np.uint64) for h, _ in sketches], np.uint64)
    c = cat([np.asarray(c, np.uint32) for _, c in sketches], np.uint32)
    put = lambda a: torch.from_numpy(a).to(dev)
    return (put(offs), put(lens), put(h.view(np.int64)),
            put(c.view(np.int32)))


def sketch_pairs(n1: int, n2: int, symmetric_diag_block: bool):
    """(ii, jj) int32 of every pair: i < j of one list when
    ``symmetric_diag_block``, else all of n1 x n2."""
    if symmetric_diag_block:
        ii, jj = np.triu_indices(n1, 1)
    else:
        ii, jj = np.divmod(np.arange(n1 * n2), max(n2, 1))
    return ii.astype(np.int32), jj.astype(np.int32)


def distance_from_device_arrays(d1: Layout, d2: Layout,
                                symmetric_diag_block: bool):
    """All-pairs (jaccard, braycurtis) float32 [n1, n2] matrices from
    two sketch lists in the exact-length layout (``simka_tpu``'s
    resident form): one ``pair_tallies`` over the pair list; with
    ``symmetric_diag_block`` (d1 and d2 the same list) the upper
    triangle, mirrored, with a zero diagonal."""
    offs1, lens1, h1, c1 = d1
    offs2, lens2, h2, c2 = d2
    n1, n2 = lens1.shape[0], lens2.shape[0]
    jac = np.zeros((n1, n2), np.float32)
    bc = np.zeros((n1, n2), np.float32)
    ii, jj = sketch_pairs(n1, n2, symmetric_diag_block)
    if not len(ii):
        return jac, bc
    dev = h1.device
    t = pair_tallies(h1, c1, offs1, lens1, h2, c2, offs2, lens2,
                     torch.from_numpy(ii).to(dev),
                     torch.from_numpy(jj).to(dev))
    jv, bv = (x.cpu().numpy() for x in distances_from_tallies(t))
    jac[ii, jj] = jv
    bc[ii, jj] = bv
    if symmetric_diag_block:
        jac[jj, ii] = jv
        bc[jj, ii] = bv
    return jac, bc


def compute_distance_block_device(sketches1: List[Sketch],
                                  sketches2: List[Sketch],
                                  symmetric_diag_block: bool,
                                  device="cuda"):
    """``minhash.distance.compute_distance_block`` on ``device``: each
    list shipped once as exact-length columns (once in all when the two
    are the same list), then ``distance_from_device_arrays``."""
    d1 = ship_sketches(sketches1, device)
    d2 = d1 if sketches2 is sketches1 else ship_sketches(sketches2, device)
    return distance_from_device_arrays(d1, d2, symmetric_diag_block)
