"""SimkaMin's sketch-pair distance in the port, on the CPU, against
simka_tpu on the same numpy-seeded sketches: the plain tallies against
the host walk's quantities, the matrices against simka_tpu's
compute_distance_block_device (JAX on the CPU) and compute_distance_block
(the host walk) bit for bit, symmetric and rectangular, on heavy
overlap, empty sketches, length 1, unequal lengths, the all-ones hash as
a member and hashes with the top bit set; the port's
assemble_sketch_grid against simka_tpu's on a compacted stream; the
inclusion rule ("x <= t and rank <= min(lA, lB)") alone against the
plain version; and a numpy model of the CUDA kernel's merge path (the
diagonal search, the segments, the one-element halo, the look-back's
exclusive shared prefix, past-skip) against the plain version."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simka_tpu.minhash.device import assemble_sketch_grid as ref_grid
from simka_tpu.minhash.device_distance import (
    compute_distance_block_device as ref_block_device,
)
from simka_tpu.minhash.distance import compute_distance_block as ref_block
from simka_tpu_torch.minhash import device_distance as dd
from simka_tpu_torch.minhash.device import assemble_sketch_grid

ALL_ONES = np.uint64(2**64 - 1)


def _sketch(rng, m, pool=None, top=False, hi=1 << 48):
    """An ascending distinct uint64 sketch of about m members (half from
    ``pool`` when given), counts 1..255."""
    lo_bits = rng.integers(0, hi, size=m, dtype=np.uint64)
    if top:
        lo_bits |= np.uint64(1 << 63)
    parts = [lo_bits]
    if pool is not None and m:
        parts.append(pool[rng.integers(0, len(pool), size=m // 2)])
    h = np.unique(np.concatenate(parts))
    return h, rng.integers(1, 256, size=len(h)).astype(np.uint32)


def _empty():
    return np.empty(0, np.uint64), np.empty(0, np.uint32)


def _case(name):
    rng = np.random.default_rng(CASES.index(name))
    pool = np.unique(rng.integers(0, 1 << 48, size=400, dtype=np.uint64))
    if name == "symmetric":
        return [_sketch(rng, int(rng.integers(1, 300)), pool)
                for _ in range(9)], None
    if name == "rectangular":
        return ([_sketch(rng, int(rng.integers(1, 200)), pool)
                 for _ in range(5)],
                [_sketch(rng, int(rng.integers(1, 200)), pool)
                 for _ in range(7)])
    if name == "heavy_overlap":
        base = pool[:300]
        sk = []
        for _ in range(6):
            h = np.unique(np.concatenate(
                [base, rng.integers(0, 1 << 48, 60, dtype=np.uint64)]))
            sk.append((h, rng.integers(1, 50, len(h)).astype(np.uint32)))
        return sk, None
    if name == "empty":
        return [_empty(), _sketch(rng, 50, pool), _empty(),
                _sketch(rng, 80, pool)], None
    if name == "length_1":
        one = (pool[:1].copy(), np.array([7], np.uint32))
        return [one, _sketch(rng, 40, pool), one,
                (pool[1:2].copy(), np.array([3], np.uint32))], None
    if name == "unequal_lengths":
        return [_sketch(rng, m, pool) for m in (3, 500, 40, 250, 1)], None
    if name == "all_ones_member":
        sk = []
        for m in (30, 60, 1, 45):
            h, c = _sketch(rng, m, pool)
            h = np.unique(np.append(h, ALL_ONES))
            sk.append((h, rng.integers(1, 256, len(h)).astype(np.uint32)))
        return sk + [_sketch(rng, 50, pool)], None
    if name == "top_bit":
        tpool = pool | np.uint64(1 << 63)
        return [_sketch(rng, m, tpool, top=bool(m % 2), hi=1 << 62)
                for m in (40, 81, 120, 7)], None
    raise KeyError(name)


CASES = ["symmetric", "rectangular", "heavy_overlap", "empty", "length_1",
         "unequal_lengths", "all_ones_member", "top_bit"]


def _host_tallies(hA, cA, hB, cB):
    """The host walk's (processed, shared_distinct, nb_kmers,
    shared_kmers) (minhash/distance.py::sketch_pair_distance)."""
    if len(hA) == 0 or len(hB) == 0:
        return 0, 0, 0, 0
    L = min(len(hA), len(hB))
    t_exh = min(hA[-1], hB[-1])
    inter, ia, ib = np.intersect1d(hA, hB, assume_unique=True,
                                   return_indices=True)
    r_exh = int(np.searchsorted(hA, t_exh, "right")
                + np.searchsorted(hB, t_exh, "right")
                - np.searchsorted(inter, t_exh, "right"))
    processed = min(L, r_exh)
    t_star = (t_exh if processed >= r_exh
              else np.union1d(hA, hB)[processed - 1])
    pa = np.searchsorted(hA, t_star, "right")
    pb = np.searchsorted(hB, t_star, "right")
    ps = np.searchsorted(inter, t_star, "right")
    nb = int(cA[:pa].astype(np.int64).sum() + cB[:pb].astype(np.int64).sum())
    sk = int(np.minimum(cA[ia[:ps]], cB[ib[:ps]]).astype(np.int64).sum())
    return processed, int(ps), nb, sk


@pytest.mark.parametrize("name", CASES)
def test_plain_matrices_match_reference(name):
    s1, s2 = _case(name)
    symmetric = s2 is None
    s2 = s1 if symmetric else s2
    got = dd.compute_distance_block_device(s1, s2, symmetric, device="cpu")
    for want in (ref_block(s1, s2, symmetric),
                 ref_block_device(s1, s2, symmetric)):
        for g, w in zip(got, want):
            assert g.dtype == np.float32
            np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("name", CASES)
def test_plain_tallies_match_the_host_walk(name):
    s1, s2 = _case(name)
    s2 = s1 if s2 is None else s2
    d1, d2 = dd.ship_sketches(s1, "cpu"), dd.ship_sketches(s2, "cpu")
    ii, jj = dd.sketch_pairs(len(s1), len(s2), False)
    (o1, l1, h1, c1), (o2, l2, h2, c2) = d1, d2
    before = dd.launches
    got = dd.pair_tallies(h1, c1, o1, l1, h2, c2, o2, l2,
                          torch.from_numpy(ii), torch.from_numpy(jj))
    assert dd.launches == before  # the CPU path does not count
    want = [_host_tallies(*s1[i], *s2[j]) for i, j in zip(ii, jj)]
    assert got.tolist() == [list(w) for w in want]


def test_counts_are_unsigned_32_bit():
    """Counts past 2^31 (uint32 in the sketch file) sum as the host walk
    sums them."""
    rng = np.random.default_rng(3)
    pool = np.unique(rng.integers(0, 1 << 48, 200, dtype=np.uint64))
    sk = []
    for m in (50, 70, 90):
        h, _ = _sketch(rng, m, pool)
        sk.append((h, rng.integers(2**31, 2**32, len(h),
                                    dtype=np.uint64).astype(np.uint32)))
    got = dd.compute_distance_block_device(sk, sk, True, device="cpu")
    for g, w in zip(got, ref_block(sk, sk, True)):
        np.testing.assert_array_equal(g, w)


def test_pair_tallies_rejects_bad_input():
    h = torch.zeros(4, dtype=torch.int64)
    c = torch.ones(4, dtype=torch.int32)
    off = torch.tensor([0, 2], dtype=torch.int64)
    ln = torch.tensor([2, 2], dtype=torch.int64)
    ij = torch.tensor([0], dtype=torch.int32)
    good = [h, c, off, ln, h, c, off, ln, ij, ij]
    assert dd.pair_tallies(*good).shape == (1, 4)
    for k, bad in ((1, c.long()), (0, h[:3]), (8, ij.long()),
                   (9, torch.tensor([2], dtype=torch.int32)),
                   (8, torch.tensor([-1], dtype=torch.int32))):
        args = list(good)
        args[k] = bad
        with pytest.raises(ValueError):
            dd.pair_tallies(*args)


def _stream(rng, n_kept, s):
    """A compacted multi-sample prefix stream as sketch_multi_prefix
    gives it: per sample min(n_kept, s) ascending hashes and counts."""
    hs, cs = [], []
    for k in n_kept:
        m = min(k, s)
        h = np.unique(rng.integers(1, 1 << 40, size=m, dtype=np.uint64))
        assert len(h) == m
        hs.append(h)
        cs.append(rng.integers(1, 9, m).astype(np.int32))
    return np.concatenate(hs), np.concatenate(cs)


@pytest.mark.parametrize("base_c", [1, 2])
@pytest.mark.parametrize("fill", ["full", "underfull"])
def test_assemble_sketch_grid_matches_reference(fill, base_c):
    rng = np.random.default_rng(base_c)
    s = 16
    n_kept = (np.array([16, 40, 16, 100]) if fill == "full"
              else np.array([16, 3, 0, 29, 15]))
    n_before = rng.integers(0, 4, len(n_kept)).astype(np.int64)
    hashes, counts = _stream(rng, n_kept, s)
    counts0 = counts.copy()
    lens = np.minimum(n_kept, s).astype(np.int32)
    offs = (np.cumsum(lens) - lens).astype(np.int32)
    H, C = ref_grid(jnp.asarray(hashes), jnp.asarray(counts),
                    jnp.asarray(offs), jnp.asarray(lens),
                    jnp.asarray(n_before.astype(np.int32)),
                    jnp.asarray(n_kept >= s), n=len(n_kept), s_pad=32,
                    base_c=base_c)
    H, C = np.asarray(H), np.asarray(C)
    o, ln, h, c = assemble_sketch_grid(
        torch.from_numpy(hashes.view(np.int64)), torch.from_numpy(counts),
        n_kept, n_before, sketch_size=s, base_c=base_c)
    assert o.tolist() == offs.tolist() and ln.tolist() == lens.tolist()
    assert h.dtype == torch.int64 and c.dtype == torch.int32
    np.testing.assert_array_equal(counts, counts0)  # not changed in place
    for i, (a, m) in enumerate(zip(o.tolist(), ln.tolist())):
        np.testing.assert_array_equal(h[a:a + m].numpy().view(np.uint64),
                                      H[i, :m])
        np.testing.assert_array_equal(c[a:a + m].numpy(), C[i, :m])
        assert (H[i, m:] == ALL_ONES).all() and (C[i, m:] == 0).all()


def _inclusion_rule(A, CA, B, CB):
    """The tallies from the inclusion rule alone: a union element x is
    processed when x <= t = min(A[-1], B[-1]) and its union rank <=
    min(lA, lB)."""
    if len(A) == 0 or len(B) == 0:
        return 0, 0, 0, 0
    t = min(A[-1], B[-1])
    union = np.union1d(A, B)
    kept = union[(union <= t) & (np.arange(1, len(union) + 1)
                                 <= min(len(A), len(B)))]
    in_a, in_b = np.isin(A, kept), np.isin(B, kept)
    shared, ia, ib = np.intersect1d(A[in_a], B[in_b], assume_unique=True,
                                    return_indices=True)
    ca, cb = CA[in_a].astype(np.int64), CB[in_b].astype(np.int64)
    return (len(kept), len(shared), int(ca.sum() + cb.sum()),
            int(np.minimum(ca[ia], cb[ib]).sum()))


@pytest.mark.parametrize("name", CASES)
def test_inclusion_rule_matches_plain(name):
    s1, s2 = _case(name)
    s2 = s1 if s2 is None else s2
    (o1, l1, h1, c1), (o2, l2, h2, c2) = (dd.ship_sketches(s1, "cpu"),
                                          dd.ship_sketches(s2, "cpu"))
    ii, jj = dd.sketch_pairs(len(s1), len(s2), False)
    plain = dd.pair_tallies(h1, c1, o1, l1, h2, c2, o2, l2,
                            torch.from_numpy(ii), torch.from_numpy(jj))
    assert plain.tolist() == [list(_inclusion_rule(*s1[i], *s2[j]))
                              for i, j in zip(ii, jj)]


def _diag(A, na, B, nb, d, win=None):
    """The merge-path split: A elements among the first d merged
    positions of A[0, na) and B[0, nb), A first on a tie, by a diagonal
    binary search (the walk's in the kernel); with ``win``, from the
    window d na / (na + nb) +- win when it brackets the split
    (diag_split)."""
    lo, hi = max(0, d - nb), min(d, na)
    pred = lambda i: A[i] <= B[d - 1 - i]
    if win is not None:
        guess = min(max(d * na // max(na + nb, 1), lo), hi)
        wl, wh = max(lo, guess - win), min(hi, guess + win)
        if (wl == lo or pred(wl - 1)) and (wh == hi or not pred(wh)):
            lo, hi = wl, wh
    while lo < hi:
        mid = (lo + hi) // 2
        if pred(mid):
            lo = mid + 1
        else:
            hi = mid
    return lo


def _walk(sA, nA, sB, nB, halo, q0, n):
    """One thread's merge of positions [q0, q0 + n) of a segment's
    staged spans (sA[h + x] is A span element x, sA[0] the halo when
    h = 1): (from_a, index, index of the A element before, dup) each."""
    h = int(halo)
    ia = _diag(sA[h:], nA, sB, nB, q0)
    jb = q0 - ia
    for _ in range(n):
        if jb >= nB or (ia < nA and sA[h + ia] <= sB[jb]):
            yield True, ia, ia, False
            ia += 1
        else:
            dup = (ia > 0 or halo) and sA[h + ia - 1] == sB[jb]
            yield False, jb, ia - 1, bool(dup)
            jb += 1


def _look_back(status, k):
    """(state, D) of segment k from its predecessors' status words
    ("A" or "P", value) or "PAST", nearest first; None: not published."""
    D = 0
    for kk in range(k - 1, -1, -1):
        w = status[kk]
        if w is None:
            return "pending", 0
        if w == "PAST":
            return "past", 0
        D += w[1]
        if w[0] == "P":
            return "resolved", D
    return "resolved", D


def _merge_path_model(A, CA, B, CB, seg, per, ready, seen):
    """csrc/min_distance.cu's merge path in numpy, one pair: M, the
    splits of every segment boundary, then the segments in order, each
    staging A[i0 - 1, i1) (the halo) and B[j0, j1), merged by threads of
    ``per`` positions, its dup count published and its rank offset taken
    by look-back, the rule "x <= t and rank <= L" applied as the kernel
    does (lower segments whole; past L whole, none, or a second walk
    with ranks), a segment past L skipping its loads when its
    predecessors already place it past the cut-off. ``ready``: a peek at a predecessor finds it published (else lower
    segments publish A and past-skip's first look-back is pending).
    ``seen`` counts "halo_dup", "past", "cut" and "lower" segments."""
    la, lb = len(A), len(B)
    L = min(la, lb)
    if L == 0:
        return 0, 0, 0, 0
    t = min(A[-1], B[-1])
    na, nb = (int(np.searchsorted(X, t, "right")) for X in (A, B))
    M = min(na + nb, 2 * L)
    K = -(-M // seg)
    # a small window, so that it brackets some splits and not others
    split = [_diag(A, na, B, nb, min(k * seg, M), win=2)
             for k in range(K + 1)]
    status = [None] * K
    tallies = np.zeros(4, np.int64)
    for k in range(K):
        d0, d1 = k * seg, min((k + 1) * seg, M)
        i0, i1 = split[k], split[k + 1]
        lower = d1 <= L
        seen["lower"] += lower
        state, D = "pending", 0
        if not lower:
            if ready:
                state, D = _look_back(status, k)
            if state == "past" or (state == "resolved" and d0 - D > L):
                status[k] = "PAST"
                seen["past"] += 1
                continue
        halo = i0 > 0
        nA, n = i1 - i0, d1 - d0
        nB, j0 = n - nA, d0 - i0
        sA, sCA = A[i0 - halo:i1], CA[i0 - halo:i1]
        sB, sCB = B[j0:j0 + nB], CB[j0:j0 + nB]
        h = int(halo)
        threads = []
        for q0 in range(0, n, per):
            threads.append(list(_walk(sA, nA, sB, nB, halo, q0,
                                      min(per, n - q0))))
        dups = [sum(e[3] for e in th) for th in threads]
        excl = np.cumsum([0] + dups)[:-1]
        agg = int(sum(dups))
        first = threads[0][0]
        seen["halo_dup"] += bool(first[3] and first[2] == -1)

        def tally(with_rank):
            out = np.zeros(4, np.int64)
            for th, q0, ex in zip(threads, range(0, n, per), excl):
                dseen = D + ex
                for q, (from_a, x, xa, dup) in enumerate(th):
                    dseen += dup
                    if with_rank and d0 + q0 + q + 1 - dseen > L:
                        continue
                    if from_a:
                        out += (1, 0, int(sCA[h + x]), 0)
                    elif dup:
                        out += (0, 1, int(sCB[x]),
                                min(int(sCA[h + xa]), int(sCB[x])))
                    else:
                        out += (1, 0, int(sCB[x]), 0)
            return out

        if lower:
            prev = status[k - 1] if k else ("P", 0)
            status[k] = (("P", prev[1] + agg)
                         if ready and prev[0] == "P" else ("A", agg))
            tallies += tally(False)
            continue
        if state != "resolved":
            status[k] = ("A", agg)
            state, D = _look_back(status, k)
        past = state == "past" or d0 - D > L
        status[k] = "PAST" if past else ("P", D + agg)
        if past:
            seen["past"] += 1
        elif d1 - (D + agg) > L:
            seen["cut"] += 1
            tallies += tally(True)
        else:
            tallies += tally(False)
    return tuple(int(v) for v in tallies)


def _straddle_seg(A, B):
    """A segment size whose first boundary falls between the two merged
    copies of a shared value: the merged position of the first dup past
    position 8 of the pair (A, B)."""
    t = min(A[-1], B[-1])
    a, b = A[A <= t], B[B <= t]
    merged = sorted([(x, 0) for x in a] + [(x, 1) for x in b])
    for m in range(9, len(merged)):
        if merged[m][1] == 1 and merged[m - 1][0] == merged[m][0]:
            return m
    raise AssertionError("no shared value in the pair")


@pytest.mark.parametrize("seg", [1, 2, 3, 64, 4096, "straddle"])
def test_merge_path_model_matches_plain(seg):
    rng = np.random.default_rng(7)
    pool = np.unique(rng.integers(0, 1 << 40, 400, dtype=np.uint64))
    sk = [_empty(), (pool[:1].copy(), np.array([2], np.uint32))]
    # lengths past two segments of the kernel's own size (4,096)
    for m in (5, 90, 300, 301, 40, 600) + ((6000,) * 2 if seg == 4096 else ()):
        sk.append(_sketch(rng, m, pool, hi=1 << 40))
    h, _ = sk[-1]
    sk.append((np.unique(np.append(h, ALL_ONES)),
               rng.integers(1, 256, len(h) + 1).astype(np.uint32)))
    if seg == "straddle":
        seg = _straddle_seg(sk[-2][0], sk[-1][0])
    per = max(1, min(16, seg // 4))
    o, ln, hh, cc = dd.ship_sketches(sk, "cpu")
    ii, jj = dd.sketch_pairs(len(sk), len(sk), False)
    plain = dd.pair_tallies(hh, cc, o, ln, hh, cc, o, ln,
                            torch.from_numpy(ii), torch.from_numpy(jj))
    seen = dict.fromkeys(("halo_dup", "past", "cut", "lower"), 0)
    for (i, j), want in zip(zip(ii, jj), plain.tolist()):
        for ready in (True, False):
            got = _merge_path_model(*sk[i], *sk[j], seg, per, ready, seen)
            assert list(got) == want, (i, j, ready)
    # every path of the kernel ran: segments wholly below L, past the
    # cut-off, and cut; a dup opening a segment (its A copy the halo)
    # where segments are small or the size was chosen for it
    assert seen["lower"] and seen["past"] and seen["cut"], seen
    assert seen["halo_dup"] or seg in (64, 4096), seen


def test_segments_bound():
    """The kernel's bound on segments a pair, ceil(min(lA + lB, 2
    min(lA, lB)) / seg), over the pairs, at least 1; an index out of
    range is clamped (the caller rejects it in the same host read)."""
    lens = torch.tensor([0, 1, 4096, 5000, 9000], dtype=torch.int64)
    for i, j, want in ((0, 0, 1), (1, 4, 1), (2, 2, 2), (2, 3, 2),
                       (3, 4, 3), (4, 4, 5), (7, 4, 5), (-3, 3, 1)):
        got = dd.segments_bound(lens, lens,
                                torch.tensor([i], dtype=torch.int32),
                                torch.tensor([j], dtype=torch.int32), 4096)
        assert int(got) == want, (i, j)
    ii, jj = (torch.from_numpy(a) for a in dd.sketch_pairs(5, 5, False))
    assert int(dd.segments_bound(lens, lens, ii, jj, 4096)) == 5


def test_empty_and_single_lists():
    for s1, s2, sym in (([], [], True), ([_empty()], [_empty()], False),
                        ([_empty(), _empty()], None, True)):
        s2 = s1 if s2 is None else s2
        got = dd.compute_distance_block_device(s1, s2, sym, device="cpu")
        for g, w in zip(got, ref_block(s1, s2, sym)):
            np.testing.assert_array_equal(g, w)


@pytest.mark.cuda
def test_kernel_matches_plain_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda")
    # chip_smoke.py's phase 12a cases: the merge path's segment shapes
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("_chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    edges = smoke.edge_sketches(0)
    for name in CASES + list(edges):
        s1, s2 = _case(name) if name in CASES else (edges[name], None)
        s2 = s1 if s2 is None else s2
        (o1, l1, h1, c1) = dd.ship_sketches(s1, dev)
        (o2, l2, h2, c2) = dd.ship_sketches(s2, dev)
        ii, jj = (torch.from_numpy(a).to(dev)
                  for a in dd.sketch_pairs(len(s1), len(s2), False))
        args = (h1, c1, o1, l1, h2, c2, o2, l2, ii, jj)
        before = dd.launches
        got = dd.pair_tallies(*args)
        want = dd.pair_tallies_plain(*args)
        torch.cuda.synchronize()
        assert dd.launches == before + 1
        assert torch.equal(got, want), name
