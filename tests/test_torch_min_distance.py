"""SimkaMin's sketch-pair distance in the port, on the CPU, against
simka_tpu on the same numpy-seeded sketches: the plain tallies against
the host walk's quantities, the matrices against simka_tpu's
compute_distance_block_device (JAX on the CPU) and compute_distance_block
(the host walk) bit for bit, symmetric and rectangular, on heavy
overlap, empty sketches, length 1, unequal lengths, the all-ones hash as
a member and hashes with the top bit set; the port's
assemble_sketch_grid against simka_tpu's on a compacted stream; and a
numpy model of the CUDA kernel's walk (chunks searched in a staged
window of the other list or past it, the chunked scan, the early stop)
against the plain version."""

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


def _kernel_model(A, CA, B, CB, chunk, window):
    """csrc/min_distance.cu's walk in numpy, one CTA: chunks of ``chunk``
    elements of X searched in a staged window of the next ``window``
    elements of Y (past it, in the rest of Y), the pass-1 count over
    A[0, #A<=t), the pass-2 scan with its carry and early stop."""
    la, lb = len(A), len(B)
    if la == 0 or lb == 0:
        return 0, 0, 0, 0
    t = min(A[-1], B[-1])
    na, nbt = np.searchsorted(A, t, "right"), np.searchsorted(B, t, "right")

    def chunks(X, Y, n):
        base = 0
        for c0 in range(0, n, chunk):
            x = X[c0:min(c0 + chunk, n)]
            win = Y[base:base + window]
            lo = np.searchsorted(win, x, "left")
            l = base + lo
            rest = base + len(win)
            beyond = lo == len(win)
            if rest < len(Y):
                l[beyond] = rest + np.searchsorted(Y[rest:], x[beyond], "left")
            sh = (l < len(Y)) & (Y[np.minimum(l, len(Y) - 1)] == x)
            base = int(l[-1])
            yield c0, x, l, sh

    ns = sum(int(sh.sum()) for _, _, _, sh in chunks(A, B, na))
    processed = min(la, lb, int(na + nbt - ns))
    tallies = [processed, 0, 0, 0]
    for X, CX, Y, CY, own in ((A, CA, B, CB, True), (B, CB, A, CA, False)):
        carry = 0
        for c0, x, l, sh in chunks(X, Y, len(X)):
            excl = carry + np.cumsum(sh) - sh
            rank = c0 + np.arange(len(x)) + 1 + l - excl
            inc = rank <= processed
            tallies[2] += int(CX[c0:c0 + len(x)][inc].astype(np.int64).sum())
            if own:
                s_in = inc & sh
                tallies[1] += int(s_in.sum())
                tallies[3] += int(np.minimum(
                    CX[c0:c0 + len(x)][s_in],
                    CY[l[s_in]]).astype(np.int64).sum())
            carry += int(sh.sum())
            if (rank > processed).any():
                break
    return tuple(tallies)


@pytest.mark.parametrize("chunk,window", [(1, 2), (4, 4), (4, 8), (32, 64),
                                          (1024, 2048)])
def test_kernel_walk_model_matches_plain(chunk, window):
    rng = np.random.default_rng(chunk + window)
    pool = np.unique(rng.integers(0, 1 << 40, 500, dtype=np.uint64))
    sk = [_empty(), (pool[:1].copy(), np.array([2], np.uint32))]
    for m in (5, 90, 300, 301, 40, 600, 3000):
        sk.append(_sketch(rng, m, pool, hi=1 << 40))
    h, c = sk[-1]
    sk.append((np.unique(np.append(h, ALL_ONES)),
               np.ones(len(h) + 1, np.uint32)))
    d = dd.ship_sketches(sk, "cpu")
    ii, jj = dd.sketch_pairs(len(sk), len(sk), False)
    o, ln, hh, cc = d
    plain = dd.pair_tallies(hh, cc, o, ln, hh, cc, o, ln,
                            torch.from_numpy(ii), torch.from_numpy(jj))
    model = [_kernel_model(*sk[i], *sk[j], chunk, window)
             for i, j in zip(ii, jj)]
    assert plain.tolist() == [list(m) for m in model]


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
    for name in CASES:
        s1, s2 = _case(name)
        s2 = s1 if s2 is None else s2
        (o1, l1, h1, c1) = dd.ship_sketches(s1, dev)
        (o2, l2, h2, c2) = dd.ship_sketches(s2, dev)
        ii, jj = (torch.from_numpy(a).to(dev)
                  for a in dd.sketch_pairs(len(s1), len(s2), False))
        before = dd.launches
        got = dd.pair_tallies(h1, c1, o1, l1, h2, c2, o2, l2, ii, jj)
        want = dd.pair_tallies_plain(h1, c1, o1, l1, h2, c2, o2, l2, ii, jj)
        torch.cuda.synchronize()
        assert dd.launches == before + 1
        assert torch.equal(got, want), name
