"""SimkaMin's device programs in the port (simka_tpu_torch.minhash.device,
ops.spectrum.hash_spectrum, the gatb extraction of ops.kmers) against
simka_tpu's on the same numpy-made inputs, bit for bit: the hash's plain
version (the CUDA kernel's CPU form) against the host murmur and the
reference's device hash, canonical k-mers with comp_xor=2, hash_spectrum,
each bottom-s program, and the all-ones hash, which the port keeps as an
ordinary member (its oracle: _compute_sketch_host's bottom-s rule in
numpy). The kernel itself is held against the plain version on the card
(the cuda test below, and chip_smoke.py phase 11)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simka_tpu.minhash.device as ref
import simka_tpu.ops.kmers as jk
import simka_tpu_torch.minhash.device as port
import simka_tpu_torch.ops.kmers as tk
from simka_tpu.minhash.murmur import murmur3_u64 as ref_murmur
from simka_tpu_torch.minhash.murmur import murmur3_u64

FULL = np.uint64((1 << 64) - 1)


def _u64(rng, n):
    return rng.integers(0, 1 << 63, size=n, dtype=np.uint64) | (
        rng.integers(0, 2, size=n, dtype=np.uint64) << np.uint64(63))


def _t(a: np.ndarray) -> torch.Tensor:
    """uint64 numpy -> int64 torch (the same bits)."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int64))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def _hash_stream(rng, n, pool=300):
    """n instance hashes drawn from a pool (duplicates; high bits set in
    about half), never all ones."""
    vals = _u64(rng, pool)
    vals[vals == FULL] = 7
    return vals[rng.integers(0, pool, size=n)]


def test_plain_murmur_matches_host_and_reference():
    rng = np.random.default_rng(0)
    vals = _u64(rng, 4096)
    vals[:6] = [0, 1, (1 << 64) - 1, (1 << 42) - 1, (1 << 62) - 1, 1 << 63]
    for seed in (100, 0, 7_777_777, (1 << 64) - 1):
        want = ref_murmur(vals, seed)
        np.testing.assert_array_equal(murmur3_u64(vals, seed), want)
        np.testing.assert_array_equal(
            _np(port.murmur3_plain(_t(vals), seed)), want)
    # the reference's device hash of (hi, lo) words: a k <= 31 word
    words = vals & np.uint64((1 << 62) - 1)
    valid = rng.random(4096) < 0.8
    hi = np.where(valid, words >> np.uint64(32), 0xFFFFFFFF).astype(np.uint32)
    lo = (words & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    want_h, want_v = ref.hash_kmer_words(jnp.asarray(hi), jnp.asarray(lo),
                                         seed=100)
    h, keep, counts = port.hash_kmer_words(_t(words), torch.from_numpy(valid),
                                           100)
    np.testing.assert_array_equal(_np(h), np.asarray(want_h))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(want_v))
    assert counts.tolist() == [int(valid.sum())] * 2


@pytest.mark.parametrize("thresh", [(1 << 64) - 1, 1 << 60, 0, (1 << 64) - 2,
                                    1 << 63])
def test_keep_bound_is_unsigned(thresh):
    rng = np.random.default_rng(1)
    words = _u64(rng, 3000) >> np.uint64(2)
    valid = rng.random(3000) < 0.6
    bits = thresh - (1 << 64) if thresh >= 1 << 63 else thresh
    h, keep, counts = port.hash_kmer_words(_t(words), torch.from_numpy(valid),
                                           100, bits)
    want_h = np.where(valid, ref_murmur(words, 100), FULL)
    want_keep = valid & (want_h <= np.uint64(thresh))
    np.testing.assert_array_equal(_np(h), want_h)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    assert counts.tolist() == [int(valid.sum()), int(want_keep.sum())]


def test_hash_kmer_words_rejects_bad_input():
    w = torch.zeros(8, dtype=torch.int64)
    v = torch.ones(8, dtype=torch.bool)
    for args in ((w.to(torch.int32), v, 100), (w, v.to(torch.uint8), 100),
                 (w, v[:7], 100), (w.reshape(2, 4), v.reshape(2, 4), 100),
                 (w, v, -1), (w, v, 100, 1 << 63)):
        with pytest.raises(ValueError):
            port.hash_kmer_words(*args)
    before = port.launches
    port.hash_kmer_words(w, v, 100)
    assert port.launches == before  # the CPU path does not count


@pytest.mark.cuda
@pytest.mark.parametrize("E", [1, 4095, (1 << 20) + 3])
def test_kernel_matches_plain_on_cuda(E):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    rng = np.random.default_rng(E)
    dev = torch.device("cuda")
    words = _t(_u64(rng, E) >> np.uint64(2)).to(dev)
    valid = torch.from_numpy(rng.random(E) < 0.5).to(dev)
    for thresh in (port.FULL64, 1 << 60):
        before = port.launches
        got = port.hash_kmer_words(words, valid, 100, thresh)
        want = port.hash_kmer_words_plain(words, valid, 100, thresh)
        torch.cuda.synchronize()
        assert port.launches == before + 1
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("k", [15, 21, 31])
def test_canonical_kmers_gatb_complement(k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, size=(24, 80)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.03] = 255
    hi, lo, valid = jk.extract_canonical_kmers(jnp.asarray(codes), k,
                                               comp_xor=2)
    t_hi, t_lo, t_valid = tk.extract_canonical_kmers(torch.from_numpy(codes),
                                                     k, comp_xor=2)
    np.testing.assert_array_equal(t_valid.numpy(), np.asarray(valid))
    np.testing.assert_array_equal(t_hi.numpy(), np.asarray(hi))
    np.testing.assert_array_equal(t_lo.numpy(), np.asarray(lo))
    # the packed form, and the one int64 word the hash reads
    from simka_tpu.ops.kmers import pack_codes_host

    packed, vb = pack_codes_host(codes)
    p_hi, p_lo = tk.extract_packed(torch.from_numpy(packed),
                                   torch.from_numpy(vb), k, comp_xor=2)
    np.testing.assert_array_equal(p_hi.numpy(), np.asarray(hi))
    np.testing.assert_array_equal(p_lo.numpy(), np.asarray(lo))
    w, v = port.gatb_words(torch.from_numpy(packed), torch.from_numpy(vb), k)
    m = v.numpy()
    both = (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | np.asarray(
        lo).astype(np.uint64)
    np.testing.assert_array_equal(w.numpy()[m].view(np.uint64),
                                  both.ravel()[m])


def test_hash_packed_batches_match_reference():
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 4, size=(256, 64)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.02] = 255
    from simka_tpu.ops.kmers import pack_codes_host

    packed, vb = pack_codes_host(codes)
    want_h, want_nv = ref.hash_packed_batch(jnp.asarray(packed),
                                            jnp.asarray(vb), 21, 100)
    want_h = np.asarray(want_h)
    h, nv = port.hash_packed_batch(torch.from_numpy(packed),
                                   torch.from_numpy(vb), 21, 100)
    assert nv == int(want_nv)
    np.testing.assert_array_equal(_np(h), want_h[want_h != FULL])
    thresh = 1 << 62
    sid_row = np.full(256, 3, np.int32)
    r_h, r_sid, r_nv, r_tot, r_kept = ref.hash_packed_sid_batch(
        jnp.asarray(packed), jnp.asarray(vb), jnp.asarray(sid_row),
        jnp.asarray(np.uint64(thresh)), 21, 100, n_samples=5)
    h, sid, nv, nk = port.hash_packed_sid_batch(
        torch.from_numpy(packed), torch.from_numpy(vb), 3, thresh, 21, 100)
    assert (nv, nk) == (int(r_tot[3]), int(r_kept[3])) and nk < nv
    np.testing.assert_array_equal(_np(h), np.asarray(r_h)[:nk])
    np.testing.assert_array_equal(sid.numpy(), np.asarray(r_sid)[:nk])


def test_hash_spectrum_matches_reference():
    from simka_tpu.ops.spectrum import hash_spectrum as ref_spectrum
    from simka_tpu_torch.ops.spectrum import hash_spectrum

    rng = np.random.default_rng(5)
    stream = _hash_stream(rng, 5000)
    stream[[3, 70, 4000]] = FULL
    stream[[5, 6]] = 0
    want = ref_spectrum((stream >> np.uint64(32)).astype(np.uint32),
                        (stream & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    got = hash_spectrum(_t(stream))
    np.testing.assert_array_equal(_np(got[0]), want[0])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("use_filter", [False, True])
@pytest.mark.parametrize("s", [1, 40, 10_000])
def test_sketch_prefix_matches_reference(use_filter, s):
    rng = np.random.default_rng(6)
    stream = _hash_stream(rng, 4096)
    r_h, r_c, r_e, r_n, _ = ref.sketch_prefix_device(
        jnp.asarray(stream), sketch_size=s, use_filter=use_filter)
    h, c, e, n = port.sketch_prefix_device(_t(stream), sketch_size=s,
                                           use_filter=use_filter)
    m = min(s, int(r_n))
    assert n == int(r_n) and h.shape[0] == m
    np.testing.assert_array_equal(_np(h), np.asarray(r_h)[:m])
    np.testing.assert_array_equal(c.numpy(), np.asarray(r_c)[:m])
    np.testing.assert_array_equal(e.numpy(), np.asarray(r_e)[:m])


@pytest.mark.parametrize("s", [1, 50, 700])
def test_sketch_stream_step_matches_reference(s):
    rng = np.random.default_rng(7)
    full = np.uint64((1 << 64) - 1)
    st = (jnp.full((s,), full), jnp.zeros((s,), jnp.int64), jnp.uint64(full),
          jnp.int64(0), jnp.int64(0))
    empty = torch.empty(0, dtype=torch.int64)
    pst = (empty, empty, torch.tensor(-1), torch.tensor(0))
    for _ in range(4):
        batch = _hash_stream(rng, 1024, pool=900)
        st = ref.sketch_stream_step(jnp.asarray(batch), *st, sketch_size=s)
        pst = port.sketch_stream_step(_t(batch), *pst, sketch_size=s)
        r_h = np.asarray(st[0])
        m = int((r_h != full).sum())
        np.testing.assert_array_equal(_np(pst[0]), r_h[:m])
        np.testing.assert_array_equal(pst[1].numpy(), np.asarray(st[1])[:m])
        assert int(pst[2]) & ((1 << 64) - 1) == int(st[2])
        assert int(pst[3]) == int(st[3])


@pytest.mark.parametrize("use_filter", [False, True])
@pytest.mark.parametrize("s", [1, 30, 5000])
def test_sketch_multi_prefix_matches_reference(use_filter, s):
    rng = np.random.default_rng(8)
    E, N = 6000, 4
    h = _hash_stream(rng, E, pool=2000)
    sid = rng.integers(0, N, size=E).astype(np.int32)  # interleaved
    r_h, r_c, r_k, r_b, _ = ref.sketch_multi_prefix(
        jnp.asarray(h), jnp.asarray(sid), n_samples=N, sketch_size=s,
        use_filter=use_filter, cap=min(E, N * s))
    hashes, counts, n_kept, n_before = port.sketch_multi_prefix(
        _t(h), torch.from_numpy(sid), n_samples=N, sketch_size=s,
        use_filter=use_filter)
    np.testing.assert_array_equal(n_kept, np.asarray(r_k))
    full = n_kept >= s
    np.testing.assert_array_equal(n_before[full], np.asarray(r_b)[full])
    n_out = hashes.shape[0]
    assert n_out == int(np.minimum(n_kept, s).sum())
    np.testing.assert_array_equal(_np(hashes), np.asarray(r_h)[:n_out])
    np.testing.assert_array_equal(counts.numpy(), np.asarray(r_c)[:n_out])


def test_device_sketch_update_matches_reference():
    rng = np.random.default_rng(9)
    E, s = 1 << 12, 300
    hi = rng.integers(0, 1 << 10, size=E, dtype=np.uint32)
    lo = rng.integers(0, 1 << 12, size=E, dtype=np.uint32)
    hi[::7] = 0xFFFFFFFF
    want_h, want_c = ref.device_sketch_update(jnp.asarray(hi), jnp.asarray(lo),
                                              seed=100, sketch_size=s)
    valid = hi != 0xFFFFFFFF
    words = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    h, c = port.device_sketch_update(_t(words), torch.from_numpy(valid),
                                     seed=100, sketch_size=s)
    np.testing.assert_array_equal(_np(h), np.asarray(want_h))
    np.testing.assert_array_equal(c.numpy(), np.asarray(want_c))
    h, c = port.device_sketch_update(_t(words[:40]),
                                     torch.from_numpy(valid[:40]), seed=100,
                                     sketch_size=s)
    assert (_np(h)[35:] == FULL).all() and (c.numpy()[35:] == 0).all()


def _oracle(stream, s, use_filter):
    """_compute_sketch_host's bottom-s rule in numpy."""
    order = np.argsort(stream, kind="stable")
    hs = stream[order]
    starts = np.r_[0, np.nonzero(hs[1:] != hs[:-1])[0] + 1]
    counts = np.diff(np.r_[starts, len(hs)])
    uniq, entry, base = hs[starts], order[starts], 1
    if use_filter:
        keep = counts >= 2
        uniq, counts, base = uniq[keep], counts[keep], 2
        entry = order[np.minimum(starts + 1, len(hs) - 1)][keep]
    m = min(s, len(uniq))
    out = counts[:m].astype(np.int64)
    if len(uniq) >= s and m:
        t_last = int(entry[: m - 1].max()) if m >= 2 else 0
        out[m - 1] = max(base, int((stream[:t_last] == uniq[m - 1]).sum()))
    return uniq[:m], out


@pytest.mark.parametrize("use_filter", [False, True])
def test_all_ones_hash_is_an_ordinary_member(use_filter):
    """A genuine 2^64 - 1 hash is the largest member: the port's one-shot
    prefix, its stream fold and its multi-sample prefix keep it, with
    the heap-quirk count, as the exact path does."""
    rng = np.random.default_rng(10)
    stream = _hash_stream(rng, 3000, pool=120)
    stream[rng.integers(0, 3000, size=9)] = FULL  # largest, repeated
    for s in (1, 60, 119, 121, 10_000):
        want_h, want_c = _oracle(stream, s, use_filter)
        assert want_h[-1] == FULL or s < len(np.unique(stream))
        h, c, _, _ = port.sketch_prefix_device(_t(stream), sketch_size=s,
                                               use_filter=use_filter)
        np.testing.assert_array_equal(_np(h), want_h)
        np.testing.assert_array_equal(c.numpy(), want_c)
        sid = np.repeat(np.arange(2, dtype=np.int32), 3000)
        hashes, counts, n_kept, n_before = port.sketch_multi_prefix(
            _t(np.concatenate([stream, stream])), torch.from_numpy(sid),
            n_samples=2, sketch_size=s, use_filter=use_filter)
        m = len(want_h)
        for i in range(2):
            got_c = counts.numpy()[i * m:(i + 1) * m].astype(np.int64)
            if n_kept[i] >= s:
                got_c[-1] = max(2 if use_filter else 1, int(n_before[i]))
            np.testing.assert_array_equal(_np(hashes)[i * m:(i + 1) * m],
                                          want_h)
            np.testing.assert_array_equal(got_c, want_c)
        if use_filter:
            continue
        empty = torch.empty(0, dtype=torch.int64)
        st = (empty, empty, torch.tensor(-1), torch.tensor(0))
        for part in np.array_split(stream, 7):
            st = port.sketch_stream_step(_t(part), *st, sketch_size=s)
        got_c = st[1].numpy().copy()
        if len(got_c) >= s:
            assert int(st[2]) == int(st[0][-1])
            got_c[-1] = max(1, int(st[3]))
        np.testing.assert_array_equal(_np(st[0]), want_h)
        np.testing.assert_array_equal(got_c, want_c)
