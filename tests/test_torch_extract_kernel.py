"""The extraction kernel's wrapper (``ops.kmers.extract_kmers``, plain
torch version on CPU tensors) against ``simka_tpu``'s fused extraction
program on the same numpy inputs; a model of the kernel's work
(csrc/kmers.cu: the staged 2-bit, reversed and validity streams, each
word two extractions from them, the walk over tiles)
against the plain version; the kernel against its plain version on the
card (``cuda``-marked). Exact
equality throughout, but for the Shannon filter, held as
tests/test_torch_kmers.py holds the index: XLA's f32 log is off by an
ulp at some frequencies, so a window whose reference index lies within
2 ulp of the threshold may fall the other way."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simka_tpu.core.pipeline import _extract_windows_program
from simka_tpu.io.bank import encode_batch
from simka_tpu.ops import kmers as jk
from simka_tpu_torch.core import pipeline as tp
from simka_tpu_torch.io.packed import pack_codes_host
from simka_tpu_torch.ops import kmers as tk
from simka_tpu_torch.ops.compact import compact_rows

KS = (1, 15, 16, 21, 31, 32, 33, 48, 62, 63, 64, 127)
WIDTH = 160
ULP2 = 2 * float(np.spacing(np.float32(2.0)))
PATTERNS = (b"AAAA", b"AAAC", b"AACC", b"AACG", b"ACGT")


def _batch(seed: int, n: int = 24, width: int = WIDTH, low: bool = False):
    """[n, width] ACGT codes (255 invalid): ragged reads with N bases, one
    all-N read, reads shorter than most k, one empty slot; with ``low``,
    every other read a repeat of one of ``PATTERNS`` (Shannon indices 0,
    0.81, 1.0, 1.5 and 2.0 at k a multiple of 4)."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGTN", np.uint8)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    reads = []
    for i in range(n):
        if i == 0:
            reads.append(b"N" * width)
        elif i == 1:
            reads.append(b"")
        elif i < 4:
            size = int(rng.integers(1, 15))
            reads.append(bytes(rng.choice(acgt, size=size)))
        elif low and i % 2:
            pat = np.frombuffer(PATTERNS[(i // 2) % len(PATTERNS)], np.uint8)
            reads.append(bytes(np.tile(pat, width // 4)[:width]))
        else:
            size = int(rng.integers(width // 2, width + 1))
            reads.append(bytes(rng.choice(
                bases, size=size, p=[0.2475] * 4 + [0.01])))
    codes, _ = encode_batch(reads, max_len=width)
    return codes


def _reference(packed, vb, k: int, min_shannon: float):
    """``simka_tpu``'s program: (uint32 words of the kept windows, their
    count, the histogram)."""
    B = packed.shape[0]
    words, _, hist = _extract_windows_program(
        jnp.asarray(packed), jnp.asarray(vb), jnp.zeros(B, jnp.int32), k=k,
        multi=k > 31, min_shannon=min_shannon, with_hist=True)
    words = [np.asarray(w, np.int64) for w in words]
    n = int((words[0] != jk.SENTINEL).sum())
    assert all((w[n:] == jk.SENTINEL).all() for w in words)
    return [w[:n] for w in words], n, np.asarray(hist, np.int64)


def _port(packed, vb, k: int, **kw):
    ex = tk.extract_kmers(torch.from_numpy(packed), torch.from_numpy(vb), k,
                          with_hist=True, **kw)
    n = int(ex.n_kept)
    kept = compact_rows(ex.words, ex.keep, (-1,) * len(ex.words), n=n)
    return ex, kept, n


@pytest.mark.parametrize("k", KS)
def test_extract_kmers_matches_reference_program(k):
    packed, vb = pack_codes_host(_batch(k))
    want, n, hist = _reference(packed, vb, k, 0.0)
    ex, kept, got_n = _port(packed, vb, k)
    assert got_n == n > 0
    E = packed.shape[0] * (4 * packed.shape[1] - k + 1)
    assert ex.keep.shape == (E,) and len(ex.words) == tk.n_words(k)
    for g, w in zip(tk.uint32_words(kept, k), want):
        np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_array_equal(ex.hist.numpy(), hist)
    assert int(ex.hist.sum()) == n


@pytest.mark.parametrize("k", KS)
def test_extract_kmers_gatb_complement_matches_reference(k):
    """comp_xor=2 (SimkaMin's gatb-core codes) against
    ``simka_tpu.ops.kmers.extract_packed(comp_xor=2)``."""
    packed, vb = pack_codes_host(_batch(100 + k))
    ref = jk.extract_packed(jnp.asarray(packed), jnp.asarray(vb), k,
                            comp_xor=2, multi=k > 31)
    ref = [np.asarray(w, np.int64).ravel() for w in ref]
    ex = tk.extract_kmers(torch.from_numpy(packed), torch.from_numpy(vb), k,
                          comp_xor=2)
    keep = ex.keep.numpy()
    np.testing.assert_array_equal(keep, ref[0] != jk.SENTINEL)
    for g, w in zip(tk.uint32_words(ex.words, k, ex.keep), ref):
        np.testing.assert_array_equal(g.numpy(), w)
    assert ex.hist is None and int(ex.n_kept) == keep.sum() > 0


@pytest.mark.parametrize("thr", [1.0, 1.5])
@pytest.mark.parametrize("k", [16, 21, 32, 63, 64, 127])
def test_extract_kmers_shannon_filter_matches_reference(k, thr):
    packed, vb = pack_codes_host(_batch(200 + k, low=True))
    _, n, _ = _reference(packed, vb, k, thr)
    ex, _, got_n = _port(packed, vb, k, min_shannon=thr)
    # every window the two keep differently has a reference index within
    # 2 ulp of the threshold
    ref_words = jk.extract_packed(jnp.asarray(packed), jnp.asarray(vb), k,
                                  multi=k > 31)
    ref_index = np.asarray(jk.kmer_shannon_index_words(ref_words, k)).ravel()
    valid = np.asarray(ref_words[0]).ravel() != jk.SENTINEL
    ref_keep = valid & (ref_index >= np.float32(thr))
    got_keep = ex.keep.numpy()
    assert (got_keep <= valid).all()
    off = got_keep != ref_keep
    assert (np.abs(ref_index[off] - thr) <= ULP2).all()
    assert got_n == n + int(got_keep[off].sum()) - int(ref_keep[off].sum())
    assert 0 < got_n < valid.sum()
    if k % 4 == 0:  # an index exactly at the threshold is kept
        assert (ref_index[got_keep] == np.float32(thr)).any()
    if not off.any():
        _, _, hist = _reference(packed, vb, k, thr)
        np.testing.assert_array_equal(ex.hist.numpy(), hist)


@pytest.mark.parametrize("k", [1, 21, 33, 127])
@pytest.mark.parametrize("comp_xor", [3, 2])
def test_codes_entry_point_equals_packed_entry_point(k, comp_xor):
    codes = _batch(300 + k)
    packed, vb = pack_codes_host(codes)
    a = tk.extract_kmers(torch.from_numpy(packed), torch.from_numpy(vb), k,
                         comp_xor=comp_xor, with_hist=True, min_shannon=1.2)
    b = tk.extract_kmers_codes(torch.from_numpy(codes), k, comp_xor=comp_xor,
                               with_hist=True, min_shannon=1.2)
    for x, y in zip((*a.words, a.keep, a.hist, a.n_kept),
                    (*b.words, b.keep, b.hist, b.n_kept)):
        assert torch.equal(x, y)


def test_extract_kmers_refuses_bad_shapes():
    packed, vb = pack_codes_host(_batch(0, width=32))
    p, v = torch.from_numpy(packed), torch.from_numpy(vb)
    with pytest.raises(NotImplementedError):
        tk.extract_kmers(p, v, 128)
    with pytest.raises(ValueError):
        tk.extract_kmers(p, v, 33)  # reads of 32 slots
    with pytest.raises(ValueError):
        tk.extract_kmers(p, v[:, :1], 5)
    with pytest.raises(ValueError):
        tk.extract_kmers_codes(torch.zeros(4, 40, dtype=torch.int32), 5)


@pytest.mark.parametrize("k,shannon", [(21, 0.0), (63, 0.0), (63, 1.5)])
def test_pipeline_batch_takes_one_extraction(k, shannon):
    """``core.pipeline.extract_windows``: the kept windows and histogram
    of the reference program, the parser's n_valid taken where no
    Shannon filter drops windows."""
    packed, vb = pack_codes_host(_batch(400 + k, low=True))
    want, n, hist = _reference(packed, vb, k, shannon)
    n_valid = None if shannon else n
    words, sid, got_hist = tp.extract_windows(
        torch.from_numpy(packed), torch.from_numpy(vb), 5, k, n_valid,
        shannon)
    assert sid.dtype == torch.int32 and (sid == 5).all()
    assert sid.shape[0] == n
    for g, w in zip(tk.uint32_words(words, k), want):
        np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_array_equal(got_hist.numpy(), hist)
    again = tp.kept_windows(torch.from_numpy(packed), torch.from_numpy(vb),
                            k, n_valid, shannon)
    assert all(torch.equal(a, b) for a, b in zip(again, words))


# ---- (b) a model of the kernel's work (csrc/kmers.cu) -------------------

M55 = 0x5555555555555555
M64 = (1 << 64) - 1
# csrc/kmers.cu's geometry: tiles of 4096 window starts, 256 threads
TILE_BASES, THREADS = 4096, 256


def _streams_from_packed(packed, vb):
    """The kernel's staged streams of a packed batch as Python integers:
    the flat 2-bit stream (base i at bits 2i, 2i + 1; an invalid base
    code 3: the packed bits OR its validity bit spread to two) and the
    validity bits (base i at bit i)."""
    p = int.from_bytes(packed.tobytes(), "little")
    v = int.from_bytes(vb.tobytes(), "little")
    n = 8 * vb.size
    inv = ~v & ((1 << n) - 1)
    spread = int("".join(b + b for b in format(inv, f"0{n}b")), 2) if n else 0
    return p | spread, v


def _streams_from_codes(codes):
    """The same streams packed from a code batch as the codes entry
    point stages it: code c & 3, valid where c < 4."""
    flat = codes.ravel()
    p = sum(int(c & 3) << (2 * i) for i, c in enumerate(flat))
    v = sum(1 << i for i, c in enumerate(flat) if c < 4)
    return p, v


def _reverse_groups32(x: int) -> int:
    """__brev of a 32-bit word, then a swap within each pair of bits:
    its 16 2-bit groups in reverse order."""
    x = int(format(x, "032b")[::-1], 2)
    return ((x >> 1) & 0x55555555) | ((x & 0x55555555) << 1)


def _stage(pk: int, vb: int, s0: int, n: int, vecs: int):
    """csrc/kmers.cu's staged streams of bases [s0, s0 + n) of a flat
    stream, in `vecs` vectors of 64 bases: the 2-bit stream and the
    validity bits from s0, and the reversed stream of M = 64 vecs bases:
    each 32-bit word of the 2-bit stream with its groups reversed, the
    words in reverse order (base i at group M - 1 - i)."""
    p = (pk >> (2 * s0)) & ((1 << (2 * n)) - 1)
    v = (vb >> s0) & ((1 << n) - 1)
    rv = 0
    for wi in range(4 * vecs):
        rv |= _reverse_groups32((p >> (32 * wi)) & 0xFFFFFFFF) << (
            32 * (4 * vecs - 1 - wi))
    return p, rv, v, 64 * vecs


def _bits64(s: int, bit: int) -> int:
    return (s >> bit) & M64


def _model_window(staged, at: int, k: int, comp_xor: int, terms):
    """csrc/kmers.cu's work for the window whose first base is base `at`
    of the staged streams: each word two extractions of 2n bits, the
    forward word from the reversed stream at the mirrored offset, the
    reverse complement's from the 2-bit stream XOR the replicated
    complement; validity k bits all set, 64 at a time; the base counts
    by popcounts; the lexicographic min; the f32 Shannon sum; the
    reference's uint32 words by the kernel's one formula and the
    mix_hash fold."""
    pk, rv, vb, M = staged
    nw = tk.n_words(k)
    top = k - tk.WORD_BASES * (nw - 1)
    comp = M55 * comp_xor
    f, r, n123 = [], [], [0, 0, 0]
    for w in range(nw):
        hi = top + tk.WORD_BASES * w
        lo = 0 if w == 0 else hi - tk.WORD_BASES
        m = (1 << (2 * (hi - lo))) - 1
        f.append(_bits64(rv, 2 * (M - at - hi)) & m)
        r.append((_bits64(pk, 2 * (at + k - hi)) ^ comp) & m)
        a, b = f[-1] & M55, (f[-1] >> 1) & M55
        for i, x in enumerate((a & ~b, b & ~a, a & b)):
            n123[i] += bin(x).count("1")
    ok = True
    for c in range(0, k, 64):
        m = (1 << min(64, k - c)) - 1
        ok = ok and (_bits64(vb, at + c) & m) == m
    take_fwd = next((a < b for a, b in zip(f, r) if a != b), True)
    o = f if take_fwd else r
    x = 0 if take_fwd else comp_xor
    cnt = [k - sum(n123), *n123]
    s = np.float32(terms[cnt[0 ^ x]])
    for c in (1, 2, 3):
        s = np.float32(s + np.float32(terms[cnt[c ^ x]]))
    n32 = tk.n_uint32_words(k)
    u = []
    for i in range(n32):
        j, ob = divmod(32 * i, 62)
        v = (o[nw - 1 - j] >> ob) if j < nw else 0
        if j + 1 < nw:
            v |= o[nw - 2 - j] << (62 - ob)
        u.append(v & 0xFFFFFFFF)
    h = u[-1]
    for v in reversed(u[:-1]):
        h = (h ^ 0x9E3779B9) * 0x85EBCA6B & 0xFFFFFFFF
        h ^= h >> 13
        h = (h ^ v) * 0xC2B2AE35 & 0xFFFFFFFF
        h ^= h >> 16
    return o, ok, abs(s), h & 15


def _model_walk(B: int, L: int, k: int, tile: int, threads: int,
                grid: int = 3):
    """The windows each thread of csrc/kmers.cu visits: tiles of `tile`
    window starts over the flat stream of B * L bases, CTA c of `grid`
    taking tiles c, c + grid, ...; a tile's windows [e_lo, e_lo + n)
    and the first window's row offset and base, from the tile's start
    as (row, offset) advanced by host-made steps (no division but one a
    CTA); thread t's first window t on, by one division; then steps of
    `threads` windows: step_rows rows and step_rem windows, with k - 1
    stream bases skipped at each row's end. Yields (tile, thread, step,
    e, base in the tile, bases staged)."""
    N, Wk = B * L, L - k + 1
    E = B * Wk
    step_rows, step_rem = divmod(threads, Wk)
    tile_rows, tile_rem = divmod(tile, L)
    grid_rows, grid_rem = divmod(grid * tile, L)

    def advance(pos, rows, rem):
        row, off = pos[0] + rows, pos[1] + rem
        return (row + 1, off - L) if off >= L else (row, off)

    def before(pos):
        return pos[0] * Wk + min(pos[1], Wk)

    n_tiles = -(-N // tile)
    for c in range(min(grid, n_tiles)):
        at = divmod(c * tile, L)
        for ti in range(c, n_tiles, grid):
            s0 = ti * tile
            if ti > c:
                at = advance(at, grid_rows, grid_rem)
            assert at == divmod(s0, L)
            e_lo = before(at)
            end = advance(at, tile_rows, tile_rem)
            n = (before(end) if s0 + tile < N else E) - e_lo
            staged = min(tile + k - 1, N - s0)
            p0, b0 = (at[1], 0) if at[1] < Wk else (0, L - at[1])
            for t in range(threads):
                rows = (p0 + t) // Wk
                p, base = p0 + t - rows * Wk, b0 + t + rows * (k - 1)
                for step, j in enumerate(range(0, n, threads)):
                    if j + t < n:
                        yield ti, t, step, e_lo + j + t, base, staged
                    p += step_rem
                    base += threads + step_rows * (k - 1)
                    if p >= Wk:
                        p -= Wk
                        base += k - 1


def _model_kernel(pk, vb, B, L, k, comp_xor, min_shannon, tile, threads):
    """csrc/kmers.cu's outputs from the batch's streams: each tile staged
    (its bases and the k - 1 after it), every window at the base the
    walk gives it, a thread taking at most ceil(tile / threads) windows
    a tile; kept windows and buckets counted a thread."""
    terms = tk.shannon_terms(k).numpy()
    N, E = B * L, B * (L - k + 1)
    words = np.zeros((tk.n_words(k), E), np.int64)
    keep = np.zeros(E, bool)
    hist = np.zeros(16, np.int64)
    staged, taken = {}, {}
    for ti, t, _, e, base, n in _model_walk(B, L, k, tile, threads):
        if ti not in staged:
            staged[ti] = _stage(pk, vb, ti * tile, n, -(-(tile + k - 1) //
                                                       64))
        o, ok, s, bucket = _model_window(staged[ti], base, k, comp_xor,
                                         terms)
        ok = ok and (min_shannon == 0.0 or s >= np.float32(min_shannon))
        words[:, e] = o
        keep[e] = ok
        hist[bucket] += ok
        taken[ti, t] = taken.get((ti, t), 0) + 1
    assert max(taken.values()) <= -(-tile // threads)
    return words, keep, hist, int(keep.sum())


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("comp_xor", [3, 2])
def test_kernel_model_matches_plain(k, comp_xor):
    """The model of one window against the plain version at every
    window of a batch, kept or not (N bases read as code 3)."""
    codes = _batch(500 + k, n=6, low=True)
    packed, vb = pack_codes_host(codes)
    pk, v = _streams_from_packed(packed, vb)
    N = codes.size
    staged = _stage(pk, v, 0, N, -(-N // 64))
    terms = tk.shannon_terms(k).numpy()
    ex = tk.extract_kmers_codes(torch.from_numpy(codes), k,
                                comp_xor=comp_xor, with_hist=True)
    index = tk.kmer_shannon_index_words(ex.words, k).numpy()
    words = np.stack([w.numpy() for w in ex.words])
    L = codes.shape[1]
    hist = np.zeros(16, np.int64)
    for b in range(codes.shape[0]):
        for p in range(L - k + 1):
            e = b * (L - k + 1) + p
            o, valid, s, bucket = _model_window(staged, b * L + p, k,
                                                comp_xor, terms)
            assert list(words[:, e]) == o
            assert bool(ex.keep[e]) == valid
            assert s == index[e]
            hist[bucket] += valid
    np.testing.assert_array_equal(ex.hist.numpy(), hist)


def test_staged_streams_of_both_entry_points_agree():
    """The packed entry point's staged streams (validity spread into the
    2-bit stream) are the codes entry point's (c & 3 of 255 is 3)."""
    codes = _batch(7, n=5, width=40)
    packed, vb = pack_codes_host(codes)
    assert _streams_from_packed(packed, vb) == _streams_from_codes(codes)


# row strides of 8, 26 and 40 packed bytes; k up to the row
WALK_CASES = [(L, k) for L in (32, 104, 160) for k in KS if k <= L]


@pytest.mark.parametrize("L,k", WALK_CASES)
def test_tile_walk_visits_every_window_once(L, k):
    """The kernel's walk at its own geometry and at a small one (tiles
    of 64 starts, 8 threads): every window once, at base b * L + p of
    the stream, inside its tile's staged bases; batches whose stream
    ends mid-tile."""
    for B, tile, threads in ((97, TILE_BASES, THREADS), (13, 64, 8)):
        Wk = L - k + 1
        seen = np.zeros(B * Wk, np.int64)
        for ti, _, _, e, base, staged in _model_walk(B, L, k, tile,
                                                     threads):
            b, p = divmod(e, Wk)
            assert ti * tile + base == b * L + p
            assert base < tile and base + k <= staged
            seen[e] += 1
        assert (seen == 1).all()


@pytest.mark.parametrize("L,k,comp_xor,shannon", [
    (32, 1, 3, 0.0), (32, 21, 2, 1.0), (104, 21, 3, 0.0),
    (104, 63, 3, 1.5), (40, 33, 2, 0.0), (160, 127, 3, 1.5),
    (160, 64, 2, 1.0), (104, 104, 3, 0.0)])
def test_kernel_model_matches_plain_over_tiles(L, k, comp_xor, shannon):
    """The whole kernel's model (the walk over tiles of 64 starts and
    8 threads a CTA, so windows and reads straddle tiles; each tile
    staged with its halo) against the plain version, bit for bit, on a
    batch of 13 reads, whose stream ends mid-tile."""
    codes = _batch(L + k, n=13, width=L, low=True)
    packed, vb = pack_codes_host(codes)
    pk, v = _streams_from_packed(packed, vb)
    words, keep, hist, n = _model_kernel(pk, v, 13, L, k, comp_xor, shannon,
                                         64, 8)
    ex = tk.extract_kmers(torch.from_numpy(packed), torch.from_numpy(vb), k,
                          comp_xor=comp_xor, min_shannon=shannon,
                          with_hist=True)
    np.testing.assert_array_equal(np.stack([w.numpy() for w in ex.words]),
                                  words)
    np.testing.assert_array_equal(ex.keep.numpy(), keep)
    np.testing.assert_array_equal(ex.hist.numpy(), hist)
    assert int(ex.n_kept) == n


# ---- (c) on the card --------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("comp_xor", [3, 2])
def test_kernel_matches_plain_on_cuda(k, comp_xor):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    codes = _batch(600 + k, n=64, low=True)
    packed, vb = pack_codes_host(codes)
    for shannon in (0.0, 1.0, 1.5):
        for hist in (False, True):
            before = tk.launches
            got = tk.extract_kmers(torch.from_numpy(packed).cuda(),
                                   torch.from_numpy(vb).cuda(), k,
                                   comp_xor=comp_xor, min_shannon=shannon,
                                   with_hist=hist)
            want = tk.extract_kmers(torch.from_numpy(packed),
                                    torch.from_numpy(vb), k,
                                    comp_xor=comp_xor, min_shannon=shannon,
                                    with_hist=hist)
            torch.cuda.synchronize()
            assert tk.launches == before + 1
            for g, w in zip((*got.words, got.keep, got.n_kept),
                            (*want.words, want.keep, want.n_kept)):
                assert torch.equal(g.cpu(), w)
            assert (got.hist is None) == (not hist)
            if hist:
                assert torch.equal(got.hist.cpu(), want.hist)
    codes_dev = torch.from_numpy(codes).cuda()
    got = tk.extract_kmers_codes(codes_dev, k, comp_xor=comp_xor)
    want = tk.extract_kmers_codes(torch.from_numpy(codes), k,
                                  comp_xor=comp_xor)
    for g, w in zip((*got.words, got.keep), (*want.words, want.keep)):
        assert torch.equal(g.cpu(), w)
