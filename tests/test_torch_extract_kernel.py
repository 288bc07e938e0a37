"""The extraction kernel's wrapper (``ops.kmers.extract_kmers``, plain
torch version on CPU tensors) against ``simka_tpu``'s fused extraction
program on the same numpy inputs; a numpy model of the kernel's
per-window work (csrc/kmers.cu) against the plain version; the kernel
against its plain version on the card (``cuda``-marked). Exact
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


# ---- (b) a numpy model of the kernel's per-window work ----------------


def _model_window(codes_row, p: int, k: int, comp_xor: int, terms):
    """csrc/kmers.cu's work for one window, in Python integers: a Horner
    a 62-bit word over its own offsets (no carry between words), once
    forward and once over the complement read backwards; the
    lexicographic min; the canonical base counts as the forward counts
    permuted by comp_xor; the f32 Shannon sum; the reference's uint32
    words by the kernel's one formula and the mix_hash fold."""
    nw = tk.n_words(k)
    top = k - tk.WORD_BASES * (nw - 1)
    bad = False
    fcnt = [0] * 4

    def base(pos):
        nonlocal bad
        c = int(codes_row[p + pos])
        if c >= 4:
            bad = True
        return c & 3

    f, r = [], []
    for w in range(nw):
        hi = top + tk.WORD_BASES * w
        lo = 0 if w == 0 else hi - tk.WORD_BASES
        v = 0
        for i in range(lo, hi):
            c = base(i)
            v = (v << 2) | c
            fcnt[c] += 1
        f.append(v)
    was_bad = bad
    for w in range(nw):
        hi = top + tk.WORD_BASES * w
        lo = 0 if w == 0 else hi - tk.WORD_BASES
        v = 0
        for j in range(lo, hi):
            v = (v << 2) | (base(k - 1 - j) ^ comp_xor)
        r.append(v)
    take_fwd = next((a < b for a, b in zip(f, r) if a != b), True)
    o = f if take_fwd else r
    x = 0 if take_fwd else comp_xor
    s = np.float32(terms[fcnt[0 ^ x]])
    for c in (1, 2, 3):
        s = np.float32(s + np.float32(terms[fcnt[c ^ x]]))
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
    return o, not was_bad, abs(s), h & 15


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("comp_xor", [3, 2])
def test_kernel_model_matches_plain(k, comp_xor):
    codes = _batch(500 + k, n=6, low=True)
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
            o, valid, s, bucket = _model_window(codes[b], p, k, comp_xor,
                                                terms)
            assert list(words[:, e]) == o
            assert bool(ex.keep[e]) == valid
            assert s == index[e]
            hist[bucket] += valid
    np.testing.assert_array_equal(ex.hist.numpy(), hist)


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
