"""Canonical k-mer extraction on torch tensors (k up to 127).

A k-mer is held as a big-endian tuple of int64 WORDS of at most 31
bases (62 bits) each: one word for k <= 31, two for k <= 62, five at
k = 127 (``n_words``). The least significant word holds the last 31
bases, the most significant one the first ``k - 31 * (n_words - 1)``.
Every word is a fixed 62-bit field, so the lexicographic order of the
tuples is the numeric order of the 2k-bit values. There are no
unsigned types: torch's uint32/uint64 lack shifts and comparisons on
the CPU build.

``simka_tpu`` holds the same value as big-endian uint32 words. That
layout appears only where the reference's own values are needed: the
public functions ``extract_packed``, ``extract_canonical_kmers``,
``extract_canonical_kmers_multi`` and ``mix_hash`` (which the
repartition histogram runs over those words), as int64 tensors holding
uint32 values, so tests compare like with like (``uint32_words``), and
the count checkpoints, whose files hold that layout so either package
loads the other's (``uint32_words`` on save, ``from_uint32_words`` on
load).

Base codes: A=0, C=1, G=2, T=3, invalid = 255; complement is
``code ^ 3``. SimkaMin hashes k-mers in gatb-core's codes (A=0, C=1,
T=2, G=3), whose complement is ``code ^ 2``: the extraction takes the
mask as ``comp_xor``. The canonical k-mer is min(forward, reverse
complement); when the two are equal the forward word is kept (the same
k-mer either way).

The paths call ``extract_kmers`` (a packed batch) or
``extract_kmers_codes`` (an unpacked one): words, keep mask (with the
Shannon filter), repartition histogram and kept count in one call. On
CUDA tensors that is one launch of the hand-written kernel of
``csrc/kmers.cu``; on CPU tensors its plain version,
``_extract_kmers_plain``, built from the torch functions below.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

SENTINEL = 0xFFFFFFFF  # every uint32 word of an invalid window
_M32 = 0xFFFFFFFF
WORD_BASES = 31  # bases in one int64 word (62 bits)
MAX_K = 127  # the reference's largest k (gatb-core's k-mer spans)

Words = Tuple[torch.Tensor, ...]


def n_words(k: int) -> int:
    """int64 words of the port's k-mer layout."""
    return -(-k // WORD_BASES)


def n_uint32_words(k: int) -> int:
    """uint32 words of ``simka_tpu``'s layout: ``n_words_for_k`` plus
    the extra leading word it keeps when 2k is a multiple of 32 (so a
    real k-mer's first word is never the all-ones SENTINEL); 2 for
    k <= 31, whose (hi, lo) pair is never widened."""
    if k <= 31:
        return 2
    nw = -(-2 * k // 32)
    return nw + 1 if 2 * k == 32 * nw else nw


def unpack_codes(packed: torch.Tensor, validbits: torch.Tensor) -> torch.Tensor:
    """[B, W/4] packed codes + [B, W/8] validity bits -> [B, W] uint8
    codes with 255 at invalid bases (``io.packed.pack_codes_host``
    layout: 2-bit codes little-endian within each byte, validity bits
    in little bit order)."""
    B, Wq = packed.shape
    dev = packed.device
    p = packed.to(torch.int32)
    sh2 = torch.arange(0, 8, 2, device=dev, dtype=torch.int32)
    codes = ((p.unsqueeze(-1) >> sh2) & 3).reshape(B, Wq * 4)
    sh1 = torch.arange(8, device=dev, dtype=torch.int32)
    bits = ((validbits.to(torch.int32).unsqueeze(-1) >> sh1) & 1).reshape(
        B, -1
    )
    return torch.where(bits == 1, codes, 255).to(torch.uint8)


def _word_spans(k: int):
    """[lo, hi) window offsets of each word, most significant first."""
    nw = n_words(k)
    spans = []
    for w in range(nw):
        hi = k - WORD_BASES * (nw - 1 - w)
        spans.append((max(0, hi - WORD_BASES), hi))
    return spans


def canonical_kmers(codes: torch.Tensor, k: int, comp_xor: int = 3):
    """Canonical k-mers of every window of a [B, L] code batch, the
    complement of a base code being ``code ^ comp_xor``.

    Returns (words, valid): ``n_words(k)`` [B, W] int64 words, most
    significant first, and the [B, W] bool validity, W = L - k + 1. A
    window touching any invalid base is invalid; its words are
    unspecified.
    """
    if not 1 <= k <= MAX_K:
        raise NotImplementedError(
            f"k={k}: the port handles 1 <= k <= {MAX_K}, as the reference"
        )
    B, L = codes.shape
    if L < k:
        raise ValueError(f"read window {L} shorter than k={k}")
    W = L - k + 1
    c = codes.to(torch.int64)
    invalid = c >= 4
    c = c & 3
    # Horner per word over its own window offsets: forward value
    # sum_i base[i] * 4^(k-1-i); the reverse complement reads
    # comp(base[k-1-j]) at its offset j
    fwd, rc = [], []
    for lo, hi in _word_spans(k):
        f = torch.zeros((B, W), dtype=torch.int64, device=codes.device)
        r = torch.zeros_like(f)
        for i in range(lo, hi):
            f = (f << 2) | c[:, i : i + W]
            r = (r << 2) | (c[:, k - 1 - i : k - 1 - i + W] ^ comp_xor)
        fwd.append(f)
        rc.append(r)
    if len(fwd) == 1:
        words = (torch.minimum(fwd[0], rc[0]),)
    else:
        # lexicographic min(forward, revcomp); equal -> forward
        take_fwd = torch.zeros((B, W), dtype=torch.bool, device=codes.device)
        undecided = torch.ones_like(take_fwd)
        for f, r in zip(fwd, rc):
            take_fwd |= undecided & (f < r)
            undecided &= f == r
        take_fwd |= undecided
        words = tuple(torch.where(take_fwd, f, r) for f, r in zip(fwd, rc))
    cum = torch.nn.functional.pad(
        torch.cumsum(invalid.to(torch.int32), dim=1), (1, 0)
    )
    valid = (cum[:, k:] - cum[:, :W]) == 0
    return words, valid


def uint32_words(words: Words, k: int, valid=None) -> Words:
    """The port's words as ``simka_tpu``'s big-endian uint32 words
    (``n_uint32_words(k)`` int64 tensors of uint32 values), with
    SENTINEL in every word where ``valid`` is False."""
    nw = len(words)
    out = []
    for i in range(n_uint32_words(k)):  # i: uint32 word from the bottom
        s = 32 * i
        j, o = divmod(s, 2 * WORD_BASES)  # port word from the bottom
        if j >= nw:
            v = torch.zeros_like(words[0])
        else:
            v = words[nw - 1 - j]
            if o:
                v = v >> o
            avail = 2 * WORD_BASES - o  # bits of v, all below 2^avail
            if avail > 32:
                v = v & _M32
            elif avail < 32 and j + 1 < nw:
                nxt = words[nw - 2 - j] & ((1 << (32 - avail)) - 1)
                v = v | (nxt << avail)
        out.append(v if valid is None else torch.where(valid, v, SENTINEL))
    return tuple(reversed(out))


def from_uint32_words(words32: Words, k: int) -> Words:
    """``uint32_words`` undone: ``simka_tpu``'s big-endian uint32 words
    of real k-mers (int64 tensors of uint32 values, any count of them
    that holds the 2k bits) as the port's ``n_words(k)`` int64 words."""
    low = tuple(reversed(words32))  # uint32 words from the bottom
    out = []
    for j in range(n_words(k)):  # port word from the bottom
        s = 2 * WORD_BASES * j
        width = min(2 * WORD_BASES, 2 * k - s)
        v = torch.zeros_like(low[0])
        for i, w in enumerate(low):
            b = 32 * i
            if b + 32 <= s or b >= s + width:
                continue
            if b < s:
                v = v | (w >> (s - b))
            else:
                v = v | ((w & ((1 << min(32, s + width - b)) - 1)) << (b - s))
        out.append(v & ((1 << width) - 1))
    return tuple(reversed(out))


def extract_canonical_kmers(codes: torch.Tensor, k: int, comp_xor: int = 3):
    """Canonical k-mers of a [B, L] uint8 code batch as (hi, lo, valid)
    (``simka_tpu``'s ``extract_canonical_kmers``, k <= 31): [B, W]
    int64 tensors of uint32 values, SENTINEL in both at invalid
    windows, and the [B, W] bool validity."""
    if k > 31:
        raise ValueError(f"k={k}: (hi, lo) holds k <= 31")
    words, valid = canonical_kmers(codes, k, comp_xor)
    hi, lo = uint32_words(words, k, valid)
    return hi, lo, valid


def extract_canonical_kmers_multi(codes: torch.Tensor, k: int):
    """(uint32 words, valid) of a [B, L] code batch in
    ``simka_tpu``'s ``extract_canonical_kmers_multi`` layout (k > 31)."""
    words, valid = canonical_kmers(codes, k)
    return uint32_words(words, k, valid), valid


def extract_packed(
    packed: torch.Tensor, validbits: torch.Tensor, k: int,
    comp_xor: int = 3, multi: bool = False,
) -> Words:
    """Unpack a packed batch and extract canonical k-mers.

    Returns ``simka_tpu``'s ``extract_packed`` words: (hi, lo) for
    k <= 31, or the multi-word tuple with ``multi``; [B, W*4 - k + 1]
    int64 tensors of uint32 values, SENTINEL at invalid windows.
    """
    codes = unpack_codes(packed, validbits)
    if multi:
        return extract_canonical_kmers_multi(codes, k)[0]
    hi, lo, _ = extract_canonical_kmers(codes, k, comp_xor)
    return hi, lo


# extraction-kernel launches on the CUDA path (the CPU path does not count)
launches = 0
N_HIST_BUCKETS = 16


class Extracted(NamedTuple):
    """``extract_kmers``' outputs, on the batch's device."""

    words: Words  # n_words(k) [E] int64 canonical words, E = B * (L - k + 1)
    keep: torch.Tensor  # [E] bool: valid (and Shannon index >= threshold)
    hist: Optional[torch.Tensor]  # [16] int64 kept windows a bucket, or None
    n_kept: torch.Tensor  # 0-dim int64: kept windows


def _extract_kmers_plain(codes: torch.Tensor, k: int, comp_xor: int,
                         min_shannon: float, with_hist: bool) -> Extracted:
    """The plain torch version of the extraction kernel, from a [B, L]
    code batch (255 = invalid): ``canonical_kmers``, the Shannon mask,
    the histogram over ``uint32_words`` + ``mix_hash_words``."""
    words, valid = canonical_kmers(codes, k, comp_xor)
    words = tuple(w.reshape(-1) for w in words)
    keep = valid.reshape(-1)
    if min_shannon > 0.0:
        # compared in f32, as the reference compares its f32 index with
        # the threshold
        thr = torch.tensor(min_shannon, dtype=torch.float32)
        keep = keep & (kmer_shannon_index_words(words, k)
                       >= thr.to(keep.device))
    hist = None
    if with_hist:
        h = mix_hash_words(uint32_words(words, k))
        hist = torch.bincount((h & (N_HIST_BUCKETS - 1))[keep],
                              minlength=N_HIST_BUCKETS)
    return Extracted(words, keep, hist, keep.sum())


def _extract_kmers_cuda(packed, validbits, codes, k: int, comp_xor: int,
                        min_shannon: float, with_hist: bool) -> Extracted:
    global launches
    from simka_tpu_torch.ops import _kernels

    lib = _kernels.lib()
    src = codes if packed is None else packed
    dev = src.device
    B = src.shape[0]
    L = codes.shape[1] if packed is None else 4 * packed.shape[1]
    E = B * (L - k + 1)
    words = torch.empty((n_words(k), E), dtype=torch.int64, device=dev)
    keep = torch.empty(E, dtype=torch.bool, device=dev)
    counts = torch.empty(N_HIST_BUCKETS + 1, dtype=torch.int64, device=dev)
    use_thr = min_shannon > 0.0
    terms = shannon_terms(k).to(dev) if use_thr else None
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        code = lib.simka_extract_kmers(
            ptr(packed), ptr(validbits), ptr(codes), B, L, k, comp_xor,
            int(use_thr), min_shannon, ptr(terms), int(with_hist),
            n_uint32_words(k), words.data_ptr(), keep.data_ptr(),
            counts.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check(code, "extract_kmers")
    launches += 1
    return Extracted(tuple(words), keep,
                     counts[:N_HIST_BUCKETS] if with_hist else None,
                     counts[N_HIST_BUCKETS])


def _extract(packed, validbits, codes, k: int, comp_xor: int,
             min_shannon: float, with_hist: bool) -> Extracted:
    if not 1 <= k <= MAX_K:
        raise NotImplementedError(
            f"k={k}: the port handles 1 <= k <= {MAX_K}, as the reference"
        )
    src = codes if packed is None else packed
    L = codes.shape[1] if packed is None else 4 * packed.shape[1]
    if L < k:
        raise ValueError(f"read window {L} shorter than k={k}")
    if src.device.type == "cpu":
        if codes is None:
            codes = unpack_codes(packed, validbits)
        return _extract_kmers_plain(codes, k, comp_xor, min_shannon,
                                    with_hist)
    if src.device.type != "cuda":
        raise ValueError(f"extract_kmers: unsupported device {src.device}")
    if not all(t.is_contiguous() for t in (packed, validbits, codes)
               if t is not None):
        raise ValueError("extract_kmers needs contiguous tensors on CUDA")
    return _extract_kmers_cuda(packed, validbits, codes, k, comp_xor,
                               min_shannon, with_hist)


def extract_kmers(packed: torch.Tensor, validbits: torch.Tensor, k: int, *,
                  comp_xor: int = 3, min_shannon: float = 0.0,
                  with_hist: bool = False) -> Extracted:
    """Canonical k-mers of every window of one packed batch, in one pass
    (``simka_tpu``'s ``_extract_windows_program`` before its compaction).

    Args:
      packed, validbits: [B, L/4] 2-bit codes and [B, L/8] validity bits,
        uint8 (``io.packed.pack_codes_host`` layout).
      k: 1..127, at most L.
      comp_xor: the complement of code c is ``c ^ comp_xor`` (3 for
        simka's codes, 2 for gatb-core's).
      min_shannon: keep only windows whose k-mer Shannon index (f32) is
        at least this; 0 keeps every valid window.
      with_hist: also count the kept windows a repartition bucket
        (``mix_hash_words`` of the reference's uint32 words, & 15).

    Returns ``Extracted``: the words of window b * (L - k + 1) + p (the
    words of a dropped window are those of its bases, an invalid base
    read as code 3), the keep mask, the histogram and the kept count,
    on the batch's device. On CUDA tensors this launches the kernel of
    ``csrc/kmers.cu`` once or raises; on CPU tensors it is the plain
    version, bit for bit the same.
    """
    if packed.dtype != torch.uint8 or validbits.dtype != torch.uint8 or (
            packed.dim() != 2 or validbits.shape != (
                packed.shape[0], packed.shape[1] // 2)
            or packed.shape[1] % 2 or validbits.device != packed.device):
        raise ValueError("extract_kmers: packed [B, L/4] and validbits "
                         "[B, L/8] uint8 on one device")
    return _extract(packed, validbits, None, k, comp_xor, min_shannon,
                    with_hist)


def extract_kmers_codes(codes: torch.Tensor, k: int, *, comp_xor: int = 3,
                        min_shannon: float = 0.0,
                        with_hist: bool = False) -> Extracted:
    """``extract_kmers`` of an unpacked [B, L] uint8 code batch (255, or
    any code >= 4, invalid)."""
    if codes.dtype != torch.uint8 or codes.dim() != 2:
        raise ValueError("extract_kmers_codes: codes [B, L] uint8")
    return _extract(None, None, codes, k, comp_xor, min_shannon, with_hist)


def shannon_terms(k: int) -> torch.Tensor:
    """[k + 1] f32 table: the Shannon term ``f * (log(f) / log 2)`` of a
    base seen c times in a k-mer, f = c / k, each step in f32 as the
    reference computes it, 0 at c = 0. Made on the host, so every device
    gets the same bits; log(f) is the correctly rounded f32 log (the f32
    logs of XLA and CUDA are each off by an ulp at some frequencies)."""
    f = torch.arange(k + 1, dtype=torch.float32) / torch.tensor(
        float(k), dtype=torch.float32)
    log_f = torch.tensor([math.log(v) if v > 0 else 0.0 for v in f.tolist()],
                         dtype=torch.float64).to(torch.float32)
    log2 = torch.tensor(math.log(2.0), dtype=torch.float32)
    return f * (log_f / log2)


def kmer_shannon_index_words(words: Words, k: int) -> torch.Tensor:
    """Shannon index of each k-mer over its 4 base frequencies, f32
    (``simka_tpu``'s ``kmer_shannon_index_words``:
    ``|sum f * log(f) / log 2|`` summed in base order), from the port's
    int64 words through the ``shannon_terms`` table. It equals the
    reference's wherever XLA's f32 log is correctly rounded, and is
    within 2 ulp elsewhere; indices made of frequencies 0, 1/4, 1/2 and
    1 (0, 1.0, 1.5, 2.0) are exact in both.

    Base i (0 = the last base) sits at bits [2i, 2i + 2) of the 2k-bit
    value; a base never straddles two 62-bit words.
    """
    nw = len(words)
    counts = [torch.zeros(words[0].shape, dtype=torch.int64,
                          device=words[0].device) for _ in range(4)]
    for i in range(k):
        j, o = divmod(i, WORD_BASES)
        code = (words[nw - 1 - j] >> (2 * o)) & 3
        for base in range(4):
            counts[base] += code == base
    terms = shannon_terms(k).to(words[0].device)
    total = terms[counts[0]]
    for cnt in counts[1:]:
        total = total + terms[cnt]
    return torch.abs(total)


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a * b) mod 2^32 for 0 <= a, b < 2^32 without int64 overflow."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def mix_hash(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Cheap 32-bit mix of a (hi, lo) k-mer (``simka_tpu``'s
    ``mix_hash``) on int64 tensors of uint32 values; returns int64 in
    [0, 2^32)."""
    h = _mul32(hi ^ 0x9E3779B9, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h ^ lo, 0xC2B2AE35)
    return h ^ (h >> 16)


def mix_hash_words(words32: Words) -> torch.Tensor:
    """``mix_hash`` folded over uint32 words, most significant first:
    ``h = w0; h = mix_hash(h, w)`` for each further word (the
    reference's repartition hash for any word count)."""
    h = words32[0]
    for w in words32[1:]:
        h = mix_hash(h, w)
    return h


def mix_hash_np(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """Host copy of ``mix_hash`` on numpy uint32 arrays (uint32
    wraparound)."""
    with np.errstate(over="ignore"):
        h = (hi ^ np.uint32(0x9E3779B9)) * np.uint32(0x85EBCA6B)
        h = h ^ (h >> np.uint32(13))
        h = (h ^ lo) * np.uint32(0xC2B2AE35)
        h = h ^ (h >> np.uint32(16))
    return h
