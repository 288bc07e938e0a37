"""Canonical k-mer extraction on torch tensors (k <= 31).

A k-mer of k <= 31 bases is 2k <= 62 bits, so it is held as ONE
int64 (no unsigned types: torch's uint32/uint64 lack shifts and
comparisons on the CPU build). The (hi, lo) uint32 pair of
``simka_tpu`` appears only at the public functions ``extract_packed``
and ``mix_hash``, as int64 tensors holding uint32 values, so tests
compare like with like.

Base codes: A=0, C=1, G=2, T=3, invalid = 255; complement is
``code ^ 3``. The canonical k-mer is min(forward, reverse complement);
when the two are equal the forward word is kept (the same k-mer
either way).
"""

from __future__ import annotations

from typing import Tuple

import torch

SENTINEL = 0xFFFFFFFF  # (hi, lo) of an invalid window
_M32 = 0xFFFFFFFF


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


def canonical_kmers(codes: torch.Tensor, k: int):
    """Canonical k-mers of every window of a [B, L] code batch.

    Returns (kmer [B, W] int64, valid [B, W] bool), W = L - k + 1. A
    window touching any invalid base is invalid; its kmer value is
    unspecified.
    """
    if not 1 <= k <= 31:
        raise NotImplementedError(
            f"k={k}: the port handles k <= 31 (k > 31 is ROADMAP "
            "queue 1, item 7)"
        )
    B, L = codes.shape
    if L < k:
        raise ValueError(f"read window {L} shorter than k={k}")
    W = L - k + 1
    c = codes.to(torch.int64)
    invalid = c >= 4
    c = c & 3
    fwd = torch.zeros((B, W), dtype=torch.int64, device=codes.device)
    rc = torch.zeros_like(fwd)
    # Horner over the k window offsets: forward value
    # sum_i base[i] * 4^(k-1-i), revcomp sum_i comp(base[i]) * 4^i
    for i in range(k):
        fwd = (fwd << 2) | c[:, i : i + W]
        rc = (rc << 2) | (c[:, k - 1 - i : k - 1 - i + W] ^ 3)
    kmer = torch.minimum(fwd, rc)
    cum = torch.nn.functional.pad(
        torch.cumsum(invalid.to(torch.int32), dim=1), (1, 0)
    )
    valid = (cum[:, k:] - cum[:, :W]) == 0
    return kmer, valid


def extract_canonical_kmers(codes: torch.Tensor, k: int):
    """Canonical k-mers of a [B, L] uint8 code batch as (hi, lo, valid)
    (``simka_tpu``'s ``extract_canonical_kmers`` for k <= 31): [B, W]
    int64 tensors of uint32 values, SENTINEL in both at invalid
    windows, and the [B, W] bool validity."""
    kmer, valid = canonical_kmers(codes, k)
    hi = torch.where(valid, kmer >> 32, SENTINEL)
    lo = torch.where(valid, kmer & _M32, SENTINEL)
    return hi, lo, valid


def extract_packed(
    packed: torch.Tensor, validbits: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unpack a packed batch and extract canonical k-mers.

    Returns (hi, lo): [B, W*4 - k + 1] int64 tensors of uint32 values,
    SENTINEL in both at invalid windows (``simka_tpu``'s
    ``extract_packed`` for k <= 31).
    """
    hi, lo, _ = extract_canonical_kmers(unpack_codes(packed, validbits), k)
    return hi, lo


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
