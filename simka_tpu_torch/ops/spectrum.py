"""Per-sample k-mer spectrum: sort + run-length count on the device.

The torch counterpart of ``simka_tpu.ops.spectrum``'s ``count_spectrum``
and ``merge_spectra`` (the reference's per-sample DSK run, its
partition files): the count phase of the ``-out-tmp`` checkpoint path.
The JAX package's device-resident forms collapse into the same
functions here, since tensors stay on their device.

A spectrum is (words, counts): the ``n_words(k)`` int64 k-mer words of
``ops.kmers`` and an int32 count, one row per distinct k-mer,
k-mer-ascending. Lengths are exact (no SENTINEL rows); the distinct
rows are made contiguous by the stable compaction (``ops.compact``).
On the host (the checkpoint files, the repartition histogram) a
spectrum holds ``simka_tpu``'s uint32 words and int64 counts
(``to_host``, ``words_from_host``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from simka_tpu_torch.ops.countjoin import (
    INT32_MAX,
    _first_of_run,
    _lex_order,
    solid_rows,
)
from simka_tpu_torch.ops.kmers import from_uint32_words, uint32_words


Spectrum = Tuple[Tuple[torch.Tensor, ...], torch.Tensor]


def count_spectrum(words: Sequence[torch.Tensor], k: int) -> Spectrum:
    """Distinct k-mers and their counts in one sample's instances.

    ``words``: the ``n_words(k)`` [E] int64 words of real k-mers (any
    order). Returns (words tuple, counts [n] int32), k-mer-ascending:
    ``ops.countjoin.solid_rows`` with one bank and no abundance bound.
    """
    words = tuple(words)
    sid = torch.zeros(words[0].shape, dtype=torch.int32,
                      device=words[0].device)
    uw, _, counts = solid_rows(words, sid, 0, INT32_MAX, n_banks=1,
                               kmer_bits=2 * k)
    return uw, counts


def merge_spectra(spectra: Sequence[Spectrum]) -> Spectrum:
    """Fold spectra of ONE sample with overlapping k-mers (the partial
    spectra of its read batches) into one: sort the rows, then sum the
    counts of each k-mer as differences of an exclusive prefix sum
    taken at each k-mer's first row."""
    from simka_tpu_torch.ops.compact import compact_rows

    spectra = list(spectra)
    if len(spectra) == 1:
        return spectra[0]
    nw = len(spectra[0][0])
    words = tuple(torch.cat([s[0][i] for s in spectra]) for i in range(nw))
    counts = torch.cat([s[1] for s in spectra]).to(torch.int64)
    if nw == 1:
        w0, order = torch.sort(words[0])
        words = (w0,)
    else:
        order = _lex_order(words)
        words = tuple(w[order] for w in words)
    counts = counts[order]
    csum = torch.cumsum(counts, 0)
    before = csum - counts  # the count of all rows before each row
    del order, counts
    first = _first_of_run(*words)
    n = int(first.sum())
    if n == 0:
        return words, torch.zeros(0, dtype=torch.int32, device=csum.device)
    cols = compact_rows((*words, before), first, fills=(-1,) * nw + (0,), n=n)
    totals = torch.diff(cols[nw], append=csum[-1:])
    if int(totals.max()) > INT32_MAX:
        raise OverflowError("a merged k-mer count exceeds int32")
    return cols[:nw], totals.to(torch.int32)


def to_host(spectrum: Spectrum, k: int):
    """(``simka_tpu``'s uint32 words as numpy uint32 arrays, int64
    counts): the checkpoint's layout. The words cross as their int32
    bits, half the bytes of their int64 tensors."""
    words, counts = spectrum
    return (
        tuple(w.to(torch.int32).cpu().numpy().view(np.uint32)
              for w in uint32_words(words, k)),
        counts.cpu().numpy().astype(np.int64),
    )


def words_from_host(words32: Sequence[np.ndarray], k: int,
                    device: torch.device) -> Tuple[torch.Tensor, ...]:
    """``simka_tpu``'s uint32 words (numpy) as the port's int64 words on
    ``device``, shipped as their int32 bits."""
    return from_uint32_words(tuple(
        torch.from_numpy(np.ascontiguousarray(w).view(np.int32)).to(device)
        .to(torch.int64) & 0xFFFFFFFF
        for w in words32
    ), k)


HostRows = Tuple[Tuple[np.ndarray, ...], np.ndarray, np.ndarray]


def rows_from_host(rows: HostRows, k: int, device: torch.device):
    """Spectrum rows on the host (``simka_tpu``'s uint32 words, int32
    sample ids and counts) as (the port's words, sid, counts) on
    ``device``."""
    words32, sid, counts = rows
    return (words_from_host(list(words32), k, device),
            torch.from_numpy(sid).to(device),
            torch.from_numpy(counts).to(device))


def hash_spectrum(h: torch.Tensor):
    """Distinct 64-bit hashes of a stream and, for each, its count and
    its first and second occurrence positions (``simka_tpu``'s
    ``hash_spectrum``; SimkaMin's -filter cut on the streaming route).

    ``h``: [E] int64 holding uint64 hashes; any value is a hash. Returns
    (hashes ascending unsigned, counts, first, second), [n] int64 each.
    For a hash seen once ``second`` is the reference's value there, the
    next row's position (its own at the last row); callers read it only
    at count >= 2. One stable sort of the order key keeps each run's
    positions ascending.
    """
    sign = -(1 << 63)
    E = h.shape[0]
    key, pos = torch.sort(h ^ sign, stable=True)
    starts = _first_of_run(key).nonzero().squeeze(1)
    ends = torch.cat([starts[1:], starts.new_full((1,), E)])
    second = pos[torch.clamp(starts + 1, max=E - 1)] if E else pos
    return key[starts] ^ sign, ends - starts, pos[starts], second
