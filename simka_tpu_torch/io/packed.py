"""Packed dataset read sources: parse -> 2-bit pack in one native pass.

`PackedReadSource` runs the whole parse+filter+2-bit-pack pipeline in
the native parser (one C pass), so Python only moves [B, W/4]+[B, W/8]
arrays to the device, including the reference's SimkaInputIterator
per-group -max-reads quirks (SimkaCommons.hpp:226-290 upstream).

The source still satisfies the zero-arg provider protocol (calling it
yields raw filtered reads).
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from simka_tpu_torch.io.bank import (
    encode_batch,
    encode_batch_gatb,
    iter_dataset_reads,
)


def pack_codes_host(codes):
    """Host-side 2-bit packing of a [B, W] uint8 code batch (W % 8 == 0).

    Four 2-bit codes per byte, little-endian within the byte (code j
    at bits 2*(j % 4)); a validity bitmap with bit j % 8 of byte j // 8
    set for every base that is not INVALID_CODE (little bit order).
    The native parser writes the same layout.
    """
    valid = codes != 255
    c = np.where(valid, codes, 0).astype(np.uint8)
    packed = (
        c[:, 0::4]
        | (c[:, 1::4] << 2)
        | (c[:, 2::4] << 4)
        | (c[:, 3::4] << 6)
    )
    validbits = np.packbits(valid, axis=1, bitorder="little")
    return packed, validbits


def host_pack_chunk(chunk, k: int, encoding: str = "acgt"):
    """Python fallback of the native packed batch: encode + 2-bit pack
    one list of reads, in our base codes (``"acgt"``) or gatb-core's
    (``"gatb"``, SimkaMin's hash input)."""
    enc = encode_batch_gatb if encoding == "gatb" else encode_batch
    max_len = max((len(s) for s in chunk), default=k)
    width = -(-max(max_len, k) // 8) * 8
    codes, _ = enc(chunk, max_len=width)
    pad_b = -(-len(chunk) // 256) * 256 - len(chunk)
    if pad_b:
        codes = np.concatenate(
            [codes, np.full((pad_b, width), 255, np.uint8)]
        )
    return pack_codes_host(codes)


class PackedReadSource:
    """One dataset's reads as device-ready 2-bit packed batches.

    ``banks``: the dataset's ';'-group list (io.dsl.Dataset.banks);
    ``max_reads`` applies per group with the reference's
    SimkaInputIterator quirks (first passing read of each file is
    uncounted; the read whose increment reaches the cap is dropped).
    ``pin``: the native parser's batches page-locked, which a card
    copies straight; the owner of the job's device says whether it is a
    card, and None pins where torch sees one.
    """

    def __init__(
        self,
        banks,
        min_read_size: int = 0,
        min_read_shannon_index: float = 0.0,
        max_reads: int = 0,
        encoding: str = "acgt",
        pin: Optional[bool] = None,
    ):
        banks = list(banks)
        if banks and isinstance(banks[0], (str, bytes, os.PathLike)):
            banks = [banks]
        self.banks = banks
        self.min_read_size = min_read_size
        self.min_read_shannon_index = min_read_shannon_index
        self.max_reads = max_reads
        self.encoding = encoding
        self.pin = torch.cuda.is_available() if pin is None else pin

    def __call__(self) -> Iterator[bytes]:
        """Provider protocol: the filtered, capped raw-read stream."""
        return iter_dataset_reads(
            self.banks,
            self.min_read_size,
            self.min_read_shannon_index,
            max_reads=self.max_reads,
        )

    def iter_packed(
        self, batch_reads: int, k: int = 21
    ) -> Iterator[Tuple[np.ndarray, np.ndarray, int, "int | None"]]:
        """Yield (packed [B, W/4], validbits [B, W/8], n_reads,
        n_valid_windows) batches in pack_codes_host layout. Rows past
        n_reads are all-invalid; n_valid_windows is the exact count of
        valid k-mer windows (None when unknown: the Python fallback,
        or a cap-trimmed batch). Native when available."""
        native = None
        if os.environ.get("SIMKA_TPU_NO_NATIVE") != "1":
            try:
                from simka_tpu_torch.io import native as _native

                if _native.available():
                    native = _native
            except (OSError, RuntimeError):
                pass
        if native is None:
            yield from self._iter_packed_python(batch_reads, k)
            return
        # start narrow and let the reader grow to the true read
        # length rounded to 8: every width slot beyond the longest
        # read becomes a padded k-mer window
        width0 = max(64, -(-k // 8) * 8)
        cap = self.max_reads
        for group in self.banks:
            c = 0
            capped = False
            for path in group:
                first_of_file = True
                for packed, vb, n, n_valid in native.iter_packed_batches(
                    path,
                    batch_reads,
                    self.min_read_size,
                    self.min_read_shannon_index,
                    encoding=self.encoding,
                    width=width0,
                    kmer_size=k,
                    pin=self.pin,
                ):
                    if cap:
                        # SimkaInputIterator quirks: the first passing
                        # read of each file is "free", and the read
                        # whose increment reaches the cap is dropped
                        free = 1 if first_of_file else 0
                        countable = n - free
                        keep = free + min(
                            countable, max(cap - 1 - c, 0)
                        )
                        if countable >= cap - c:
                            capped = True
                        c += min(countable, cap - c)
                    else:
                        keep = n
                    first_of_file = False
                    if keep < n:
                        packed[keep:] = 0
                        vb[keep:] = 0
                        n_valid = None  # dropped rows' windows unknown
                    if keep > 0:
                        # trim to a 256-row class (the Python encoder's
                        # rounding): the native buffer is always
                        # batch_reads rows, but partial batches (file
                        # tails, cap trims) must not pay full-batch
                        # extraction
                        rows = min(len(packed), -(-keep // 256) * 256)
                        yield packed[:rows], vb[:rows], keep, n_valid
                    if capped:
                        break
                if capped:
                    break
            if capped:
                continue  # next group restarts its own counter

    def _iter_packed_python(self, batch_reads: int, k: int):
        from itertools import islice

        it = iter(self())
        while True:
            chunk = list(islice(it, batch_reads))
            if not chunk:
                return
            packed, vb = host_pack_chunk(chunk, k, self.encoding)
            yield packed, vb, len(chunk), None
