"""Sequence banks: FASTA/FASTQ(.gz) readers, filters, 2-bit batch encoding.

Replaces the gatb-core ``Bank``/``IBank`` layer the reference leans on
(inventoried in SURVEY.md §2.9) with a host-side reader that
produces dense, device-ready uint8 code batches. A native (C++) fast
path can plug in behind :func:`read_sequences` later; the interface is
"list of raw sequence byte strings" in, "padded [B, Lmax] code batch"
out.

Encoding: A/a=0, C/c=1, G/g=2, T/t=3, anything else (incl. N and pad)
= INVALID_CODE. The numeric encoding is deliberately *not* GATB's
((c>>1)&3): only canonical-class grouping matters for the distance
math, not k-mer integer values, so we pick the conventional ordering.
Complement is ``3 - code``.
"""

from __future__ import annotations

import gzip
import io
import os
from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np

INVALID_CODE = np.uint8(255)

# base -> 2-bit code lookup
_CODE_LUT = np.full(256, 255, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _CODE_LUT[_b] = _i
    _CODE_LUT[_b + 32] = _i  # lowercase

# base -> Shannon bin, mirroring the reference's nt2binTab
# (src/core/SimkaCommons.hpp:393-432): A=0, C=1, T=2, G=3, N=4, and
# every other byte falls in bin 0.
_SHANNON_LUT = np.zeros(256, dtype=np.uint8)
_SHANNON_LUT[ord("C")] = 1
_SHANNON_LUT[ord("T")] = 2
_SHANNON_LUT[ord("G")] = 3
_SHANNON_LUT[ord("N")] = 4


def _open_maybe_gz(path: str):
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rb")
    return open(path, "rb")


def _iter_fasta(f) -> Iterator[bytes]:
    seq_parts: List[bytes] = []
    for line in f:
        if line.startswith(b">"):
            if seq_parts:
                yield b"".join(seq_parts)
                seq_parts = []
        else:
            seq_parts.append(line.strip())
    if seq_parts:
        yield b"".join(seq_parts)


def _iter_fastq(f, path: str = "") -> Iterator[bytes]:
    """FASTQ records with the spec's multi-line form: sequence lines
    until the '+' separator, then quality lines until the quality
    length matches the sequence length (a quality line may START with
    '@' or '+', so structure -- not markers -- terminates a record).
    Malformed records raise instead of silently mis-parsing; CRLF is
    stripped everywhere. Mirrors the native
    parser (fastx.cpp FastxReader::next)."""
    rec = 0
    while True:
        header = f.readline()
        if not header:
            return
        header = header.strip()
        if not header:
            continue  # tolerate blank lines between records
        rec += 1
        if not header.startswith(b"@"):
            raise ValueError(
                f"{path}: malformed FASTQ record {rec}: header "
                f"{header[:30]!r} does not start with '@'"
            )
        seq_parts: List[bytes] = []
        line = f.readline()
        while line and not line.startswith(b"+"):
            seq_parts.append(line.strip())
            line = f.readline()
        if not line:
            raise ValueError(
                f"{path}: malformed FASTQ record {rec}: truncated "
                "(missing '+' line)"
            )
        seq = b"".join(seq_parts)
        qlen = 0
        while qlen < len(seq):
            line = f.readline()
            if not line:
                raise ValueError(
                    f"{path}: malformed FASTQ record {rec}: "
                    "truncated qualities"
                )
            qlen += len(line.strip())
        if qlen != len(seq):
            raise ValueError(
                f"{path}: malformed FASTQ record {rec}: quality "
                f"length {qlen} != sequence length {len(seq)}"
            )
        yield seq


def iter_sequences(path: str) -> Iterator[bytes]:
    """Yield raw sequence byte strings from a FASTA/FASTQ(.gz) file."""
    f = _open_maybe_gz(path)
    try:
        buffered = io.BufferedReader(f) if not isinstance(f, io.BufferedReader) else f
        first = buffered.peek(1)[:1]
        if first == b">":
            yield from _iter_fasta(buffered)
        elif first == b"@":
            yield from _iter_fastq(buffered, path)
        elif first == b"":
            return
        else:
            raise ValueError(f"{path}: unrecognized sequence format")
    finally:
        f.close()


def read_sequences(path: str) -> List[bytes]:
    return list(iter_sequences(path))


def shannon_index_read(seq: bytes) -> float:
    """Read-level Shannon index over the 5 bins A/C/T/G/N.

    Float32 stepping matches the reference
    (SimkaSequenceFilter::getShannonIndex,
    src/core/SimkaCommons.hpp:393-432): freqs and the accumulator are
    C ``float``.
    """
    if len(seq) == 0:
        return 0.0
    arr = np.frombuffer(seq, dtype=np.uint8)
    bins = _SHANNON_LUT[arr]
    freqs = np.bincount(bins, minlength=5)[:5].astype(np.float32)
    freqs /= np.float32(len(seq))
    index = np.float32(0.0)
    for fr in freqs:
        if fr != 0:
            index = np.float32(index + fr * np.log(fr) / np.log(2))
    return float(abs(index))


def sequence_passes(
    seq: bytes, min_read_size: int, min_read_shannon_index: float
) -> bool:
    """Reference read filter (SimkaSequenceFilter, SimkaCommons.hpp:317-436)."""
    if min_read_size != 0 and len(seq) < min_read_size:
        return False
    if (
        min_read_shannon_index != 0.0
        and shannon_index_read(seq) < min_read_shannon_index
    ):
        return False
    return True


def iter_filtered_reads(
    path: str, min_read_size: int, min_read_shannon_index: float
) -> Iterator[bytes]:
    """Filtered read stream for one file: the native (C++) parser when
    available (the role of gatb-core's Bank, SURVEY.md §2.9 /
    src/SimkaCount.cpp:188), the pure-Python reader otherwise.
    SIMKA_TPU_NO_NATIVE=1 forces the Python path."""
    if os.environ.get("SIMKA_TPU_NO_NATIVE") != "1":
        try:
            from simka_tpu_torch.io import native

            if native.available():
                yield from native.iter_raw_reads(
                    path, min_read_size, min_read_shannon_index
                )
                return
        except (OSError, RuntimeError):
            pass  # fall back to the Python reader
    for seq in iter_sequences(path):
        if sequence_passes(seq, min_read_size, min_read_shannon_index):
            yield seq


def iter_dataset_reads(
    banks: Iterable,
    min_read_size: int = 0,
    min_read_shannon_index: float = 0.0,
    max_reads: int = 0,
) -> Iterator[bytes]:
    """Stream one dataset's reads, group by group, filtered and capped.

    The streaming analog of gatb's IBank pull iteration
    (src/core/SimkaCommons.hpp:159-314): reads flow
    through the consumer one at a time, so host memory stays O(1)
    regardless of dataset size.

    ``banks`` is the dataset's list of ';'-paired groups, each a list
    of ','-concatenated files (io.dsl.Dataset.banks); a flat list of
    paths is accepted as one single group.

    ``max_reads`` applies PER GROUP, not per dataset: both workers
    construct SimkaInputIterator with nbDatasets = the dataset's
    ';'-group count (SimkaCount.cpp:267 + SimkaPotara.hpp:853;
    SimkaMinCount.hpp:1140 + 979), which makes each group a "virtual
    dataset" with its own read counter. The cap counts *filtered*
    reads. 0 = no cap.
    """
    banks = list(banks)
    if banks and isinstance(banks[0], (str, bytes, os.PathLike)):
        banks = [banks]
    for group in banks:
        # SimkaInputIterator counting quirks (SimkaCommons.hpp:226-290):
        # the first passing read of each file arrives via first() and is
        # NOT counted ("free"), and the read whose increment reaches the
        # cap is loaded but never consumed (nextDataset overwrites it).
        c = 0
        capped = False
        for path in group:
            first_in_file = True
            for seq in iter_filtered_reads(
                path, min_read_size, min_read_shannon_index
            ):
                if first_in_file:
                    first_in_file = False
                    yield seq
                    continue
                c += 1
                if max_reads and c >= max_reads:
                    capped = True
                    break
                yield seq
            if capped:
                break


def read_dataset(
    banks: Iterable,
    min_read_size: int = 0,
    min_read_shannon_index: float = 0.0,
    max_reads: int = 0,
) -> List[bytes]:
    """All reads of one dataset in host RAM (see iter_dataset_reads;
    prefer the iterator on large inputs)."""
    return list(
        iter_dataset_reads(
            banks, min_read_size, min_read_shannon_index, max_reads
        )
    )


def count_dataset_reads(
    banks: Iterable,
    min_read_size: int = 0,
    min_read_shannon_index: float = 0.0,
) -> int:
    """Number of filtered reads in a dataset WITHOUT materializing
    them (native C++ counting when available).

    Used by the auto -max-reads mode: the reference sizes the cap from
    O(1) bank estimates (SimkaAlgorithm.cpp:428-433); we pay one
    streaming pass but no Python object per read.
    """
    banks = list(banks)
    if banks and isinstance(banks[0], (str, bytes, os.PathLike)):
        banks = [banks]
    total = 0
    for group in banks:
        for path in group:
            if os.environ.get("SIMKA_TPU_NO_NATIVE") != "1":
                try:
                    from simka_tpu_torch.io import native

                    if native.available():
                        total += native.count_reads(
                            path, min_read_size, min_read_shannon_index
                        )
                        continue
                except (OSError, RuntimeError):
                    pass
            total += sum(
                1
                for _ in iter_filtered_reads(
                    path, min_read_size, min_read_shannon_index
                )
            )
    return total


def _estimate_file_reads(
    path: str,
    min_read_size: int,
    min_read_shannon_index: float,
    sample_bytes: int = 1 << 22,
) -> int:
    """O(sample) filtered-read-count estimate for one file.

    Parses the first ``sample_bytes`` (decompressed), counts complete
    records and their filter pass rate, and scales by the file's
    (estimated-decompressed) size. EXACT when the file fits the
    sample. The role of gatb Bank::estimate
    (src/core/SimkaAlgorithm.cpp:428-433).
    """
    records, complete, data_bytes, est_total_bytes = _head_records(
        path, sample_bytes)
    n_pass = sum(
        1
        for r in records
        if sequence_passes(r, min_read_size, min_read_shannon_index)
    )
    if complete:
        return n_pass
    if not records:
        return 0
    return int(n_pass * est_total_bytes / data_bytes)


def windows_per_byte(path: str, k: int, sample_bytes: int = 1 << 17) -> float:
    """k-mer windows per (decompressed) byte of a FASTA/FASTQ file:
    sum(max(L - k + 1, 0)) over the complete records of its first
    ``sample_bytes``, over those bytes (headers, newlines and qualities
    included). 0.0 for an empty file."""
    records, _, data_bytes, _ = _head_records(path, sample_bytes)
    windows = sum(max(len(r) - k + 1, 0) for r in records)
    return windows / data_bytes if data_bytes else 0.0


def _head_records(path: str, sample_bytes: int):
    """(the complete records of the first ``sample_bytes``
    (decompressed), whether that is the whole file, the bytes parsed,
    the file's estimated decompressed size)."""
    import zlib

    size = os.path.getsize(path)
    with open(path, "rb") as fh:
        magic = fh.read(2)
        fh.seek(0)
        if magic == b"\x1f\x8b":
            # decompress the sample ourselves so the COMPRESSED bytes
            # consumed are known exactly (GzipFile's readahead makes
            # its fileobj position useless as a ratio)
            d = zlib.decompressobj(wbits=31)
            out = bytearray()
            pending = b""
            consumed = 0
            at_eof = False
            while len(out) <= sample_bytes:
                if not pending:
                    pending = fh.read(1 << 16)
                    if not pending:
                        at_eof = True
                        break
                before = len(pending)
                out += d.decompress(
                    pending, sample_bytes + 1 - len(out)
                )
                consumed += before - len(d.unconsumed_tail)
                pending = d.unconsumed_tail
                if d.eof:
                    at_eof = fh.read(1) == b""
                    break
            data = bytes(out[:sample_bytes])
            complete = at_eof and len(out) <= sample_bytes
            est_total_bytes = (
                len(out) * (size / max(consumed, 1))
                if consumed
                else float(size) * 4.0
            )
        else:
            data = fh.read(sample_bytes)
            complete = fh.read(1) == b""
            est_total_bytes = float(size)
    if not data:
        return [], complete, 0, est_total_bytes
    buf = io.BufferedReader(io.BytesIO(data))
    first = data[:1]
    if first == b">":
        parse = _iter_fasta(buf)
    elif first == b"@":
        parse = _iter_fastq(buf, path)
    else:
        raise ValueError(f"{path}: unrecognized sequence format")
    records = []
    try:
        for r in parse:
            records.append(r)
    except ValueError:
        if complete:
            raise
        # a FASTQ record cut by the sample raises; the records before
        # it are whole
        return records, complete, len(data), est_total_bytes
    if not complete and records:
        records = records[:-1]  # the tail record may be truncated
    return records, complete, len(data), est_total_bytes


def estimate_dataset_reads(
    banks: Iterable,
    min_read_size: int = 0,
    min_read_shannon_index: float = 0.0,
) -> int:
    """Sampled filtered-read estimate for one dataset (O(sample) per
    file instead of a full parsing pass; exact on files under the
    sample size). Feeds auto -max-reads like the reference's bank
    estimates -- the resulting cap is an estimate THERE too
    (SimkaPotara.hpp:617-657)."""
    banks = list(banks)
    if banks and isinstance(banks[0], (str, bytes, os.PathLike)):
        banks = [banks]
    total = 0
    for group in banks:
        for path in group:
            total += _estimate_file_reads(
                path, min_read_size, min_read_shannon_index
            )
    return total


def encode_batch(
    seqs: List[bytes], max_len: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Encode sequences into a dense [B, Lmax] uint8 code batch.

    Padding (and any non-ACGT base) is INVALID_CODE, so a single
    prefix-sum validity check in the k-mer kernel covers both read ends
    and ambiguous bases.

    Returns (codes [B, Lmax] uint8, lengths [B] int32).
    """
    if not seqs:
        width = max_len or 1
        return (
            np.full((0, width), INVALID_CODE, dtype=np.uint8),
            np.zeros((0,), dtype=np.int32),
        )
    lengths = np.array([len(s) for s in seqs], dtype=np.int32)
    width = int(max_len if max_len is not None else lengths.max())
    codes = np.full((len(seqs), width), INVALID_CODE, dtype=np.uint8)
    # one vectorized pass over the concatenated bytes (a per-read
    # Python loop here dominated end-to-end ingest wall-clock)
    flat = _CODE_LUT[
        np.frombuffer(b"".join(seqs), dtype=np.uint8)
    ]
    lmax = int(lengths.max(initial=0))
    lmin = int(lengths.min(initial=0))
    if lmin == lmax and lmax <= width:
        # equal-length reads (the Illumina common case): pure reshape
        codes[:, :lmax] = flat.reshape(len(seqs), lmax)
        return codes, lengths
    clipped = np.minimum(lengths, width)
    if lmax > width:
        # rare: reads longer than the batch width are truncated; keep
        # only each read's first `width` codes
        keep = np.arange(lmax)[None, :] < clipped[:, None]
        starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
        sel = starts[:, None] + np.arange(lmax)[None, :]
        flat = flat[np.minimum(sel, len(flat) - 1)][keep]
    codes[np.arange(width)[None, :] < clipped[:, None]] = flat
    return codes, lengths


def count_file_reads(path: str) -> int:
    return sum(1 for _ in iter_sequences(path))


# gatb-core's base codes (SimkaMin's hash input): A=0, C=1, T=2, G=3,
# our A=0, C=1, G=2, T=3 remapped
_GATB_REMAP = np.array([0, 1, 3, 2], dtype=np.uint8)


def encode_batch_gatb(
    seqs: List[bytes], max_len: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """``encode_batch`` in gatb-core's base codes (``simka_tpu``'s
    ``minhash.sketch.encode_batch_gatb``); invalid stays INVALID_CODE."""
    codes, lengths = encode_batch(seqs, max_len=max_len)
    valid = codes < 4
    codes[valid] = _GATB_REMAP[codes[valid]]
    return codes, lengths
