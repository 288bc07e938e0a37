"""ctypes bindings for the native FASTA/FASTQ parser.

This loader compiles the port's own copy of the JAX package's parser,
``fastx.cpp`` beside this file, with g++ at first use
(``tests/test_torch_host.py`` holds the copy to the original byte for
byte, so the two cannot drift). The library goes into the port's
git-ignored build directory (``simka_tpu_torch/_build``), never next
to the source. Callers fall back to the pure-Python reader in
``simka_tpu_torch.io.bank`` when the toolchain or zlib is unavailable;
``chip_smoke.py`` refuses that fallback on the card's machine, since
the parser sets the main path's pace.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(os.path.dirname(_HERE))
SRC = os.path.join(_HERE, "fastx.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
_LIB = os.path.join(BUILD_DIR, "libfastx.so")

_lib = None
_tried = False


def _build() -> Optional[str]:
    if os.path.exists(_LIB) and os.path.getmtime(_LIB) >= os.path.getmtime(
        SRC
    ):
        return _LIB
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build under a private name, then rename: concurrent test workers
    # may build at once, and a reader must never load a partial file
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", SRC,
           "-o", tmp, "-lz"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB)
        return _LIB
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.unlink(tmp)
        return None


def get_lib():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = _build()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.fastx_open.restype = ctypes.c_void_p
    lib.fastx_open.argtypes = [ctypes.c_char_p]
    lib.fastx_close.argtypes = [ctypes.c_void_p]
    lib.fastx_close.restype = None
    lib.fastx_count_reads.restype = ctypes.c_int64
    lib.fastx_count_reads.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int32,
        ctypes.c_float,
    ]
    lib.fastx_read_raw_batch.restype = ctypes.c_int64
    lib.fastx_read_raw_batch.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.c_float,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.fastx_read_packed_batch.restype = ctypes.c_int64
    lib.fastx_read_packed_batch.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.c_float,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.fastx_error.restype = ctypes.c_char_p
    lib.fastx_error.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


def _raise_if_malformed(lib, h, path: str) -> None:
    """A batch loop ending may mean EOF -- or a malformed FASTQ
    record the reader refused to mis-parse. Raise the reader's
    message instead of silently truncating the stream."""
    msg = lib.fastx_error(h)
    if msg:
        raise ValueError(f"{path}: {msg.decode()}")


def _batch_buffers(pinned: bool, rows: int, width: int):
    """A batch's packed [rows, width/4] and validity [rows, width/8]
    uint8 buffers. When ``pinned``, both are views of one page-locked
    block (a tensor's memory, kept alive by the arrays: one allocation a
    batch), which a CUDA card's driver copies straight, not through a
    staging buffer of its own."""
    w4, w8 = width // 4, width // 8
    if not pinned:
        return np.empty((rows, w4), np.uint8), np.empty((rows, w8), np.uint8)
    block = torch.empty(rows * (w4 + w8), dtype=torch.uint8,
                        pin_memory=True).numpy()
    return (block[:rows * w4].reshape(rows, w4),
            block[rows * w4:].reshape(rows, w8))


def iter_packed_batches(
    path: str,
    batch_reads: int,
    min_read_size: int = 0,
    min_shannon: float = 0.0,
    encoding: str = "acgt",
    width: int = 64,
    kmer_size: int = 0,
    pin: bool = False,
) -> Iterator[Tuple[np.ndarray, np.ndarray, int, int]]:
    """Yield (packed [B, width/4], validbits [B, width/8], n_reads,
    n_valid_windows) batches in pack_codes_host layout, filtered and
    2-bit packed at parse time (one C pass; Python never touches read
    bytes). ``width`` grows automatically when a longer read arrives
    (rounded to 8: every width slot beyond the longest read becomes a
    padded k-mer window downstream). ``kmer_size`` > 0 also counts
    the valid k-mer windows per batch. ``pin``: the batches page-locked
    (``_batch_buffers``), for a job on a card."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native fastx library unavailable")
    h = lib.fastx_open(path.encode())
    if not h:
        raise IOError(f"cannot open sequence file: {path}")
    enc = 1 if encoding == "gatb" else 0
    width = -(-max(width, 8) // 8) * 8
    try:
        while True:
            packed, validbits = _batch_buffers(pin, batch_reads, width)
            n_valid = ctypes.c_int64(0)
            n = lib.fastx_read_packed_batch(
                h,
                batch_reads,
                width,
                min_read_size,
                min_shannon,
                enc,
                kmer_size,
                packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                validbits.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_uint8)
                ),
                ctypes.byref(n_valid),
            )
            if n == 0:
                _raise_if_malformed(lib, h, path)
                break
            if n < 0:  # a read longer than width: widen + retry
                width = -(-max(-n, width + 8) // 8) * 8
                continue
            yield packed, validbits, int(n), int(n_valid.value)
            # no early EOF inference: a short batch can also mean a
            # pending longer-than-width read was pushed back
    finally:
        lib.fastx_close(h)


def iter_raw_reads(
    path: str,
    min_read_size: int = 0,
    min_shannon: float = 0.0,
    batch_reads: int = 1 << 16,
    batch_bytes: int = 1 << 24,
) -> Iterator[bytes]:
    """Yield FILTERED raw sequence byte strings at native parse speed,
    with the filter semantics of ``io.bank.sequence_passes``."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native fastx library unavailable")
    h = lib.fastx_open(path.encode())
    if not h:
        raise IOError(f"cannot open sequence file: {path}")
    try:
        buf = np.empty(batch_bytes, np.uint8)
        offsets = np.empty(batch_reads + 1, np.int64)
        while True:
            n = lib.fastx_read_raw_batch(
                h,
                batch_reads,
                buf.shape[0],
                min_read_size,
                min_shannon,
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            )
            if n == 0:
                _raise_if_malformed(lib, h, path)
                break
            if n < 0:  # one read larger than the buffer: grow + retry
                buf = np.empty(max(-n, 2 * buf.shape[0]), np.uint8)
                continue
            raw = bytes(buf[: offsets[n]])
            for i in range(n):
                yield raw[offsets[i] : offsets[i + 1]]
    finally:
        lib.fastx_close(h)


def count_reads(
    path: str, min_read_size: int = 0, min_shannon: float = 0.0
) -> int:
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native fastx library unavailable")
    n = lib.fastx_count_reads(path.encode(), min_read_size, min_shannon)
    if n == -2:
        raise ValueError(f"{path}: malformed FASTQ record")
    if n < 0:
        raise IOError(f"cannot open sequence file: {path}")
    return n
