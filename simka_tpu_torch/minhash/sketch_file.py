"""SimkaMin sketch file format -- binary-compatible with the reference.

Layout (src/simkaMin/SimkaMinCommons.hpp:28-161):
  header (13 bytes, LE): u8 kmerSize | u32 sketchSize | u32 seed
                         | u32 nbDatasets
  records: nbDatasets * sketchSize slots of KmerAndCountType
           {u64 hashedKmer, u32 count} -- written with
           sizeof(KmerAndCountType) == 16 (the struct carries 4 bytes
           of alignment padding, SimkaMinCount.hpp:1237), so the
           on-disk record stride is 16 bytes.
  ids: per dataset, u8 length + raw bytes (writeString,
       SimkaMinCommons.hpp:82-86).

Each slot holds the sample's bottom-s hashes in ASCENDING order,
right-aligned: if a sample has fewer than s distinct k-mers the
leading entries stay zero (the reference drains its heap from the back
of the slot, SimkaMinCount.hpp:171-189; readers trim the zero padding,
SimkaMinDistance.hpp:567-585).
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import List, Tuple

import numpy as np

HEADER_SIZE = 13
RECORD_SIZE = 16  # u64 + u32 + 4 pad
_REC_DTYPE = np.dtype(
    [("hash", "<u8"), ("count", "<u4"), ("_pad", "<u4")]
)


@dataclasses.dataclass
class SketchHeader:
    kmer_size: int
    sketch_size: int
    seed: int
    nb_datasets: int

    def pack(self) -> bytes:
        return struct.pack(
            "<BIII",
            self.kmer_size,
            self.sketch_size,
            self.seed,
            self.nb_datasets,
        )

    @classmethod
    def unpack(cls, data: bytes) -> "SketchHeader":
        k, s, seed, n = struct.unpack("<BIII", data[:HEADER_SIZE])
        return cls(k, s, seed, n)


class SketchFile:
    """Reader/writer for .sketch files (reference `simkaMinCore sketch`
    output; also consumed by append/distance/info/export)."""

    def __init__(self, path: str):
        self.path = path

    # -- reading -----------------------------------------------------------

    def header(self) -> SketchHeader:
        with open(self.path, "rb") as f:
            return SketchHeader.unpack(f.read(HEADER_SIZE))

    def ids(self) -> List[str]:
        h = self.header()
        out = []
        with open(self.path, "rb") as f:
            f.seek(HEADER_SIZE + h.nb_datasets * h.sketch_size * RECORD_SIZE)
            for _ in range(h.nb_datasets):
                (n,) = struct.unpack("<B", f.read(1))
                out.append(f.read(n).decode())
        return out

    def read_slot(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        """(hashes, counts) for one dataset, zero-padding trimmed,
        ascending hash order."""
        h = self.header()
        with open(self.path, "rb") as f:
            f.seek(HEADER_SIZE + index * h.sketch_size * RECORD_SIZE)
            raw = np.frombuffer(
                f.read(h.sketch_size * RECORD_SIZE), dtype=_REC_DTYPE
            )
        hashes = raw["hash"]
        counts = raw["count"]
        # trim the leading zero-hash padding (short sketches)
        nz = np.nonzero(hashes)[0]
        if len(nz) == 0:
            return hashes[:0], counts[:0]
        start = nz[0]
        return hashes[start:].copy(), counts[start:].copy()

    # -- writing -----------------------------------------------------------

    @classmethod
    def create(
        cls,
        path: str,
        kmer_size: int,
        sketch_size: int,
        seed: int,
        nb_datasets: int,
    ) -> "SketchFile":
        with open(path, "wb") as f:
            f.write(
                SketchHeader(kmer_size, sketch_size, seed, nb_datasets).pack()
            )
            f.truncate(
                HEADER_SIZE + nb_datasets * sketch_size * RECORD_SIZE
            )
        return cls(path)

    def write_slot(
        self, index: int, hashes: np.ndarray, counts: np.ndarray
    ) -> None:
        h = self.header()
        assert len(hashes) <= h.sketch_size
        rec = np.zeros(h.sketch_size, dtype=_REC_DTYPE)
        n = len(hashes)
        if n:
            rec["hash"][h.sketch_size - n :] = hashes
            rec["count"][h.sketch_size - n :] = counts
        with open(self.path, "r+b") as f:
            f.seek(HEADER_SIZE + index * h.sketch_size * RECORD_SIZE)
            f.write(rec.tobytes())

    def write_ids(self, ids: List[str]) -> None:
        h = self.header()
        with open(self.path, "r+b") as f:
            f.seek(HEADER_SIZE + h.nb_datasets * h.sketch_size * RECORD_SIZE)
            for s in ids:
                b = s.encode()
                if len(b) > 255:
                    raise ValueError(f"dataset id too long: {s}")
                f.write(struct.pack("<B", len(b)) + b)
            f.truncate()

    def set_nb_datasets(self, n: int) -> None:
        with open(self.path, "r+b") as f:
            f.seek(9)  # getFilePosition_nbDatasets() == 1+4+4
            f.write(struct.pack("<I", n))

    # -- append (reference SimkaMinAppend.hpp:36-204) ----------------------

    def append(self, other: "SketchFile") -> None:
        """Merge `other`'s sketches into this file in place."""
        h1, h2 = self.header(), other.header()
        if (
            h1.kmer_size != h2.kmer_size
            or h1.sketch_size != h2.sketch_size
            or h1.seed != h2.seed
        ):
            raise ValueError(
                "incompatible sketch files (k/sketch-size/seed mismatch)"
            )
        ids = self.ids() + other.ids()
        slot_bytes = h1.sketch_size * RECORD_SIZE
        with open(other.path, "rb") as src:
            src.seek(HEADER_SIZE)
            payload = src.read(h2.nb_datasets * slot_bytes)
        with open(self.path, "r+b") as f:
            f.seek(HEADER_SIZE + h1.nb_datasets * slot_bytes)
            f.write(payload)
            for s in ids:
                b = s.encode()
                f.write(struct.pack("<B", len(b)) + b)
            f.truncate()
        self.set_nb_datasets(h1.nb_datasets + h2.nb_datasets)

    def info(self) -> str:
        """`simkaMinCore info` (reference SimkaMinInfos.hpp:64-104)."""
        h = self.header()
        lines = [
            f"Sketch info: {self.path}",
            f"\tk-mer size: {h.kmer_size}",
            f"\tSketch size: {h.sketch_size}",
            f"\tSeed: {h.seed}",
            f"\tNb datasets: {h.nb_datasets}",
            "Datasets:",
        ]
        lines += [f"\t{s}" for s in self.ids()]
        return "\n".join(lines)
