"""Input-description DSL parser.

The reference parses an input file where each line describes one dataset
(src/core/SimkaAlgorithm.cpp:244-351):

    ID: f1 , f2 ; f3 , f4

- ``:``  separates the dataset id from its files
- ``;``  separates *paired* banks (e.g. paired-end mates)
- ``,``  separates files that are concatenated into one bank
- spaces are stripped; relative paths resolve against the input file's
  directory.

For counting purposes every file of every bank of a dataset contributes
reads to the same sample; pairing only matters for the per-dataset
max-reads iteration order (reference SimkaInputIterator,
src/core/SimkaCommons.hpp:159-314: banks are consumed sequentially and
the cap applies across the whole dataset).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List


@dataclasses.dataclass
class Dataset:
    """One sample: an id plus its banks (each bank = list of files)."""

    id: str
    banks: List[List[str]]  # banks[pair_index] = [file, file, ...]

    @property
    def files(self) -> List[str]:
        """All files in iteration order (bank by bank, part by part)."""
        return [f for bank in self.banks for f in bank]


def _resolve(path: str, base_dir: str) -> str:
    path = path.strip()
    if os.path.isabs(path):
        return path
    return os.path.normpath(os.path.join(base_dir, path))


def parse_input_text(text: str, base_dir: str = ".") -> List[Dataset]:
    datasets: List[Dataset] = []
    seen = set()
    for raw_line in text.splitlines():
        line = raw_line.strip()
        if not line:
            continue
        if ":" not in line:
            raise ValueError(
                f"invalid input line (missing 'id:'): {raw_line!r}"
            )
        sample_id, _, files_part = line.partition(":")
        sample_id = sample_id.strip()
        if not sample_id:
            raise ValueError(f"empty dataset id in line: {raw_line!r}")
        if sample_id in seen:
            raise ValueError(f"duplicate dataset id: {sample_id}")
        seen.add(sample_id)
        banks = []
        for bank_str in files_part.split(";"):
            parts = [
                _resolve(p, base_dir) for p in bank_str.split(",") if p.strip()
            ]
            if parts:
                banks.append(parts)
        if not banks:
            raise ValueError(f"dataset {sample_id} has no files")
        datasets.append(Dataset(id=sample_id, banks=banks))
    if not datasets:
        raise ValueError("input file contains no datasets")
    return datasets


def parse_input_file(filename: str) -> List[Dataset]:
    with open(filename, "r") as f:
        text = f.read()
    return parse_input_text(text, base_dir=os.path.dirname(os.path.abspath(filename)))


def check_input_validity(datasets: List[Dataset]) -> None:
    """Probe every file for existence/readability (reference
    SimkaCommons::checkInputValidity, src/core/SimkaCommons.hpp:32-145)."""
    missing = []
    for ds in datasets:
        for f in ds.files:
            if not os.path.isfile(f):
                missing.append((ds.id, f))
    if missing:
        lines = "\n".join(f"  {d}: {f}" for d, f in missing)
        raise FileNotFoundError(f"missing input files:\n{lines}")
