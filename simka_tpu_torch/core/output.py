"""Distance-matrix CSV output, byte-compatible with the reference.

Format (SimkaStatistics::dumpMatrix, src/core/SimkaDistance.cpp:653-699):
header ``;id1;id2;...``, then one row per sample ``id;v;v;...`` with
values printed ``%f`` (6 decimals) from the float32-stored matrix,
gzip-compressed as ``<name>.csv.gz``.
"""

from __future__ import annotations

import gzip
import os
from typing import Dict, List

import numpy as np


def format_matrix_csv(matrix: np.ndarray, ids: List[str]) -> str:
    # the reference stores distances in vector<vector<float>> and
    # prints with %f -> float32 rounding happens BEFORE formatting
    m32 = matrix.astype(np.float32)
    lines = ["".join(";" + i for i in ids)]
    for i, row_id in enumerate(ids):
        row = m32[i]
        lines.append(
            row_id + "".join(f";{float(v):.6f}" for v in row)
        )
    return "\n".join(lines) + "\n"


def dump_matrix_csv_gz(
    output_dir: str, name: str, matrix: np.ndarray, ids: List[str]
) -> str:
    path = os.path.join(output_dir, name + ".csv.gz")
    data = format_matrix_csv(matrix, ids).encode()
    with gzip.open(path, "wb") as f:
        f.write(data)
    return path


def write_all_matrices(
    output_dir: str, matrices: Dict[str, np.ndarray], ids: List[str]
) -> List[str]:
    os.makedirs(output_dir, exist_ok=True)
    return [
        dump_matrix_csv_gz(output_dir, name, mat, ids)
        for name, mat in matrices.items()
    ]
