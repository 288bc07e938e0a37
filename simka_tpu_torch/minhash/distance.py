"""Sketch-intersection distances + binary distance matrices.

Reference: ComputeDistanceManager::computeDistance_unsynch
(src/simkaMin/SimkaMinDistance.hpp:191-284) walks two ascending hash
streams, stopping after min(s1, s2) union elements (or stream
exhaustion), and derives
  jaccard     = 1 - sharedDistinct / distinct
  braycurtis  = 1 - 2*sum(min(c1,c2)) / sum(counts)
over the processed prefix.

We reproduce that walk in closed form: the processed set is exactly
the union elements <= T*, where T* is the min(L, r(T_exh))-th union
value (T_exh = min of the two stream maxima -- the walk can only break
while consuming the last element of the stream that exhausts first).
This turns the O(s) sequential walk into sorted-array set ops.

Binary matrices are float32 row-major [n1, n2] files named
mat_presenceAbsence_jaccard.bin / mat_abundance_braycurtis.bin
(SimkaMinDistance.hpp:588-597).
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

MATRIX_NAMES = (
    "mat_presenceAbsence_jaccard",
    "mat_abundance_braycurtis",
)


def sketch_pair_distance(
    hA: np.ndarray, cA: np.ndarray, hB: np.ndarray, cB: np.ndarray
) -> Tuple[float, float]:
    """(jaccard, braycurtis) between two trimmed ascending sketches."""
    if len(hA) == 0 or len(hB) == 0:
        return 1.0, 1.0
    L = min(len(hA), len(hB))
    t_exh = min(hA[-1], hB[-1])

    inter, ia, ib = np.intersect1d(
        hA, hB, assume_unique=True, return_indices=True
    )
    # union rank of t_exh = #A<=t + #B<=t - #shared<=t
    n_a = np.searchsorted(hA, t_exh, side="right")
    n_b = np.searchsorted(hB, t_exh, side="right")
    n_s = np.searchsorted(inter, t_exh, side="right")
    r_exh = int(n_a + n_b - n_s)
    processed = min(L, r_exh)
    if processed == 0:
        return 1.0, 1.0

    if processed >= r_exh:
        t_star = t_exh
    else:
        union = np.union1d(hA, hB)
        t_star = union[processed - 1]

    pa = np.searchsorted(hA, t_star, side="right")
    pb = np.searchsorted(hB, t_star, side="right")
    ps = np.searchsorted(inter, t_star, side="right")

    distinct = processed
    shared_distinct = int(ps)
    nb_kmers = int(cA[:pa].sum()) + int(cB[:pb].sum())
    shared_kmers = int(
        np.minimum(cA[ia[:ps]], cB[ib[:ps]]).sum()
    )

    jaccard = (
        1.0
        if distinct == 0
        else 1.0 - shared_distinct / float(distinct)
    )
    braycurtis = (
        1.0
        if nb_kmers == 0
        else 1.0 - (2.0 * shared_kmers) / float(nb_kmers)
    )
    return jaccard, braycurtis


class BinaryMatrix:
    """A float32 row-major [n1, n2] on-disk distance matrix
    (reference SimkaDistanceMatrixBinary,
    src/simkaMin/SimkaMinDistanceMatrixExporter.hpp:33-227)."""

    def __init__(self, path: str, n1: int, n2: int):
        self.path = path
        self.n1 = n1
        self.n2 = n2
        size = n1 * n2 * 4
        if not os.path.exists(path) or os.path.getsize(path) < size:
            with open(path, "ab") as f:
                f.truncate(size)

    def write_block(self, i0: int, j0: int, block: np.ndarray) -> None:
        m = np.memmap(
            self.path, dtype=np.float32, mode="r+", shape=(self.n1, self.n2)
        )
        m[i0 : i0 + block.shape[0], j0 : j0 + block.shape[1]] = block
        m.flush()

    def read(self) -> np.ndarray:
        return np.fromfile(self.path, dtype=np.float32).reshape(
            self.n1, self.n2
        )


def compute_distance_block(
    sketches1: List[Tuple[np.ndarray, np.ndarray]],
    sketches2: List[Tuple[np.ndarray, np.ndarray]],
    symmetric_diag_block: bool,
) -> Tuple[np.ndarray, np.ndarray]:
    """All-pairs (jaccard, braycurtis) between two sketch lists.

    ``symmetric_diag_block``: both lists are the same slice of the
    same sketch file -- compute the upper triangle and mirror, zero
    the diagonal (reference SimkaMinDistance.hpp:619-753).
    """
    n1, n2 = len(sketches1), len(sketches2)
    jac = np.zeros((n1, n2), np.float32)
    bc = np.zeros((n1, n2), np.float32)
    for i in range(n1):
        hA, cA = sketches1[i]
        j_start = i + 1 if symmetric_diag_block else 0
        for j in range(j_start, n2):
            hB, cB = sketches2[j]
            d_j, d_b = sketch_pair_distance(hA, cA, hB, cB)
            jac[i, j] = np.float32(d_j)
            bc[i, j] = np.float32(d_b)
            if symmetric_diag_block:
                jac[j, i] = jac[i, j]
                bc[j, i] = bc[i, j]
    return jac, bc


def merge_matrices(
    existing: np.ndarray,
    existing_vs_new: np.ndarray,
    new_vs_new: np.ndarray,
) -> np.ndarray:
    """Incremental matrix growth (reference
    SimkaDistanceMatrixBinary::mergeMatrices,
    SimkaMinDistanceMatrixExporter.hpp:44-121): compose the
    (Nold+Nnew)^2 matrix from existing + existingVsNew (top-right,
    transposed bottom-left) + newVsNew."""
    n_old = existing.shape[0]
    n_new = new_vs_new.shape[0]
    out = np.zeros((n_old + n_new, n_old + n_new), np.float32)
    out[:n_old, :n_old] = existing
    out[:n_old, n_old:] = existing_vs_new
    out[n_old:, :n_old] = existing_vs_new.T
    out[n_old:, n_old:] = new_vs_new
    return out
