"""Closed-form ecological distance matrices from sufficient statistics.

Every formula reproduces the reference's exactly, including its edge
cases and float-width quirks (all cited to
src/core/SimkaDistance.cpp). Vectorized numpy float64;
matrices are cast to float32 at CSV time (the reference stores
``vector<vector<float>>``).

Notation: for a pair (i, j),
  a = shared distinct k-mers, b = distinct_i - a, c = distinct_j - a
  A1 = sum of counts_i over co-present k-mers  (_matrixNbSharedKmers[i][j])
  B1 = likewise for j                          (_matrixNbSharedKmers[j][i])
  A0/B0 = total solid k-mers per sample        (_nbSolidKmersPerBank)
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from simka_tpu_torch.core.stats import SimkaStatistics
from simka_tpu_torch.utils.metrics import Spans, span

SQRT2 = np.sqrt(2.0)


def _offdiag(n: int) -> np.ndarray:
    return ~np.eye(n, dtype=bool)


def _sym_guard(matrix: np.ndarray) -> np.ndarray:
    np.fill_diagonal(matrix, 0.0)
    return matrix


def compute_all_matrices(
    stats: SimkaStatistics, spans: Optional[Spans] = None,
) -> Dict[str, np.ndarray]:
    """All output matrices keyed by their reference filename stem
    (SimkaStatistics::outputMatrix, SimkaDistance.cpp:603-649), in the
    span ``simka.matrices`` of ``spans``."""
    n = stats.n_banks
    off = _offdiag(n)
    with span("simka.matrices", spans), \
            np.errstate(divide="ignore", invalid="ignore"):
        out = {}

        d_i = stats.distinct_per_bank.astype(np.float64)[:, None]
        d_j = stats.distinct_per_bank.astype(np.float64)[None, :]
        a = stats.shared_distinct.astype(np.float64)
        b = d_i - a
        c = d_j - a

        K_i = stats.solid_per_bank.astype(np.float64)[:, None]
        K_j = stats.solid_per_bank.astype(np.float64)[None, :]
        A1 = stats.shared_kmers.astype(np.float64)
        B1 = A1.T

        def guard(den, num_expr, default):
            return _sym_guard(
                np.where(off, np.where(den == 0, default, num_expr), 0.0)
            )

        # --- presence/absence family (SimkaDistance.cpp:1117-1226) ---
        p1 = np.sqrt((a + b) * (a + c))
        safe_p1 = np.where(p1 == 0, 1.0, p1)
        out["mat_presenceAbsence_chord"] = guard(
            p1, np.sqrt(2.0 * (1.0 - a / safe_p1)), SQRT2
        )

        ab0 = (a + b) == 0
        ac0 = (a + c) == 0
        sab = np.where(ab0, 1.0, a + b)
        sac = np.where(ac0, 1.0, a + c)
        whitt = 0.5 * (b / sab + c / sac + np.abs(a / sab - a / sac))
        out["mat_presenceAbsence_whittaker"] = _sym_guard(
            np.where(off, np.where(ab0 | ac0, 1.0, whitt), 0.0)
        )

        kulc = 1.0 - 0.5 * (a / sab + a / sac)
        out["mat_presenceAbsence_kulczynski"] = _sym_guard(
            np.where(off, np.where(ab0 | ac0, 1.0, kulc), 0.0)
        )

        den = 2 * a + b + c
        out["mat_presenceAbsence_braycurtis"] = guard(
            den, (b + c) / np.where(den == 0, 1.0, den), 1.0
        )

        den = a + b + c
        out["mat_presenceAbsence_jaccard"] = guard(
            den, (b + c) / np.where(den == 0, 1.0, den), 1.0
        )

        den = d_i + d_j + np.zeros_like(a)
        out["mat_presenceAbsence_simka-jaccard"] = guard(
            den, 1.0 - 2.0 * a / np.where(den == 0, 1.0, den), 1.0
        )

        den = d_i + np.zeros_like(a)
        out["mat_presenceAbsence_simka-jaccard_asym"] = guard(
            den, 1.0 - a / np.where(den == 0, 1.0, den), 1.0
        )

        # float32 intermediate: the reference computes
        # `float val = sqrt((a+b)*(a+c))` (SimkaDistance.cpp:1194)
        val = np.float32(0) + np.sqrt((a + b) * (a + c)).astype(np.float32)
        val64 = val.astype(np.float64)
        out["mat_presenceAbsence_ochiai"] = guard(
            val64, 1.0 - a / np.where(val64 == 0, 1.0, val64), 1.0
        )

        # --- abundance family ---
        den = K_i + K_j + np.zeros_like(a)
        out["mat_abundance_simka-jaccard"] = guard(
            den, 1.0 - (A1 + B1) / np.where(den == 0, 1.0, den), 1.0
        )

        den = K_i + np.zeros_like(a)
        out["mat_abundance_simka-jaccard_asym"] = guard(
            den, 1.0 - A1 / np.where(den == 0, 1.0, den), 1.0
        )

        bad = (K_i == 0) | (K_j == 0) | np.zeros_like(a, dtype=bool)
        sKi = np.where(K_i == 0, 1.0, K_i)
        sKj = np.where(K_j == 0, 1.0, K_j)
        och = 1.0 - np.sqrt(A1 / sKi) * np.sqrt(B1 / sKj)
        out["mat_abundance_ab-ochiai"] = _sym_guard(
            np.where(off, np.where(bad, 1.0, och), 0.0)
        )

        den = K_i * B1 + A1 * K_j
        out["mat_abundance_ab-sorensen"] = guard(
            den, 1.0 - 2.0 * A1 * B1 / np.where(den == 0, 1.0, den), 1.0
        )

        den = K_i * B1 + A1 * K_j - A1 * B1
        out["mat_abundance_ab-jaccard"] = guard(
            den, 1.0 - A1 * B1 / np.where(den == 0, 1.0, den), 1.0
        )

        den = K_i + K_j + np.zeros_like(a)
        bray = 1.0 - 2.0 * stats.bray_numerator.astype(np.float64) / np.where(
            den == 0, 1.0, den
        )
        bc = _sym_guard(np.where(off, np.where(den == 0, 1.0, bray), 0.0))
        out["mat_abundance_braycurtis"] = bc

        # Jaccard derived from the *float32-rounded* Bray-Curtis matrix
        # (outputMatrix passes the stored float matrix,
        # SimkaDistance.cpp:633-635, 463-475); diagonal goes through the
        # formula too (2*0/(1+0) = 0).
        b32 = bc.astype(np.float32).astype(np.float64)
        out["mat_abundance_jaccard"] = (2.0 * b32) / (1.0 + b32)

        if stats.compute_simple:
            sq = stats.chord_sqrt_n2
            den = sq[:, None] * sq[None, :]
            chord = np.sqrt(
                np.maximum(
                    2.0
                    - 2.0 * stats.chord_ninj / np.where(den == 0, 1.0, den),
                    0.0,
                )
            )
            out["mat_abundance_chord"] = guard(den, chord, SQRT2)

            den = np.sqrt(K_i) * np.sqrt(K_j) + np.zeros_like(a)
            hell = np.sqrt(
                np.maximum(
                    2.0
                    - 2.0
                    * stats.hellinger.astype(np.float64)
                    / np.where(den == 0, 1.0, den),
                    0.0,
                )
            )
            out["mat_abundance_hellinger"] = guard(den, hell, SQRT2)

            bad = (K_i == 0) | (K_j == 0) | np.zeros_like(a, dtype=bool)
            m = stats.bray_numerator.astype(np.float64)  # == kulczynski min
            # Reference quirk: updateDistanceSimple fills only the upper
            # triangle of _kulczynski_minNiNj (SimkaAlgorithm.hpp:384-398),
            # but distance_abundance_kulczynski reads BOTH [i][j] and
            # [j][i] (SimkaDistance.cpp:1028-1029) with i<j -- so the n2
            # term is always 0. Mirror the triangle relation: for the
            # (i<j) evaluation, n1 uses K of the smaller index.
            iu = np.triu(np.ones_like(m, dtype=bool), 1)
            k_small = np.where(iu, K_i + np.zeros_like(m), K_j + np.zeros_like(m))
            kul = 1.0 - 0.5 * (m / k_small)
            out["mat_abundance_kulczynski"] = _sym_guard(
                np.where(off, np.where(bad, 1.0, kul), 0.0)
            )

        if stats.compute_complex:
            den = K_i * K_j + np.zeros_like(a)
            whit = 0.5 * (
                stats.whittaker.astype(np.float64)
                / np.where(den == 0, 1.0, den)
            )
            out["mat_abundance_whittaker"] = guard(den, whit, 1.0)

            # device accumulation already filled both triangles with the
            # full (d1 + d2) pair sum -- do NOT symmetrize by addition
            kl = stats.kullback_leibler.copy()
            np.fill_diagonal(kl, 0.0)
            js = np.sqrt(np.maximum(0.5 * kl, 0.0))
            out["mat_abundance_jensenshannon"] = _sym_guard(
                np.where(off, np.where(kl == 0, 1.0, js), 0.0)
            )

            den = a + b + c
            canb = stats.canberra.astype(np.float64) / np.where(
                den == 0, 1.0, den
            )
            out["mat_abundance_canberra"] = guard(den, canb, 1.0)

    return out
