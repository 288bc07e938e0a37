"""The plain reference of one Simka comparison, from the reads.

Straight from the definitions, in plain PyTorch (any device) and numpy,
and independent of the program: it imports nothing of
``simka_tpu_torch`` and takes nothing the program made. From each
sample's reads it works out:

1. every k-mer window with no base outside ACGT (the rest are skipped),
   as its canonical form, the smaller of the 2-bit word of the window
   and of its reverse complement (A0 C1 G2 T3);
2. each (k-mer, sample) count, kept when abundance_min <= count <=
   abundance_max (the solid rows);
3. the dense [k-mers, N] count matrix X of the solid rows, and from it
   Simka's statistics (the reference's SimkaStatistics,
   src/core/SimkaDistance.hpp:68-139): per sample the distinct and
   solid k-mers and the sum of squared counts; per pair the shared
   distinct k-mers, the counts of each side over the shared k-mers,
   the sum of the smaller count; with the simple distances the sum of
   products and of isqrt(products); with the complex ones Whittaker's
   sum of |int32(u64(c_a K_b) - u64(c_b K_a))| over every k-mer present
   in either (SimkaAlgorithm.hpp:481, 505) and the Kullback-Leibler
   terms (:437-446; a k-mer present on one side only adds
   (c / K) log 2);
4. every distance matrix the reference writes
   (SimkaStatistics::outputMatrix, SimkaDistance.cpp:603-649), with its
   edge cases and float-width quirks, in ``float_dtype``.

Integer sums are exact. ``float_dtype`` float32 in place of float64 is
the control: the same reference one precision lower.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

# rows of the count matrix a block of the pair loop takes
PAIR_BLOCK_ROWS = 1 << 20

INT_FIELDS = ("nb_distinct_kmers", "nb_shared_kmers", "dataset_nb_reads",
              "distinct_per_bank", "solid_per_bank", "chord_n2_per_bank",
              "shared_kmers", "shared_distinct", "bray_numerator")
SIMPLE_FIELDS = ("chord_ninj", "hellinger")
COMPLEX_FIELDS = ("whittaker",)


def _codes(device) -> torch.Tensor:
    """[256] int64: A C G T (either case) as 0 1 2 3, any other byte 4."""
    lut = torch.full((256,), 4, dtype=torch.int64)
    for code, bases in enumerate((b"Aa", b"Cc", b"Gg", b"Tt")):
        for b in bases:
            lut[b] = code
    return lut.to(device)


def instance_keys(reads: torch.Tensor, k: int, sample: int,
                  sbits: int) -> torch.Tensor:
    """(canonical k-mer << sbits) | sample of every window of ``reads``
    ([R, L] uint8 ASCII, equal lengths) with no base outside ACGT."""
    codes = _codes(reads.device)[reads.long()]
    W = codes.shape[1] - k + 1
    if W <= 0:
        return torch.empty(0, dtype=torch.int64, device=reads.device)
    fwd = torch.zeros((codes.shape[0], W), dtype=torch.int64,
                      device=reads.device)
    rc = torch.zeros_like(fwd)
    bad = torch.zeros(fwd.shape, dtype=torch.bool, device=reads.device)
    for j in range(k):
        c = codes[:, j:j + W]
        bad |= c > 3
        c = c & 3
        fwd = (fwd << 2) | c
        rc |= (3 - c) << (2 * j)
    return (torch.minimum(fwd, rc)[~bad] << sbits) | sample


def _upper_to_full(upper: torch.Tensor) -> np.ndarray:
    """A pair sum held at [a, b], b > a, as the symmetric matrix, 0 on
    the diagonal."""
    m = upper.cpu().numpy()
    return m + m.T


def statistics(samples: Sequence[np.ndarray], k: int, abundance_min: int,
               abundance_max: int, simple: bool, complex_: bool,
               device: torch.device,
               float_dtype: torch.dtype = torch.float64) -> dict:
    """Simka's statistics of the samples' reads (host [R, L] uint8 ASCII
    arrays), as numpy arrays under the names of the reference's fields,
    and ``shapes``: the sizes the kernels' bounds need."""
    N = len(samples)
    sbits = max(1, (N - 1).bit_length())
    if 2 * k + sbits > 63:
        raise ValueError("the reference packs a k-mer and a sample id into "
                         "one int64 key: 2k + bits(N - 1) <= 63")
    keys = torch.cat([
        instance_keys(torch.from_numpy(r).to(device), k, s, sbits)
        for s, r in enumerate(samples)])
    instances = keys.shape[0]
    keys, counts = torch.unique(keys, sorted=True, return_counts=True)
    solid = (counts >= abundance_min) & (counts <= abundance_max)
    keys, counts = keys[solid], counts[solid]
    del solid
    sid = keys & ((1 << sbits) - 1)
    kmers, row_kmer = torch.unique_consecutive(keys >> sbits,
                                               return_inverse=True)
    del keys
    M = kmers.shape[0]
    X = torch.zeros((M, N), dtype=torch.int64, device=device)
    X[row_kmer, sid] = counts
    del row_kmer, kmers
    banks = (X > 0).sum(1)
    solid_rows = counts.shape[0]
    sample_counts = torch.unique(sid * (int(counts.max()) + 1) + counts
                                 ).shape[0] if solid_rows else 0
    del sid, counts

    i64, f64 = torch.int64, torch.float64
    out = {
        "nb_distinct_kmers": np.int64(M),
        "nb_shared_kmers": np.int64(int((banks >= 2).sum())),
        "dataset_nb_reads": np.array([len(r) for r in samples], np.int64),
        "distinct_per_bank": (X > 0).sum(0).cpu().numpy(),
        "solid_per_bank": X.sum(0).cpu().numpy(),
        "chord_n2_per_bank": (X * X).sum(0).cpu().numpy(),
    }
    K = X.sum(0).to(f64)
    shared_kmers = torch.zeros((N, N), dtype=f64, device=device)
    shared_distinct = torch.zeros_like(shared_kmers)
    chord = torch.zeros_like(shared_kmers)
    bray = torch.zeros((N, N), dtype=i64, device=device)
    hell = torch.zeros_like(bray)
    whitt = torch.zeros_like(bray)
    kl = torch.zeros((N, N), dtype=float_dtype, device=device)
    Kf = K.to(float_dtype)
    log2 = math.log(2.0)
    for r0 in range(0, M, PAIR_BLOCK_ROWS):
        Xb = X[r0:r0 + PAIR_BLOCK_ROWS]
        Xd = Xb.to(f64)
        Pd = (Xb > 0).to(f64)
        # integer-valued f64 products: exact below 2^53
        shared_kmers += Xd.T @ Pd
        shared_distinct += Pd.T @ Pd
        if simple:
            chord += Xd.T @ Xd
        for a in range(N - 1):
            xa, xo = Xb[:, a:a + 1], Xb[:, a + 1:]
            bray[a, a + 1:] += torch.minimum(xa, xo).sum(0)
            if simple:
                hell[a, a + 1:] += torch.floor(
                    torch.sqrt((xa * xo).to(f64))).to(i64).sum(0)
            if complex_:
                x = (xa.to(f64) * K[a + 1:]).to(i64)
                y = (xo.to(f64) * K[a]).to(i64)
                low = (x - y) & 0xFFFFFFFF
                whitt[a, a + 1:] += torch.where(
                    low >= 1 << 31, low - (1 << 32), low).abs().sum(0)
                cx, co = xa.to(float_dtype), xo.to(float_dtype)
                xY, yX = cx * Kf[a + 1:], co * Kf[a]
                den = xY + yX
                both = (xa > 0) & (xo > 0)
                ta = torch.where(both, (cx / Kf[a]) * torch.log(2 * xY / den),
                                 torch.where(xa > 0, (cx / Kf[a]) * log2, 0))
                to = torch.where(both,
                                 (co / Kf[a + 1:]) * torch.log(2 * yX / den),
                                 torch.where(xo > 0, (co / Kf[a + 1:]) * log2,
                                             0))
                kl[a, a + 1:] += (ta + to).sum(0)
    out["shared_kmers"] = shared_kmers.to(i64).cpu().numpy()
    out["shared_distinct"] = shared_distinct.to(i64).cpu().numpy()
    out["bray_numerator"] = (_upper_to_full(bray)
                             + np.diag(out["solid_per_bank"]))
    if simple:
        c = chord.cpu().numpy()
        np.fill_diagonal(c, 0.0)
        out["chord_ninj"] = c
        out["hellinger"] = _upper_to_full(hell)
    if complex_:
        out["whittaker"] = _upper_to_full(whitt)
        out["kullback_leibler"] = _upper_to_full(kl)
    out["shapes"] = {
        "instances": int(instances), "solid_rows": int(solid_rows),
        "kmers": int(M), "pairs": int((banks * (banks - 1) // 2).sum()),
        "sample_counts": int(sample_counts), "n_banks": N,
    }
    return out


def matrices(st: dict, simple: bool, complex_: bool,
             dtype=np.float64) -> Dict[str, np.ndarray]:
    """Every distance matrix of the statistics ``st``, in ``dtype``,
    keyed by the reference's file stem."""
    N = len(st["distinct_per_bank"])
    off = ~np.eye(N, dtype=bool)
    f = lambda v: np.asarray(v).astype(dtype)  # noqa: E731
    one, two, half, sqrt2 = f(1.0), f(2.0), f(0.5), np.sqrt(f(2.0))
    d = st["distinct_per_bank"]
    d_i, d_j = f(d)[:, None], f(d)[None, :]
    a = f(st["shared_distinct"])
    b, c = d_i - a, d_j - a
    K_i = f(st["solid_per_bank"])[:, None]
    K_j = f(st["solid_per_bank"])[None, :]
    A1 = f(st["shared_kmers"])
    B1 = A1.T
    zero = np.zeros((N, N), dtype)
    out = {}

    def pair(den, value, default):
        """``value`` where ``den`` is not 0, else ``default``; 0 on the
        diagonal."""
        den = den + zero
        return np.where(off, np.where(den == 0, default, value), 0).astype(
            dtype)

    def safe(den):
        return np.where(den == 0, one, den)

    with np.errstate(divide="ignore", invalid="ignore"):
        p1 = np.sqrt((a + b) * (a + c))
        out["mat_presenceAbsence_chord"] = pair(
            p1, np.sqrt(two * (one - a / safe(p1))), sqrt2)
        ab0, ac0 = (a + b) == 0, (a + c) == 0
        sab, sac = safe(a + b), safe(a + c)
        either = (ab0 | ac0).astype(dtype)  # a zero denominator gives 1
        out["mat_presenceAbsence_whittaker"] = pair(
            one - either, half * (b / sab + c / sac + np.abs(a / sab - a / sac)),
            one)
        out["mat_presenceAbsence_kulczynski"] = pair(
            one - either, one - half * (a / sab + a / sac), one)
        den = two * a + b + c
        out["mat_presenceAbsence_braycurtis"] = pair(den, (b + c) / safe(den),
                                                     one)
        den = a + b + c
        out["mat_presenceAbsence_jaccard"] = pair(den, (b + c) / safe(den),
                                                  one)
        den = d_i + d_j + zero
        out["mat_presenceAbsence_simka-jaccard"] = pair(
            den, one - two * a / safe(den), one)
        den = d_i + zero
        out["mat_presenceAbsence_simka-jaccard_asym"] = pair(
            den, one - a / safe(den), one)
        # SimkaDistance.cpp:1194: `float val = sqrt((a+b)*(a+c))`
        val = np.sqrt((a + b) * (a + c)).astype(np.float32).astype(dtype)
        out["mat_presenceAbsence_ochiai"] = pair(val, one - a / safe(val),
                                                 one)

        den = K_i + K_j + zero
        out["mat_abundance_simka-jaccard"] = pair(
            den, one - (A1 + B1) / safe(den), one)
        den = K_i + zero
        out["mat_abundance_simka-jaccard_asym"] = pair(
            den, one - A1 / safe(den), one)
        no_k = ((K_i == 0) | (K_j == 0)).astype(dtype)
        out["mat_abundance_ab-ochiai"] = pair(
            one - no_k,
            one - np.sqrt(A1 / safe(K_i)) * np.sqrt(B1 / safe(K_j)), one)
        den = K_i * B1 + A1 * K_j
        out["mat_abundance_ab-sorensen"] = pair(
            den, one - two * A1 * B1 / safe(den), one)
        den = K_i * B1 + A1 * K_j - A1 * B1
        out["mat_abundance_ab-jaccard"] = pair(
            den, one - A1 * B1 / safe(den), one)
        den = K_i + K_j + zero
        bc = pair(den, one - two * f(st["bray_numerator"]) / safe(den), one)
        out["mat_abundance_braycurtis"] = bc
        # the Jaccard of the stored float Bray-Curtis matrix
        # (SimkaDistance.cpp:463-475, 633-635)
        b32 = bc.astype(np.float32).astype(dtype)
        out["mat_abundance_jaccard"] = (two * b32) / (one + b32)

        if simple:
            sq = np.sqrt(f(st["chord_n2_per_bank"]))
            den = sq[:, None] * sq[None, :]
            out["mat_abundance_chord"] = pair(den, np.sqrt(np.maximum(
                two - two * f(st["chord_ninj"]) / safe(den), 0)), sqrt2)
            den = np.sqrt(K_i) * np.sqrt(K_j) + zero
            out["mat_abundance_hellinger"] = pair(den, np.sqrt(np.maximum(
                two - two * f(st["hellinger"]) / safe(den), 0)), sqrt2)
            # the reference fills only the upper triangle of its
            # min(Ni, Nj) sums and reads both (SimkaAlgorithm.hpp:384-398,
            # SimkaDistance.cpp:1028-1029): n1 is over the smaller index's K
            iu = np.triu(np.ones((N, N), dtype=bool), 1)
            k_small = np.where(iu, K_i + zero, K_j + zero)
            out["mat_abundance_kulczynski"] = pair(
                one - no_k, one - half * (f(st["bray_numerator"]) / k_small),
                one)

        if complex_:
            den = K_i * K_j + zero
            out["mat_abundance_whittaker"] = pair(
                den, half * (f(st["whittaker"]) / safe(den)), one)
            kl = f(st["kullback_leibler"]).copy()
            np.fill_diagonal(kl, 0)
            out["mat_abundance_jensenshannon"] = pair(
                kl, np.sqrt(np.maximum(half * kl, 0)), one)
            canb = f(d[:, None] + d[None, :] - 2 * st["shared_distinct"])
            den = a + b + c
            out["mat_abundance_canberra"] = pair(den, canb / safe(den), one)
    return out


def compare(stats, mats: Dict[str, np.ndarray], ref: dict,
            ref_mats: Dict[str, np.ndarray], simple: bool,
            complex_: bool) -> Dict[str, float]:
    """The numbers a job's answer is judged by: ``stat_mismatch``, the
    entries of the integer statistics (and of the integer-valued chord
    sums) that differ from the reference's, and ``matrix_gap``, the
    largest absolute gap between a distance matrix and the reference's
    (inf where a matrix is missing, misshapen or NaN on one side only).
    ``stats`` is any object with the reference's field names."""
    fields = (INT_FIELDS + (SIMPLE_FIELDS if simple else ())
              + (COMPLEX_FIELDS if complex_ else ()))
    mismatch = 0
    for name in fields:
        want = np.asarray(ref[name])
        got = np.asarray(getattr(stats, name, None) if not isinstance(
            stats, dict) else stats.get(name))
        if got.shape != want.shape:
            mismatch += max(want.size, 1)
        else:
            mismatch += int(np.count_nonzero(got != want))
    gap = 0.0
    for name, want in ref_mats.items():
        got = mats.get(name)
        if got is None or np.shape(got) != want.shape:
            return {"stat_mismatch": mismatch, "matrix_gap": math.inf}
        got = np.asarray(got, np.float64)
        want = want.astype(np.float64)
        nan_g, nan_w = np.isnan(got), np.isnan(want)
        if (nan_g != nan_w).any():
            return {"stat_mismatch": mismatch, "matrix_gap": math.inf}
        diff = np.abs(np.where(nan_w, 0.0, got - want))
        gap = max(gap, float(diff.max()) if diff.size else 0.0)
    return {"stat_mismatch": mismatch, "matrix_gap": gap}


def answer(samples: List[np.ndarray], k: int, abundance_min: int,
           abundance_max: int, simple: bool, complex_: bool, device,
           float_dtype: torch.dtype = torch.float64):
    """(statistics, matrices) of the reference at ``float_dtype``
    (float32: the control)."""
    st = statistics(samples, k, abundance_min, abundance_max, simple,
                    complex_, device, float_dtype)
    np_dtype = np.float32 if float_dtype == torch.float32 else np.float64
    return st, matrices(st, simple, complex_, np_dtype)
