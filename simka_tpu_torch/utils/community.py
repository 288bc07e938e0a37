"""Simulated metagenome community: sequencing samples written from a seed.

Random genomes, and per sample reads drawn at Dirichlet-random genome
abundances, half of them reverse-complemented, with a small share of
``N`` bases. Samples then share real k-mers at realistic coverage, so
the abundance filter and every distance matrix have work to do
(uniform random reads would make every k-mer a singleton).
Vectorised numpy throughout: no per-read Python loop.

    python -m simka_tpu_torch.utils.community OUT_DIR [--seed 0]

writes ``WIDE_COMMUNITY`` (``chip_smoke.py`` phase 14's 100 samples)
and prints the path of its ``input.txt``.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List

import numpy as np

# 100 samples x 50,000 reads x 100 bp of 20 genomes x 200 kbp: 1.25x
# coverage a sample, most solid k-mers shared by many samples (the
# wide-N community of chip_smoke.py phase 14 and of the command line)
WIDE_COMMUNITY = dict(n_samples=100, n_genomes=20, genome_len=200_000,
                      reads_per_sample=50_000, read_len=100, n_frac=0.001)

# 8 samples x 500,000 reads x 100 bp of 20 genomes x 2 Mbp (the
# full-size community of chip_smoke.py phase 7 and of the profiling
# scripts that run it)
FULL_COMMUNITY = dict(n_samples=8, n_genomes=20, genome_len=2_000_000,
                      reads_per_sample=500_000, read_len=100, n_frac=0.001)

_BASES = np.frombuffer(b"ACGT", np.uint8)
_N = ord("N")


def sample_reads(
    rng: np.random.Generator,
    genomes: np.ndarray,
    n_reads: int,
    read_len: int,
    n_frac: float,
    alpha: float = 1.0,
) -> np.ndarray:
    """[n_reads, read_len] ASCII bases of one sample."""
    G, L = genomes.shape
    weights = rng.dirichlet(np.full(G, alpha))
    which = rng.choice(G, size=n_reads, p=weights)
    start = rng.integers(0, L - read_len + 1, size=n_reads)
    codes = genomes[which[:, None], start[:, None] + np.arange(read_len)]
    rc = rng.random(n_reads) < 0.5
    codes[rc] = 3 - codes[rc, ::-1]
    reads = _BASES[codes]
    reads[rng.random(reads.shape) < n_frac] = _N
    return reads


def _records(reads: np.ndarray, fastq: bool) -> bytes:
    """FASTA or FASTQ bytes of equal-length reads, one record each."""
    R, rl = reads.shape
    if fastq:
        # "@r\n" seq "\n+\n" qual "\n"
        rec = np.empty((R, 3 + rl + 3 + rl + 1), np.uint8)
        rec[:, :3] = np.frombuffer(b"@r\n", np.uint8)
        rec[:, 3 : 3 + rl] = reads
        rec[:, 3 + rl : 6 + rl] = np.frombuffer(b"\n+\n", np.uint8)
        rec[:, 6 + rl : 6 + 2 * rl] = ord("I")
        rec[:, -1] = ord("\n")
    else:
        rec = np.empty((R, 3 + rl + 1), np.uint8)
        rec[:, :3] = np.frombuffer(b">r\n", np.uint8)
        rec[:, 3 : 3 + rl] = reads
        rec[:, -1] = ord("\n")
    return rec.tobytes()


def write_community(
    out_dir: str,
    *,
    seed: int,
    n_samples: int,
    n_genomes: int,
    genome_len: int,
    reads_per_sample: int,
    read_len: int = 100,
    n_frac: float = 0.001,
    fastq_samples: int = 0,
    motif_genomes: int = 0,
    first: int = 0,
) -> str:
    """Write one file per sample plus ``input.txt``; return its path.

    Sample s is the same in every community of a seed that has it, so
    ``first`` > 0 writes only samples ``first`` .. ``n_samples - 1`` (the
    ones before are drawn, not written, nor listed in ``input.txt``): a
    larger community grows from a smaller one's files.
    The first ``fastq_samples`` samples are FASTQ, the rest FASTA. The
    first ``motif_genomes`` genomes are low-complexity tandem repeats,
    for the k-mer Shannon filter, of a motif cycling through three
    kinds: two distinct bases (every k-mer's index is 1.0 at even k);
    four bases with one of them twice (1.5 at k a multiple of 4); four
    bases with one of them three times (0.811 at k a multiple of 4).
    """
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    genomes = rng.integers(0, 4, size=(n_genomes, genome_len), dtype=np.uint8)
    for g in range(motif_genomes):
        p = rng.permutation(4).astype(np.uint8)
        motif = (p[:2], p[[0, 0, 1, 2]], p[[0, 0, 0, 1]])[g % 3]
        genomes[g] = np.tile(motif, -(-genome_len // len(motif)))[:genome_len]
    lines: List[str] = []
    for s in range(n_samples):
        fastq = s < fastq_samples
        reads = sample_reads(rng, genomes, reads_per_sample, read_len, n_frac)
        if s < first:
            continue
        path = os.path.join(out_dir, f"S{s}." + ("fastq" if fastq else "fasta"))
        with open(path, "wb") as f:
            f.write(_records(reads, fastq))
        lines.append(f"S{s}: {path}\n")
    input_path = os.path.join(out_dir, "input.txt")
    with open(input_path, "w") as f:
        f.writelines(lines)
    return input_path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Write the wide-N community (WIDE_COMMUNITY).")
    ap.add_argument("out_dir")
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    print(write_community(a.out_dir, seed=a.seed, **WIDE_COMMUNITY))
    return 0


if __name__ == "__main__":
    sys.exit(main())
