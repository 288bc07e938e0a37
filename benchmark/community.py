"""A simulated metagenome community, drawn from a seed on the device.

The read model follows ``simka_tpu_torch/utils/community.py``
(``sample_reads`` and ``_records``, commit 04a1e524): random sequences
stand for the community's genomes; per sample, reads at uniform
positions of elements drawn at the sample's abundances, half of them
reverse-complemented, and a share ``n_frac`` of ``N`` bases. Here the
community is a list of element groups (genomes, circular elements), each
of one length, and a read comes from an element with probability
proportional to its abundance times its length, as a simulator that
draws cells and sequences them does. Abundances are drawn anew for each
sample from a log-normal, CAMISIM's model (``utils/community.py`` draws
Dirichlet(1) weights).

It draws with a ``torch.Generator`` on the given device in a few large
calls, not with numpy on the host (1.8 s a sample of 500,000 reads
there), so that the set-up every run pays stays short. The same seed on
the same kind of device gives the same reads.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

BASES = b"ACGT"


def draw_community(seed: int, device: torch.device, *, n_samples: int,
                   elements: Sequence[Sequence[int]], lognormal_mu: float,
                   lognormal_sigma: float, reads_per_sample: int,
                   read_len: int, n_frac: float) -> List[np.ndarray]:
    """Every sample's reads as a host [reads_per_sample, read_len] uint8
    array of ASCII bases. ``elements``: [[count, length], ...], groups
    of random sequences of one length each; an element's abundance in a
    sample is exp(lognormal_mu + lognormal_sigma * z), z standard
    normal."""
    lengths = torch.tensor([int(length) for count, length in elements
                            for _ in range(int(count))],
                           dtype=torch.int64, device=device)
    if int(lengths.min()) < read_len:
        raise ValueError("an element is shorter than a read")
    starts = torch.cumsum(lengths, 0) - lengths
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    genomes = torch.randint(0, 4, (int(lengths.sum()),), generator=gen,
                            device=device, dtype=torch.uint8)
    ascii_of = torch.tensor(list(BASES), dtype=torch.uint8, device=device)
    offsets = torch.arange(read_len, device=device)
    out = []
    for _ in range(n_samples):
        z = torch.randn(lengths.shape[0], generator=gen, device=device,
                        dtype=torch.float64)
        weights = torch.exp(lognormal_mu + lognormal_sigma * z) * lengths
        which = torch.multinomial(weights / weights.sum(), reads_per_sample,
                                  replacement=True, generator=gen)
        u = torch.rand(reads_per_sample, generator=gen, device=device,
                       dtype=torch.float64)
        span = lengths[which] - read_len + 1
        pos = starts[which] + torch.minimum((u * span).long(), span - 1)
        codes = genomes[pos[:, None] + offsets]
        rc = torch.rand(reads_per_sample, generator=gen, device=device) < 0.5
        codes = torch.where(rc[:, None], 3 - codes.flip(1), codes)
        reads = ascii_of[codes.long()]
        n_mask = torch.rand((reads_per_sample, read_len), generator=gen,
                            device=device) < n_frac
        reads[n_mask] = ord("N")
        out.append(reads.cpu().numpy())
    return out


def fasta_bytes(reads: np.ndarray) -> bytes:
    """FASTA bytes of equal-length reads, one record each."""
    R, rl = reads.shape
    rec = np.empty((R, 3 + rl + 1), np.uint8)
    rec[:, :3] = np.frombuffer(b">r\n", np.uint8)
    rec[:, 3:3 + rl] = reads
    rec[:, -1] = ord("\n")
    return rec.tobytes()
