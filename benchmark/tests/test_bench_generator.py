"""The community repeats per seed, and the program's parser reads what
the harness feeds it through a pipe."""

import numpy as np
import torch

from benchmark import community, harness

SIZES = dict(n_samples=3, elements=[[2, 1000], [1, 300]],
             lognormal_mu=1.0, lognormal_sigma=2.0,
             reads_per_sample=50, read_len=40, n_frac=0.05)


def draw(seed):
    return community.draw_community(seed, torch.device("cpu"), **SIZES)


def test_the_same_seed_gives_the_same_reads():
    a, b = draw(2**31 + 77), draw(2**31 + 77)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_other_seeds_give_other_reads():
    a, b = draw(1), draw(2)
    assert not any(np.array_equal(x, y) for x, y in zip(a, b))


def test_reads_have_the_configured_shape_and_bases():
    for reads in draw(5):
        assert reads.shape == (50, 40) and reads.dtype == np.uint8
        assert set(np.unique(reads).tolist()) <= set(b"ACGTN")
        assert 0 < (reads == ord("N")).mean() < 0.2


def test_reads_come_from_the_genomes_in_both_strands():
    """Every read without N is a window of some element or of its reverse
    complement (the model of utils/community.py), none across two."""
    gen = torch.Generator().manual_seed(9)
    flat = torch.randint(0, 4, (2300,), generator=gen, dtype=torch.uint8)
    genomes = (flat[:1000], flat[1000:2000], flat[2000:])
    text = [bytes(community.BASES[c] for c in g.tolist()) for g in genomes]
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    both = text + [t.translate(comp)[::-1] for t in text]
    for reads in community.draw_community(9, torch.device("cpu"), **SIZES):
        for r in reads:
            r = r.tobytes()
            if b"N" not in r:
                assert any(r in t for t in both)


def test_the_parser_reads_every_sample_through_the_pipe(tmp_path):
    samples = draw(3)
    batches, seconds = harness.parse_samples(samples, 21, 32, str(tmp_path))
    assert seconds > 0 and len(batches) == 3
    for b, reads in zip(batches, samples):
        assert sum(n for _, _, n, _ in b) == len(reads)
        # the native parser's count of valid windows
        valid = sum(nv for _, _, _, nv in b)
        want = sum(
            sum(1 for i in range(40 - 21 + 1) if b"N" not in r[i:i + 21])
            for r in (x.tobytes() for x in reads))
        assert valid == want
    assert list(tmp_path.iterdir()) == []
