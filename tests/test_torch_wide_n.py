"""The wide-N exact path on the CPU, where the pair sums run their plain
torch version (``ops.countjoin._pair_sums_plain``): the port's
count_join_stats at N = 100 against simka_tpu's split join
(``count_join_stats_split``, which its pipeline takes from
SPLIT_MIN_BANKS = 33 samples) and its direct join; the pair sums at
N = 256, past any N the reference has run (VERDICT.md), against a
brute-force numpy oracle of every pair channel; the port's CLI at
N = 40 against simka_tpu's run_simka (n_shards=1: the split path); the
kernel's channel groups; and, on the card only, the kernel of
``csrc/pair_sums.cu`` against its plain version.

Integer channels are held exactly. Kullback-Leibler: against
simka_tpu within its f32 panel-sum error bound (FLOAT_RTOL,
test_torch_countjoin.py); against the oracle to 1e-12 relative, since
numpy's log and torch's may differ in an f64 term's last bit and the
oracle sums its terms in f64 (a few hundred terms a bin: ~1e-14)."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simka_tpu.config import SimkaConfig as RefConfig
from simka_tpu.core.pipeline import run_simka as run_ref
from simka_tpu.ops.countjoin import SPLIT_MIN_BANKS, use_split_join
from simka_tpu.ops.countjoin import count_join_stats as count_join_ref
from simka_tpu.ops.countjoin import count_join_stats_split as count_join_split_ref
from simka_tpu_torch.cli import main as port_main
from simka_tpu_torch.ops import countjoin
from test_torch_cli_channels import _assert_csvs_match
from test_torch_countjoin import _assert_stats_match
from test_torch_pipeline import _outputs

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
from synthetic50 import make_datasets  # noqa: E402

TWO32 = 2.0**32


def _wide_instances(n_banks: int, E: int, seed: int):
    """uint32 (hi, lo) at k=21 widths (hi_bits 10) and int32 sid: 512
    distinct k-mers over E instances, so each k-mer lands ~E / 512
    times across the samples and is shared by most of them."""
    rng = np.random.default_rng(seed)
    hi = rng.integers(0, 4, size=E).astype(np.uint64) | np.uint64(1 << 9)
    lo = rng.integers(0, 128, size=E).astype(np.uint64) | np.uint64(1 << 31)
    sid = rng.integers(0, n_banks, size=E).astype(np.int32)
    return hi.astype(np.uint32), lo.astype(np.uint32), sid


@pytest.mark.parametrize("amin", [0, 2])
def test_all_channels_at_n100_match_the_split_join(amin):
    N = 100
    hi, lo, sid = _wide_instances(N, 40_000, 100 + amin)
    args = (jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(sid),
            jnp.int32(amin), jnp.int64(999_999_999))
    kw = dict(n_banks=N, hi_bits=10, simple=True, complex_=True)
    kmer = (hi.astype(np.int64) << 32) | lo.astype(np.int64)
    got = countjoin.count_join_stats(
        torch.from_numpy(kmer), torch.from_numpy(sid), amin, 999_999_999,
        n_banks=N, kmer_bits=42, simple=True, complex_=True,
    ).to_numpy()
    assert N >= SPLIT_MIN_BANKS and use_split_join(N)
    _assert_stats_match(got, count_join_split_ref(*args, **kw))
    _assert_stats_match(got, count_join_ref(*args, **kw))
    # wide segments: most k-mers in most samples
    assert int(got.shared_distinct.sum()) > 100 * int(got.nb_shared)
    for name in ("hellinger", "whittaker", "whittaker_s12",
                 "kullback_leibler"):
        assert getattr(got, name).any(), name


def _segment_rows(N: int, n_segs: int, cmax: int, seed: int):
    """Solid rows of n_segs k-mers in (k-mer, sample) order: singletons,
    full segments (every sample) and 2..N samples; counts in [1, cmax],
    one in 20 at cmax. Returns (kmer word, sid, count, lengths)."""
    rng = np.random.default_rng(seed)
    kind = rng.choice(3, size=n_segs, p=(0.1, 0.4, 0.5))
    kind[:2] = (0, 1)
    lens = np.where(kind == 0, N, np.where(
        kind == 1, 1, rng.integers(2, N + 1, size=n_segs)))
    sid = np.concatenate([np.sort(rng.choice(N, L, replace=False))
                          for L in lens])
    count = rng.integers(1, cmax + 1, size=sid.size)
    count[rng.random(sid.size) < 0.05] = cmax
    word = np.repeat(np.arange(n_segs, dtype=np.int64) * 7 + 3, lens)
    return word, sid.astype(np.int64), count.astype(np.int64), lens


def _abs_wrap32(p):
    low = np.mod(p, TWO32)
    return np.abs(np.where(low >= 2.0**31, low - TWO32, low)).astype(
        np.int64)


def _oracle(sid, count, lens, N):
    """Every pair channel by brute force: for each segment, each pair
    of its rows i < j (a = sid[i] < b = sid[j]), the reference's terms
    (SimkaAlgorithm.hpp) in numpy, added with np.add.at."""
    z = lambda dt=np.int64: np.zeros((N, N), dt)  # noqa: E731
    out = {k: z() for k in ("ab", "ba", "distinct", "bray", "hellinger",
                            "chord", "whittaker", "s12")}
    out["kl"] = z(np.float64)
    K = np.zeros(N, np.int64)
    np.add.at(K, sid, count)
    Kf = K.astype(np.float64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    for s0, L in zip(starts, lens):
        if L < 2:
            continue
        i, j = np.triu_indices(L, 1)
        a, b = sid[s0 + i], sid[s0 + j]
        ca, cb = count[s0 + i], count[s0 + j]
        assert (a < b).all()
        prod = ca * cb
        xY, yX = ca * Kf[b], cb * Kf[a]
        low = np.mod(np.mod(xY, TWO32) - np.mod(yX, TWO32), TWO32).astype(
            np.int64)
        den = xY + yX
        kl = (ca / np.maximum(Kf[a], 1.0) * np.log(2.0 * xY / den)
              + cb / np.maximum(Kf[b], 1.0) * np.log(2.0 * yX / den))
        for key, v in (("ab", ca), ("ba", cb), ("distinct", 1),
                       ("bray", np.minimum(ca, cb)),
                       ("hellinger", np.floor(np.sqrt(prod.astype(
                           np.float64))).astype(np.int64)),
                       ("chord", prod),
                       ("whittaker", np.abs(np.where(low >= 1 << 31,
                                                     low - (1 << 32), low))),
                       ("s12", _abs_wrap32(xY) + _abs_wrap32(yX)),
                       ("kl", kl)):
            np.add.at(out[key], (a, b), v)
    A = z()
    for j in range(N):
        np.add.at(A[:, j], sid, _abs_wrap32(count * Kf[j]))
    return out, K, A


@pytest.mark.parametrize("cmax", [(1 << 20) + 1, 1 << 22])
def test_pair_sums_at_n256_match_a_brute_force_oracle(cmax):
    """N = 256 (the reference has run N <= 128): every pair channel,
    the per-bank totals and Whittaker's all-rows sums, with counts past
    2^20 (Whittaker's products past 2^32 wrap)."""
    N = 256
    word, sid, count, lens = _segment_rows(N, 160, cmax, seed=cmax % 97)
    got = countjoin.stats_from_rows(
        (torch.from_numpy(word),), torch.from_numpy(sid),
        torch.from_numpy(count).to(torch.int32), n_banks=N, simple=True,
        complex_=True,
    ).to_numpy()
    want, K, A = _oracle(sid, count, lens, N)
    for field, key in (("shared_kmers_ab", "ab"), ("shared_kmers_ba", "ba"),
                       ("shared_distinct", "distinct"),
                       ("bray_numerator", "bray"), ("hellinger", "hellinger"),
                       ("whittaker", "whittaker"),
                       ("whittaker_s12", "s12")):
        np.testing.assert_array_equal(getattr(got, field), want[key],
                                      err_msg=field)
    np.testing.assert_array_equal(got.chord_ninj,
                                  want["chord"].astype(np.float64))
    np.testing.assert_allclose(got.kullback_leibler, want["kl"], rtol=1e-12,
                               atol=0)
    np.testing.assert_array_equal(got.whittaker_all, A)
    np.testing.assert_array_equal(got.solid_per_bank, K)
    np.testing.assert_array_equal(got.distinct_per_bank,
                                  np.bincount(sid, minlength=N))
    n2 = np.zeros(N, np.int64)
    np.add.at(n2, sid, count * count)
    np.testing.assert_array_equal(got.chord_n2_per_bank, n2)
    assert int(got.nb_distinct) == lens.size
    assert int(got.nb_shared) == int((lens >= 2).sum())
    assert int(got.max_count) == cmax
    # full segments, and Whittaker's double products past int32's wrap
    assert lens.max() == N and cmax * int(K.min()) > TWO32


def test_cli_at_n40_matches_the_split_pipeline(tmp_path):
    """scripts/synthetic50.py's community at N = 40 (>= SPLIT_MIN_BANKS)
    through the port's CLI and simka_tpu's run_simka (n_shards=1, its
    split join), k=31, every distance: the CSVs equal, Jensen-Shannon to
    one unit of its 6th decimal."""
    N = 40
    assert use_split_join(N)
    lines = []
    for s, reads in enumerate(make_datasets(N, 200)):
        path = tmp_path / f"S{s:03d}.fasta"
        path.write_bytes(b"".join(b">r\n" + r + b"\n" for r in reads))
        lines.append(f"S{s:03d}: {path}\n")
    inp = tmp_path / "input.txt"
    inp.write_text("".join(lines))
    port_out, ref_out = str(tmp_path / "port"), str(tmp_path / "ref")
    assert port_main([
        "-in", str(inp), "-out", port_out, "-kmer-size", "31",
        "-abundance-min", "2", "-simple-dist", "-complex-dist", "-verbose",
        "0", "-device", "cpu",
    ]) == 0
    run_ref(RefConfig(
        input_filename=str(inp), output_dir=ref_out, kmer_size=31,
        abundance_min=2, simple_dist=True, complex_dist=True, verbose=False,
        n_shards=1,
    ))
    (got_csv, got_m), (want_csv, want_m) = _outputs(port_out), _outputs(
        ref_out)
    _assert_csvs_match(got_csv, want_csv, 21)
    for key in ("repartition_histogram", "nb_distinct_kmers", "reads"):
        assert got_m[key] == want_m[key], key
    assert got_m["nb_distinct_kmers"] > 0


_ALL = list(range(13))  # the kernel's channels: 0-7, the KL limbs 8-12


@pytest.mark.parametrize("channels,slots,groups", [
    ([0, 1, 2, 3], 5, [[0, 1, 2, 3]]),
    (_ALL, 5, [[8, 9, 10, 11, 12], [0, 1, 2, 3, 4], [5, 6, 7]]),
    (_ALL, 7, [[8, 9, 10, 11, 12, 0, 1], [2, 3, 4, 5, 6, 7]]),
    (_ALL, 4, [[8, 9, 10, 11], [12, 0, 1, 2], [3, 4, 5, 6], [7]]),
    (_ALL, 13, [_ALL]),
    (list(range(6)), 1, [[c] for c in range(6)]),
    (_ALL, 0, [_ALL]),
])
def test_pair_groups(channels, slots, groups):
    """The kernel's launches: channel groups that fit one launch's
    shared partials, the KL limbs together where the slots allow, or
    every channel in one launch of the global form (slots 0)."""
    assert countjoin.pair_groups(channels, slots) == groups


def test_community_command_writes_the_wide_community(monkeypatch, capsys):
    """``python -m simka_tpu_torch.utils.community OUT_DIR --seed S``
    writes WIDE_COMMUNITY, the community of chip_smoke.py phase 14."""
    from simka_tpu_torch.utils import community

    calls = []
    monkeypatch.setattr(community, "write_community",
                        lambda out, **kw: calls.append((out, kw)) or "in.txt")
    assert community.main(["wide", "--seed", "3"]) == 0
    assert calls == [("wide", dict(seed=3, **community.WIDE_COMMUNITY))]
    assert capsys.readouterr().out == "in.txt\n"
    assert community.WIDE_COMMUNITY["n_samples"] == 100


def _pair_args(N, n_segs, cmax, seed, dev):
    word, sid, count, lens = _segment_rows(N, n_segs, cmax, seed)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    K = np.zeros(N, np.int64)
    np.add.at(K, sid, count)
    return tuple(torch.from_numpy(x).to(dev) for x in (
        sid, count, starts, lens, K.astype(np.float64)))


def _outputs_for(N, complex_, dev):
    names = countjoin.PAIR_CHANNELS if complex_ else (
        countjoin.PAIR_CHANNELS[:4])
    flat = {n: torch.zeros(N * N, dtype=torch.int64, device=dev)
            for n in names}
    kl = torch.zeros((N * N, 1 + countjoin.KL_FRAC_LIMBS), dtype=torch.int64,
                     device=dev)
    return flat, kl


def test_pair_sums_refuses_what_it_does_not_take():
    args = _pair_args(8, 20, 100, 0, "cpu")
    flat, kl = _outputs_for(8, True, "cpu")
    with pytest.raises(ValueError):  # int32 sample ids
        countjoin.pair_sums(args[0].to(torch.int32), *args[1:], flat, kl,
                            d_max=8)
    with pytest.raises(ValueError):  # a channel it does not know
        countjoin.pair_sums(*args, {**flat, "other": flat["ab"]}, kl,
                            d_max=8)
    with pytest.raises(ValueError):  # limbs of the wrong width
        countjoin.pair_sums(*args, flat, kl[:, :3], d_max=8)
    meta = tuple(t.to("meta") for t in args)
    mflat = {n: t.to("meta") for n, t in flat.items()}
    with pytest.raises(ValueError):  # neither the CPU nor CUDA
        countjoin.pair_sums(*meta, mflat, kl.to("meta"), d_max=8)
    before = countjoin.launches
    countjoin.pair_sums(*args, flat, kl, d_max=int(args[3].max()))
    assert countjoin.launches == before  # the CPU path launches nothing
    assert flat["distinct"].any() and kl.any()


@pytest.mark.cuda
@pytest.mark.parametrize("N", [8, 300])
@pytest.mark.parametrize("complex_", [False, True])
def test_kernel_matches_plain_on_cuda(N, complex_):
    """csrc/pair_sums.cu against the plain loop on the same CUDA rows:
    N = 8 shared partials in one launch, N = 300 the global form."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    args = _pair_args(N, 200, (1 << 31) - 1, N, "cuda")
    d_max = int(args[3].max())
    got, want = _outputs_for(N, complex_, "cuda"), _outputs_for(
        N, complex_, "cuda")
    before = countjoin.launches
    countjoin.pair_sums(*args, *got, d_max=d_max)
    countjoin._pair_sums_plain(*args, *want, d_max=d_max)
    torch.cuda.synchronize()
    assert countjoin.launches > before
    for name in got[0]:
        assert torch.equal(got[0][name], want[0][name]), name
    assert torch.equal(got[1], want[1])
