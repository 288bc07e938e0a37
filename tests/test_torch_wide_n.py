"""The wide-N exact path on the CPU, where the pair sums run their plain
torch version (``ops.countjoin._pair_sums_plain``): the port's
count_join_stats at N = 100 against simka_tpu's split join
(``count_join_stats_split``, which its pipeline takes from
SPLIT_MIN_BANKS = 33 samples) and its direct join; the pair sums at
N = 256, past any N the reference has run (VERDICT.md), against a
brute-force numpy oracle of every pair channel; the port's CLI at
N = 40 against simka_tpu's run_simka (n_shards=1: the split path); the
kernel's plan; Whittaker's all-rows sums of the plain pair_sums
against simka_tpu's _whittaker_all_banks; and, on the card only, the
kernel of ``csrc/pair_sums.cu`` against its plain version.

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
from simka_tpu.ops.countjoin import (SPLIT_MIN_BANKS, _whittaker_all_banks,
                                     use_split_join)
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


def _plan_ok(plan, N, budget):
    """A shared plan's groups and warp ranges tile [0, N) in order, and
    its partials fit the budget."""
    g = plan.groups
    assert g[0] == 0 and g[-1] == N and all(a < b for a, b in zip(g, g[1:]))
    assert len(plan.warp_bounds) == len(g) - 1
    for lo, hi, wb in zip(g, g[1:], plan.warp_bounds):
        assert len(wb) == plan.team_warps + 1
        assert wb[0] == lo and wb[-1] == hi
        assert all(a <= b for a, b in zip(wb, wb[1:]))
    assert countjoin.PAIR_WARPS % plan.team_warps == 0
    assert 0 < plan.smem <= budget


@pytest.mark.parametrize("N,n_slots,wall,budget,d_max,groups,team_warps", [
    # phase 7's N = 8: a private copy a warp
    (8, 4, False, 214_000, 8, (0, 8), 1),
    (8, 13, True, 207_648, 8, (0, 8), 1),
    # N = 33: two copies (every channel) or eight (default)
    (33, 4, False, 214_000, 33, (0, 33), 2),
    (33, 13, True, 207_328, 33, (0, 33), 8),
    # N = 100: one copy (default), two and three sample groups
    (100, 4, False, 214_736, 49, (0, 100), 16),
    (100, 6, False, 214_736, 49, (0, 30, 100), 16),
    (100, 13, True, 206_544, 49, (0, 20, 46, 100), 16),
    (256, 4, False, 212_864, 256, (0, 27, 58, 94, 142, 256), 16),
    # the global form: past PAIR_MAX_GROUPS groups, past a chunk, no
    # shared memory
    (300, 13, True, 204_144, 300, (), 0),
    (2000, 4, False, 200_000, 30, (), 0),
    (100, 4, False, 0, 49, (), 0),
    (100, 4, False, 214_736, 2000, (), 0),
])
def test_pair_plan(N, n_slots, wall, budget, d_max, groups, team_warps):
    """The kernel's plan from N, the channels and a CTA's shared bytes:
    as many copies of the partials as fit, else the fewest sample
    groups of equal bytes that fit, else the global form (every add
    into device memory)."""
    plan = countjoin.pair_plan(N, n_slots, wall, budget, d_max)
    assert (plan.groups, plan.team_warps) == (groups, team_warps)
    if groups:
        assert plan.form == "shared"
        _plan_ok(plan, N, budget)
        per = [8 * (n_slots * (N - 1 - a) + N * wall) for a in range(N)]
        copies = countjoin.PAIR_WARPS // team_warps
        assert plan.smem == copies * max(
            sum(per[lo:hi]) for lo, hi in zip(groups, groups[1:]))
    else:
        assert plan == countjoin.GLOBAL_PLAN


@pytest.mark.parametrize("budget,form", [
    (206_544, "shared"),
    # what the library returns where the row stage and K alone fill a
    # CTA's shared memory (N >= 16,630 on an H100): the global form
    (0, "global"),
    (-1, None),  # the device could not be read
])
def test_cuda_path_plans_from_the_librarys_budget(monkeypatch, budget, form):
    """``_pair_sums_cuda`` plans with the budget the library gives: a
    budget of 0 takes the global form, only -1 raises."""
    import contextlib

    from simka_tpu_torch.ops import _kernels

    class Lib:
        def simka_pair_sums_budget(self, n_banks, kl):
            return budget

    planned = []
    monkeypatch.setattr(_kernels, "lib", Lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(countjoin, "_launch_pair_sums",
                        lambda *args: planned.append(args[-1]))
    args = _pair_args(100, 50, 100, 0, "cpu")
    flat, kl = _outputs_for(100, True, "cpu")
    wall = torch.zeros(100 * 100, dtype=torch.int64)
    call = lambda: countjoin._pair_sums_cuda(  # noqa: E731
        *args, flat, kl, wall, d_max=int(args[3].max()))
    if form is None:
        with pytest.raises(RuntimeError):
            call()
        assert planned == []
    else:
        call()
        assert [p.form for p in planned] == [form]


@pytest.mark.parametrize("N", [2, 8, 33, 100])
@pytest.mark.parametrize("cmax", [1 << 20, (1 << 31) - 1])
def test_plain_whittaker_all_matches_the_reference(N, cmax):
    """pair_sums' whittaker_all output (the plain version on the CPU)
    against simka_tpu's _whittaker_all_banks (JAX on the CPU) and the
    port's _whittaker_all: every row's |int32(u64(c K_j))|, with counts
    up to 2^31 - 1, where c K_j passes 2^53 and 2^63."""
    word, sid, count, lens = _segment_rows(N, 3000 // N + 20, cmax, seed=N)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    K = np.zeros(N, np.int64)
    np.add.at(K, sid, count)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))  # noqa: E731
    flat, kl = _outputs_for(N, False, "cpu")
    wall = torch.zeros(N * N, dtype=torch.int64)
    countjoin.pair_sums(t(sid), t(count), t(starts), t(lens),
                        t(K.astype(np.float64)), flat, kl,
                        d_max=int(lens.max()), whittaker_all=wall)
    ref = np.asarray(_whittaker_all_banks(
        jnp.asarray(sid.astype(np.int32)), jnp.asarray(count.astype(np.int32)),
        jnp.asarray(K), n_banks=N))
    np.testing.assert_array_equal(wall.view(N, N).numpy(), ref)
    np.testing.assert_array_equal(
        wall.view(N, N).numpy(),
        countjoin._whittaker_all(t(sid), t(count), t(K), N).numpy())
    if cmax > 1 << 20:
        assert count.max() * float(K.max()) > 2.0**63
    assert ref.any()


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
    with pytest.raises(ValueError):  # half of the simple pair
        countjoin.pair_sums(*args, {k: v for k, v in flat.items()
                                    if k != "chord"}, kl, d_max=8)
    with pytest.raises(ValueError):  # limbs of the wrong width
        countjoin.pair_sums(*args, flat, kl[:, :3], d_max=8)
    wall = torch.zeros(64, dtype=torch.int64)
    with pytest.raises(ValueError):  # whittaker_all of the wrong shape
        countjoin.pair_sums(*args, flat, kl, d_max=8,
                            whittaker_all=wall.view(8, 8))
    with pytest.raises(ValueError):  # whittaker_all of the wrong dtype
        countjoin.pair_sums(*args, flat, kl, d_max=8,
                            whittaker_all=wall.to(torch.int32))
    meta = tuple(t.to("meta") for t in args)
    mflat = {n: t.to("meta") for n, t in flat.items()}
    with pytest.raises(ValueError):  # neither the CPU nor CUDA
        countjoin.pair_sums(*meta, mflat, kl.to("meta"), d_max=8)
    before = countjoin.launches
    countjoin.pair_sums(*args, flat, kl, d_max=int(args[3].max()),
                        whittaker_all=wall)
    assert countjoin.launches == before  # the CPU path launches nothing
    assert flat["distinct"].any() and kl.any() and wall.any()


@pytest.mark.cuda
@pytest.mark.parametrize("N", [8, 100, 300])
@pytest.mark.parametrize("complex_", [False, True])
def test_kernel_matches_plain_on_cuda(N, complex_):
    """csrc/pair_sums.cu against the plain version on the same CUDA rows,
    in one launch: N = 8 a private copy a warp, N = 100 one copy
    (default) or three sample groups (every channel with
    whittaker_all), N = 300 sample groups (default) or the global form
    (every channel)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    args = _pair_args(N, 200, (1 << 31) - 1, N, "cuda")
    d_max = int(args[3].max())
    got, want = _outputs_for(N, complex_, "cuda"), _outputs_for(
        N, complex_, "cuda")
    walls = [torch.zeros(N * N, dtype=torch.int64, device="cuda")
             if complex_ else None for _ in range(2)]
    before = countjoin.launches
    countjoin.pair_sums(*args, *got, d_max=d_max, whittaker_all=walls[0])
    countjoin._pair_sums_plain(*args, *want, d_max=d_max,
                               whittaker_all=walls[1])
    torch.cuda.synchronize()
    assert countjoin.launches == before + 1
    for name in got[0]:
        assert torch.equal(got[0][name], want[0][name]), name
    assert torch.equal(got[1], want[1])
    if complex_:
        assert torch.equal(walls[0], walls[1]) and walls[0].any()
