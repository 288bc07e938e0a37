"""The port's hash-space shards (simka_tpu_torch.parallel.sharded) on
repeated CPU devices, against simka_tpu's sharded path on its virtual
8-device CPU mesh (tests/conftest.py) and against the port's one-device
run, on inputs made from seeds with numpy or the community simulator.

- Every k-mer lands on the shard simka_tpu's shard_instances_by_hash
  gives it (k 21, 33 and 63).
- compute_statistics over [cpu] * n, n in {2, 3, 4, 8}, every distance:
  the statistics equal the port's one-device run bit for bit, floats
  included, and simka_tpu's compute_statistics with n_shards=n in every
  integer field; chord within 1e-6 and Kullback-Leibler within 8192 x
  2^-24 relative, simka_tpu's f32 panel sums (ROADMAP.md section 3).
- The per-bank solid totals are summed over the shards before any pair
  term reads them: with shards whose totals differ, the sharded join
  equals the one-device join, and a join that gave each shard its own
  totals does not.
- Through the CLI with -n-shards: the Shannon filter, the -out-tmp
  join, the sweep (forced, and up front past a tiny device plan), the
  CSVs equal simka_tpu's (the Jensen-Shannon matrix to one unit of its
  last digit).
"""

import numpy as np
import pytest
import torch

from simka_tpu.config import SimkaConfig as RefConfig
from simka_tpu.core.pipeline import compute_statistics as ref_statistics
from simka_tpu.io.packed import PackedReadSource as RefSource
from simka_tpu.parallel.sharded import (
    shard_instances_by_hash as ref_shard_instances,
)
from simka_tpu_torch.cli import main as port_main
from simka_tpu_torch.config import SimkaConfig
from simka_tpu_torch.core.pipeline import compute_statistics
from simka_tpu_torch.io.dsl import parse_input_file
from simka_tpu_torch.io.packed import PackedReadSource
from simka_tpu_torch.ops import countjoin
from simka_tpu_torch.ops.kmers import uint32_words
from simka_tpu_torch.parallel import sharded
from simka_tpu_torch.utils.community import write_community
from test_torch_cli_channels import _assert_csvs_match
from test_torch_pipeline import _outputs
from test_torch_sweep import _random_words

CPU = torch.device("cpu")
# simka_tpu's float sums (ROADMAP.md section 3; test_torch_countjoin.py)
REF_RTOL = {"chord_ninj": 1e-6, "kullback_leibler": 8192 * 2.0**-24}
STAT_FIELDS = ("nb_distinct_kmers", "nb_shared_kmers", "dataset_nb_reads",
               "distinct_per_bank", "solid_per_bank", "chord_n2_per_bank",
               "shared_kmers", "shared_distinct", "bray_numerator",
               "chord_ninj", "hellinger", "whittaker", "kullback_leibler")


@pytest.fixture(scope="module")
def communities(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded")
    return {
        "plain": write_community(
            str(root / "plain"), seed=11, n_samples=5, n_genomes=4,
            genome_len=3000, reads_per_sample=300, n_frac=0.005,
            fastq_samples=1),
        "motif": write_community(
            str(root / "motif"), seed=12, n_samples=4, n_genomes=5,
            genome_len=3000, reads_per_sample=300, n_frac=0.005,
            motif_genomes=2),
    }


@pytest.mark.parametrize("k", [21, 33, 63])
def test_shard_of_every_kmer_matches_reference(k):
    rng = np.random.default_rng(k)
    words = _random_words(rng, k, 5000)
    sid = torch.from_numpy(rng.integers(0, 7, 5000).astype(np.int32))
    words32 = tuple(w.numpy().astype(np.uint32)
                    for w in uint32_words(words, k))
    for n in (2, 3, 8):
        ref_words, ref_sid = ref_shard_instances(words32, sid.numpy(), n,
                                                 pad_multiple=1)
        got = sharded.shard_instances_by_hash(words, sid, k, [CPU] * n)
        assert sum(g[1].shape[0] for g in got) == 5000
        for s, (w, i) in enumerate(got):
            real = ref_words[0][s] != 0xFFFFFFFF  # the reference's padding
            m = int(real.sum())
            assert real[:m].all() and w[0].shape[0] == m, (k, n, s)
            np.testing.assert_array_equal(i.numpy(), ref_sid[s][:m])
            for a, b in zip(uint32_words(w, k), ref_words):
                np.testing.assert_array_equal(
                    a.numpy().astype(np.uint32), b[s][:m])


def _assert_same_statistics(got, want, rtol=None):
    for name in STAT_FIELDS:
        g, w = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        if rtol and name in rtol:
            np.testing.assert_allclose(g, w, rtol=rtol[name], atol=0,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_compute_statistics_matches_reference_and_one_device(communities, n):
    datasets = parse_input_file(communities["plain"])
    ids = [d.id for d in datasets]
    kw = dict(input_filename=communities["plain"], kmer_size=21,
              abundance_min=2, simple_dist=True, complex_dist=True,
              verbose=False)
    one = compute_statistics([PackedReadSource(d.banks) for d in datasets],
                             ids, SimkaConfig(**kw), CPU)
    observer = {}
    got = compute_statistics([PackedReadSource(d.banks) for d in datasets],
                             ids, SimkaConfig(**kw), CPU, observer=observer,
                             shards=[CPU] * n)
    assert observer["route"] == "in-memory"
    rows = observer["repartition_instances"]
    assert len(rows) == n and (rows > 0).all()
    _assert_same_statistics(got, one)
    ref = ref_statistics([RefSource(d.banks) for d in datasets], ids,
                         RefConfig(n_shards=n, **kw))
    _assert_same_statistics(got, ref, REF_RTOL)
    assert got.kullback_leibler.any() and got.whittaker.any()


def test_complex_dist_reads_the_global_solid_totals():
    """Three shards of one instance stream whose per-bank solid totals
    differ from shard to shard: the sharded join equals the one-device
    join in every field, and the order is what makes it so -- each
    shard's pair terms with its own totals give other Whittaker and
    Kullback-Leibler sums."""
    rng = np.random.default_rng(5)
    k, n_banks, n = 21, 6, 3
    table = _random_words(rng, k, 400)
    pick = torch.from_numpy(rng.integers(0, 400, 20_000))
    words = tuple(t[pick] for t in table)
    sid = torch.from_numpy(rng.integers(0, n_banks, 20_000).astype(np.int32))
    kw = dict(n_banks=n_banks, kmer_bits=2 * k, simple=True, complex_=True)
    want = countjoin.count_join_stats(words, sid, 2, 999, **kw).to_numpy()
    shards = sharded.shard_instances_by_hash(words, sid, k, [CPU] * n)
    got = sharded.sharded_count_join_stats(shards, 2, 999, **kw).to_numpy()
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    # the shards' own totals differ from each other and from the whole's
    rows = [countjoin.solid_rows(w, s, 2, 999, n_banks=n_banks,
                                 kmer_bits=2 * k) for w, s in shards]
    own = [np.bincount(r[1].numpy(), weights=r[2].numpy(),
                       minlength=n_banks) for r in rows]
    assert len({tuple(t) for t in own}) == n
    assert not np.array_equal(own[0], want.solid_per_bank)
    # one pass a shard with its own totals: the default channels agree,
    # Whittaker's and KL's do not
    total = None
    for r in rows:
        raw = countjoin._raw_stats_from_rows(
            *r, n_banks=n_banks, simple=True, complex_=True)
        total = raw if total is None else countjoin._add_raw(total, raw)
    one_pass = countjoin._finish(total, True).to_numpy()
    np.testing.assert_array_equal(one_pass.bray_numerator,
                                  want.bray_numerator)
    assert not np.array_equal(one_pass.whittaker_all, want.whittaker_all)
    assert not np.array_equal(one_pass.kullback_leibler,
                              want.kullback_leibler)


def test_restart_past_the_plan_keeps_the_shards(communities, monkeypatch):
    """A device that holds both shards outgrows its plan mid-ingest (the
    plan counts every shard it holds): the gathered batches are dropped
    and the run restarts out of core, its sweep over the same shards,
    with the one-device statistics."""
    datasets = parse_input_file(communities["plain"])
    ids = [d.id for d in datasets]
    config = SimkaConfig(input_filename=communities["plain"],
                         simple_dist=True, complex_dist=True, verbose=False)
    one = compute_statistics([PackedReadSource(d.banks) for d in datasets],
                             ids, config, CPU)
    observer, swept = {}, []
    real_sweep = sharded.raw_sharded_join_from_spectra
    monkeypatch.setattr(sharded, "raw_sharded_join_from_spectra",
                        lambda parts, *a, **kw: swept.append(len(parts))
                        or real_sweep(parts, *a, **kw))
    # 53,333 instance rows a device (12 B a row x 8): the 5 samples hold
    # about 120,000 windows, so the device holding both shards passes it
    monkeypatch.setenv("SIMKA_TPU_HBM_MB", "5.12")
    got = compute_statistics([PackedReadSource(d.banks) for d in datasets],
                             ids, config, CPU, observer=observer,
                             shards=[CPU] * 2)
    assert observer["route"] == "restart" and observer["sweep_ranges"] > 1
    assert swept and set(swept) == {2}
    _assert_same_statistics(got, one)


def test_shard_devices_rule(monkeypatch):
    """The reference's rule: n_shards or the device count, sharded only
    when n > 1 devices exist; on the CPU, n copies of it."""
    assert sharded.shard_devices(0, CPU) == [CPU]
    assert sharded.shard_devices(1, CPU) == [CPU]
    assert sharded.shard_devices(3, CPU) == [CPU] * 3
    cuda0 = torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert sharded.shard_devices(0, cuda0) == [cuda0]
    assert sharded.shard_devices(2, cuda0) == [cuda0]  # too few cards
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert sharded.shard_devices(0, cuda0) == [
        torch.device("cuda", i) for i in range(4)]
    assert sharded.shard_devices(2, cuda0) == [
        torch.device("cuda", i) for i in range(2)]
    with pytest.raises(ValueError):
        sharded.check_shards(["cpu", "cuda:0"], CPU)


@pytest.mark.parametrize("case", [
    "default", "shannon", "out-tmp", "out-tmp-sweep", "up-front"])
def test_cli_sharded_matches_reference(communities, tmp_path, monkeypatch,
                                       case):
    """-n-shards through both CLIs: in memory with the k-mer Shannon
    filter at k=63, the -out-tmp join, the -out-tmp sweep with every
    distance, and the in-memory command past a tiny device plan
    (SIMKA_TPU_HBM_MB), which the port takes out of core up front and
    sweeps over the shards."""
    inp, n, flags = communities["plain"], 3, []
    if case == "shannon":
        inp, n = communities["motif"], 4
        flags = ["-kmer-size", "63", "-kmer-shannon-index", "1.5"]
    elif case == "out-tmp":
        n, flags = 2, ["-out-tmp", "TMP"]
    elif case == "out-tmp-sweep":
        flags = ["-out-tmp", "TMP", "-sweep-ranges", "3", "-simple-dist",
                 "-complex-dist"]
    outs = {}
    for side in ("port", "ref"):
        out = str(tmp_path / side)
        argv = ["-in", inp, "-out", out, "-verbose", "0", "-n-shards", str(n),
                *[str(tmp_path / f"{side}_tmp") if f == "TMP" else f
                  for f in flags]]
        if side == "port":
            if case == "up-front":
                monkeypatch.setenv("SIMKA_TPU_HBM_MB", "0.05")
            assert port_main([*argv, "-device", "cpu"]) == 0
            monkeypatch.delenv("SIMKA_TPU_HBM_MB", raising=False)
        else:
            from simka_tpu.cli import main as ref_main

            assert ref_main(argv) == 0
        outs[side] = _outputs(out)
    (got, got_m), (want, _) = outs["port"], outs["ref"]
    _assert_csvs_match(got, want, 21 if "-complex-dist" in flags else 15)
    assert got_m["n_shards"] == n
    if case == "up-front":
        assert got_m["route"] == "up-front" and got_m["sweep_ranges"] > 1
    if case == "out-tmp-sweep":
        assert got_m["sweep_ranges"] == 3


def test_run_simka_shards_argument_matches_one_device(communities, tmp_path):
    """run_simka(shards=...) on repeated devices (as chip_smoke.py runs
    [cuda:0] x n) against its one-device run, byte for byte."""
    from simka_tpu_torch.core.pipeline import run_simka

    outs = []
    for shards in (None, ["cpu"] * 2, [CPU] * 5):
        out = str(tmp_path / f"s{0 if shards is None else len(shards)}")
        run_simka(SimkaConfig(input_filename=communities["plain"],
                              output_dir=out, verbose=False),
                  device="cpu", shards=shards)
        outs.append(_outputs(out))
    assert outs[0][0] == outs[1][0] == outs[2][0]
    assert [m["n_shards"] for _, m in outs] == [1, 2, 5]
    assert len(outs[2][1]["repartition_histogram"]) == 5


def test_spectrum_rows_budget_over_shards(monkeypatch):
    """The out-of-core plan over a shard list, against simka_tpu's
    spectrum_rows_budget with its mesh's shard count (a k=21 row is 16
    bytes in both packages): distinct devices add their plans, a device
    repeated n times plans as one, a device holding m of n shards
    serves n/m times its plan and the list plans with the least of
    those, and -max-memory caps the whole range."""
    import simka_tpu.core.budget as ref_budget
    from simka_tpu_torch.core.budget import spectrum_rows_budget

    a, b = torch.device("cpu", 0), torch.device("cpu", 1)
    for hbm in ("0.5", "3", "80000"):
        monkeypatch.setenv("SIMKA_TPU_HBM_MB", hbm)
        plan = int(float(hbm) * 1_000_000)  # bytes a device
        assert spectrum_rows_budget([a, b, b], 1, None) == (
            plan * 3 // 2 // 128)
        assert spectrum_rows_budget([a, b, b, a], 1, None) == (
            2 * plan // 128)
        for mm in (1, 2, 100, 5000, None):
            cap = 10**9 if mm is None else mm
            assert spectrum_rows_budget([a, b], 1, mm) == (
                ref_budget.spectrum_rows_budget(2, cap, 2))
            for repeated in ([CPU] * 3, [a, a]):
                assert spectrum_rows_budget(repeated, 1, mm) == (
                    spectrum_rows_budget(CPU, 1, mm)) == (
                    ref_budget.spectrum_rows_budget(2, cap, 1))
    # 3 MB a device, capped at 4 MB: the pair plans 4 MB, not 6
    monkeypatch.setenv("SIMKA_TPU_HBM_MB", "3")
    assert spectrum_rows_budget([a, b], 1, 4) == 4_000_000 // 128 < (
        spectrum_rows_budget([a, b], 1, None)) == 2 * 3_000_000 // 128


@pytest.mark.parametrize("route", ["up-front", "out-tmp"])
def test_distinct_devices_stage_within_one_device_plan(
        communities, tmp_path, monkeypatch, route):
    """Shards on distinct devices (cpu:0 and cpu:1, two devices to the
    plan, tensors on the one CPU): every plan doubles, so the sweep's
    range count is the reference's rule over both devices (simka_tpu's
    HBM plan times the mesh's shards: up front, the projected rows over
    simka_tpu's spectrum_rows_budget; with -out-tmp, simka_tpu's own
    run with -n-shards 2 where -max-memory binds both); each range is
    staged from the host over the shards in chunks of one device's
    plan, so no device stages more than its plan plus one chunk, and
    the CSVs equal the one-device run's."""
    import simka_tpu.core.budget as ref_budget
    from simka_tpu_torch.core.budget import (
        estimate_total_instances,
        instance_rows_budget,
        spectrum_rows_budget,
    )
    from simka_tpu_torch.core.pipeline import run_simka

    two = [torch.device("cpu", 0), torch.device("cpu", 1)]
    monkeypatch.setenv("SIMKA_TPU_HBM_MB", "0.5")
    assert instance_rows_budget(two, 1) == 2 * instance_rows_budget(CPU, 1)
    plan = spectrum_rows_budget(CPU, 1, None)  # one device's, k=21 rows
    assert spectrum_rows_budget(two, 1, None) == 2 * plan
    real_split, real_stage = sharded.shard_rows_by_hash, sharded.stage_rows_by_hash
    # -max-memory 1 (MB) equals the pair's plan, so the reference's
    # -out-tmp count (from -max-memory alone) is the port's too
    mm = ["-max-memory", "1"] if route == "out-tmp" else []
    outs = {}
    for name, shards in (("one", None), ("two", two)):
        chunks, staged = [], []

        def split(w, s, c, k, d):
            chunks.append(s.shape[0])
            return real_split(w, s, c, k, d)

        def stage(rows, k, devices, device):
            parts = real_stage(rows, k, devices, device)
            staged.append([(d, p[1].shape[0])
                           for d, p in zip(devices, parts)])
            return parts

        monkeypatch.setattr(sharded, "shard_rows_by_hash", split)
        monkeypatch.setattr(sharded, "stage_rows_by_hash", stage)
        out = str(tmp_path / name)
        argv = ["-in", communities["plain"], "-out", out, "-verbose", "0",
                "-simple-dist", "-complex-dist", *mm]
        if route == "out-tmp":
            argv += ["-out-tmp", str(tmp_path / f"{name}_tmp")]
        from simka_tpu_torch.cli import parse_simka_args

        run_simka(parse_simka_args(argv)[1], device="cpu", shards=shards,
                  tier="ram" if route == "up-front" and shards is None
                  else None)
        outs[name] = (*_outputs(out), chunks, staged)
    (one, one_m, _, _), (got, got_m, chunks, staged) = (
        outs["one"], outs["two"])
    assert got == one and got_m["n_shards"] == 2
    ranges = got_m["sweep_ranges"]
    assert 1 < ranges < one_m["sweep_ranges"] and len(staged) == ranges
    # every row staged once, each device's part within its own plan,
    # each chunk within one device's plan, some range in several chunks
    assert sum(r for parts in staged for _, r in parts) == got_m[
        "spectrum_rows"]
    assert {d for parts in staged for d, _ in parts} == set(two)
    assert max(r for parts in staged for _, r in parts) <= plan
    assert max(chunks) <= plan
    # up front the ranges are provisioned from the instance estimate,
    # which the distinct rows fall well below: one chunk a range
    assert len(chunks) == ranges if route == "up-front" else (
        len(chunks) > ranges)
    if route == "up-front":
        assert got_m["route"] == "up-front" and got_m["spill_tier"] == "ram"
        datasets = parse_input_file(communities["plain"])
        projected = max(int(got_m["per_sample"][0]["rows"] * 5 * 1.3),
                        estimate_total_instances(datasets, 21))
        assert ranges == -(-projected // ref_budget.spectrum_rows_budget(
            2, 5000, 2)) == -(-one_m["sweep_ranges"] // 2)
        with pytest.raises(ValueError, match="every shard"):
            run_simka(SimkaConfig(input_filename=communities["plain"],
                                  output_dir=str(tmp_path / "dev"),
                                  verbose=False),
                      device="cpu", shards=two, tier="device")
    else:
        from simka_tpu.cli import main as ref_main

        assert got_m["memory_budget_bytes"] == 2 * one_m[
            "memory_budget_bytes"] == 1_000_000
        ref_out = str(tmp_path / "ref")
        assert ref_main(["-in", communities["plain"], "-out", ref_out,
                         "-verbose", "0", "-n-shards", "2", *mm,
                         "-out-tmp", str(tmp_path / "ref_tmp")]) == 0
        assert ranges == _outputs(ref_out)[1]["sweep_ranges"]
        # the -out-tmp join without a sweep: the spectra's rows between
        # one device's plan and the pair's, staged in chunks
        rows = one_m["spectrum_rows"]
        monkeypatch.setenv("SIMKA_TPU_HBM_MB", str(rows * 128 * 0.75 / 1e6))
        plan = spectrum_rows_budget(CPU, 1, None)
        chunks.clear()
        staged.clear()
        out = str(tmp_path / "join")
        run_simka(SimkaConfig(input_filename=communities["plain"],
                              output_dir=out, verbose=False,
                              simple_dist=True, complex_dist=True,
                              output_tmp_dir=str(tmp_path / "join_tmp")),
                  device="cpu", shards=two)
        got, got_m = _outputs(out)
        assert got == one and "sweep_ranges" not in got_m
        assert plan < rows <= 2 * plan and len(staged) == 1
        assert len(chunks) == 2 and max(chunks) <= plan
        assert [d for d, _ in staged[0]] == two
        assert max(r for _, r in staged[0]) <= plan
