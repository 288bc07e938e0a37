"""The port's out-of-core hash-range sweep on the CPU.

Against the port's own in-memory join: for every spill tier (device,
host memory, disk) and R in {1, 3, 64} hash ranges, the folded JoinStats
equal count_join_stats field for field and bit for bit, chord and
Kullback-Leibler included, at k 21 and 63 with every channel and an
empty sample. Against simka_tpu (n_shards=1): the range of every k-mer,
the sweep over a RamSpill of the same spectra, and run_simka with
-out-tmp and -sweep-ranges or -max-memory 1 (the same sweep_ranges, the
CSVs equal; the Jensen-Shannon matrix to one unit of its last digit,
ROADMAP.md section 3). Then the routes: the mid-ingest restart past the
device plan, run_simka's up-front route and its estimate of k-mer
windows, and the -out-tmp ranges sized to the device plan. Inputs are
made from seeds with numpy (the community simulator or random k-mer
streams).
"""

import os

import numpy as np
import pytest
import torch

import simka_tpu.core.sweep as ref_sweep
from simka_tpu.config import SimkaConfig as RefConfig
from simka_tpu.core.pipeline import run_simka as run_ref
from simka_tpu_torch.cli import main as port_main
from simka_tpu_torch.config import SimkaConfig
from simka_tpu_torch.core import sweep
from simka_tpu_torch.core.pipeline import (
    compute_statistics,
    compute_statistics_out_of_core,
)
from simka_tpu_torch.io.dsl import parse_input_file
from simka_tpu_torch.io.packed import PackedReadSource
from simka_tpu_torch.ops.countjoin import count_join_stats
from simka_tpu_torch.ops.kmers import (
    from_uint32_words,
    n_uint32_words,
    uint32_words,
)
from simka_tpu_torch.ops.spectrum import count_spectrum, to_host
from simka_tpu_torch.utils.community import write_community
from test_torch_cli_channels import _assert_csvs_match
from test_torch_countjoin import _assert_stats_match
from test_torch_pipeline import _outputs

CPU = torch.device("cpu")
N_SAMPLES, EMPTY = 5, 2  # sample EMPTY has no instance
AMIN, AMAX = 2, 999_999_999


def _random_words(rng, k, n):
    """n random k-mers as the port's int64 words."""
    nw = -(-k // 31)
    top = 2 * k - 62 * (nw - 1)
    return tuple(
        torch.from_numpy(rng.integers(0, 1 << (top if i == 0 else 62), n,
                                      dtype=np.int64))
        for i in range(nw)
    )


@pytest.fixture(scope="module")
def streams():
    """k -> (words, sid) of an instance stream: 100 distinct k-mers at
    skewed frequencies over N_SAMPLES samples, none in sample EMPTY."""
    out = {}
    for k in (21, 63):
        rng = np.random.default_rng(k)
        table = _random_words(rng, k, 100)
        p = 1.0 / np.arange(1, 101)
        pick = torch.from_numpy(rng.choice(100, 6000, p=p / p.sum()))
        sid = rng.integers(0, N_SAMPLES - 1, 6000).astype(np.int32)
        sid[sid >= EMPTY] += 1
        out[k] = tuple(t[pick] for t in table), torch.from_numpy(sid)
    return out


def _spectra(words, sid, k):
    """Per sample (words, int32 counts) on the CPU (``ops.spectrum``)."""
    return [count_spectrum(tuple(w[sid == s] for w in words), k)
            for s in range(N_SAMPLES)]


def _spill(tier, n_ranges, k, spectra, tmp):
    if tier == "device":
        spill = sweep.DeviceSpill(n_ranges, k)
    elif tier == "ram":
        spill = sweep.RamSpill(n_ranges, k, CPU)
    else:
        spill = sweep.SpectrumSpill(str(tmp), n_ranges, k, CPU)
    for s, spectrum in enumerate(spectra):
        if tier == "device":
            spill.spill_sample(s, *spectrum)
        elif tier == "ram":  # as the out-of-core count spills
            spill.spill_parts(s, sweep.partition_on_device(
                *spectrum, k, n_ranges))
        else:  # host rows, as the -out-tmp path spills
            spill.spill_sample(s, *to_host(spectrum, k))
    return spill


def _global_solid(spectra):
    return sweep.filtered_solid_per_bank(
        [c.numpy() for _, c in spectra], AMIN, AMAX)


@pytest.mark.parametrize("k", [21, 31, 32, 63, 64])
def test_range_ids_match_reference(k):
    """One k-mer, one range in both packages: the host ids over the
    reference's uint32 words (with the extra word where 2k % 32 == 0)
    and the device ids over the port's int64 words."""
    rng = np.random.default_rng(k)
    words = _random_words(rng, k, 4000)
    words32 = tuple(w.numpy().astype(np.uint32)
                    for w in uint32_words(words, k))
    assert len(words32) == n_uint32_words(k)
    for w, back in zip(words, from_uint32_words(
            tuple(torch.from_numpy(w.astype(np.int64)) for w in words32), k)):
        assert torch.equal(w, back)
    for n_ranges in (1, 3, 64, 40_000):
        want = ref_sweep._range_of(words32, n_ranges)
        got = sweep._range_of(words32, n_ranges)
        assert got.dtype == np.min_scalar_type(n_ranges - 1)
        np.testing.assert_array_equal(got.astype(np.int64), want)
        np.testing.assert_array_equal(
            sweep.range_ids(words, k, n_ranges).numpy().astype(np.int64),
            want)


@pytest.mark.parametrize("k", [21, 63])
@pytest.mark.parametrize("n_ranges", [1, 3, 64])
@pytest.mark.parametrize("tier", ["device", "ram", "disk"])
def test_sweep_equals_in_memory_join(streams, tmp_path, tier, n_ranges, k):
    """Every JoinStats field bit for bit: the fold adds KL's fixed-point
    limbs and chord's int64 sum and converts once."""
    words, sid = streams[k]
    want = count_join_stats(words, sid, AMIN, AMAX, n_banks=N_SAMPLES,
                            kmer_bits=2 * k, simple=True,
                            complex_=True).to_numpy()
    spectra = _spectra(words, sid, k)
    assert spectra[EMPTY][1].shape[0] == 0
    spill = _spill(tier, n_ranges, k, spectra, tmp_path)
    got = sweep.sweep_join_stats(
        spill, N_SAMPLES, AMIN, AMAX, _global_solid(spectra), k=k,
        device=CPU, simple=True, complex_=True,
    ).to_numpy()
    for name in want._fields:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert g.tobytes() == w.tobytes(), name
    assert want.kullback_leibler.any() and want.whittaker_all.any()
    if n_ranges == 64:  # some ranges hold no row at all
        h = sweep._range_of(tuple(w.numpy().astype(np.uint32)
                                  for w in uint32_words(words, k)), n_ranges)
        assert len(np.unique(h)) < n_ranges
    if tier == "disk":
        assert len(os.listdir(tmp_path / "sweep")) == N_SAMPLES * n_ranges
        spill.cleanup()
        assert not (tmp_path / "sweep").exists()


@pytest.mark.parametrize("k", [21, 63])
def test_sweep_matches_reference_sweep(streams, k):
    """The same spectra through simka_tpu's RamSpill and
    sweep_join_stats: integer fields exact, chord and KL within the
    reference's own f32 error bound."""
    words, sid = streams[k]
    spectra = _spectra(words, sid, k)
    solid = _global_solid(spectra)
    port_spill = _spill("ram", 3, k, spectra, None)
    spill = ref_sweep.RamSpill(3)
    for s, spectrum in enumerate(spectra):
        spill.spill_sample(s, *to_host(spectrum, k))
    for r in range(3):  # the same rows in each range
        got_sid = port_spill.load_range(r, N_SAMPLES)[1].numpy()
        np.testing.assert_array_equal(got_sid,
                                      spill.load_range(r, N_SAMPLES)[1])
    got = sweep.sweep_join_stats(
        port_spill, N_SAMPLES, AMIN, AMAX, solid,
        k=k, device=CPU, simple=True, complex_=True,
    ).to_numpy()
    want = ref_sweep.sweep_join_stats(
        spill, N_SAMPLES, AMIN, AMAX, solid, simple=True, complex_=True,
        hi_bits=max(0, 2 * k - 32) if k <= 31 else 32, n_shards=1,
    )
    _assert_stats_match(got, type(want)(*(np.asarray(f) for f in want)))


def _reads(rng, n_reads, length=80):
    return [bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=length))
            for _ in range(n_reads)]


def test_restart_past_the_device_plan(monkeypatch):
    """compute_statistics on list providers with a 1 MB plan: the
    in-memory ingest trips its guard, the run restarts out-of-core
    (host-memory tier: lists carry no file sizes) over several ranges,
    and the statistics equal the in-memory run's bit for bit."""
    rng = np.random.default_rng(42)
    shared = _reads(rng, 120)
    samples = [shared[:80] + _reads(rng, 150), shared[40:] + _reads(rng, 150),
               shared[::2] + _reads(rng, 150), _reads(rng, 100)]
    ids = ["A", "B", "C", "D"]
    config = SimkaConfig(kmer_size=21, abundance_min=1, simple_dist=True,
                         complex_dist=True, verbose=False)
    want, mem = compute_statistics(samples, ids, config, CPU), {}
    compute_statistics(samples, ids, config, CPU, observer=mem)
    monkeypatch.setenv("SIMKA_TPU_HBM_MB", "1")
    lines, observer = [], {}
    got = compute_statistics(samples, ids, config, CPU, log=lines.append,
                             observer=observer)
    assert mem["route"] == "in-memory" and observer["route"] == "restart"
    assert any("restarting out-of-core" in m for m in lines), lines
    assert observer["sweep_ranges"] > 1 and observer["spill_tier"] == "ram"
    for name, value in want.__dict__.items():
        np.testing.assert_array_equal(getattr(got, name), value,
                                      err_msg=name)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    root = tmp_path_factory.mktemp("sweep_community")
    return write_community(str(root / "c"), seed=11, n_samples=3,
                           n_genomes=4, genome_len=3000, reads_per_sample=400,
                           n_frac=0.005, fastq_samples=1)


def _port(inp, out, *flags):
    assert port_main(["-in", inp, "-out", str(out), "-verbose", "0",
                      "-device", "cpu", "-simple-dist", "-complex-dist",
                      *flags]) == 0
    return _outputs(str(out))


@pytest.fixture(scope="module")
def small_mem(small, tmp_path_factory):
    """(CSVs, metrics) of the in-memory run of ``small``."""
    return _port(small, tmp_path_factory.mktemp("sweep_mem") / "mem")


def test_upfront_route_equals_in_memory(small, small_mem, tmp_path,
                                        monkeypatch):
    """run_simka with a 50 kB plan: the file-size estimate routes the
    run out-of-core before any ingest; byte-equal CSVs."""
    mem_csv, mem_m = small_mem
    monkeypatch.setenv("SIMKA_TPU_HBM_MB", "0.05")
    got_csv, got_m = _port(small, tmp_path / "ooc")
    assert mem_m["route"] == "in-memory" and "sweep_ranges" not in mem_m
    assert got_m["route"] == "up-front" and got_m["sweep_ranges"] > 1
    assert got_m["spectrum_rows"] == sum(
        s["rows"] for s in got_m["per_sample"])
    assert len(got_csv) == 21 and got_csv == mem_csv


@pytest.mark.parametrize("tier", ["device", "ram", "disk"])
def test_sample_emptied_by_the_read_filter(tmp_path, tier):
    """A first sample whose reads all fall to -min-read-size has no
    batch in the count stream: it still gets its (empty) spectrum, and
    each tier's statistics equal the in-memory run's at k=48."""
    inp = write_community(str(tmp_path / "c"), seed=1, n_samples=2,
                          n_genomes=2, genome_len=2000, reads_per_sample=200)
    rng = np.random.default_rng(0)
    short = tmp_path / "short.fasta"
    short.write_text("".join(
        ">s\n" + "".join(rng.choice(list("ACGT"), 40)) + "\n"
        for _ in range(50)))
    inp2 = tmp_path / "input.txt"
    inp2.write_text(f"E: {short}\n" + open(inp).read())
    datasets = parse_input_file(str(inp2))
    providers = [PackedReadSource(d.banks, 50) for d in datasets]
    ids = [d.id for d in datasets]
    config = SimkaConfig(kmer_size=48, min_read_size=50, simple_dist=True,
                         complex_dist=True, verbose=False,
                         output_tmp_dir=str(tmp_path / "tmp"))
    want = compute_statistics(providers, ids, config, CPU)
    observer = {}
    got = compute_statistics_out_of_core(providers, ids, config, CPU,
                                         observer=observer, tier=tier)
    assert observer["spill_tier"] == tier
    assert [s["rows"] == 0 for s in observer["per_sample"]] == [
        True, False, False]
    for name, value in want.__dict__.items():
        np.testing.assert_array_equal(getattr(got, name), value,
                                      err_msg=name)
    assert want.nb_distinct_kmers > 0


@pytest.mark.parametrize("flags,keep", [
    (["-sweep-ranges", "3"], False),
    (["-max-memory", "1"], True),
])
def test_out_tmp_sweep_matches_reference(small, small_mem, tmp_path, flags,
                                        keep):
    """-out-tmp with the sweep forced or past -max-memory: the port's
    CSVs equal its in-memory run's and simka_tpu's, with the same
    number of ranges; <tmp>/sweep/ stays only with -keep-tmp."""
    tmp = tmp_path / "tmp"
    got_csv, got_m = _port(small, tmp_path / "port", "-out-tmp", str(tmp),
                           *flags, *(["-keep-tmp"] if keep else []))
    assert got_csv == small_mem[0]
    ref_out = tmp_path / "ref"
    run_ref(RefConfig(
        input_filename=small, output_dir=str(ref_out),
        output_tmp_dir=str(tmp_path / "ref_tmp"), simple_dist=True,
        complex_dist=True, verbose=False, n_shards=1,
        sweep_ranges=int(flags[1]) if flags[0] == "-sweep-ranges" else 0,
        max_memory_mb=int(flags[1]) if flags[0] == "-max-memory" else 5000,
    ))
    ref_csv, ref_m = _outputs(str(ref_out))
    _assert_csvs_match(got_csv, ref_csv, 21)
    assert got_m["sweep_ranges"] == ref_m["sweep_ranges"] > 1
    for key in ("repartition_histogram", "nb_distinct_kmers", "reads"):
        assert got_m[key] == ref_m[key], key
    assert (tmp / "sweep").is_dir() == keep
    if keep:
        assert len(os.listdir(tmp / "sweep")) == 3 * got_m["sweep_ranges"]
    assert all("spill_s" in s for s in got_m["per_sample"])


@pytest.mark.parametrize("k", [21, 63])
def test_device_partition_equals_host_partition(streams, k):
    """A spectrum cut per range before its copy to the host gives the
    same parts, row for row, as its host copy cut on the host by the
    reference's range ids (a stable argsort of ``_range_of``)."""
    words, sid = streams[k]
    spectrum = count_spectrum(words, k)
    words32, counts = to_host(spectrum, k)
    rng = sweep._range_of(words32, 7)
    want = [(tuple(w[rng == r] for w in words32), counts[rng == r])
            for r in range(7)]
    got = sweep.partition_on_device(*spectrum, k, 7)
    assert len(got) == len(want) == 7
    for (gw, gc), (ww, wc) in zip(got, want):
        assert len(gw) == len(ww) == n_uint32_words(k)
        for g, w in zip((*gw, gc), (*ww, wc)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_out_tmp_ranges_fit_the_device_plan(small, small_mem, tmp_path,
                                            monkeypatch):
    """-max-memory above a 0.5 MB device plan: the spill rule fires on
    the plan, and the ranges are sized to it, not to -max-memory (which
    alone would give one range); the CSVs equal the in-memory run's."""
    from simka_tpu_torch.core.budget import spectrum_rows_budget

    monkeypatch.setenv("SIMKA_TPU_HBM_MB", "0.5")
    got_csv, got_m = _port(small, tmp_path / "port", "-out-tmp",
                           str(tmp_path / "tmp"), "-max-memory", "100000")
    assert got_csv == small_mem[0]
    assert sweep.choose_n_ranges(10**6, 2, 100000) == 1
    # the projection is the mean sample so far x 3 x 1.3
    least = min(s["rows"] for s in got_m["per_sample"]) * 3 * 1.3
    assert got_m["sweep_ranges"] >= least / spectrum_rows_budget(
        CPU, 1, None) > 1


def test_tier_refused_with_out_tmp(small, tmp_path):
    """A spill tier belongs to the in-memory command: with -out-tmp the
    spill is <tmp>/sweep/, and run_simka says so rather than ignore it."""
    from simka_tpu_torch.core.pipeline import run_simka

    with pytest.raises(ValueError, match="spill tier"):
        run_simka(SimkaConfig(input_filename=small,
                              output_dir=str(tmp_path / "o"),
                              output_tmp_dir=str(tmp_path / "t"),
                              verbose=False),
                  device="cpu", tier="ram")


def test_upfront_estimate_counts_windows(small, tmp_path, monkeypatch):
    """The up-front estimate counts k-mer windows, not bytes: at k=63
    a plan between the two keeps the run in memory (the byte count
    alone, simka_tpu's estimate, would route it out-of-core), with the
    CSVs of a run under the card's own plan."""
    from simka_tpu_torch.core.budget import (
        JOIN_WORKING_SET_FACTOR,
        estimate_total_instances,
    )

    datasets = parse_input_file(small)
    by_bytes = estimate_total_instances(datasets)
    windows = estimate_total_instances(datasets, 63)
    # the files fit the sample: exactly the windows of every read
    assert windows == sum(
        max(len(r) - 62, 0) for d in datasets for g in d.banks for f in g
        for r in _records(f))
    assert 0 < windows < by_bytes / 2
    want = _port(small, tmp_path / "want", "-kmer-size", "63")[0]
    plan_rows = (windows + by_bytes) // 2
    per_row = (3 * 8 + 4) * JOIN_WORKING_SET_FACTOR  # k=63: 3 int64 words
    monkeypatch.setenv("SIMKA_TPU_HBM_MB", str(plan_rows * per_row / 1e6))
    got, m = _port(small, tmp_path / "got", "-kmer-size", "63")
    assert m["route"] == "in-memory" and got == want


@pytest.mark.parametrize("fastq", [False, True])
def test_windows_per_byte_from_a_cut_sample(tmp_path, fastq):
    """A sample that cuts a record (FASTQ raises on one) still gives the
    windows per byte of the whole file, to 1%."""
    from simka_tpu_torch.io.bank import windows_per_byte

    write_community(str(tmp_path), seed=5, n_samples=1, n_genomes=2,
                    genome_len=5000, reads_per_sample=2000,
                    fastq_samples=int(fastq))
    (path,) = (str(p) for p in tmp_path.glob("S0.*"))
    size = os.path.getsize(path)
    exact = sum(max(len(r) - 20, 0) for r in _records(path)) / size
    assert size > 1 << 14
    assert windows_per_byte(path, 21, 1 << 22) == pytest.approx(exact,
                                                                rel=1e-12)
    assert windows_per_byte(path, 21, 1 << 14) == pytest.approx(exact,
                                                                rel=0.01)


def _records(path):
    from simka_tpu_torch.io.bank import iter_sequences

    return list(iter_sequences(path))
