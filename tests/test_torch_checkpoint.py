"""The port's -out-tmp checkpoint path on the CPU, against its own
in-memory run and simka_tpu.run_simka(output_tmp_dir=..., n_shards=1)
on the same community files: CSVs byte-equal (against simka_tpu the
Jensen-Shannon matrix to one unit of its 6th decimal, as in
test_torch_cli_channels.py) and the metrics counters equal. Then:
resume, checkpoints written by either package loaded by the other,
recounts where the count key changes, adding a dataset, -keep-tmp, the
reference's spill rule into the sweep, a sample left empty by the read
filter, the checkpoint files field for field against simka_tpu's, and
which count failures are retried."""

import glob
import os
import shutil

import numpy as np
import pytest
import torch

from simka_tpu.config import SimkaConfig as RefConfig
from simka_tpu.core.checkpoint import CountCheckpoint as RefCheckpoint
from simka_tpu.core.pipeline import count_one_dataset as ref_count_one
from simka_tpu.core.pipeline import run_simka as run_ref
from simka_tpu_torch.cli import main as port_main
from simka_tpu_torch.config import SimkaConfig
from simka_tpu_torch.core.checkpoint import CountCheckpoint
from simka_tpu_torch.core.pipeline import count_one_dataset
from simka_tpu_torch.io.dsl import parse_input_file
from simka_tpu_torch.utils.community import write_community
from test_torch_cli_channels import _assert_csvs_match
from test_torch_pipeline import _outputs, community  # noqa: F401 (fixture)

DISTANCES = ["-simple-dist", "-complex-dist"]
# simka_metrics.json counters of the checkpoint path in both packages
COUNTERS = ("datasets_resumed", "kmer_instances", "reads",
            "repartition_histogram", "nb_distinct_kmers", "n_datasets")
CASES = [(3, 21), (3, 63), (16, 21), (16, 63)]


def _port(inp, out, k, *flags):
    assert port_main(["-in", inp, "-out", str(out), "-kmer-size", str(k),
                      "-verbose", "0", "-device", "cpu", *flags]) == 0
    return _outputs(str(out))


def _ref(inp, out, k, tmp, **kw):
    run_ref(RefConfig(
        input_filename=inp, output_dir=str(out), output_tmp_dir=str(tmp),
        kmer_size=k, simple_dist=True, complex_dist=True, verbose=False,
        n_shards=1, **kw,
    ))
    return _outputs(str(out))


def _mtimes(tmp):
    paths = sorted(glob.glob(os.path.join(str(tmp), "count", "*.npz")))
    return {p: os.stat(p).st_mtime_ns for p in paths}


@pytest.fixture(scope="module")
def runs(community, tmp_path_factory):  # noqa: F811
    """(n, k) -> the port's -out-tmp -keep-tmp run, its in-memory run
    and simka_tpu's -out-tmp -keep-tmp run, all distances, each once."""
    cache = {}

    def get(n, k):
        if (n, k) not in cache:
            root = tmp_path_factory.mktemp(f"n{n}_k{k}")
            inp = community[n]
            r = {"inp": inp, "root": root, "port_tmp": root / "port_tmp",
                 "ref_tmp": root / "ref_tmp"}
            r["port"] = _port(inp, root / "port", k, "-out-tmp",
                              str(r["port_tmp"]), "-keep-tmp", *DISTANCES)
            r["mem"] = _port(inp, root / "mem", k, *DISTANCES)
            r["ref"] = _ref(inp, root / "ref", k, r["ref_tmp"],
                            keep_tmp=True)
            cache[(n, k)] = r
        return cache[(n, k)]

    return get


@pytest.mark.parametrize("n,k", CASES)
def test_out_tmp_matches_in_memory_and_reference(runs, n, k):
    r = runs(n, k)
    (got_csv, got_m), (mem_csv, _), (ref_csv, ref_m) = (
        r["port"], r["mem"], r["ref"])
    assert len(got_csv) == 21 and got_csv == mem_csv
    _assert_csvs_match(got_csv, ref_csv, 21)
    for key in COUNTERS:
        assert got_m.get(key) == ref_m.get(key), key
    assert "datasets_resumed" not in got_m and got_m["nb_distinct_kmers"] > 0
    assert got_m["spectrum_rows"] == sum(s["rows"] for s in got_m["per_sample"])
    assert len(_mtimes(r["port_tmp"])) == n


@pytest.mark.parametrize("n,k", CASES)
def test_resume_reuses_every_checkpoint(runs, n, k):
    r = runs(n, k)
    before = _mtimes(r["port_tmp"])
    got_csv, got_m = _port(r["inp"], r["root"] / "resume", k, "-out-tmp",
                           str(r["port_tmp"]), "-keep-tmp", *DISTANCES)
    assert got_m["datasets_resumed"] == n
    assert all(s["resumed"] and "count_s" not in s
               for s in got_m["per_sample"])
    assert _mtimes(r["port_tmp"]) == before
    assert got_csv == r["port"][0]


@pytest.mark.parametrize("n,k", CASES)
def test_reference_checkpoints_load_in_the_port(runs, n, k):
    r = runs(n, k)
    tmp = r["root"] / "ref_tmp_copy"
    shutil.copytree(r["ref_tmp"], tmp)
    before = _mtimes(tmp)
    got_csv, got_m = _port(r["inp"], r["root"] / "from_ref", k, "-out-tmp",
                           str(tmp), "-keep-tmp", *DISTANCES)
    assert got_m["datasets_resumed"] == n and _mtimes(tmp) == before
    assert got_csv == r["port"][0]


@pytest.mark.parametrize("n,k", CASES)
def test_port_checkpoints_load_in_the_reference(runs, n, k):
    r = runs(n, k)
    tmp = r["root"] / "port_tmp_copy"
    shutil.copytree(r["port_tmp"], tmp)
    before = _mtimes(tmp)
    ref_csv, ref_m = _ref(r["inp"], r["root"] / "ref_from_port", k, tmp,
                          keep_tmp=True)
    assert ref_m["datasets_resumed"] == n and _mtimes(tmp) == before
    assert ref_csv == r["ref"][0]


def test_changed_k_recounts(community, tmp_path):  # noqa: F811
    tmp = str(tmp_path / "tmp")
    _port(community[3], tmp_path / "k21", 21, "-out-tmp", tmp, "-keep-tmp")
    before = _mtimes(tmp)
    got_csv, got_m = _port(community[3], tmp_path / "k23", 23, "-out-tmp",
                           tmp, "-keep-tmp")
    assert "datasets_resumed" not in got_m
    after = _mtimes(tmp)
    assert after.keys() == before.keys()
    assert all(after[p] != before[p] for p in after)
    assert got_csv == _port(community[3], tmp_path / "mem", 23)[0]


@pytest.fixture(scope="module")
def growing(tmp_path_factory):
    """Three samples, and a fourth of fewer reads (so the auto
    -max-reads cap moves when it is added)."""
    root = tmp_path_factory.mktemp("growing")
    three = write_community(str(root / "a"), seed=21, n_samples=3,
                            n_genomes=4, genome_len=3000,
                            reads_per_sample=400, n_frac=0.005)
    extra = write_community(str(root / "b"), seed=22, n_samples=1,
                            n_genomes=4, genome_len=3000,
                            reads_per_sample=300, n_frac=0.005)
    four = str(root / "four.txt")
    with open(four, "w") as f:
        f.write(open(three).read()
                + open(extra).read().replace("S0:", "S3:"))
    return three, four


@pytest.mark.parametrize("max_reads,resumed", [("-1", 3), ("0", None)])
def test_adding_a_dataset_counts_only_it(growing, tmp_path, max_reads,
                                         resumed):
    """With every read used, the three counted samples are reused; with
    the auto cap, which the fourth sample moves, every sample is
    recounted, as in the reference."""
    three, four = growing
    tmp = str(tmp_path / "tmp")
    flags = ["-max-reads", max_reads, "-out-tmp", tmp, "-keep-tmp"]
    _port(three, tmp_path / "three", 21, *flags)
    got_csv, got_m = _port(four, tmp_path / "four", 21, *flags)
    assert got_m.get("datasets_resumed") == resumed
    assert len(_mtimes(tmp)) == 4
    assert got_csv == _port(four, tmp_path / "mem", 21, "-max-reads",
                            max_reads)[0]
    assert got_m["reads"] < 4 * 400


def test_count_dir_removed_without_keep_tmp(community, tmp_path):  # noqa: F811
    tmp = tmp_path / "tmp"
    got_csv, _ = _port(community[3], tmp_path / "out", 21, "-out-tmp",
                       str(tmp))
    assert tmp.is_dir() and not (tmp / "count").exists()
    assert got_csv == _port(community[3], tmp_path / "mem", 21)[0]


def test_spill_rule_routes_like_the_reference(community, tmp_path):  # noqa: F811
    """The port takes the out-of-core sweep where simka_tpu takes it
    (rows x 16 B x 8 > -max-memory at k=21), with as many hash ranges,
    and joins in memory one megabyte above, as the reference; the CSVs
    equal the in-memory run's either way."""
    inp = community[3]
    _, m = _port(inp, tmp_path / "probe", 21, "-out-tmp",
                 str(tmp_path / "probe_tmp"))
    over = m["spectrum_rows"] * 16 * 8 // 1_000_000
    assert over >= 1
    mem_csv = _port(inp, tmp_path / "mem", 21)[0]
    out = tmp_path / "ref"
    for mm in (over, over + 1):
        got_csv, got_m = _port(inp, tmp_path / f"port{mm}", 21, "-out-tmp",
                               str(tmp_path / f"t{mm}"), "-max-memory",
                               str(mm))
        assert got_csv == mem_csv
        run_ref(RefConfig(input_filename=inp, output_dir=str(out / str(mm)),
                          output_tmp_dir=str(tmp_path / f"r{mm}"),
                          max_memory_mb=mm, verbose=False, n_shards=1))
        ref_m = _outputs(str(out / str(mm)))[1]
        assert got_m.get("sweep_ranges") == ref_m.get("sweep_ranges")
        assert ("sweep_ranges" in got_m) == (mm == over)


def test_sample_emptied_by_the_read_filter(tmp_path):
    """A first sample whose reads are all shorter than -min-read-size:
    the port's checkpoint path equals its in-memory run at k=48. The
    reference fails there (ROADMAP.md section 3): its empty spectrum
    has 3 uint32 words where k=48 has 4, and its concatenation of the
    spectra indexes past them."""
    inp = write_community(str(tmp_path / "c"), seed=1, n_samples=2,
                          n_genomes=2, genome_len=2000, reads_per_sample=200)
    rng = np.random.default_rng(0)
    short = tmp_path / "short.fasta"
    short.write_text("".join(
        ">s\n" + "".join(rng.choice(list("ACGT"), 40)) + "\n"
        for _ in range(50)))
    inp2 = tmp_path / "input.txt"
    inp2.write_text(f"E: {short}\n" + open(inp).read())
    flags = ("-min-read-size", "50")
    got_csv, got_m = _port(str(inp2), tmp_path / "port", 48, "-out-tmp",
                           str(tmp_path / "tmp"), "-keep-tmp", *flags)
    assert got_csv == _port(str(inp2), tmp_path / "mem", 48, *flags)[0]
    assert got_m["per_sample"][0]["rows"] == 0
    with pytest.raises(IndexError):
        run_ref(RefConfig(input_filename=str(inp2),
                          output_dir=str(tmp_path / "ref"),
                          output_tmp_dir=str(tmp_path / "ref_tmp"),
                          kmer_size=48, min_read_size=50, verbose=False,
                          n_shards=1))


@pytest.mark.parametrize("k", [21, 31, 32, 63, 64])
def test_checkpoint_files_match_reference(community, tmp_path, k):  # noqa: F811
    """One sample counted by each package's count_one_dataset: the two
    files agree field for field (the k-mer rows in simka_tpu's uint32
    layout, ascending in both), not byte for byte (zip entries carry
    timestamps)."""
    d = parse_input_file(community[3])[0]
    kw = dict(input_filename=community[3], kmer_size=k, verbose=False)
    words, counts, n, resumed = count_one_dataset(
        d, SimkaConfig(**kw), 0, torch.device("cpu"),
        ckpt=CountCheckpoint(str(tmp_path / "port")))
    ref = ref_count_one(d, RefConfig(**kw), 0,
                        ckpt=RefCheckpoint(str(tmp_path / "ref")))
    assert not resumed and not ref[3] and n == ref[2] > 0
    got = np.load(CountCheckpoint(str(tmp_path / "port")).path(d.id))
    want = np.load(RefCheckpoint(str(tmp_path / "ref")).path(d.id))
    assert sorted(got.files) == sorted(want.files)
    for name in want.files:
        g, w = got[name], want[name]
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert int(got["n_words"]) == len(words) == len(ref[0])
    assert len(counts) == int(got["nb_distinct"]) > 0


@pytest.mark.parametrize("error,attempts", [(OSError, 2), (RuntimeError, 1)])
def test_only_read_failures_are_retried(community, monkeypatch, error,  # noqa: F811
                                        attempts):
    """An OSError (a read failure) is retried, as the reference retries
    a count; a RuntimeError (the device's or a kernel wrapper's)
    propagates from the first attempt."""
    import simka_tpu_torch.core.pipeline as pipeline

    real = pipeline.count_dataset_spectrum
    calls = []

    def flaky(*args, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise error("first attempt fails")
        return real(*args, **kw)

    monkeypatch.setattr(pipeline, "count_dataset_spectrum", flaky)
    d = parse_input_file(community[3])[0]
    config = SimkaConfig(input_filename=community[3], verbose=False)
    if error is OSError:
        words, counts, n, _ = count_one_dataset(d, config, 0,
                                                torch.device("cpu"))
        assert n > 0 and len(counts) > 0
    else:
        with pytest.raises(RuntimeError, match="first attempt"):
            count_one_dataset(d, config, 0, torch.device("cpu"))
    assert len(calls) == attempts
