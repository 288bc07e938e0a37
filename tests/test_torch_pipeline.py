"""The port end to end: its CLI on the CPU against
simka_tpu.core.pipeline.run_simka (single-device path, n_shards=1) on
the same simulated community files. The decompressed CSV text must be
byte-equal and so must the repartition histogram; the options that
raised NotImplementedError before the multi-device paths were ported
(-n-shards > 1, alone or under the sweep, and -coordinator) give the
same CSVs as simka_tpu's CLI; -data-info gives the same read counts;
`min distance` gives the same matrices. The optional distances and the k-mer Shannon filter are
in test_torch_cli_channels.py, the out-of-core sweep in
test_torch_sweep.py."""

import glob
import gzip
import json
import os

import pytest
import torch

from simka_tpu.config import SimkaConfig as RefConfig
from simka_tpu.core.pipeline import run_simka as run_ref
from simka_tpu_torch.cli import main as port_main
from simka_tpu_torch.utils.community import write_community


def _outputs(out_dir):
    texts = {
        os.path.basename(p): gzip.open(p, "rt").read()
        for p in sorted(glob.glob(os.path.join(out_dir, "*.csv.gz")))
    }
    with open(os.path.join(out_dir, "simka_metrics.json")) as f:
        return texts, json.load(f)["counters"]


@pytest.fixture(scope="module")
def community(tmp_path_factory):
    # sizes avoid a one-batch stream of exactly a power-of-two window
    # class, where the reference's single-device path fails (it
    # deletes the lone batch that jnp.concatenate handed back as is)
    root = tmp_path_factory.mktemp("community")
    return {
        n: write_community(
            str(root / f"n{n}"), seed=n, n_samples=n, n_genomes=4,
            genome_len=3000, reads_per_sample=reads, n_frac=0.005,
            fastq_samples=1,
        )
        for n, reads in ((3, 400), (16, 250))
    }


@pytest.mark.parametrize(
    "n,k,amin", [(3, 21, 0), (3, 21, 2), (3, 31, 0), (3, 31, 2), (16, 21, 2)]
)
def test_cli_matches_reference(community, tmp_path, n, k, amin):
    inp = community[n]
    port_out, ref_out = str(tmp_path / "port"), str(tmp_path / "ref")
    rc = port_main([
        "-in", inp, "-out", port_out, "-kmer-size", str(k),
        "-abundance-min", str(amin), "-verbose", "0", "-device", "cpu",
    ])
    assert rc == 0
    run_ref(RefConfig(
        input_filename=inp, output_dir=ref_out, kmer_size=k,
        abundance_min=amin, verbose=False, n_shards=1,
    ))
    got_csv, got_m = _outputs(port_out)
    want_csv, want_m = _outputs(ref_out)
    assert list(got_csv) == list(want_csv) and len(got_csv) == 15
    for name in want_csv:
        assert got_csv[name] == want_csv[name], name
    for key in ("repartition_histogram", "nb_distinct_kmers", "reads",
                "n_datasets"):
        assert got_m[key] == want_m[key], key
    for key in ("stage_parse_pack_s", "stage_h2d_s",
                "stage_extract_dispatch_s", "stage_join_s"):
        assert key in got_m
    assert got_m["nb_distinct_kmers"] > 0


@pytest.mark.parametrize(
    "flags",
    [["-out-tmp", "tmp", "-sweep-ranges", "2", "-n-shards", "2"],
     ["-coordinator", "localhost:1234"], ["-sweep-ranges", "2", "-n-shards",
                                          "4"],
     ["-n-shards", "2"], ["-out-tmp", "tmp", "-max-memory", "1",
                          "-n-shards", "8"]],
)
def test_options_outside_the_slice_raise(community, tmp_path, flags):
    """The options these cases once showed refused -- several devices
    (alone, or under the out-of-core sweep, forced or where the
    reference's spill rule takes it) and several hosts -- now run: the
    port's CLI on n copies of the CPU, or as one gloo rank, gives the
    CSVs of simka_tpu's CLI with the same flags (its n virtual CPU
    devices). simka_tpu's -coordinator would initialise jax.distributed
    in this process, so that case runs simka_tpu's run_simka_multihost,
    which its CLI calls next, in one process. The sweep's flags give
    both the same hash ranges."""
    import socket

    from simka_tpu.cli import main as ref_main
    from simka_tpu.parallel.multihost import run_simka_multihost

    with socket.socket() as sock:  # a free port for the one-rank group
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    runs = {}
    for side in ("port", "ref"):
        args = [str(tmp_path / f"{side}_tmp") if f == "tmp"
                else f"localhost:{port}" if f == "localhost:1234" else f
                for f in flags]
        out = str(tmp_path / side)
        argv = ["-in", community[3], "-out", out, "-verbose", "0", *args]
        if side == "port":
            assert port_main([*argv, "-device", "cpu"]) == 0
        elif "-coordinator" in flags:
            run_simka_multihost(RefConfig(input_filename=community[3],
                                          output_dir=out, verbose=False))
        else:
            assert ref_main(argv) == 0
        runs[side] = _outputs(out)
    (got_csv, got_m), (want_csv, want_m) = runs["port"], runs["ref"]
    assert list(got_csv) == list(want_csv) and len(got_csv) == 15
    for name in want_csv:
        assert got_csv[name] == want_csv[name], name
    assert got_m.get("sweep_ranges") == want_m.get("sweep_ranges")
    if "-n-shards" in flags:
        assert got_m["n_shards"] == int(flags[flags.index("-n-shards") + 1])


def test_data_info_matches_reference(community, capsys):
    from simka_tpu.core.pipeline import run_data_info as ref_data_info
    from simka_tpu_torch.config import SimkaConfig
    from simka_tpu_torch.core.pipeline import run_data_info

    for shannon in (0.0, 1.95):
        kw = dict(input_filename=community[16], min_read_size=100,
                  min_read_shannon_index=shannon, verbose=True)
        got = run_data_info(SimkaConfig(**kw))
        printed = capsys.readouterr().out
        assert got == ref_data_info(RefConfig(**kw))
        capsys.readouterr()
        assert len(got) == 16 and all(n > 0 for _, n in got)
        assert printed.splitlines() == [f"{i}: {n} reads" for i, n in got]
        if shannon:  # the filter drops reads
            assert sum(n for _, n in got) < 16 * 250
    assert port_main(["-in", community[3], "-data-info", "-device", "cpu",
                      "-verbose", "0"]) == 0


def test_min_subcommand_raises(community, tmp_path):
    """`min distance` (ROADMAP item 11b, which raised NotImplementedError
    until it was ported) through both CLIs on one sketch file of the
    16-sample community, whole and in two tiles: the same .bin
    matrices."""
    from simka_tpu.minhash.cli import min_main as ref_min

    x = str(tmp_path / "x.sketch")
    assert port_main(["min", "sketch", "-in", community[16], "-out", x,
                      "-nb-kmers", "500", "-device", "cpu"]) == 0
    bins = {}
    for side, tiles in (("ref", [[]]), ("port", [[]]),
                        ("tiles", [["-n-i", "9", "-n-j", "9"],
                                   ["-start-j", "9", "-n-i", "9", "-n-j",
                                    "7"],
                                   ["-start-i", "9", "-start-j", "9",
                                    "-n-i", "7"]])):
        out = tmp_path / side
        for tile in tiles:
            argv = ["distance", "-in1", x, "-in2", x, "-out", str(out), *tile]
            if side == "ref":
                assert ref_min(argv) == 0
            else:
                assert port_main(["min", *argv, "-device", "cpu"]) == 0
        bins[side] = {p.name: p.read_bytes() for p in sorted(out.iterdir())}
    assert len(bins["ref"]) == 2
    assert bins["port"] == bins["ref"] == bins["tiles"]


def test_device_cuda_without_gpu_raises(community, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        port_main(["-in", community[3], "-out", str(tmp_path), "-verbose",
                   "0", "-device", "cuda"])
    assert not glob.glob(os.path.join(str(tmp_path), "*.csv.gz"))


def test_device_plan_overflow_raises(community, monkeypatch):
    """Past the device plan the in-memory ingest raises
    DeviceBudgetExceeded, having dropped its batches, before the
    allocator would fail; compute_statistics restarts out-of-core from
    it (tests/test_torch_sweep.py)."""
    from simka_tpu_torch.config import SimkaConfig
    from simka_tpu_torch.core.budget import DeviceBudgetExceeded
    from simka_tpu_torch.core.pipeline import _compute_statistics_in_memory
    from simka_tpu_torch.io.dsl import parse_input_file
    from simka_tpu_torch.io.packed import PackedReadSource

    monkeypatch.setenv("SIMKA_TPU_HBM_MB", "0.01")
    datasets = parse_input_file(community[3])
    with pytest.raises(DeviceBudgetExceeded, match="device plan"):
        _compute_statistics_in_memory(
            [PackedReadSource(d.banks) for d in datasets],
            [d.id for d in datasets], SimkaConfig(verbose=False),
            torch.device("cpu"), 1 << 17, None, None)
