"""The port's multi-host path (simka_tpu_torch.parallel.multihost) on
the CPU: real torch.distributed processes on localhost with the gloo
backend, launched through the CLI's -coordinator / -num-hosts /
-host-id (after tests/test_multiprocess_distributed.py), on a simulated
community made from a seed.

- The manifest equals simka_tpu's datasets_for_process.
- Two processes give the CSVs of one process (run_simka_multihost
  alone, and one gloo rank through the CLI), of the port's run_simka and
  of simka_tpu's run_simka (n_shards=1); the Jensen-Shannon matrix to
  one unit of its last digit (ROADMAP.md section 3).
- Auto -max-reads resolves from the counts of every process: samples of
  unequal sizes, split over two processes, give the single-process cap.
- With -out-tmp each process keeps its checkpoints under
  <tmp>/host{rank}; a second run resumes every one of them untouched
  and writes the same CSVs.
- A process's shards are its local devices (-n-shards, [cpu] * n on
  the CPU): 2 ranks x 2 local shards at k 21 and 33, ranks of 1 and 3
  local shards, 3 ranks over 2 samples (where simka_tpu's own
  multi-host path fails: ROADMAP.md section 3), the -out-tmp resume
  and auto -max-reads over local shards all give simka_tpu's CSVs
  (run_simka, n_shards=1); each k-mer's (rank, local shard) is the
  device simka_tpu's binning (mix_hash % G over a mesh of every
  process's devices in rank order) sends it to.
- Two processes whose home cards are one card of one host (mocked
  device counts) are refused with a ValueError through a store, before
  any collective.
"""

import glob
import os
import socket
import subprocess
import sys
import threading
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist

from simka_tpu.config import SimkaConfig as RefConfig
from simka_tpu.core.pipeline import run_simka as run_ref
from simka_tpu.parallel.multihost import (
    datasets_for_process as ref_datasets_for_process,
)
from simka_tpu_torch.cli import main as port_main
from simka_tpu_torch.config import SimkaConfig
from simka_tpu_torch.core.pipeline import resolve_max_reads, run_simka
from simka_tpu_torch.parallel import multihost
from simka_tpu_torch.utils.community import write_community
from test_torch_cli_channels import _assert_csvs_match
from test_torch_pipeline import _outputs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALL = ["-simple-dist", "-complex-dist"]


@pytest.fixture(scope="module")
def community(tmp_path_factory):
    root = tmp_path_factory.mktemp("multihost")
    return write_community(
        str(root / "c"), seed=21, n_samples=5, n_genomes=4, genome_len=3000,
        reads_per_sample=300, n_frac=0.005, fastq_samples=1)


@pytest.fixture(scope="module")
def uneven(tmp_path_factory):
    """Five samples of 120..600 reads: each process's own (min + mean)
    / 2 differs from the global one."""
    root = tmp_path_factory.mktemp("uneven")
    lines = []
    for s, reads in enumerate((600, 120, 450, 300, 200)):
        inp = write_community(
            str(root / f"s{s}"), seed=30 + s, n_samples=1, n_genomes=3,
            genome_len=3000, reads_per_sample=reads, n_frac=0.0)
        with open(inp) as f:
            path = f.read().split(":", 1)[1].strip()
        lines.append(f"U{s}: {path}")
    inp = root / "input.txt"
    inp.write_text("\n".join(lines) + "\n")
    return str(inp)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _ranks(n, inp, out, *flags, per_rank=None):
    """The CLI with -coordinator in ``n`` processes, one a rank (gloo on
    the CPU), rank r with ``per_rank[r]``'s flags too; returns each
    rank's output."""
    argv = [sys.executable, "-m", "simka_tpu_torch.cli", "-in", inp,
            "-out", out, "-device", "cpu", "-coordinator",
            f"localhost:{_free_port()}", "-num-hosts", str(n), *flags]
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(argv + ["-host-id", str(r)]
                              + list(per_rank[r] if per_rank else ()),
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return logs


def test_datasets_for_process_matches_reference():
    for n in (0, 1, 5, 16):
        for n_proc in (1, 2, 3, 7):
            got = [multihost.datasets_for_process(n, p, n_proc)
                   for p in range(n_proc)]
            assert got == [ref_datasets_for_process(n, p, n_proc)
                           for p in range(n_proc)]
            assert sorted(sum(got, [])) == list(range(n))


def test_two_processes_match_one_and_reference(community, tmp_path):
    """Every distance through two gloo ranks, one gloo rank and one
    process without torch.distributed: byte-equal to each other and to
    the port's run_simka; simka_tpu's run_simka to the JS matrix's last
    digit."""
    _ranks(2, community, str(tmp_path / "two"), "-verbose", "0", *ALL)
    _ranks(1, community, str(tmp_path / "one_rank"), "-verbose", "0", *ALL)
    kw = dict(input_filename=community, simple_dist=True, complex_dist=True,
              verbose=False)
    multihost.run_simka_multihost(
        SimkaConfig(output_dir=str(tmp_path / "alone"), **kw), device="cpu")
    run_simka(SimkaConfig(output_dir=str(tmp_path / "run_simka"), **kw),
              device="cpu")
    run_ref(RefConfig(output_dir=str(tmp_path / "ref"), n_shards=1, **kw))
    two, m = _outputs(str(tmp_path / "two"))
    assert m["n_processes"] == 2
    assert m["compact_launches"] == 0  # the CPU launches no kernel
    for other in ("one_rank", "alone", "run_simka"):
        assert _outputs(str(tmp_path / other))[0] == two, other
    _assert_csvs_match(two, _outputs(str(tmp_path / "ref"))[0], 21)
    # only process 0 writes
    assert len(glob.glob(str(tmp_path / "two" / "*.csv.gz"))) == 21


def test_auto_max_reads_resolved_globally(uneven, tmp_path):
    """-max-reads 0 with read filters: both processes resolve the cap
    of all five samples, and the CSVs equal one process's."""
    flags = ["-max-reads", "0", "-min-read-size", "60",
             "-read-shannon-index", "1.2"]
    logs = _ranks(2, uneven, str(tmp_path / "two"), "-verbose", "1", *flags)
    assert port_main(["-in", uneven, "-out", str(tmp_path / "one"),
                      "-verbose", "0", "-device", "cpu", *flags]) == 0
    from simka_tpu_torch.io.bank import estimate_dataset_reads
    from simka_tpu_torch.io.dsl import parse_input_file

    datasets = parse_input_file(uneven)
    counts = [estimate_dataset_reads(d.banks, 60, 1.2) // len(d.banks)
              for d in datasets]
    cap = resolve_max_reads(counts, 0)
    for pid, n_proc in ((0, 2), (1, 2)):
        mine = [counts[s] for s in multihost.datasets_for_process(
            5, pid, n_proc)]
        assert resolve_max_reads(mine, 0) != cap  # a local cap would differ
    for log in logs:
        assert f"auto -max-reads resolved globally to {cap}" in log
    assert _outputs(str(tmp_path / "two"))[0] == _outputs(
        str(tmp_path / "one"))[0]


def test_per_host_checkpoints_resume(community, tmp_path):
    """-out-tmp: each process checkpoints its own datasets under
    <tmp>/host{rank}/count; a second run resumes all of them, rewriting
    none, with the same CSVs."""
    tmp = tmp_path / "tmp"
    flags = ["-verbose", "0", "-out-tmp", str(tmp), "-keep-tmp"]
    _ranks(2, community, str(tmp_path / "run1"), *flags)

    def checkpoints():
        return {p: os.stat(p).st_mtime_ns
                for p in sorted(glob.glob(str(tmp / "host*" / "count" /
                                              "*.npz")))}

    first = checkpoints()
    per_host = {os.path.basename(os.path.dirname(os.path.dirname(p)))
                for p in first}
    assert per_host == {"host0", "host1"} and len(first) == 5
    assert len(glob.glob(str(tmp / "host1" / "count" / "*.npz"))) == 2
    _ranks(2, community, str(tmp_path / "run2"), *flags)
    assert checkpoints() == first
    got, m = _outputs(str(tmp_path / "run2"))
    assert m["datasets_resumed"] == 3  # process 0's datasets 0, 2, 4
    assert got == _outputs(str(tmp_path / "run1"))[0]


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """Two samples: a third process has no dataset."""
    root = tmp_path_factory.mktemp("pair")
    return write_community(
        str(root / "c"), seed=23, n_samples=2, n_genomes=3, genome_len=3000,
        reads_per_sample=300, n_frac=0.005)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """simka_tpu's run_simka (n_shards=1) CSVs of an input, by (input,
    k, all distances), each run once."""
    root = tmp_path_factory.mktemp("reference")
    runs = {}

    def get(inp, k=21, every=True):
        key = (inp, k, every)
        if key not in runs:
            out = str(root / f"r{len(runs)}")
            run_ref(RefConfig(input_filename=inp, output_dir=out,
                              kmer_size=k, simple_dist=every,
                              complex_dist=every, verbose=False,
                              n_shards=1))
            runs[key] = _outputs(out)[0]
        return runs[key]

    return get


@pytest.mark.parametrize("k,local", [(21, (2, 2)), (33, (2, 2)),
                                     (21, (1, 3))],
                         ids=["k21-2x2", "k33-2x2", "k21-1+3"])
def test_ranks_over_local_shards_match_reference(community, reference,
                                                 tmp_path, k, local):
    """Two gloo ranks, each over its own -n-shards copies of the CPU (2
    and 2, or 1 and 3: a global shard count of 4 either way), every
    distance: the port's one-process CSVs byte for byte, simka_tpu's to
    the JS matrix's last digit."""
    out = str(tmp_path / "ranks")
    _ranks(2, community, out, "-verbose", "0", "-kmer-size", str(k), *ALL,
           per_rank=[["-n-shards", str(n)] for n in local])
    got, m = _outputs(out)
    assert m["n_processes"] == 2 and m["n_shards"] == 4
    assert m["shards_per_process"] == list(local)
    run_simka(SimkaConfig(input_filename=community, kmer_size=k,
                          output_dir=str(tmp_path / "one"), verbose=False,
                          simple_dist=True, complex_dist=True), device="cpu")
    assert got == _outputs(str(tmp_path / "one"))[0]
    _assert_csvs_match(got, reference(community, k), 21)


def test_three_ranks_over_two_samples(pair, reference, tmp_path):
    """More processes than samples: process 2 counts nothing and still
    takes its shards' rows in the exchange. simka_tpu's own multi-host
    path fails on this input (it concatenates an empty list), so the
    CSVs are held against one process and simka_tpu's run_simka."""
    _ranks(3, pair, str(tmp_path / "three"), "-verbose", "0", *ALL,
           per_rank=[[], ["-n-shards", "2"], []])
    assert multihost.datasets_for_process(2, 2, 3) == []
    got, m = _outputs(str(tmp_path / "three"))
    assert m["n_processes"] == 3 and m["shards_per_process"] == [1, 2, 1]
    multihost.run_simka_multihost(
        SimkaConfig(input_filename=pair, output_dir=str(tmp_path / "one"),
                    simple_dist=True, complex_dist=True, verbose=False),
        device="cpu")
    assert got == _outputs(str(tmp_path / "one"))[0]
    _assert_csvs_match(got, reference(pair), 21)


def test_local_shards_resume_per_host_checkpoints(community, reference,
                                                  tmp_path):
    """-out-tmp over 2 ranks x 2 local shards: each process checkpoints
    under <tmp>/host{rank}; a second run, over 1 and 3 local shards,
    resumes every checkpoint untouched; both give simka_tpu's CSVs."""
    tmp = tmp_path / "tmp"
    flags = ["-verbose", "0", "-out-tmp", str(tmp), "-keep-tmp", *ALL]
    _ranks(2, community, str(tmp_path / "run1"), *flags,
           per_rank=[["-n-shards", "2"]] * 2)
    first = {p: os.stat(p).st_mtime_ns
             for p in glob.glob(str(tmp / "host*" / "count" / "*.npz"))}
    assert len(first) == 5
    assert len(glob.glob(str(tmp / "host1" / "count" / "*.npz"))) == 2
    _ranks(2, community, str(tmp_path / "run2"), *flags,
           per_rank=[["-n-shards", "1"], ["-n-shards", "3"]])
    assert {p: os.stat(p).st_mtime_ns for p in first} == first
    assert len(glob.glob(str(tmp / "host*" / "count" / "*.npz"))) == 5
    got, m = _outputs(str(tmp_path / "run2"))
    assert m["datasets_resumed"] == 3 and m["n_shards"] == 4
    assert got == _outputs(str(tmp_path / "run1"))[0]
    _assert_csvs_match(got, reference(community), 21)


def test_auto_max_reads_over_local_shards(uneven, tmp_path):
    """-max-reads 0 over 2 ranks x 2 local shards: both processes log
    the cap of all five samples, and the CSVs equal one process's and
    simka_tpu's with the same flags."""
    flags = ["-max-reads", "0", "-min-read-size", "60",
             "-read-shannon-index", "1.2"]
    logs = _ranks(2, uneven, str(tmp_path / "two"), "-verbose", "1",
                  "-n-shards", "2", *flags)
    assert port_main(["-in", uneven, "-out", str(tmp_path / "one"),
                      "-verbose", "0", "-device", "cpu", *flags]) == 0
    from simka_tpu.cli import main as ref_main

    assert ref_main(["-in", uneven, "-out", str(tmp_path / "ref"),
                     "-verbose", "0", "-n-shards", "1", *flags]) == 0
    from simka_tpu_torch.io.bank import estimate_dataset_reads
    from simka_tpu_torch.io.dsl import parse_input_file

    cap = resolve_max_reads(
        [estimate_dataset_reads(d.banks, 60, 1.2) // len(d.banks)
         for d in parse_input_file(uneven)], 0)
    for log in logs:
        assert f"auto -max-reads resolved globally to {cap}" in log
    got = _outputs(str(tmp_path / "two"))[0]
    assert got == _outputs(str(tmp_path / "one"))[0]
    _assert_csvs_match(got, _outputs(str(tmp_path / "ref"))[0], 15)


@pytest.mark.parametrize("k", [21, 33])
def test_shard_routes_match_reference_mesh(k):
    """Each k-mer's (rank, local shard) over processes of unequal local
    shard counts is the device that simka_tpu's multi-host binning
    (_bin_rows_by_dest: mix_hash % G) sends it to in a mesh of every
    process's devices in rank order, rows in order within each."""
    import jax.numpy as jnp

    from simka_tpu.parallel.multihost import _bin_rows_by_dest
    from simka_tpu_torch.ops.kmers import uint32_words
    from test_torch_sweep import _random_words

    rng = np.random.default_rng(k)
    words = _random_words(rng, k, 1500)
    sid = rng.integers(0, 9, 1500).astype(np.int32)
    words32 = [w.numpy().astype(np.uint32) for w in uint32_words(words, k)]
    for per_rank in ([2, 2], [1, 3], [1, 1, 1], [3, 1, 2]):
        G = sum(per_rank)
        blocks = _bin_rows_by_dest(
            tuple(jnp.asarray(w) for w in words32), jnp.asarray(sid),
            jnp.asarray(sid), G, 1500)
        owner, local = multihost.shard_routes(words, k, per_rank)
        first = np.cumsum([0] + per_rank[:-1])
        device = first[owner.numpy()] + local.numpy()
        assert ((local.numpy() >= 0)
                & (local.numpy() < np.asarray(per_rank)[owner.numpy()])).all()
        for d in range(G):
            mine = device == d
            kept = np.asarray(blocks[0][d]) != 0xFFFFFFFF
            assert kept.sum() == mine.sum() > 0, (per_rank, d)
            for got, want in zip((*words32, sid), blocks):
                np.testing.assert_array_equal(got[mine],
                                              np.asarray(want[d])[kept])


def test_two_processes_on_one_card_are_refused(monkeypatch):
    """The home card (the first local shard) by the -n-shards rule, with
    the card count mocked: two processes on one card (one card, or
    every card of a host each, as -n-shards 0 and 2 give) are refused
    by both with a ValueError naming both remedies, traded through a
    store with no collective; a card each (-n-shards 1 on two cards,
    or two hosts) passes, and a second check on the same store takes
    its own keys."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)

    def homes(cards, n_shards):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
        return [f"host {multihost.local_shards('cuda', r, n_shards)[0]}"
                for r in range(2)]

    store = dist.HashStore()  # one world a store, as a process group's
    store.set_timeout(timedelta(seconds=20))

    def check(cards, store=store):
        errors = [None] * len(cards)

        def one(r):
            try:
                multihost.check_home_cards(store, r, len(cards), cards[r])
            except Exception as e:  # any other error fails the test
                errors[r] = e

        threads = [threading.Thread(target=one, args=(r,))
                   for r in range(len(cards))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        return errors

    for cards, n_shards in ((1, 1), (1, 0), (8, 0), (8, 2)):
        errors = check(homes(cards, n_shards))
        assert all(isinstance(e, ValueError) for e in errors), errors
        assert all("processes 0 and 1" in str(e) and "cuda:0" in str(e)
                   and "one process a host" in str(e)
                   and "-n-shards 1" in str(e)
                   and "CUDA_VISIBLE_DEVICES" in str(e) for e in errors)
    assert check(homes(8, 1)) == [None, None]
    assert multihost.local_shards("cuda", 1, 1) == [torch.device("cuda", 1)]
    assert len(multihost.local_shards("cuda", 1, 0)) == 8
    three = dist.HashStore()
    three.set_timeout(timedelta(seconds=20))
    assert check(["a cuda:0", "b cuda:0", "a cuda:1"], three) == [None] * 3
    errors = check(["a cuda:1", "b cuda:0", "a cuda:1"], three)
    assert all(isinstance(e, ValueError) and "processes 0 and 2" in str(e)
               for e in errors), errors


def test_cluster_job_flags_print_the_reference_note(community, capsys):
    """The reference's inert cluster-job flags (-count-cmd, -merge-cmd,
    -count-file, -merge-file) print simka_tpu's note, with the port's
    names, before the run."""
    from simka_tpu.cli import main as ref_main

    argv = ["-in", community, "-data-info", "-count-cmd", "qsub"]
    assert ref_main(argv) == 0
    want = capsys.readouterr().out.splitlines()[0]
    assert port_main([*argv, "-device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()[0]
    assert "inert" in want and got == want.replace(
        "simka-tpu", "simka-tpu-torch").replace("jax.distributed",
                                                "torch.distributed")
