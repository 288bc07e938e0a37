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
"""

import glob
import os
import socket
import subprocess
import sys

import pytest

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


def _ranks(n, inp, out, *flags):
    """The CLI with -coordinator in ``n`` processes, one a rank (gloo on
    the CPU); returns each rank's output."""
    argv = [sys.executable, "-m", "simka_tpu_torch.cli", "-in", inp,
            "-out", out, "-device", "cpu", "-coordinator",
            f"localhost:{_free_port()}", "-num-hosts", str(n), *flags]
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(argv + ["-host-id", str(r)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE,
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
