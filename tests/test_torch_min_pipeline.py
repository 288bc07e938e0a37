"""SimkaMin's distance commands and flows end to end in the port, on
the CPU, against simka_tpu on the same files: `min pipeline` and `min
update` (k 21 and 31, with and without -filter), `min distance` whole,
in tiles and across two files, `min export` and `min matrix-update`
through both CLIs give the same .bin matrices and sketch.bin byte for
byte and the same CSV text; the resident route equals the from-file
route (the batched route's bail, and a device plan too small for the
resident distance); a failed sketch.bin write is raised, not
swallowed, and leaves no partial file."""

import glob
import gzip
import os
import shutil

import numpy as np
import pytest
import torch

from simka_tpu.cli import main as ref_main
from simka_tpu_torch.cli import main as port_main
from simka_tpu_torch.minhash import device_distance
from simka_tpu_torch.minhash.cli import min_main
from simka_tpu_torch.minhash.pipeline import run_simka_min


def ref_min(argv):
    return ref_main(["min", *argv])


def port_min(argv):
    return port_main(["min", *argv])


@pytest.fixture(scope="module")
def samples(tmp_path_factory):
    """Six samples of 300 reads of 70 bp, 30% of them from 40 shared
    reads (counts > 1, so -filter keeps members)."""
    rng = np.random.default_rng(23)
    bases = np.frombuffer(b"ACGT", np.uint8)
    root = tmp_path_factory.mktemp("min_pipeline")
    shared = [bases[rng.integers(0, 4, 70)].tobytes() for _ in range(40)]
    paths = []
    for s in range(6):
        p = root / f"S{s}.fasta"
        with open(p, "wb") as f:
            for i in range(300):
                seq = (shared[rng.integers(0, 40)] if rng.random() < 0.3
                       else bases[rng.integers(0, 4, 70)].tobytes())
                f.write(b">r%d\n" % i + seq + b"\n")
        paths.append(str(p))
    return paths


def _input(tmp_path, paths, name, first=0):
    inp = tmp_path / name
    inp.write_text("".join(f"S{first + i}: {p}\n"
                           for i, p in enumerate(paths)))
    return str(inp)


def _files(out, pattern):
    return {os.path.relpath(p, out): open(p, "rb").read()
            for p in sorted(glob.glob(os.path.join(out, pattern)))}


def _texts(out):
    return {os.path.basename(p): gzip.open(p, "rt").read()
            for p in sorted(glob.glob(os.path.join(out, "*.csv.gz")))}


def _same_run(a, b):
    """Two pipeline output dirs hold the same matrices, sketch file and
    CSV text."""
    assert _files(a, "distance/*.bin") == _files(b, "distance/*.bin")
    assert _files(a, "sketch/sketch.bin") == _files(b, "sketch/sketch.bin")
    assert len(_texts(a)) == 2 and _texts(a) == _texts(b)


@pytest.mark.parametrize("flags", [
    ["-nb-kmers", "300"],
    ["-nb-kmers", "300", "-filter"],
    ["-kmer-size", "31", "-nb-kmers", "5000", "-seed", "7"],
])
def test_pipeline_and_update_match_reference(samples, tmp_path, flags,
                                             capsys):
    filt = ["-filter"] if "-filter" in flags else []
    inp = _input(tmp_path, samples[:4], "in.txt")
    new = _input(tmp_path, samples[4:], "new.txt", 4)
    a, b = str(tmp_path / "ref"), str(tmp_path / "port")
    assert ref_min(["pipeline", "-in", inp, "-out", a, *flags]) == 0
    want = capsys.readouterr().out
    obs = {}
    assert min_main(["pipeline", "-in", inp, "-out", b, *flags, "-device",
                     "cpu"], observer=obs) == 0
    assert capsys.readouterr().out == want
    assert obs["min_route"] == "resident" and obs["pair_launches"] == 0
    _same_run(a, b)
    assert ref_min(["update", "-in", new, "-out", a, *filt]) == 0
    assert port_min(["update", "-in", new, "-out", b, *filt, "-device",
                     "cpu"]) == 0
    _same_run(a, b)
    assert "S5" in _texts(b)["mat_presenceAbsence_jaccard.csv.gz"]


def test_distance_export_and_matrix_update_match_reference(samples,
                                                           tmp_path):
    """`min distance` whole, in tiles (-start-i/-n-i) and across two
    files; `min export` and `min matrix-update` on the results."""
    x, y = str(tmp_path / "x.sketch"), str(tmp_path / "y.sketch")
    assert ref_min(["sketch", "-in", _input(tmp_path, samples[:5], "x.txt"),
                    "-out", x, "-nb-kmers", "400"]) == 0
    assert ref_min(["sketch", "-in", _input(tmp_path, samples[5:], "y.txt",
                                            5),
                    "-out", y, "-nb-kmers", "400"]) == 0
    runs = {
        "whole": [["-in1", x, "-in2", x]],
        "tiles": [["-in1", x, "-in2", x, "-start-i", str(i), "-start-j",
                   str(j), "-n-i", str(min(2, 5 - i)), "-n-j",
                   str(min(2, 5 - j))]
                  for i in (0, 2, 4) for j in (0, 2, 4) if j >= i],
        "two_files": [["-in1", x, "-in2", y]],
        "new_vs_new": [["-in1", y, "-in2", y]],
    }
    dirs = {}
    for tag, calls in runs.items():
        for side, run in (("ref", ref_min), ("port", port_min)):
            out = str(tmp_path / f"{tag}_{side}")
            for call in calls:
                dev = ["-device", "cpu"] if side == "port" else []
                assert run(["distance", *call, "-out", out, *dev]) == 0
            dirs[tag, side] = out
        assert _files(dirs[tag, "ref"], "*.bin") == _files(dirs[tag, "port"],
                                                           "*.bin"), tag
    assert _files(dirs["whole", "port"], "*.bin") == _files(
        dirs["tiles", "port"], "*.bin")
    for side, run in (("ref", ref_min), ("port", port_min)):
        csv = str(tmp_path / f"csv_{side}")
        assert run(["export", "-in", dirs["whole", side], "-in1", x, "-in2",
                    x, "-out", csv]) == 0
        grown = str(tmp_path / f"grown_{side}")
        shutil.copytree(dirs["whole", side], grown)
        assert run(["matrix-update", "-in", grown, "-in-evn",
                    dirs["two_files", side], "-in-nvn",
                    dirs["new_vs_new", side], "-n-old", "5",
                    "-n-new", "1"]) == 0
    assert _texts(str(tmp_path / "csv_ref")) == _texts(
        str(tmp_path / "csv_port"))
    assert _files(str(tmp_path / "grown_ref"), "*.bin") == _files(
        str(tmp_path / "grown_port"), "*.bin")


@pytest.mark.parametrize("route", ["bail", "small_plan"])
def test_resident_route_equals_from_file_route(samples, tmp_path,
                                               monkeypatch, route):
    """The batched route's bail (per-sample sketch into the file) and a
    device plan too small for the resident distance (the bundle written
    to the file) both take the from-file route, in 2 x 2 tiles, and give
    the resident route's files."""
    inp = _input(tmp_path, samples[:5], "in.txt")
    kw = dict(sketch_size=400, device="cpu", verbose=False, tile=2)
    resident, from_file = {}, {}
    run_simka_min(inp, str(tmp_path / "resident"), observer=resident, **kw)
    if route == "bail":
        kw["instance_limit"] = 0
    else:
        monkeypatch.setenv("SIMKA_TPU_HBM_MB", "0.0001")
    run_simka_min(inp, str(tmp_path / "file"), observer=from_file, **kw)
    assert resident["min_route"] == "resident"
    assert resident["sketch_route"] == "batched"
    assert from_file["min_route"] == "from-file"
    assert from_file["sketch_route"] == (
        "per-sample" if route == "bail" else "batched")
    _same_run(str(tmp_path / "resident"), str(tmp_path / "file"))


def test_writer_error_is_raised_and_partial_sketch_removed(
        samples, tmp_path, monkeypatch):
    from simka_tpu_torch.minhash import sketch_file

    def broken(self, *args):
        raise OSError("disk full")

    monkeypatch.setattr(sketch_file.SketchFile, "write_ids", broken)
    out = tmp_path / "out"
    with pytest.raises(OSError, match="disk full"):
        run_simka_min(_input(tmp_path, samples[:3], "in.txt"), str(out),
                      sketch_size=300, device="cpu", verbose=False)
    assert not (out / "sketch" / "sketch.bin").exists()
    assert not glob.glob(str(out / "*.csv.gz"))


def test_min_commands_cuda_without_gpu_raise(samples, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = str(tmp_path / "x.sketch")
    assert port_min(["sketch", "-in", _input(tmp_path, samples[:2], "i.txt"),
                     "-out", x, "-nb-kmers", "100", "-device", "cpu"]) == 0
    for argv in (["distance", "-in1", x, "-in2", x, "-out",
                  str(tmp_path / "d")],
                 ["pipeline", "-in", str(tmp_path / "i.txt"), "-out",
                  str(tmp_path / "p")]):
        before = device_distance.launches
        with pytest.raises(RuntimeError, match="cuda"):
            port_min(argv)
        assert device_distance.launches == before
