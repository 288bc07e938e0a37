"""SimkaMin's sketch end to end in the port, on the CPU, against
simka_tpu on the same files: `min sketch` writes the same sketch.bin
byte for byte (k 21 and 31, with and without -filter, full and
underfull sketches, an empty sample, -max-reads) on every route, each
forced by keyword (batched with the prefilter, the bail to per sample,
one sample, streaming with and without -filter, underfill);
compute_sketch, one-shot and streaming, equals the reference's host
oracle; -filter-bloom equals the
reference's emulation; `min info` and `min append` agree through both
CLIs; `min distance`, `export`, `pipeline`, `update` and
`matrix-update` give the same files through both CLIs."""

import gzip
import os
import shutil
import tempfile

import numpy as np
import pytest
import torch

from simka_tpu.io.packed import PackedReadSource as RefSource
from simka_tpu.minhash.pipeline import sketch_command as ref_sketch
from simka_tpu_torch.io.packed import PackedReadSource
from simka_tpu_torch.minhash import sketch as sk
from simka_tpu_torch.minhash.pipeline import sketch_command
from simka_tpu_torch.minhash.sketch_file import SketchFile

FULL64 = np.uint64(2**64 - 1)


def _write_sample(path, n_reads, read_len, rng, shared):
    bases = np.frombuffer(b"ACGT", np.uint8)
    with open(path, "wb") as f:
        for i in range(n_reads):
            if rng.random() < 0.3:
                seq = shared[rng.integers(0, len(shared))]
            else:
                seq = bases[rng.integers(0, 4, read_len)].tobytes()
            f.write(b">r%d\n" % i + seq + b"\n")


@pytest.fixture(scope="module")
def samples():
    """Six samples of 400 reads of 70 bp, 30% of them drawn from 40
    shared reads (counts > 1, so -filter keeps members)."""
    rng = np.random.default_rng(17)
    bases = np.frombuffer(b"ACGT", np.uint8)
    tmp = tempfile.mkdtemp(prefix="torch_sketch_")
    shared = [bases[rng.integers(0, 4, 70)].tobytes() for _ in range(40)]
    paths = []
    for s in range(6):
        p = os.path.join(tmp, f"S{s}.fasta")
        _write_sample(p, 400, 70, rng, shared)
        paths.append(p)
    return paths


def _input(tmp_path, paths, name="input.txt"):
    inp = tmp_path / name
    inp.write_text("".join(f"S{i}: {p}\n" for i, p in enumerate(paths)))
    return str(inp)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _both(tmp_path, inp, k, s, use_filter=False, **kw):
    """(reference file bytes, port file bytes, the port's metrics)."""
    a, b = str(tmp_path / "ref.bin"), str(tmp_path / "port.bin")
    max_reads = kw.pop("max_reads", 0)
    ref_sketch(inp, a, k, s, 100, use_filter, verbose=False,
               max_reads=max_reads)
    m = sketch_command(inp, b, k, s, 100, use_filter, verbose=False,
                       device="cpu", max_reads=max_reads, **kw)
    return _bytes(a), _bytes(b), m


@pytest.mark.parametrize("k", [21, 31])
@pytest.mark.parametrize("use_filter", [False, True])
@pytest.mark.parametrize("s", [150, 50_000])
def test_sketch_command_matches_reference(samples, tmp_path, k, use_filter,
                                          s):
    """s=150 fills every sketch (the largest member's heap-quirk count),
    50000 leaves them underfull; the batched route either way."""
    want, got, m = _both(tmp_path, _input(tmp_path, samples[:4]), k, s,
                         use_filter)
    assert got == want
    assert m["sketch_route"] == "batched"
    # the prefilter keeps 8 s / (a sample's ~30 kB) of the hash range
    # when that is under a quarter, and never under -filter
    if use_filter or s == 50_000:
        assert m["prefilter_fraction"] == 1.0
    else:
        assert m["prefilter_fraction"] < 0.25
    assert 0 < m["kept_instances"] <= m["instances"]
    sizes = [len(SketchFile(str(tmp_path / "port.bin")).read_slot(i)[0])
             for i in range(4)]
    if s == 150:
        assert sizes == [150] * 4
    else:
        assert all(0 < n < 50_000 for n in sizes)


@pytest.mark.parametrize("route,kw,samples_route", [
    ("bail", dict(instance_limit=100), ["one-shot"] * 4),
    ("streaming", dict(instance_limit=0, stream_threshold=500),
     ["streaming"] * 4),
    ("filter streaming", dict(use_filter=True, instance_limit=0,
                              stream_threshold=500), ["streaming"] * 4),
    ("streaming underfull", dict(instance_limit=0, stream_threshold=1),
     ["streaming"] * 4),
])
def test_every_route_matches_reference(samples, tmp_path, route, kw,
                                       samples_route, capsys):
    use_filter = kw.pop("use_filter", False)
    s = 50_000 if "underfull" in route else 150
    want, got, m = _both(tmp_path, _input(tmp_path, samples[:4]), 21, s,
                         use_filter, **kw)
    assert got == want
    assert m["sketch_route"] == "per-sample"
    assert m["sample_routes"] == samples_route
    # -filter's streaming route cuts every sample's held stream once
    assert m["filter_cuts"] == (4 if use_filter else 0)
    assert m["sketch_route_reason"].startswith("stream")
    assert "batched sketch fallback: stream" in capsys.readouterr().err


def test_one_sample_takes_the_per_sample_route(samples, tmp_path):
    want, got, m = _both(tmp_path, _input(tmp_path, samples[:1]), 21, 150)
    assert got == want
    assert (m["sketch_route"], m["sketch_route_reason"]) == ("per-sample",
                                                             "one sample")
    assert m["sample_routes"] == ["one-shot"]


def test_underfill_leaves_for_the_per_sample_route(samples, tmp_path,
                                                   monkeypatch, capsys):
    """An overestimated sample size shrinks the prefilter's bound past
    the true bottom-s: the batched route must notice and leave."""
    monkeypatch.setattr(sk, "_estimate_sample_windows", lambda src: 1 << 40)
    want, got, m = _both(tmp_path, _input(tmp_path, samples[:4]), 21, 500)
    assert got == want
    assert m["sketch_route"] == "per-sample"
    assert m["sketch_route_reason"].startswith("prefilter underfill")
    assert "prefilter underfill" in capsys.readouterr().err


def test_prefilter_engages_at_small_s(samples, tmp_path):
    est = min(sk._estimate_sample_windows(PackedReadSource([[p]]))
              for p in samples)
    s_small = max(1, int(est * 0.25 / 8) - 1)
    want, got, m = _both(tmp_path, _input(tmp_path, samples), 21, s_small)
    assert got == want
    assert m["sketch_route"] == "batched"
    assert m["kept_instances"] < m["instances"] / 4


def test_empty_sample_and_max_reads(samples, tmp_path):
    empty = tmp_path / "empty.fasta"
    empty.write_bytes(b">r0\nACGT\n>r1\nNNNNN\n")
    inp = _input(tmp_path, [samples[0], str(empty), samples[1]])
    for max_reads in (0, 100):
        want, got, m = _both(tmp_path, inp, 21, 300, max_reads=max_reads)
        assert got == want
        assert len(SketchFile(str(tmp_path / "port.bin")).read_slot(1)[0]) == 0
    # every sample empty: nothing to sketch on any route
    inp = _input(tmp_path, [str(empty), str(empty)])
    for kw in ({}, dict(instance_limit=0)):
        want, got, _ = _both(tmp_path, inp, 21, 300, **kw)
        assert got == want


def _reads(rng, n, length):
    bases = np.frombuffer(b"ACGTN", np.uint8)
    out = []
    for _ in range(n):
        ln = int(rng.integers(25, length))
        codes = rng.choice(5, size=ln, p=[0.24, 0.24, 0.24, 0.24, 0.04])
        out.append(bases[codes].tobytes())
    return out


@pytest.mark.parametrize("use_filter", [False, True])
@pytest.mark.parametrize("s", [8, 64, 100_000])
@pytest.mark.parametrize("threshold", [None, 300])
def test_compute_sketch_matches_host_oracle(use_filter, s, threshold):
    """One-shot, and streaming past 300 held instances over 128-read
    batches: -filter cuts the held stream (s 8 and 64) or, with fewer
    than s hashes seen twice (s 100000), holds it whole."""
    from simka_tpu.minhash.sketch import _compute_sketch_host

    rng = np.random.default_rng(13)
    reads = _reads(rng, 400, 90)
    reads = reads[:200] + reads[:150] + reads[200:]
    want = _compute_sketch_host(reads, 21, s, 100, use_filter,
                                batch_reads=128)
    obs = {}
    got = sk.compute_sketch(reads, 21, s, 100, use_filter, batch_reads=128,
                            device="cpu", stream_threshold=threshold,
                            observer=obs)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].dtype == np.uint64 and got[1].dtype == np.uint32
    assert obs["sample_routes"] == ["one-shot" if threshold is None
                                    else "streaming"]
    cut = use_filter and threshold is not None and s < 100_000
    assert (obs["filter_cuts"] > 0) == cut
    if cut:  # later batches keep only hashes at or below the bound
        assert obs["kept_instances"] < obs["instances"]


def test_filter_cut_keeps_the_bottom_s_seen_twice():
    """The cut's bound is the s-th smallest hash seen at least twice
    (an all-ones hash included), and the cut keeps the held order."""
    rng = np.random.default_rng(3)
    stream = rng.integers(0, 2**64, size=400, dtype=np.uint64)
    stream = np.concatenate([stream, stream[::3], [FULL64, FULL64]])
    rng.shuffle(stream)
    twice = np.unique(stream)[[int((stream == u).sum()) >= 2
                               for u in np.unique(stream)]]
    for s in (1, 20, len(twice)):
        got, bound = sk._filter_cut(torch.from_numpy(stream.view(np.int64)),
                                    s)
        assert np.uint64(bound % 2**64) == twice[s - 1]
        np.testing.assert_array_equal(got.numpy().view(np.uint64),
                                      stream[stream <= twice[s - 1]])
    assert sk._filter_cut(torch.from_numpy(stream.view(np.int64)),
                          len(twice) + 1) is None


@pytest.mark.parametrize("s", [50, 500, 10**6])
@pytest.mark.parametrize("threshold", [1, 5000])
def test_streaming_matches_one_shot(s, threshold):
    """Tiny super-batches (threshold 1 folds every read batch) across
    many read batches: hashes and counts equal the reference's sketch;
    s=50 carries the largest member's correction across batches."""
    from simka_tpu.minhash.sketch import compute_sketch as ref_compute

    rng = np.random.default_rng(17)
    bases = np.frombuffer(b"ACGT", np.uint8)
    base = [bytes(rng.choice(bases, size=60)) for _ in range(120)]
    reads = base + base[::-1] + [bytes(rng.choice(bases, size=60))
                                 for _ in range(80)] + base[::3]
    want = ref_compute(reads, 15, s, 100)
    obs = {}
    got = sk.compute_sketch(reads, 15, s, 100, batch_reads=16, device="cpu",
                            stream_threshold=threshold, observer=obs)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert obs["sample_routes"] == ["streaming"]


def test_filter_bloom_matches_reference(tmp_path):
    from simka_tpu.minhash.bloom import compute_sketch_bloom as ref_bloom
    from simka_tpu_torch.minhash.bloom import compute_sketch_bloom

    rng = np.random.default_rng(12)
    bases = np.frombuffer(b"ACGT", np.uint8)
    reads = [bytes(rng.choice(bases, size=80)) for _ in range(300)]
    reads = reads + reads[:100]
    for k, s, bits in ((21, 10**9, 10000), (15, 50, 1 << 28),
                       (21, 200, 1 << 20)):
        want = ref_bloom(reads, k, s, 100, bloom_bits=bits)
        got = compute_sketch_bloom(reads, k, s, 100, bits, device="cpu")
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    with pytest.raises(ValueError):
        compute_sketch_bloom(reads, 33, 50, 100, 10000, device="cpu")


def test_min_cli_matches_reference(samples, tmp_path, capsys):
    """`min sketch` (-filter-bloom too), `min info` and `min append`
    through both CLIs: the same files, the same text."""
    from simka_tpu.minhash.cli import min_main as ref_min
    from simka_tpu_torch.cli import main as port_main

    inp = _input(tmp_path, samples[:3])
    for flags in (["-nb-kmers", "200"], ["-nb-kmers", "200", "-filter"],
                  ["-nb-kmers", "200", "-filter-bloom", "-max-memory", "1"],
                  ["-kmer-size", "31", "-seed", "7", "-max-reads", "50"]):
        a, b = str(tmp_path / "a.sketch"), str(tmp_path / "b.sketch")
        assert ref_min(["sketch", "-in", inp, "-out", a, *flags]) == 0
        ref_out = capsys.readouterr()
        assert port_main(["min", "sketch", "-in", inp, "-out", b, *flags,
                          "-device", "cpu"]) == 0
        port_out = capsys.readouterr()
        assert _bytes(a) == _bytes(b), flags
        assert port_out.out == ref_out.out
        assert port_out.err == ref_out.err
    # info: the same text for the same file
    for path in (a, b):
        assert ref_min(["info", "-in", path]) == 0
        want = capsys.readouterr().out
        assert port_main(["min", "info", "-in", path]) == 0
        assert capsys.readouterr().out == want
    # append, into copies of one file
    c = str(tmp_path / "c.sketch")
    assert port_main(["min", "sketch", "-in", _input(tmp_path, samples[3:5],
                                                     "in2.txt"),
                      "-out", c, "-kmer-size", "31", "-seed", "7",
                      "-device", "cpu"]) == 0
    capsys.readouterr()
    assert ref_min(["append", "-in1", a, "-in2", c]) == 0
    assert port_main(["min", "append", "-in1", b, "-in2", c]) == 0
    assert _bytes(a) == _bytes(b)
    assert SketchFile(b).header().nb_datasets == 5
    assert port_main(["min", "info", "-in", b]) == 0
    assert "Nb datasets: 5" in capsys.readouterr().out


@pytest.mark.parametrize("cmd", [
    ["distance", "-in1", "{x}", "-in2", "{x}", "-out", "{out}"],
    ["export", "-in", "{dist}", "-in1", "{x}", "-in2", "{x}", "-out",
     "{out}"],
    ["pipeline", "-in", "{inp}", "-out", "{out}", "-nb-kmers", "200"],
    ["update", "-in", "{new}", "-out", "{out}"],
    ["matrix-update", "-in", "{out}", "-in-evn", "{evn}", "-in-nvn", "{nvn}",
     "-n-old", "2", "-n-new", "1"],
])
def test_min_subcommands_still_to_port_raise(cmd, samples, tmp_path):
    """Each `min` subcommand of ROADMAP item 11b (which raised
    NotImplementedError until it was ported) through both CLIs on the
    same files: the same .bin matrices, sketch.bin and CSV text."""
    from simka_tpu.minhash.cli import min_main as ref_min
    from simka_tpu_torch.cli import main as port_main

    x, y = str(tmp_path / "x.sketch"), str(tmp_path / "y.sketch")
    inp = _input(tmp_path, samples[:2])
    new = tmp_path / "new.txt"
    new.write_text(f"S2: {samples[2]}\n")
    assert ref_min(["sketch", "-in", inp, "-out", x, "-nb-kmers", "200"]) == 0
    assert ref_min(["sketch", "-in", str(new), "-out", y, "-nb-kmers",
                    "200"]) == 0
    paths = {"x": x, "inp": inp, "new": str(new)}
    for name, a, b in (("dist", x, x), ("evn", x, y), ("nvn", y, y)):
        paths[name] = str(tmp_path / name)
        assert ref_min(["distance", "-in1", a, "-in2", b, "-out",
                        paths[name]]) == 0
    base = str(tmp_path / "base")
    assert ref_min(["pipeline", "-in", inp, "-out", base, "-nb-kmers",
                    "200"]) == 0
    got = {}
    for side in ("ref", "port"):
        out = tmp_path / side
        if cmd[0] == "update":
            shutil.copytree(base, out)
        elif cmd[0] == "matrix-update":
            shutil.copytree(paths["dist"], out)
        argv = [a.format(out=out, **paths) for a in cmd]
        if side == "ref":
            assert ref_min(argv) == 0
        else:
            dev = [] if cmd[0] in ("export", "matrix-update") else [
                "-device", "cpu"]
            assert port_main(["min", *argv, *dev]) == 0
        got[side] = {
            str(p.relative_to(out)): (gzip.open(p, "rt").read()
                                      if p.suffix == ".gz" else p.read_bytes())
            for p in sorted(out.rglob("*")) if p.is_file()}
    assert got["ref"] and got["port"] == got["ref"]
    assert any(k.endswith(".bin") or k.endswith(".gz") for k in got["ref"])


def test_min_sketch_cuda_without_gpu_raises(samples, tmp_path, monkeypatch):
    from simka_tpu_torch.cli import main as port_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "x.sketch"
    with pytest.raises(RuntimeError, match="cuda"):
        port_main(["min", "sketch", "-in", _input(tmp_path, samples[:2]),
                   "-out", str(out)])
    assert not out.exists()
    assert port_main(["min", "sketch", "-in", _input(tmp_path, samples[:2]),
                      "-out", str(out), "-kmer-size", "32", "-device",
                      "cpu"]) == 1  # SimkaMin's k is 1..31


@pytest.mark.parametrize("native", [True, False])
def test_gatb_sources_pack_like_the_reference(samples, native, monkeypatch):
    """The sketch's packed batches: the port's gatb PackedReadSource
    (native, and the Python encoder) against the reference's."""
    if not native:
        monkeypatch.setenv("SIMKA_TPU_NO_NATIVE", "1")
    got = list(PackedReadSource([[samples[0]]], encoding="gatb")
               .iter_packed(64, k=21))
    want = list(RefSource([[samples[0]]], encoding="gatb")
                .iter_packed(64, k=21))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
        assert g[2:] == w[2:]
