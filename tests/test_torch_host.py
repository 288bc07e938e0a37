"""The port's jax-free copies of the host modules agree with their
originals in simka_tpu, so the two cannot drift: the input DSL, the
native parser's C++ source, the packed read source (native and
pure-Python), the CSV format, the statistics + distance formulas on one
JoinStats, the count checkpoints (key and file format), the
repartition histogram of the checkpoint path with its host hash,
SimkaMin's murmur hash, sketch file, Bloom replay and distance walk, and
the figures of viz/."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

import simka_tpu.core.distances as ref_dist
import simka_tpu.core.output as ref_out
import simka_tpu.core.stats as ref_stats
import simka_tpu.io.dsl as ref_dsl
import simka_tpu.io.packed as ref_packed
import simka_tpu_torch.core.distances as port_dist
import simka_tpu_torch.core.output as port_out
import simka_tpu_torch.core.stats as port_stats
import simka_tpu_torch.io.dsl as port_dsl
import simka_tpu_torch.io.packed as port_packed
from simka_tpu.config import SimkaConfig as RefConfig
from simka_tpu.ops.countjoin import count_join_stats
from simka_tpu_torch.config import SimkaConfig


def _write_fasta(path, reads):
    with open(path, "wb") as f:
        for i, r in enumerate(reads):
            f.write(b">r%d\n%s\n" % (i, r))


@pytest.fixture()
def banks(tmp_path):
    rng = np.random.default_rng(5)
    bases = np.frombuffer(b"ACGTN", np.uint8)

    def reads(n):
        return [
            bytes(rng.choice(bases, size=int(rng.integers(15, 140)),
                             p=[0.24, 0.24, 0.24, 0.24, 0.04]))
            for _ in range(n)
        ]

    paths = []
    for name, n in (("a1", 37), ("a2", 23), ("b1", 41)):
        p = tmp_path / f"{name}.fasta"
        _write_fasta(p, reads(n))
        paths.append(str(p))
    fq = tmp_path / "c1.fastq"
    with open(fq, "wb") as f:
        for i, r in enumerate(reads(19)):
            f.write(b"@q%d\n%s\n+\n%s\n" % (i, r, b"I" * len(r)))
    # two ';'-groups: [a1, a2] and [b1, c1]
    return [[paths[0], paths[1]], [paths[2], str(fq)]]


def test_parse_input_file_matches(tmp_path, banks):
    inp = tmp_path / "input.txt"
    inp.write_text(
        f"A: {banks[0][0]} , {banks[0][1]} ; {banks[1][0]}\n\n"
        f"B:{banks[1][1]}\n  C : a1.fasta\n"
    )
    got = port_dsl.parse_input_file(str(inp))
    want = ref_dsl.parse_input_file(str(inp))
    assert [(d.id, d.banks) for d in got] == [(d.id, d.banks) for d in want]


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("max_reads", [0, 10, 60])
def test_iter_packed_matches(banks, native, max_reads, monkeypatch):
    if not native:
        monkeypatch.setenv("SIMKA_TPU_NO_NATIVE", "1")
    else:
        from simka_tpu_torch.io import native as port_native

        assert port_native.available()

    def batches(mod):
        src = mod.PackedReadSource(banks, 20, 0.5, max_reads=max_reads)
        return [
            (p.copy(), v.copy(), n, nv)
            for p, v, n, nv in src.iter_packed(16, k=21)
        ]

    got, want = batches(port_packed), batches(ref_packed)
    assert len(got) == len(want) > 0
    for (gp, gv, gn, gnv), (wp, wv, wn, wnv) in zip(got, want):
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_array_equal(gv, wv)
        assert (gn, gnv) == (wn, wnv)
    if native and not max_reads:
        assert all(nv is not None for *_, nv in got)


def test_native_parser_source_is_the_reference_copy():
    """The port builds its own copy of fastx.cpp; it must stay the
    reference's byte for byte (the same parse of the same inputs is
    test_iter_packed_matches)."""
    from simka_tpu_torch.io import native as port_native

    ref = os.path.join(os.path.dirname(ref_packed.__file__), "native",
                       "fastx.cpp")
    assert os.path.dirname(port_native.SRC) == os.path.dirname(
        port_native.__file__)
    with open(port_native.SRC, "rb") as f, open(ref, "rb") as g:
        assert f.read() == g.read()


def test_format_matrix_csv_matches():
    rng = np.random.default_rng(2)
    m = rng.random((5, 5)) * 1.5
    m[1, 2] = 1 / 3
    ids = [f"S{i}" for i in range(5)]
    assert port_out.format_matrix_csv(m, ids) == ref_out.format_matrix_csv(
        m, ids
    )


def test_config_from_fields_copies_every_field():
    ref = RefConfig(input_filename="x", kmer_size=31, abundance_min=0,
                    max_reads=7, verbose=False, n_shards=1)
    got = SimkaConfig.from_fields(ref)
    assert got.__dict__ == ref.__dict__


@pytest.mark.parametrize("simple,complex_", [(False, False), (True, True)])
def test_stats_and_distances_match(simple, complex_):
    rng = np.random.default_rng(9)
    E, n = 1 << 12, 6
    hi = np.zeros(E, np.uint32)
    lo = rng.integers(0, 1 << 9, size=E, dtype=np.uint64).astype(np.uint32)
    sid = rng.integers(0, n, size=E).astype(np.int32)
    js = count_join_stats(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(sid),
        jnp.int32(2), jnp.int64(10**9), n_banks=n,
        simple=simple, complex_=complex_, hi_bits=0,
    )
    js_np = type(js)(*(np.asarray(f) for f in js))
    ids = [f"S{i}" for i in range(n)]
    reads = np.arange(1, n + 1, dtype=np.int64) * 100
    want = ref_stats.SimkaStatistics.from_join_stats(
        js, ids, 21, reads, simple, complex_
    )
    got = port_stats.SimkaStatistics.from_join_stats(
        js_np, ids, 21, reads, simple, complex_
    )
    for name, value in want.__dict__.items():
        np.testing.assert_array_equal(getattr(got, name), value, err_msg=name)
    assert got.summary() == want.summary()
    m_got = port_dist.compute_all_matrices(got)
    m_want = ref_dist.compute_all_matrices(want)
    assert list(m_got) == list(m_want)
    for name in m_want:
        assert port_out.format_matrix_csv(m_got[name], ids) == (
            ref_out.format_matrix_csv(m_want[name], ids)
        ), name


@pytest.mark.parametrize("k", [21, 31, 32, 63, 64])
def test_checkpoint_copy_matches(tmp_path, banks, k):
    """core/checkpoint.py: the same key for the same count, and a file
    written by either package loads in the other field for field."""
    import simka_tpu.core.checkpoint as ref_ckpt
    import simka_tpu_torch.core.checkpoint as port_ckpt
    from simka_tpu_torch.ops.kmers import n_uint32_words

    files = banks[0] + banks[1]
    args = (files, k, 20, 0.5, 7, 1.25)
    key = port_ckpt.count_key(*args)
    assert key == ref_ckpt.count_key(*args)
    assert key != port_ckpt.count_key(files[:-1], *args[1:])
    rng = np.random.default_rng(k)
    n = 300
    words = tuple(rng.integers(0, 1 << 32, size=n, dtype=np.uint64)
                  .astype(np.uint32) for _ in range(n_uint32_words(k)))
    counts = rng.integers(1, 1 << 20, size=n).astype(np.int64)
    for writer, reader in ((port_ckpt, ref_ckpt), (ref_ckpt, port_ckpt)):
        d = tmp_path / writer.__name__
        writer.CountCheckpoint(str(d)).save("S0", key, words, counts, 41)
        got = reader.CountCheckpoint(str(d)).load("S0", key)
        assert got is not None
        for g, w in zip(got[0], words):
            assert g.dtype == np.uint32
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(got[1], counts)
        assert got[2] == 41 and len(got[0]) == len(words)
        assert reader.CountCheckpoint(str(d)).load("S0", "other") is None
        z = np.load(reader.CountCheckpoint(str(d)).path("S0"))
        assert int(z["nb_kmers"]) == int(counts.sum())
        assert int(z["chord_n2"]) == int((counts ** 2).sum())


def test_mix_hash_np_and_repartition_histogram_match():
    import simka_tpu.core.pipeline as ref_pipeline
    from simka_tpu.parallel.sharded import _mix_hash_np as ref_mix

    import simka_tpu_torch.core.pipeline as port_pipeline
    from simka_tpu_torch.ops.kmers import mix_hash_np

    rng = np.random.default_rng(3)

    def u32(n):
        return rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(
            np.uint32)

    a, b = u32(5000), u32(5000)
    np.testing.assert_array_equal(mix_hash_np(a, b),
                                  ref_mix(a, b))
    spectra = [((u32(n), u32(n), u32(n)),
                rng.integers(1, 9, size=n).astype(np.int64))
               for n in (0, 700, 1300)]
    np.testing.assert_array_equal(
        port_pipeline.repartition_histogram(spectra, 2, 6),
        ref_pipeline.repartition_histogram(spectra, 2, 6),
    )


def test_sweep_planning_copies_match(tmp_path, banks, monkeypatch):
    """core/budget.py's estimate_total_instances and core/sweep.py's
    choose_n_ranges and filtered_solid_per_bank against their
    originals, and spectrum_rows_budget at equal budgets: a k=21 row is
    16 bytes in both packages (one int64 word against two uint32
    words, then the sample id and the count)."""
    import gzip

    import torch

    import simka_tpu.core.budget as ref_budget
    import simka_tpu.core.sweep as ref_sweep
    import simka_tpu_torch.core.budget as port_budget
    import simka_tpu_torch.core.sweep as port_sweep

    gz = tmp_path / "g.fasta.gz"
    with open(banks[0][0], "rb") as f, gzip.open(gz, "wb") as g:
        g.write(f.read())
    datasets = port_dsl.parse_input_file(_input_file(
        tmp_path, banks[0] + [str(gz), str(tmp_path / "missing.fasta")],
        banks[1]))
    assert port_budget.estimate_total_instances(datasets) == (
        ref_budget.estimate_total_instances(datasets)) > 0
    for rows in (0, 1, 7812, 7813, 10**9):
        for nw32 in (2, 3, 5):
            for mm in (1, 5000):
                for req in (0, 3):
                    assert port_sweep.choose_n_ranges(rows, nw32, mm, req) == (
                        ref_sweep.choose_n_ranges(rows, nw32, mm, req))
    rng = np.random.default_rng(4)
    counts = [rng.integers(1, 12, size=n).astype(np.int64) for n in (0, 50, 9)]
    for amin, amax in ((0, 10**9), (2, 6)):
        np.testing.assert_array_equal(
            port_sweep.filtered_solid_per_bank(counts, amin, amax),
            ref_sweep.filtered_solid_per_bank(counts, amin, amax))
    for hbm in ("0.5", "3", "80000"):
        monkeypatch.setenv("SIMKA_TPU_HBM_MB", hbm)
        for mm in (1, 100, 5000):
            assert port_budget.spectrum_rows_budget(
                torch.device("cpu"), 1, mm) == (
                ref_budget.spectrum_rows_budget(2, mm))


def _input_file(tmp_path, *groups):
    inp = tmp_path / "input.txt"
    inp.write_text("".join(f"S{i}: {' , '.join(g)}\n"
                           for i, g in enumerate(groups)))
    return str(inp)


def test_murmur_copy_matches():
    import simka_tpu.minhash.murmur as ref_murmur
    import simka_tpu_torch.minhash.murmur as port_murmur

    rng = np.random.default_rng(6)
    vals = rng.integers(0, 1 << 64, size=5000, dtype=np.uint64)
    vals[:3] = [0, (1 << 64) - 1, 1 << 63]
    for seed in (0, 100, (1 << 32) - 1):
        np.testing.assert_array_equal(port_murmur.murmur3_u64(vals, seed),
                                      ref_murmur.murmur3_u64(vals, seed))


def test_sketch_file_copy_matches(tmp_path):
    """sketch_file.py: files written by either package read in the
    other, and create / write_slot / write_ids / append / info give the
    same bytes and text."""
    import simka_tpu.minhash.sketch_file as ref_sf
    import simka_tpu_torch.minhash.sketch_file as port_sf

    rng = np.random.default_rng(7)
    slots = [np.sort(rng.integers(1, 1 << 64, size=n, dtype=np.uint64))
             for n in (40, 0, 17)]
    counts = [rng.integers(1, 99, size=len(h)).astype(np.uint32)
              for h in slots]
    files = {}
    for name, mod in (("port", port_sf), ("ref", ref_sf)):
        for part, rows in (("a", (0, 1, 2)), ("b", (2, 0))):
            path = str(tmp_path / f"{name}_{part}.sketch")
            sf = mod.SketchFile.create(path, 21, 40, 100, len(rows))
            for i, r in enumerate(rows):
                sf.write_slot(i, slots[r], counts[r])
            sf.write_ids([f"S{r}" for r in rows])
            files[(name, part)] = path
        mod.SketchFile(files[(name, "a")]).append(
            mod.SketchFile(files[(name, "b")]))
    with open(files[("port", "a")], "rb") as f, \
            open(files[("ref", "a")], "rb") as g:
        assert f.read() == g.read()
    for reader, writer in ((port_sf, "ref"), (ref_sf, "port")):
        sf = reader.SketchFile(files[(writer, "a")])
        assert sf.ids() == ["S0", "S1", "S2", "S2", "S0"]
        for i, r in enumerate((0, 1, 2, 2, 0)):
            h, c = sf.read_slot(i)
            np.testing.assert_array_equal(h, slots[r])
            np.testing.assert_array_equal(c, counts[r])
    assert port_sf.SketchFile(files[("ref", "a")]).info().replace(
        "ref_a", "port_a") == ref_sf.SketchFile(files[("port", "a")]).info()


def test_min_distance_copy_matches(tmp_path):
    """minhash/distance.py: the host walk on the same pairs (empty,
    length 1, overlapping, the all-ones hash), the all-pairs blocks
    symmetric and rectangular, the binary matrix files and their growth
    give the same numbers and bytes."""
    import simka_tpu.minhash.distance as ref_d
    import simka_tpu_torch.minhash.distance as port_d

    assert port_d.MATRIX_NAMES == ref_d.MATRIX_NAMES
    rng = np.random.default_rng(11)
    pool = rng.integers(0, 1 << 64, size=300, dtype=np.uint64)
    sk = [(np.empty(0, np.uint64), np.empty(0, np.uint32)),
          (pool[:1].copy(), np.array([4], np.uint32))]
    for n in (20, 150, 90, 200):
        h = np.unique(np.concatenate([
            pool[rng.integers(0, 300, n)],
            rng.integers(0, 1 << 64, n, dtype=np.uint64),
            np.array([2**64 - 1] if n == 90 else [], np.uint64)]))
        sk.append((h, rng.integers(1, 1 << 32, len(h),
                                   dtype=np.uint64).astype(np.uint32)))
    for a in sk:
        for b in sk:
            assert port_d.sketch_pair_distance(*a, *b) == (
                ref_d.sketch_pair_distance(*a, *b))
    for s1, s2, sym in ((sk, sk, True), (sk[:3], sk[2:], False)):
        for g, w in zip(port_d.compute_distance_block(s1, s2, sym),
                        ref_d.compute_distance_block(s1, s2, sym)):
            np.testing.assert_array_equal(g, w)
    old, evn, nvn = (rng.random(shape).astype(np.float32)
                     for shape in ((3, 3), (3, 2), (2, 2)))
    np.testing.assert_array_equal(port_d.merge_matrices(old, evn, nvn),
                                  ref_d.merge_matrices(old, evn, nvn))
    files = {}
    for name, mod in (("port", port_d), ("ref", ref_d)):
        mat = mod.BinaryMatrix(str(tmp_path / f"{name}.bin"), 5, 5)
        mat.write_block(2, 3, evn)
        mat.write_block(0, 0, old)
        files[name] = (tmp_path / f"{name}.bin").read_bytes()
        np.testing.assert_array_equal(mat.read()[2:, 3:], evn)
    assert files["port"] == files["ref"]


def test_bloom_copy_matches():
    import simka_tpu.minhash.bloom as ref_bloom
    import simka_tpu_torch.minhash.bloom as port_bloom

    for mm, cores in ((8000, 1), (8000, 4), (0, 1), (100, 0)):
        assert port_bloom.bloom_bits_from_config(mm, cores) == (
            ref_bloom.bloom_bits_from_config(mm, cores))
    h = np.array([50, 50, 10, 10, 30, 30, 50, 30, 10], dtype=np.uint64)
    v = np.array([0, 0, 1, 1, 2, 2, 0, 2, 1], dtype=np.uint64)
    rng = np.random.default_rng(8)
    vals = rng.integers(0, 1 << 40, size=300, dtype=np.uint64)
    pick = rng.integers(0, 300, size=4000)
    for hashes, values, s, bits in (
            (h, v, 2, 1 << 20),
            (vals[pick] * np.uint64(2654435761), vals[pick], 50, 10000),
            (vals[pick] ^ np.uint64(12345), vals[pick], 10**6, 4096)):
        got = port_bloom.replay_sketch_bloom(hashes, values, s, bits)
        want = ref_bloom.replay_sketch_bloom(hashes, values, s, bits)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    # the streaming form, fed in pieces
    rp = port_bloom.BloomReplay(50, 10000)
    for part in np.array_split(np.arange(4000), 5):
        rp.feed(vals[pick][part] * np.uint64(2654435761), vals[pick][part])
    want = ref_bloom.replay_sketch_bloom(vals[pick] * np.uint64(2654435761),
                                         vals[pick], 50, 10000)
    for g, w in zip(rp.result(), want):
        np.testing.assert_array_equal(g, w)


def test_gatb_encoding_copies_match():
    """io/bank.py's encode_batch_gatb against minhash/sketch.py's, and
    io/packed.py's gatb host_pack_chunk against the reference's."""
    from simka_tpu.minhash.sketch import encode_batch_gatb as ref_enc
    from simka_tpu_torch.io.bank import encode_batch_gatb

    rng = np.random.default_rng(9)
    bases = np.frombuffer(b"ACGTNacgtn", np.uint8)
    reads = [bytes(rng.choice(bases, size=int(rng.integers(5, 90))))
             for _ in range(70)]
    for width in (None, 48, 96):
        for g, w in zip(encode_batch_gatb(reads, width),
                        ref_enc(reads, width)):
            np.testing.assert_array_equal(g, w)
    for k in (15, 21, 31):
        for g, w in zip(port_packed.host_pack_chunk(reads, k, "gatb"),
                        ref_packed.host_pack_chunk(reads, k, "gatb")):
            np.testing.assert_array_equal(g, w)


def _viz_matrices(tmp_path):
    """A result directory of three matrices (one gzipped) of 6 samples,
    and a metadata table."""
    rng = np.random.default_rng(8)
    ids = [f"S{i}" for i in range(6)]
    d = tmp_path / "mats"
    d.mkdir()
    for name, gz in (("braycurtis", False), ("jaccard", True),
                     ("chord", False)):
        m = rng.random((6, 6))
        m = (m + m.T) / 2
        np.fill_diagonal(m, 0)
        text = port_out.format_matrix_csv(m, ids)
        path = d / f"mat_abundance_{name}.csv"
        if gz:
            import gzip

            with gzip.open(str(path) + ".gz", "wt") as f:
                f.write(text)
        else:
            path.write_text(text)
    meta = tmp_path / "meta.csv"
    meta.write_text("DATASET_ID;GROUP\n" + "".join(
        f"{i};{'ab'[j % 2]}\n" for j, i in enumerate(ids)))
    return str(d), str(meta)


def test_viz_copy_matches(tmp_path):
    """The port's viz/visualize.py against simka_tpu's: the same
    matrices loaded, the same metadata, the same PCoA, the same figures
    (names and PNG bytes) over one result directory."""
    import simka_tpu.viz.visualize as ref_viz
    import simka_tpu_torch.viz.visualize as port_viz

    mats, meta = _viz_matrices(tmp_path)
    for name in sorted(os.listdir(mats)):
        ids_a, a = port_viz.load_distance_matrix(os.path.join(mats, name))
        ids_b, b = ref_viz.load_distance_matrix(os.path.join(mats, name))
        assert ids_a == ids_b and np.array_equal(a, b)
        for x, y in zip(port_viz.pcoa(a, 3), ref_viz.pcoa(b, 3)):
            np.testing.assert_array_equal(x, y)
    assert port_viz.load_metadata(meta, "GROUP") == ref_viz.load_metadata(
        meta, "GROUP")
    figs = {}
    for side, mod in (("port", port_viz), ("ref", ref_viz)):
        out = str(tmp_path / side)
        files = mod.run_visualization(mats, out, metadata_filename=meta,
                                      metadata_variable="GROUP")
        figs[side] = {os.path.basename(f): open(f, "rb").read()
                      for f in files}
    assert len(figs["port"]) == 9 and figs["port"] == figs["ref"]


def test_viz_draws_a_port_run(tmp_path):
    """Figures from the CSVs of one of the port's own runs (the CLI on
    the CPU over a simulated community): every matrix gives a heatmap,
    a dendrogram and a PCoA, and the PCoA places the samples from the
    Bray-Curtis matrix."""
    from simka_tpu_torch.cli import main as port_main
    from simka_tpu_torch.utils.community import write_community
    from simka_tpu_torch.viz.visualize import main as viz_main
    from simka_tpu_torch.viz.visualize import load_distance_matrix, pcoa

    inp = write_community(str(tmp_path / "c"), seed=4, n_samples=4,
                          n_genomes=3, genome_len=3000,
                          reads_per_sample=200, n_frac=0.0)
    out = str(tmp_path / "out")
    assert port_main(["-in", inp, "-out", out, "-verbose", "0",
                      "-device", "cpu"]) == 0
    figs = str(tmp_path / "figs")
    assert viz_main(["-in", out, "-out", figs]) == 0
    names = sorted(os.listdir(figs))
    assert len(names) == 15 * 3
    assert all(os.path.getsize(os.path.join(figs, n)) > 1000 for n in names)
    ids, mat = load_distance_matrix(
        os.path.join(out, "mat_abundance_braycurtis.csv.gz"))
    assert ids == ["S0", "S1", "S2", "S3"] and mat.shape == (4, 4)
    coords, explained = pcoa(mat)
    assert coords.shape == (4, 2) and 0 <= explained[0] <= 1
