"""The port's CLI with the optional distances (-simple-dist
-complex-dist) and the k-mer Shannon filter, on the CPU against
simka_tpu.core.pipeline.run_simka (n_shards=1) on the same simulated
community files: byte-equal CSV text and repartition histograms.

One matrix is held to one unit of its last printed digit instead:
mat_abundance_jensenshannon, from the Kullback-Leibler pair sums. The
reference sums those terms in f32 over 8192-row panels, which puts up
to ~6e-6 relative error in them (ROADMAP.md section 3); the port's sum
is exact (tests/test_torch_countjoin.py), so the two can round the
sixth decimal differently."""

import numpy as np
import pytest

from simka_tpu.config import SimkaConfig as RefConfig
from simka_tpu.core.pipeline import run_simka as run_ref
from simka_tpu_torch.cli import main as port_main
from simka_tpu_torch.utils.community import write_community
from test_torch_pipeline import _outputs, community  # noqa: F401 (fixture)


# matrices derived from the reference's f32 Kullback-Leibler sums
KL_MATRICES = ("mat_abundance_jensenshannon.csv.gz",)


def _assert_csvs_match(got, want, n_matrices):
    assert list(got) == list(want) and len(got) == n_matrices
    for name in want:
        if name not in KL_MATRICES:
            assert got[name] == want[name], name
            continue
        g, w = got[name].splitlines(), want[name].splitlines()
        assert g[0] == w[0] and len(g) == len(w), name
        for gl, wl in zip(g[1:], w[1:]):
            gv, wv = gl.split(";"), wl.split(";")
            assert gv[0] == wv[0] and len(gv) == len(wv), name
            diff = max(abs(float(a) - float(b)) for a, b in zip(gv[1:], wv[1:]))
            assert diff <= 1.0000001e-6, (name, gl, wl)


def _run_both(inp, tmp_path, k, amin, flags=(), **ref_kw):
    port_out, ref_out = str(tmp_path / "port"), str(tmp_path / "ref")
    rc = port_main([
        "-in", inp, "-out", port_out, "-kmer-size", str(k),
        "-abundance-min", str(amin), "-verbose", "0", "-device", "cpu",
        *flags,
    ])
    assert rc == 0
    run_ref(RefConfig(
        input_filename=inp, output_dir=ref_out, kmer_size=k,
        abundance_min=amin, verbose=False, n_shards=1, **ref_kw,
    ))
    return _outputs(port_out), _outputs(ref_out)


def _port_instances(inp, out, k, flags):
    """Instances that reach the join in a port run (its histogram)."""
    assert port_main(["-in", inp, "-out", str(out), "-kmer-size", str(k),
                      "-verbose", "0", "-device", "cpu", *flags]) == 0
    return sum(_outputs(str(out))[1]["repartition_histogram"])


@pytest.mark.parametrize("n,k", [(3, 21), (3, 33), (3, 63), (16, 21)])
def test_cli_all_distances_match_reference(community, tmp_path, n, k):
    """-simple-dist -complex-dist: all 21 matrices, at k on one, two
    and three int64 words."""
    (got_csv, got_m), (want_csv, want_m) = _run_both(
        community[n], tmp_path, k, 2, ["-simple-dist", "-complex-dist"],
        simple_dist=True, complex_dist=True,
    )
    _assert_csvs_match(got_csv, want_csv, 21)
    for key in ("repartition_histogram", "nb_distinct_kmers", "reads"):
        assert got_m[key] == want_m[key], key
    assert got_m["nb_distinct_kmers"] > 0


@pytest.fixture(scope="module")
def motif_community(tmp_path_factory):
    """Three of six genomes are tandem repeats, so k-mer Shannon indices
    sit at exactly 1.0 and 1.5, on the thresholds, and at 0.811 below
    both (k a multiple of 4)."""
    return write_community(
        str(tmp_path_factory.mktemp("motif")), seed=7, n_samples=3,
        n_genomes=6, genome_len=3000, reads_per_sample=450, n_frac=0.005,
        fastq_samples=1, motif_genomes=3,
    )


@pytest.mark.parametrize("k,threshold", [(20, 1.0), (20, 1.5), (32, 1.0),
                                         (32, 1.5)])
def test_cli_kmer_shannon_filter_matches_reference(
    motif_community, tmp_path, k, threshold
):
    (got_csv, got_m), (want_csv, want_m) = _run_both(
        motif_community, tmp_path, k, 2,
        ["-kmer-shannon-index", str(threshold)],
        min_kmer_shannon_index=threshold,
    )
    _assert_csvs_match(got_csv, want_csv, 15)
    for key in ("repartition_histogram", "nb_distinct_kmers", "reads"):
        assert got_m[key] == want_m[key], key
    # the filter drops windows, and k-mers sit exactly on the threshold:
    # one f32 ulp above it drops more (a 1-ulp error in the index would
    # flip them)
    kept = sum(got_m["repartition_histogram"])
    above = float(np.nextafter(np.float32(threshold), np.float32(3)))
    assert _port_instances(motif_community, tmp_path / "above", k,
                           ["-kmer-shannon-index", repr(above)]) < kept
    assert kept < _port_instances(motif_community, tmp_path / "all", k, [])
    assert got_m["nb_distinct_kmers"] > 0
