"""The ingest's H2D stage (``core.pipeline._shipper``) and the native
parser's page-locked batches (``io.native._batch_buffers``, asked for by
``io.packed.PackedReadSource``'s ``pin``).

On the CPU: a CPU device takes the batch's arrays themselves and counts
no page-locked copy; the parser pins its batches as its source says,
and a source left to decide pins where torch sees a card; a job on the
CPU asks for plain batches even where a card is seen, on the in-memory
route, the ``-out-tmp`` route and SimkaMin's sketch.
On the card (``cuda``-marked; the file imports no JAX): every device
batch equals its host batch byte for byte while the compute stream is
kept busy, from pageable and from page-locked arrays, each counted;
``compute_statistics`` gives the same statistics from page-locked and
pageable batches, on one device and over two shards of it; the native
parser's batches for a job on the card are page-locked, with the CPU's
statistics.
"""

import dataclasses

import numpy as np
import pytest
import torch

from simka_tpu_torch.config import SimkaConfig
from simka_tpu_torch.core import pipeline
from simka_tpu_torch.io import native
from simka_tpu_torch.io.packed import PackedReadSource, host_pack_chunk
from simka_tpu_torch.utils.metrics import Spans

CPU = torch.device("cpu")
WIDTH = 152  # bases a row: 38 B of packed codes, 19 B of valid bits
FULL = 1 << 15  # rows of a full batch on the card
SLEEP_CYCLES = 2_000_000  # ~1 ms of the compute stream a batch


def _batch(rng, rows: int):
    return (rng.integers(0, 256, (rows, WIDTH // 4), dtype=np.uint8),
            rng.integers(0, 256, (rows, WIDTH // 8), dtype=np.uint8))


def _items(seed: int, n: int):
    """``n`` seed-made host batches, in turn a full one, a partial one
    and a 256-row tail, as ``_packed_batch_stream`` yields them."""
    rng = np.random.default_rng(seed)
    sizes = [(FULL, int(rng.integers(257, FULL)), 256)[i % 3]
             for i in range(n)]
    return [(i % 5, *_batch(rng, rows), None)
            for i, rows in enumerate(sizes)]


def _sources(seed: int, n_samples: int = 3, reads: int = 300):
    """Each sample's host batches of 64 reads of 100 bases from one
    4,000-base genome, packed once, as a source that replays them."""
    rng = np.random.default_rng(seed)
    genome = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 4000)]
    out = []
    for _ in range(n_samples):
        starts = rng.integers(0, 4000 - 100, reads)
        chunk = [genome[p:p + 100].tobytes() for p in starts]
        out.append(_Replay([(*host_pack_chunk(chunk[i:i + 64], 21),
                             len(chunk[i:i + 64]), None)
                            for i in range(0, reads, 64)]))
    return out


class _Replay:
    def __init__(self, batches):
        self.batches = batches

    def iter_packed(self, batch_reads: int, k: int = 21):
        return iter(self.batches)


def _pinned(arr: np.ndarray) -> np.ndarray:
    t = torch.empty(arr.shape, dtype=torch.from_numpy(arr).dtype,
                    pin_memory=True)
    t.copy_(torch.from_numpy(arr))
    return t.numpy()


def _fasta(tmp_path, seed: int, n_samples: int = 3, reads: int = 700):
    """FASTA files of 120-base reads from one 5,000-base genome."""
    rng = np.random.default_rng(seed)
    genome = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 5000)]
    paths = []
    for s in range(n_samples):
        path = tmp_path / f"S{s}.fasta"
        with open(path, "wb") as f:
            for i, p in enumerate(rng.integers(0, 5000 - 120, reads)):
                f.write(b">r%d\n%s\n" % (i, genome[p:p + 120].tobytes()))
        paths.append(str(path))
    return paths


def _record_buffers(monkeypatch, card: bool) -> list:
    """Torch made to see a card or none; every ``_batch_buffers`` call's
    ``pinned`` recorded, and plain buffers made (the CPU has no
    page-locked memory)."""
    if not native.available():
        pytest.skip("the native parser did not build (g++ and zlib)")
    asked = []
    plain = native._batch_buffers

    def record(pinned, rows, width):
        asked.append(pinned)
        return plain(False, rows, width)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: card)
    monkeypatch.setattr(native, "_batch_buffers", record)
    return asked


def test_a_cpu_device_takes_the_arrays_themselves():
    rng = np.random.default_rng(1)
    packed, vb = _batch(rng, 300)
    spans = Spans()
    sample, p, v, n_valid = pipeline._shipper(CPU, spans)(
        (3, packed, vb, 77))
    assert (sample, n_valid) == (3, 77)
    assert np.shares_memory(p.numpy(), packed)
    assert np.shares_memory(v.numpy(), vb)
    assert spans.counters == {"h2d_pinned_in": 0}
    assert spans.ns["simka.ingest.h2d"] > 0


@pytest.mark.parametrize("width", [8, 64, 160])
def test_plain_batch_buffers_have_the_batch_shape(width):
    packed, vb = native._batch_buffers(False, 300, width)
    assert packed.shape == (300, width // 4) and vb.shape == (300, width // 8)
    assert packed.dtype == vb.dtype == np.uint8


@pytest.mark.parametrize("pin", [None, False, True],
                         ids=["pin-default", "pin-no", "pin-yes"])
@pytest.mark.parametrize("card", [False, True], ids=["no-card", "card"])
def test_the_parser_pins_its_batches_as_its_source_says(tmp_path,
                                                        monkeypatch, card,
                                                        pin):
    asked = _record_buffers(monkeypatch, card)
    path, = _fasta(tmp_path, 4, n_samples=1)
    batches = list(PackedReadSource([path], pin=pin).iter_packed(256, k=21))
    assert sum(n for _, _, n, _ in batches) == 700
    assert asked and set(asked) == {card if pin is None else pin}


@pytest.mark.parametrize("route", ["in-memory", "out-tmp", "min-sketch"])
def test_a_cpu_job_asks_for_plain_batches_where_a_card_is_seen(
        tmp_path, monkeypatch, route):
    asked = _record_buffers(monkeypatch, True)
    paths = _fasta(tmp_path, 6, n_samples=2, reads=300)
    inp = tmp_path / "input.txt"
    inp.write_text("".join(f"S{i}: {p}\n" for i, p in enumerate(paths)))
    if route == "min-sketch":
        from simka_tpu_torch.minhash.pipeline import sketch_command

        sketch_command(str(inp), str(tmp_path / "x.sketch"), 21, 1000,
                       verbose=False, device="cpu")
    else:
        config = SimkaConfig(
            input_filename=str(inp), output_dir=str(tmp_path / "out"),
            output_tmp_dir=(str(tmp_path / "tmp") if route == "out-tmp"
                            else None), verbose=False)
        mats = pipeline.run_simka(config, device="cpu")
        assert mats
    assert asked and set(asked) == {False}


def test_cpu_statistics_count_every_batch_and_none_page_locked():
    config = SimkaConfig(kmer_size=21, abundance_min=2, simple_dist=True,
                         verbose=False)
    sources = _sources(5)
    obs = {}
    stats = pipeline.compute_statistics(sources, ["a", "b", "c"], config,
                                        CPU, batch_reads=64, observer=obs)
    n = sum(len(s.batches) for s in sources)
    assert obs["counters"]["ingest_batches"] == n
    assert obs["counters"]["h2d_pinned_in"] == 0
    assert stats.nb_distinct_kmers > 0


# ---- on the card ---------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: page-locked memory is CUDA's")
    return torch.device("cuda", 0)


def _ingest(items, dev, spans):
    """``items`` through ``_pipelined_ingest`` onto ``dev``; the consumer
    keeps the compute stream busy before it reads each batch (a copy
    of it, made on the compute stream)."""
    got = []

    def consume(sample, packed, vb, n_valid):
        torch.cuda._sleep(SLEEP_CYCLES)
        got.append((sample, packed.clone(), vb.clone(), n_valid))

    pipeline._pipelined_ingest(iter(items), pipeline._shipper(dev, spans),
                               consume, spans)
    torch.cuda.synchronize(dev)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("locked", [False, True],
                         ids=["pageable", "page-locked"])
def test_every_device_batch_equals_its_host_batch_on_cuda(locked):
    dev = _cuda()
    items = _items(20261018, 48)
    if locked:
        items = [(s, _pinned(p), _pinned(v), nv) for s, p, v, nv in items]
    spans = Spans()
    got = _ingest(items, dev, spans)
    assert len(got) == len(items)
    for (s, p, v, nv), (gs, gp, gv, gnv) in zip(items, got):
        assert (gs, gnv) == (s, nv)
        assert gp.dtype == torch.uint8 and gp.shape == p.shape
        assert np.array_equal(gp.cpu().numpy(), p)
        assert np.array_equal(gv.cpu().numpy(), v)
    assert spans.counters == {"h2d_pinned_in": len(items) if locked else 0}


@pytest.mark.cuda
@pytest.mark.parametrize("n_shards", [1, 2])
def test_statistics_are_the_same_from_page_locked_batches_on_cuda(n_shards):
    dev = _cuda()
    config = SimkaConfig(kmer_size=21, abundance_min=2, simple_dist=True,
                         complex_dist=True, verbose=False)
    ids = ["a", "b", "c"]
    pageable = _sources(9)
    pinned = [_Replay([(_pinned(p), _pinned(v), n, nv)
                       for p, v, n, nv in s.batches]) for s in pageable]
    n = sum(len(s.batches) for s in pageable)
    runs = {}
    for name, sources in (("pageable", pageable), ("pinned", pinned),
                          ("cpu", pageable)):
        obs = {}
        on = CPU if name == "cpu" else dev
        runs[name] = pipeline.compute_statistics(
            sources, ids, config, on, batch_reads=64, observer=obs,
            shards=[on] * n_shards)
        assert obs["route"] == "in-memory"
        c = obs["counters"]
        assert c["ingest_batches"] == n
        assert c["h2d_pinned_in"] == (n if name == "pinned" else 0)
    for field in dataclasses.fields(runs["cpu"]):
        want = np.asarray(getattr(runs["pageable"], field.name))
        got = np.asarray(getattr(runs["pinned"], field.name))
        assert np.array_equal(got, want), field.name
        cpu = np.asarray(getattr(runs["cpu"], field.name))
        if want.dtype.kind == "f":  # the card's f64 sums in its order
            np.testing.assert_allclose(want, cpu, rtol=1e-12, atol=0)
        else:
            assert np.array_equal(want, cpu), field.name


@pytest.mark.cuda
def test_the_parsers_batches_for_the_card_are_page_locked_on_cuda(tmp_path):
    dev = _cuda()
    if not native.available():
        pytest.skip("the native parser did not build (g++ and zlib)")
    paths = _fasta(tmp_path, 12)
    for pin in (None, True, False):
        for packed, vb, _, _ in PackedReadSource(
                [paths[0]], pin=pin).iter_packed(256, k=21):
            assert torch.from_numpy(packed).is_pinned() is (pin is not False)
            assert torch.from_numpy(vb).is_pinned() is (pin is not False)
    sources = [PackedReadSource([p], pin=True) for p in paths]
    config = SimkaConfig(kmer_size=21, abundance_min=2, simple_dist=True,
                         complex_dist=True, verbose=False)
    ids = ["a", "b", "c"]
    obs = {}
    got = pipeline.compute_statistics(sources, ids, config, dev,
                                      batch_reads=256, observer=obs)
    c = obs["counters"]
    assert c["ingest_batches"] == 3 * -(-700 // 256)
    assert c["h2d_pinned_in"] == c["ingest_batches"]
    want = pipeline.compute_statistics(sources, ids, config, CPU,
                                       batch_reads=256)
    for field in dataclasses.fields(want):
        a = np.asarray(getattr(got, field.name))
        b = np.asarray(getattr(want, field.name))
        if b.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)
        else:
            assert np.array_equal(a, b), field.name
