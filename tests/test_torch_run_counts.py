"""The run-count and segment kernels' wrappers (``ops.countjoin``'s
``run_counts`` and ``segment_stats``, plain torch versions on CPU
tensors) against ``simka_tpu``'s ``_rows_from_instances``,
``_stats_from_rows`` and ``_segment_rows`` on the same numpy inputs; a
model of the kernels' work split (csrc/runs.cu: run_counts' one pass,
its per-step ballots and the equality-only search for a run's end past
the tile; segment_stats' one pass over tiles claimed in ticket order,
each tile's boundary count, its exclusive prefix by decoupled look-back,
the starts at their slots and shared or device-memory bins) against the
plain versions at edge sizes;
the kernels against their plain versions on the card
(``cuda``-marked).
Exact equality throughout."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simka_tpu.ops import countjoin as jc
from simka_tpu_torch.ops import countjoin as tc
from simka_tpu_torch.ops import kmers as tk

INT32_MAX = (1 << 31) - 1
# csrc/runs.cu's geometry: 4096-row tiles, 256 threads of 16 rows,
# per-bank bins in shared memory up to 40 KiB (3 int64 bins a bank)
TILE, THREADS = 4096, 256
SHARED_BANKS = 40 * 1024 // 24


def _runs(lengths, rng, n_cols: int = 1, dtype=np.int64):
    """Sorted key columns whose runs have ``lengths``: distinct ascending
    rows, each repeated; the last column int32 when ``dtype`` says."""
    R = len(lengths)
    keys = np.sort(rng.choice(1 << 40, size=R, replace=False))
    # spread the run keys over n_cols columns, most significant first
    cols = [(keys >> (8 * (n_cols - 1 - c))) & 0xFF if c < n_cols - 1 else
            keys for c in range(n_cols)]
    rep = [np.repeat(c, lengths) for c in cols]
    rep[-1] = rep[-1].astype(dtype)
    return rep


def _plain_counts(cols, amin, amax):
    return tc.run_counts(tuple(torch.from_numpy(c) for c in cols), amin,
                         amax)


# ---- (a) against simka_tpu ----------------------------------------------


@pytest.mark.parametrize("n_banks", [2, 8])
@pytest.mark.parametrize("amin,amax", [(1, INT32_MAX), (2, 999_999_999),
                                       (3, 5)])
def test_solid_rows_match_rows_from_instances_packed(n_banks, amin, amax):
    """The packed key (k = 21): ``solid_rows`` through ``run_counts``
    against the reference's compacted rows."""
    rng = np.random.default_rng(n_banks * 10 + amin)
    E = 5000
    kmer = rng.integers(0, 300, E).astype(np.int64) * 0x9E3779B1 % (1 << 42)
    sid = rng.integers(0, n_banks, E).astype(np.int32)
    hi, lo = (kmer >> 32).astype(np.uint32), (kmer & 0xFFFFFFFF).astype(
        np.uint32)
    (rh, rl), rsid, rcnt, rkept, compacted = jc._rows_from_instances(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(sid), amin, amax,
        n_banks=n_banks, hi_bits=10, vary_axes=())
    assert compacted
    rkept = np.asarray(rkept)
    n = int(rkept.sum())
    words, gsid, gcnt = tc.solid_rows(
        (torch.from_numpy(kmer),), torch.from_numpy(sid), amin, amax,
        n_banks=n_banks, kmer_bits=42)
    assert words[0].shape[0] == n > 0
    want = (np.asarray(rh, np.int64)[:n] << 32) | np.asarray(rl, np.int64)[:n]
    np.testing.assert_array_equal(words[0].numpy(), want)
    np.testing.assert_array_equal(gsid.numpy(), np.asarray(rsid)[:n])
    np.testing.assert_array_equal(gcnt.numpy(), np.asarray(rcnt)[:n])


@pytest.mark.parametrize("n_words", [1, 2, 5])
@pytest.mark.parametrize("amin,amax", [(1, INT32_MAX), (3, 5)])
def test_run_counts_match_rows_from_instances_multi_key(n_words, amin, amax):
    """The reference's multi-key pass (uncompacted rows, count at each
    run's first row, kept): ``run_counts`` on the same sorted rows, key
    columns the uint32 words and the sample id (2 to 6 columns)."""
    rng = np.random.default_rng(n_words + 7 * amin)
    E, N = 4000, 40
    # about 4 rows a (words, sample) key, so runs of 1 to ~12
    r = max(2, round((E / 4 / N) ** (1 / n_words)))
    words = [rng.integers(0, r, E).astype(np.uint32) for _ in range(n_words)]
    sid = rng.integers(0, N, E).astype(np.int32)
    hi = tuple(jnp.asarray(w) for w in words[:-1]) if n_words > 1 else (
        jnp.zeros(E, jnp.uint32),)
    rw, rsid, rcnt, rkept, compacted = jc._rows_from_instances(
        hi, jnp.asarray(words[-1]), jnp.asarray(sid), amin, amax,
        n_banks=N, hi_bits=32, vary_axes=())
    assert not compacted
    cols = [np.array(w, np.int64) for w in rw] + [np.array(rsid)]
    count, keep, total = _plain_counts(cols, amin, amax)
    rkept = np.asarray(rkept)
    np.testing.assert_array_equal(keep.numpy(), rkept)
    first = count.numpy() > 0
    np.testing.assert_array_equal(count.numpy()[first],
                                  np.asarray(rcnt)[first])
    assert int(total) == rkept.sum() > 0
    assert count.dtype == torch.int32


def _solid_rows(rng, N: int, n_kmers: int, k: int, cmax: int = 1000,
                d: int = 64):
    """Solid rows in (k-mer, sample) order: distinct k-mers (port
    words), the first in every sample, each other in a random nonempty
    set of at most ``d`` samples, counts 1..cmax."""
    nw = tk.n_words(k)
    top = 2 * k - 62 * (nw - 1)
    raw = [rng.integers(0, 1 << (top if w == 0 else 62), n_kmers,
                        dtype=np.int64) for w in range(nw)]
    order = np.lexsort(raw[::-1])
    raw = [r[order] for r in raw]
    diff = np.zeros(n_kmers, bool)
    diff[0] = True
    for r in raw:
        diff[1:] |= r[1:] != r[:-1]
    raw = [r[diff] for r in raw]
    per = rng.integers(1, min(N, d) + 1, raw[0].shape[0])
    per[rng.random(per.shape[0]) < 0.5] = 1  # singletons too
    per[0] = N
    sids = [np.sort(rng.choice(N, p, replace=False)) for p in per]
    words = [np.repeat(r, per) for r in raw]
    sid = np.concatenate(sids).astype(np.int32)
    count = rng.integers(1, cmax + 1, sid.shape[0]).astype(np.int32)
    return words, sid, count


@pytest.mark.parametrize("N,k", [(1, 21), (2, 21), (8, 21), (40, 33),
                                 (100, 63)])
def test_segment_stats_match_stats_from_rows(N, k):
    rng = np.random.default_rng(N + k)
    words, sid, count = _solid_rows(rng, N, 400, k, d=8)
    n = sid.shape[0]
    tw = tuple(torch.from_numpy(w) for w in words)
    w32 = [w.numpy().astype(np.uint32) for w in tk.uint32_words(tw, k)]
    kept = np.ones(n, bool)
    js = jc._stats_from_rows(
        tuple(jnp.asarray(w) for w in w32), jnp.asarray(sid),
        jnp.asarray(count), jnp.asarray(kept), n_banks=N, simple=False,
        complex_=False, count_bits=32, vary_axes=(), psum_axis="",
        rows_compacted=True)
    _, newk, seg_len, d_max, n_distinct, n_shared = jc._segment_rows(
        tuple(jnp.asarray(w) for w in w32), jnp.asarray(kept))
    bins, starts, scalars = tc.segment_stats(
        tw, torch.from_numpy(sid), torch.from_numpy(count), n_banks=N)
    newk = np.asarray(newk)
    np.testing.assert_array_equal(bins[0].numpy(), js.distinct_per_bank)
    np.testing.assert_array_equal(bins[1].numpy(), js.solid_per_bank)
    np.testing.assert_array_equal(bins[2].numpy(), js.chord_n2_per_bank)
    np.testing.assert_array_equal(starts.numpy(),
                                  np.append(np.flatnonzero(newk), n))
    np.testing.assert_array_equal((starts[1:] - starts[:-1]).numpy(),
                                  np.asarray(seg_len)[newk])
    assert scalars.tolist() == [int(n_distinct), int(n_shared), int(d_max),
                                int(js.max_count)]
    assert int(js.nb_distinct) == int(n_distinct)
    assert int(js.nb_shared) == int(n_shared) > 0 or N == 1


def test_raw_stats_take_the_segment_pass(monkeypatch):
    """``_raw_stats_from_rows`` takes its segment starts from the pass
    (no compaction: ``compact_rows`` raises here), and its totals and
    k-mer count are the pass's."""
    from simka_tpu_torch.ops import compact

    def refuse(*args, **kw):
        raise AssertionError("the join compacted rows")

    monkeypatch.setattr(compact, "compact_rows", refuse)
    rng = np.random.default_rng(5)
    words, sid, count = _solid_rows(rng, 12, 300, 21)
    args = (tuple(torch.from_numpy(w) for w in words), torch.from_numpy(sid),
            torch.from_numpy(count))
    seg = tc.segment_stats(*args, n_banks=12)
    a = tc._raw_stats_from_rows(*args, n_banks=12, simple=True,
                                complex_=True)
    assert torch.equal(a.distinct_per_bank, seg[0][0])
    assert torch.equal(a.solid_per_bank, seg[0][1])
    assert torch.equal(a.chord_n2_per_bank, seg[0][2])
    assert int(a.nb_distinct) == int(seg[2][0]) == seg[1].shape[0] - 1
    assert int(a.nb_shared) == int(seg[2][1])


# ---- (b) a numpy model of csrc/runs.cu's work split ---------------------


def _edge_flags(E: int, tile: int, kind: str, rng):
    f = np.zeros(E, bool)
    if kind == "own":  # every row its own run
        f[:] = True
    elif kind == "one":  # one run over every tile
        f[0] = True
    elif kind == "edges":  # a run ends at, before and after every edge
        f[0] = True
        for e in range(tile, E, tile):
            f[max(0, e - 1):e + 2] = True
    elif kind == "ends":  # runs from each tile's first and last row
        f[0::tile] = True
        f[tile - 1::tile] = True
    elif kind == "long":  # runs past a tile, and short ones between
        f[::3 * tile + 5] = True
        f[rng.random(E) < 0.001] = True
    else:  # random
        f[0] = True
        f[rng.random(E) < 0.05] = True
    return f


def _model_run_end(keys, start: int, E: int):
    """csrc/runs.cu's run_end, a warp of 32 lanes: the first row x >=
    start whose key differs from row start - 1's (x >= E differs),
    testing equality only: the 32 rows from start, then probes 32 << l
    rows past start + 31, then a 32-ary search. Returns (x, the rows it
    read)."""
    reads = []

    def differs(x):
        if x >= E:
            return True
        reads.append(x)
        return any(c[x] != c[start - 1] for c in keys)

    m = [differs(start + ln) for ln in range(32)]
    if any(m):
        return start + m.index(True), reads
    lo = start + 31
    while True:
        m = [differs(lo + (32 << ln)) for ln in range(32)]
        if any(m):
            lane = m.index(True)
            hi = lo + (32 << lane)
            lo = lo + (32 << (lane - 1)) if lane else lo
            break
        lo += 32 << 31
    while hi - lo > 1:
        step = -(-(hi - lo) // 32)
        m = [lo + (ln + 1) * step >= hi or differs(lo + (ln + 1) * step)
             for ln in range(32)]
        lane = m.index(True)
        hi = min(hi, lo + (lane + 1) * step)
        lo += lane * step
    return hi, reads


def _model_run_counts(keys, amin: int, amax: int, tile: int = TILE,
                      threads: int = THREADS):
    """csrc/runs.cu's one-pass run_counts: per tile, warps of up to 32
    lanes take `lanes x steps` rows each (steps = tile / threads), lane
    l row `lanes j + l` at step j; each row against the row before it in
    every key column (the row before the tile included; rows past E are
    boundaries); a ballot a step; a row's next boundary the first set
    bit after its lane in its step's ballot, else the warp's first at a
    later step, else the later warps' first, else past the tile, where
    the warp holding the tile's last boundary takes the run's end from
    run_end. Returns (count, keep, total, the tiles whose search read
    rows)."""
    E = keys[0].shape[0]
    steps, lanes = tile // threads, min(32, threads)
    wrows = lanes * steps
    first = np.zeros(E, bool)
    first[0] = True
    for c in keys:
        first[1:] |= c[1:] != c[:-1]
    count = np.zeros(E, np.int64)
    searched = []
    for t0 in range(0, E, tile):
        f = np.ones(tile, bool)
        f[:min(tile, E - t0)] = first[t0:t0 + tile]
        ballots = [[sum(int(f[w * wrows + lanes * j + ln]) << ln
                        for ln in range(lanes)) for j in range(steps)]
                   for w in range(tile // wrows)]
        warp_first = [next((w * wrows + lanes * j + (b & -b).bit_length() - 1
                            for j, b in enumerate(bs) if b), tile)
                      for w, bs in enumerate(ballots)]
        for w, bs in enumerate(ballots):
            later = min(warp_first[w + 1:], default=tile)
            after = t0 + later
            if later == tile and warp_first[w] < tile:
                after, reads = _model_run_end(keys, t0 + tile, E)
                if reads:
                    searched.append(t0 // tile)
            nxt_step = None  # the warp's first boundary at a later step
            for j in range(steps - 1, -1, -1):
                for ln in range(lanes):
                    i = t0 + w * wrows + lanes * j + ln
                    if not bs[j] >> ln & 1 or i >= E:
                        continue
                    m = bs[j] >> (ln + 1) << (ln + 1)
                    if m:
                        nxt = i - ln + (m & -m).bit_length() - 1
                    else:
                        nxt = after if nxt_step is None else nxt_step
                    count[i] = nxt - i
                if bs[j]:
                    nxt_step = (t0 + w * wrows + lanes * j
                                + (bs[j] & -bs[j]).bit_length() - 1)
    count32 = count.astype(np.int32)
    keep = first & (count32 >= amin) & (count32 <= amax)
    return count32, keep, int(keep.sum()), searched


def _keys_of(flags, n_cols: int = 1):
    """Key columns whose runs start where ``flags`` is set."""
    rid = np.cumsum(flags).astype(np.int64)
    if n_cols == 1:
        return [rid]
    return [(rid >> (8 * (n_cols - 2 - j))) & 0xFF
            for j in range(n_cols - 1)] + [rid.astype(np.int32)]


def _same_as_plain(keys, amin=1, amax=INT32_MAX, **geometry):
    count, keep, total = _plain_counts(keys, amin, amax)
    got = _model_run_counts(keys, amin, amax, **geometry)
    np.testing.assert_array_equal(got[0], count.numpy())
    np.testing.assert_array_equal(got[1], keep.numpy())
    assert got[2] == int(total)
    return got[3]


@pytest.mark.parametrize("kind", ["own", "one", "edges", "long", "random"])
@pytest.mark.parametrize("tile,threads", [(TILE, THREADS), (64, 16)])
def test_tile_model_matches_plain_run_counts(kind, tile, threads):
    """The one-pass model against the plain version: every row its own
    run, one run over every tile, runs at every tile edge, runs longer
    than a tile, random runs; 1 and 3 key columns."""
    rng = np.random.default_rng(len(kind) + tile)
    E = 5 * tile + 17
    flags = _edge_flags(E, tile, kind, rng)
    for n_cols in (1, 3):
        searched = _same_as_plain(_keys_of(flags, n_cols), 2, 5, tile=tile,
                                  threads=threads)
        if kind == "one":
            assert searched == [0]  # only the tile holding its first row


@pytest.mark.parametrize("E", [1, 2, 4095, 4096, 4097])
def test_tile_model_at_small_sizes(E):
    rng = np.random.default_rng(E)
    flags = _edge_flags(E, TILE, "random", rng)
    count, _, total = _plain_counts(_keys_of(flags), 1, INT32_MAX)
    got = _model_run_counts(_keys_of(flags), 1, INT32_MAX)
    np.testing.assert_array_equal(got[0], count.numpy())
    assert got[2] == int(total) == flags.sum()


# how far past a tile's end a run may end: within the first 32 rows, at
# each probe distance 32 << l and one row either side, and past them
GALLOP_ENDS = sorted({d for j in range(0, 12) for d in (
    (32 << j) - 1, 32 << j, (32 << j) + 1)} | {1, 2, 31, 33, 5000})


@pytest.mark.parametrize("end", GALLOP_ENDS)
def test_run_end_at_every_probe_distance(end):
    """A run from the middle of tile 0 (tiles of 128 rows, 64 threads
    of 2 steps) ending `end` rows past the tile's end, then short runs: the
    model == plain, and run_end's reads grow with log(run), not with
    the run."""
    tile = 128
    E = tile + end + 300
    flags = np.zeros(E, bool)
    flags[0] = flags[40] = True
    flags[tile + end:] = np.random.default_rng(end).random(
        E - tile - end) < 0.3
    flags[tile + end] = True
    keys = _keys_of(flags, 2)
    _same_as_plain(keys, tile=tile, threads=64)
    x, reads = _model_run_end(keys, tile, E)
    assert x == tile + end
    assert len(reads) <= 32 * (2 + max(1, end).bit_length())


def test_run_of_many_tiles_from_mid_tile():
    """A run of 2^16 rows starting mid-tile (tiles of 128 rows): one
    search, by the tile holding its first row; the 510 tiles inside it
    search nothing."""
    tile, start, n = 128, 77, 1 << 16
    E = start + n + 50
    flags = np.zeros(E, bool)
    flags[:start] = True
    flags[start] = flags[start + n] = True
    searched = _same_as_plain(_keys_of(flags), tile=tile, threads=64)
    assert 0 in searched and not set(range(1, (start + n) // tile)) & set(
        searched)


@pytest.mark.parametrize("n_cols", [1, 2])
def test_run_counts_on_unsigned_order_keys(n_cols):
    """SimkaMin's order: hashes sorted unsigned (``h ^ SIGN``), so the
    positive int64 keys come before the negative ones and the keys are
    grouped, not ascending; with 2 columns the sample id comes second,
    as ``sketch_multi_prefix``'s (hash, sample) order. The model with
    its equality-only search == plain; the single-column counts ==
    ``simka_tpu``'s ``device_sketch_update`` (JAX) of the same hashes."""
    from simka_tpu.minhash import device as jd
    from simka_tpu_torch.minhash import device as td

    rng = np.random.default_rng(n_cols)
    n_kmers = 700
    kmer = rng.integers(0, 1 << 62, n_kmers, dtype=np.int64)
    reps = rng.integers(1, 200, n_kmers)
    reps[:3] = (1000, 3000, 4500)  # runs across 128-row tiles
    inst = np.repeat(kmer, reps)
    rng.shuffle(inst)
    h, _ = td.hash_valid_words(torch.from_numpy(inst),
                               torch.ones(inst.shape[0], dtype=torch.bool),
                               seed=11)
    sid = torch.from_numpy(rng.integers(0, 3, inst.shape[0]))
    if n_cols == 1:
        hs = td._sort_hashes(h)[0]
        keys = [hs.numpy()]
    else:
        order = torch.sort(h ^ td.SIGN, stable=True).indices
        order = order[torch.sort(sid[order], stable=True).indices]
        keys = [h[order].numpy(), sid[order].numpy()]
    signs = np.sign(keys[0])
    assert (signs < 0).any() and (signs > 0).any()
    assert (keys[0][1:] < keys[0][:-1]).any()  # grouped, not ascending
    for geometry in ({}, {"tile": 128, "threads": 64}):
        _same_as_plain(keys, 2, 4000, **geometry)
    if n_cols == 1:
        count, keep, _ = _plain_counts(keys, 1, INT32_MAX)
        hi = (inst >> 32).astype(np.uint32)
        lo = (inst & 0xFFFFFFFF).astype(np.uint32)
        ref_h, ref_c = jd.device_sketch_update(
            jnp.asarray(hi), jnp.asarray(lo), seed=11, sketch_size=n_kmers)
        first = keep.numpy()
        np.testing.assert_array_equal(
            keys[0][first].view(np.uint64), np.asarray(ref_h))
        np.testing.assert_array_equal(count.numpy()[first],
                                      np.asarray(ref_c))


def _model_bins(sid, count, N: int, tile: int, blocks: int):
    """Per-bank bins as segment_stats adds them: ``blocks`` CTAs claim
    the tiles from the ticket (here in turn), each CTA's sums in shared
    bins flushed once when 3 x 8 x N bytes fit, else every add straight
    into the outputs."""
    out = np.zeros((3, N), np.int64)
    E = sid.shape[0]
    n_tiles = -(-E // tile)
    shared = N <= SHARED_BANKS
    for b in range(min(blocks, n_tiles)):
        acc = np.zeros((3, N), np.int64) if shared else out
        for t in range(b, n_tiles, blocks):
            s = sid[t * tile:(t + 1) * tile].astype(np.int64)
            c = count[t * tile:(t + 1) * tile].astype(np.int64)
            np.add.at(acc[0], s, 1)
            np.add.at(acc[1], s, c)
            np.add.at(acc[2], s, c * c)
        if shared:
            out += acc
    return out


def _model_look_back(counts, t: int, in_flight: int):
    """Tile t's exclusive prefix as warp 0 of csrc/runs.cu's
    segment_stats looks it back: the tiles t - in_flight < p < t have
    published only their count (flag A), the earlier ones their
    inclusive prefix (flag P); windows of 32 predecessors, lane 31 the
    nearest, each summing its lanes from the nearest P on, until a
    window holds a P (before tile 0: a P of 0)."""
    prefix, end = 0, t
    while True:
        window = []
        for p in range(end - 32, end):
            if p < 0:
                window.append((True, 0))
            elif p <= t - in_flight:
                window.append((True, int(sum(counts[:p + 1]))))
            else:
                window.append((False, int(counts[p])))
        ps = [i for i, (is_p, _) in enumerate(window) if is_p]
        prefix += sum(v for _, v in window[ps[-1] if ps else 0:])
        if ps:
            return prefix
        end -= 32


def _model_segments(words, sid, count, N: int, tile: int = TILE,
                    threads: int = THREADS, blocks: int = 3,
                    in_flight: int = 40):
    """csrc/runs.cu's one-pass segment_stats: tiles claimed in ticket
    order; per tile, warps of up to 32 lanes take `lanes x steps` rows
    each, a ballot a step of the rows that start a k-mer (the word
    columns alone); each warp counts its boundaries below E, so each
    warp has its exclusive offset in the tile and the tile its count;
    the tile's exclusive prefix by look-back (``_model_look_back``);
    each boundary row goes to starts[prefix + the warp's offset + the
    boundaries of its earlier steps + the set bits below its lane]; the
    tile holding the last row writes starts[nb_distinct] = E. The
    lengths are run_counts' (the same warp walk and run_end past the
    tile) on the words; the scalars come from them, the bins from
    ``_model_bins``. Returns (bins, starts[:nb_distinct + 1],
    scalars)."""
    E = sid.shape[0]
    steps, lanes = tile // threads, min(32, threads)
    wrows = lanes * steps
    first = np.zeros(E, bool)
    first[0] = True
    for w in words:
        first[1:] |= w[1:] != w[:-1]
    lengths = _model_run_counts(words, 1, INT32_MAX, tile, threads)[0]
    n_tiles = -(-E // tile)
    counts = []  # each tile's boundaries, in ticket order
    starts = np.full(E + 1, -1, np.int64)
    for t in range(n_tiles):
        t0 = t * tile
        # a step's lanes whose row starts a k-mer and lies below E
        ballots = [[sum(int(first[i]) << ln for ln in range(lanes)
                        if (i := t0 + w * wrows + lanes * j + ln) < E)
                    for j in range(steps)]
                   for w in range(tile // wrows)]
        warp_counts = [sum(bin(b).count("1") for b in bs) for bs in ballots]
        counts.append(sum(warp_counts))
        prefix = _model_look_back(counts, t, in_flight)
        for w, bs in enumerate(ballots):
            slot = prefix + sum(warp_counts[:w])
            for j, b in enumerate(bs):
                for ln in range(lanes):
                    if b >> ln & 1:
                        below = bin(b & ((1 << ln) - 1)).count("1")
                        starts[slot + below] = t0 + w * wrows + lanes * j + ln
                slot += bin(b).count("1")
        if t == n_tiles - 1:
            starts[prefix + counts[-1]] = E
    nb = sum(counts)
    lens = lengths[first].astype(np.int64)
    scalars = [nb, int((lens >= 2).sum()), int(lens.max()),
               int(count.astype(np.int64).max())]
    return (_model_bins(sid, count, N, tile, blocks), starts[:nb + 1],
            scalars)


def _same_segments_as_plain(words, sid, count, N: int, **geometry):
    bins, starts, scalars = tc.segment_stats(
        tuple(torch.from_numpy(w) for w in words), torch.from_numpy(sid),
        torch.from_numpy(count), n_banks=N)
    got = _model_segments(words, sid, count, N, **geometry)
    np.testing.assert_array_equal(got[0], bins.numpy())
    np.testing.assert_array_equal(got[1], starts.numpy())
    assert got[2] == scalars.tolist()


@pytest.mark.parametrize("N", [1, 8, SHARED_BANKS, SHARED_BANKS + 1, 20000])
def test_bin_model_matches_plain_segment_stats(N):
    """The one-pass model at 256-row tiles (2 warps of 4 steps) over 3
    CTAs, every CTA several tiles, against the plain version: shared
    bins up to N = 1706, device-memory atomics past it."""
    rng = np.random.default_rng(N)
    words, sid, count = _solid_rows(rng, N, 3000, 21, cmax=INT32_MAX)
    _same_segments_as_plain(words, sid, count, N, tile=256, threads=64)


def _segment_rows_of(flags, N: int, rng, n_words: int = 1):
    """Solid rows whose k-mers start where ``flags`` is set: int64 word
    columns, int32 sample ids in [0, N), int32 counts."""
    words = [k.astype(np.int64) for k in _keys_of(flags, n_words)]
    sid = rng.integers(0, N, flags.shape[0]).astype(np.int32)
    count = rng.integers(1, INT32_MAX, flags.shape[0]).astype(np.int32)
    return words, sid, count


@pytest.mark.parametrize("kind", ["own", "one", "edges", "ends", "long",
                                  "random"])
@pytest.mark.parametrize("N", [8, SHARED_BANKS + 1])
def test_segment_model_at_tile_edges(kind, N):
    """The one-pass model against the plain version at 256-row tiles:
    every row its own k-mer, one k-mer of all rows, k-mers ending at and
    beside every tile edge, k-mers from each tile's first and last row,
    k-mers over several tiles (tiles without a boundary) and short ones
    between, random; 1 and 3 word columns; tiles in flight past a
    look-back window and all published."""
    rng = np.random.default_rng(len(kind) + N)
    tile = 256
    E = 9 * tile + 17
    flags = _edge_flags(E, tile, kind, rng)
    for n_words, in_flight in ((1, 40), (3, 1)):
        _same_segments_as_plain(*_segment_rows_of(flags, N, rng, n_words),
                                N, tile=tile, threads=64,
                                in_flight=in_flight)


@pytest.mark.parametrize("E", [1, 4095, 4096, 4097])
def test_segment_model_at_small_sizes(E):
    """The model at csrc/runs.cu's own geometry (4096-row tiles, 8 warps
    of 16 steps) at one row and one tile's size, one row either side."""
    rng = np.random.default_rng(E)
    flags = _edge_flags(E, TILE, "random", rng)
    _same_segments_as_plain(*_segment_rows_of(flags, 100, rng), 100)


@pytest.mark.parametrize("in_flight", [1, 2, 31, 32, 33, 100])
def test_look_back_model_gives_the_exclusive_prefix(in_flight):
    """Tile t's look-back == the boundaries of the tiles before it,
    whichever of its predecessors have published their prefix: windows
    of 32 walked back one at a time until a prefix, or past tile 0."""
    counts = np.random.default_rng(in_flight).integers(0, 4097, 150)
    for t in range(counts.shape[0]):
        assert _model_look_back(counts, t, in_flight) == counts[:t].sum()


def test_wrappers_refuse_bad_columns():
    a = torch.zeros(8, dtype=torch.int64)
    with pytest.raises(ValueError):
        tc.run_counts(())
    with pytest.raises(ValueError):
        tc.run_counts((a, torch.zeros(7, dtype=torch.int64)))
    with pytest.raises(ValueError):
        tc.run_counts((a.to(torch.int16),))
    with pytest.raises(ValueError):
        tc.run_counts((a,) * 9)
    with pytest.raises(ValueError):
        tc.segment_stats((a.to(torch.int32),), a, a, n_banks=2)
    count, keep, total = tc.run_counts((a[:0],))
    assert count.shape == keep.shape == (0,) and int(total) == 0


# ---- (c) on the card ----------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["own", "one", "edges", "long", "random"])
@pytest.mark.parametrize("n_cols", [1, 6])
def test_run_counts_kernel_matches_plain_on_cuda(kind, n_cols):
    dev = _cuda()
    from simka_tpu_torch.ops import _kernels

    assert _kernels.lib().simka_runs_tile_rows() == TILE
    rng = np.random.default_rng(n_cols)
    E = (1 << 24) if kind == "one" else 9 * TILE + 123
    flags = _edge_flags(E, TILE, kind, rng)
    lengths = np.diff(np.flatnonzero(np.append(flags, True)))
    cols = _runs(lengths, rng, n_cols, np.int32 if n_cols > 1 else np.int64)
    for amin, amax in ((1, INT32_MAX), (3, 5), (2, 2)):
        want = _plain_counts(cols, amin, amax)
        before = tc.run_counts_launches
        got = tc.run_counts(tuple(torch.from_numpy(c).to(dev) for c in cols),
                            amin, amax)
        torch.cuda.synchronize()
        assert tc.run_counts_launches == before + 1
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 2, 8, 100, 1000, 20000])
def test_segment_stats_kernel_matches_plain_on_cuda(N):
    dev = _cuda()
    from simka_tpu_torch.ops import _kernels

    assert _kernels.lib().simka_segment_shared_banks() == SHARED_BANKS
    rng = np.random.default_rng(N)
    words, sid, count = _solid_rows(rng, N, 20000, 63, cmax=INT32_MAX)
    args = [tuple(torch.from_numpy(w) for w in words), torch.from_numpy(sid),
            torch.from_numpy(count)]
    want = tc.segment_stats(*args, n_banks=N)
    before = tc.segment_stats_launches
    on_card = (tuple(w.to(dev) for w in args[0]), args[1].to(dev),
               args[2].to(dev))
    bins, starts, scalars = tc.segment_stats(*on_card, n_banks=N)
    torch.cuda.synchronize()
    assert tc.segment_stats_launches == before + 1
    nb = int(scalars[0])
    assert starts.shape[0] == args[1].shape[0] + 1
    assert torch.equal(bins.cpu(), want[0])
    assert torch.equal(starts[:nb + 1].cpu(), want[1])
    assert torch.equal(scalars.cpu(), want[2])
