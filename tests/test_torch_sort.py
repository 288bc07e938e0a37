"""The join's packed-key sort (``ops.sort.sort_packed_keys``): its pass
plan for every key width, its plain version on CPU tensors against
``torch.sort``, ``solid_rows`` at the packed path's width edges against
rows counted with numpy, a model of the kernel's work (csrc/sort.cu:
the up-front histograms, the first portion's bases, a launch a portion
with its tiles claimed in order, each tile's digit counts a warp, each
key's slot from its peers in the warp's step (the bits its lanes OR into
a word a digit) and the warp's next slot of the digit, the tile's rows by look-back inside the portion, and the
next portion's bases from the last tile)
against ``np.sort`` at tile and portion edges, and the kernel against
``torch.sort`` on the card (``cuda``-marked). Exact equality throughout.
The file imports no JAX, so its ``cuda`` tests run on the card."""

import numpy as np
import pytest
import torch

from simka_tpu_torch.ops import countjoin, sort

# ---- (a) the pass plan and the plain version ----------------------------


def test_pass_plan_covers_every_width_with_fewest_passes():
    for bits in range(1, 64):
        plan = sort.radix_passes(bits)
        assert len(plan) == -(-bits // sort.DIGIT_BITS) <= 8
        shift = 0
        for s, w in plan:
            assert s == shift and 1 <= w <= sort.DIGIT_BITS
            shift += w
        assert shift == bits
        widths = [w for _, w in plan]
        assert max(widths) - min(widths) <= 1
    assert sort.radix_passes(45) == ((0, 8), (8, 8), (16, 8), (24, 7),
                                     (31, 7), (38, 7))


@pytest.mark.parametrize("bits", [0, 64])
def test_pass_plan_refuses_widths_outside_1_to_63(bits):
    with pytest.raises(ValueError):
        sort.radix_passes(bits)


def _packed(rng, E: int, sbits: int, bits: int, sid_dtype):
    word = rng.integers(0, 1 << (bits - sbits), size=E, dtype=np.int64)
    sid = rng.integers(0, 1 << sbits, size=E).astype(sid_dtype)
    return torch.from_numpy(word), torch.from_numpy(sid)


@pytest.mark.parametrize("sid_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("sbits,bits", [(1, 2), (3, 21), (1, 43), (3, 45),
                                        (21, 63), (1, 63)])
def test_plain_sort_is_torch_sort_of_the_packed_key(sbits, bits, sid_dtype):
    rng = np.random.default_rng(bits * 100 + sbits)
    word, sid = _packed(rng, 5000, sbits, bits, sid_dtype)
    got = sort.sort_packed_keys(word, sid, sbits, bits)
    want = torch.sort((word << sbits) | sid.to(torch.int64)).values
    assert got.dtype == torch.int64 and torch.equal(got, want)


def test_plain_sort_of_no_keys_and_refusals():
    w = torch.zeros(0, dtype=torch.int64)
    assert sort.sort_packed_keys(w, w.to(torch.int32), 3, 45).shape == (0,)
    with pytest.raises(ValueError):
        sort.sort_packed_keys(w.to(torch.int32), w, 3, 45)  # int32 words
    with pytest.raises(ValueError):
        sort.sort_packed_keys(w, w[:0].to(torch.int16), 3, 45)
    with pytest.raises(ValueError):
        sort.sort_packed_keys(w, w, 45, 45)  # no k-mer bits left


# ---- (b) solid_rows at the packed path's width edges ---------------------


def _solid_rows_numpy(word, sid, amin, amax):
    """(word, sid, count) of every (k-mer, sample) with amin <= count <=
    amax, (k-mer, sample)-ascending."""
    pairs = np.stack([word, sid.astype(np.int64)], 1)
    rows, counts = np.unique(pairs, axis=0, return_counts=True)
    keep = (counts >= amin) & (counts <= amax)
    return rows[keep, 0], rows[keep, 1], counts[keep]


@pytest.mark.parametrize("kmer_bits,n_banks", [
    (42, 2),  # k = 21, sbits 1
    (42, (1 << 20) + 1),  # k = 21, sbits 21: the key's 63 bits
    (62, 2),  # k = 31, sbits 1: 63 bits
    (2, 2),  # k = 1, sbits 1
])
def test_solid_rows_at_the_packed_width_edges(kmer_bits, n_banks):
    rng = np.random.default_rng(kmer_bits + n_banks)
    # a pool of values at both ends of the range, drawn ~4 times a pair,
    # so counts fall below, inside and above the bounds [3, 6]
    pool = np.unique(np.concatenate([
        rng.integers(0, 1 << kmer_bits, size=400, dtype=np.int64),
        [0, (1 << kmer_bits) - 1]]))
    sid_pool = np.unique(np.concatenate([
        rng.integers(0, n_banks, size=6), [0, n_banks - 1]]))
    E = 4 * pool.size * sid_pool.size
    word = pool[rng.integers(0, pool.size, size=E)]
    sid = sid_pool[rng.integers(0, sid_pool.size, size=E)].astype(np.int32)
    assert kmer_bits + countjoin._sbits(n_banks) <= 63
    words, s, count = countjoin.solid_rows(
        (torch.from_numpy(word),), torch.from_numpy(sid), 3, 6,
        n_banks=n_banks, kmer_bits=kmer_bits)
    w_ref, s_ref, c_ref = _solid_rows_numpy(word, sid, 3, 6)
    _, _, all_counts = _solid_rows_numpy(word, sid, 0, E)
    assert (all_counts < 3).any() and (all_counts > 6).any() and c_ref.size
    assert np.array_equal(words[0].numpy(), w_ref)
    assert np.array_equal(s.numpy().astype(np.int64), s_ref)
    assert np.array_equal(count.numpy(), c_ref)


# ---- (c) a model of csrc/sort.cu's work ----------------------------------


def _model_sort(keys, bits: int, warps: int, items: int, portion_tiles: int):
    """csrc/sort.cu's sort of non-negative ``keys`` below 2^bits, step by
    step, with ``warps`` warps of 32 lanes, ``items`` keys a lane and
    ``portion_tiles`` tiles a portion; the tiles in ticket order."""
    keys = np.asarray(keys, dtype=np.uint64)
    E = keys.size
    tile = warps * 32 * items
    tiles = -(-E // tile)
    portions = -(-tiles // portion_tiles)
    plan = sort.radix_passes(bits)

    def digits(k, s, w):
        return ((k >> np.uint64(s)) & np.uint64((1 << w) - 1)).astype(np.int64)

    # RadixSortHistogram and RadixSortScan: the first portion's bases
    hist = np.array([np.bincount(digits(keys, s, w), minlength=256)
                     for s, w in plan])
    base = np.zeros((len(plan), portions, 256), dtype=np.int64)
    base[:, 0] = np.cumsum(hist, 1) - hist
    src = keys
    for p, (s, w) in enumerate(plan):
        dst = np.full(E, np.uint64(2**64 - 1), dtype=np.uint64)
        status = np.zeros((tiles, 256), dtype=np.int64)  # published counts
        for t in range(tiles):  # a launch a portion, its tickets in order
            rows = [t * tile + wp * 32 * items + 32 * i + np.arange(32)
                    for wp in range(warps) for i in range(items)]
            valid = [r < E for r in rows]
            key = [np.where(v, src[np.minimum(r, E - 1)], 0)
                   for r, v in zip(rows, valid)]
            dg = [digits(k, s, w) for k in key]
            # each warp's count of each digit (the early counts), the
            # tile's count, then each warp's first slot of each digit
            count = np.zeros((warps, 256), dtype=np.int64)
            for step, (v, g) in enumerate(zip(valid, dg)):
                np.add.at(count[step // items], g[v], 1)
            tile_count = count.sum(0)
            excl = np.cumsum(tile_count) - tile_count
            nxt = excl + np.cumsum(count, 0) - count
            s_keys = np.zeros(int(tile_count.sum()), dtype=np.uint64)
            slots = np.full(s_keys.size, -1)
            for step, (v, g, k) in enumerate(zip(valid, dg, key)):
                wp = step // items
                new = nxt[wp].copy()
                for lane in np.nonzero(v)[0]:
                    # the bits its step's lanes OR into the digit's word
                    peers = sum(1 << ln for ln in range(32)
                                if v[ln] and g[ln] == g[lane])
                    slot = nxt[wp, g[lane]] + bin(peers & ((1 << lane) - 1)
                                                  ).count("1")
                    if peers >> lane == 1:  # the last of its peers
                        new[g[lane]] = slot + 1
                    assert slots[slot] == -1
                    slots[slot], s_keys[slot] = g[lane], k[lane]
                nxt[wp] = new
            assert (slots >= 0).all()
            q, first = divmod(t, portion_tiles)
            prefix = status[t - first:t].sum(0)  # the look-back's sum
            status[t] = tile_count
            off = base[p, q] + prefix - excl
            if t == min(tiles, (q + 1) * portion_tiles) - 1 < tiles - 1:
                base[p, q + 1] = base[p, q] + prefix + tile_count
            j = np.arange(s_keys.size)
            dst[off[slots] + j] = s_keys
        assert (dst != np.uint64(2**64 - 1)).all() or E == 0
        src = dst
    return src


@pytest.mark.parametrize("E", [1, 127, 128, 129, 255, 256, 257, 384, 700])
@pytest.mark.parametrize("kind", ["random", "equal", "sorted", "reversed",
                                  "top"])
def test_kernel_model_sorts_at_tile_and_portion_edges(E, kind):
    # 2 warps x 32 lanes x 2 keys: 128-key tiles, 2 tiles a portion
    bits = 19
    rng = np.random.default_rng(E)
    keys = {
        "random": rng.integers(0, 1 << bits, size=E),
        "equal": np.full(E, 12345),
        "sorted": np.sort(rng.integers(0, 1 << bits, size=E)),
        "reversed": np.sort(rng.integers(0, 1 << bits, size=E))[::-1],
        "top": np.full(E, (1 << bits) - 1),
    }[kind]
    got = _model_sort(keys, bits, warps=2, items=2, portion_tiles=2)
    assert np.array_equal(got, np.sort(keys.astype(np.uint64)))


# ---- (d) on the card ----------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _card_keys(kind: str, E: int, sbits: int, bits: int, sid_dtype, dev,
               seed: int):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    top = (1 << (bits - sbits)) - 1
    if kind == "top":
        word = torch.full((E,), top, dtype=torch.int64, device=dev)
        sid = torch.full((E,), (1 << sbits) - 1, dtype=sid_dtype, device=dev)
        return word, sid
    word = torch.randint(0, top + 1, (E,), generator=g, device=dev)
    sid = torch.randint(0, 1 << sbits, (E,), generator=g, device=dev,
                        dtype=sid_dtype)
    if kind == "equal":
        word.fill_(top // 3)
        sid.fill_((1 << sbits) // 2)
    elif kind in ("sorted", "reversed"):
        key = torch.sort((word << sbits) | sid.to(torch.int64),
                         descending=kind == "reversed").values
        word, sid = key >> sbits, (key & ((1 << sbits) - 1)).to(sid_dtype)
    return word.contiguous(), sid.contiguous()


def _check(word, sid, sbits, bits) -> None:
    got = sort.sort_packed_keys(word, sid, sbits, bits)
    torch.cuda.synchronize()
    want = torch.sort((word << sbits) | sid.to(torch.int64)).values
    assert got.dtype == torch.int64 and torch.equal(got, want)


KINDS = ("random", "equal", "sorted", "reversed", "top")


@pytest.mark.cuda
@pytest.mark.parametrize("sid_dtype", ["int32", "int64"])
@pytest.mark.parametrize("sbits,bits", [(1, 2), (3, 21), (1, 43), (3, 45),
                                        (21, 63)])
def test_kernel_matches_torch_sort_on_cuda(sbits, bits, sid_dtype):
    dev = _cuda()
    from simka_tpu_torch.ops import _kernels

    tile = _kernels.lib().simka_sort_tile_keys()
    dt = getattr(torch, sid_dtype)
    for E in (0, 1, tile - 1, tile, tile + 1, (1 << 20) + 7):
        for kind in KINDS:
            _check(*_card_keys(kind, E, sbits, bits, dt, dev, E + bits),
                   sbits, bits)


@pytest.mark.cuda
@pytest.mark.parametrize("sid_dtype", ["int32", "int64"])
def test_kernel_matches_torch_sort_at_1e8_keys_on_cuda(sid_dtype):
    dev = _cuda()
    for kind in ("random", "equal", "reversed"):
        _check(*_card_keys(kind, 100_000_000, 3, 45, getattr(torch, sid_dtype),
                           dev, 7), 3, 45)
        torch.cuda.empty_cache()


@pytest.mark.cuda
def test_kernel_matches_torch_sort_past_one_portion_on_cuda():
    dev = _cuda()
    from simka_tpu_torch.ops import _kernels

    lib = _kernels.lib()
    E = lib.simka_sort_portion_tiles() * lib.simka_sort_tile_keys() + 4099
    _check(*_card_keys("random", E, 3, 45, torch.int32, dev, 11), 3, 45)
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_sort_launches_count_the_kernels_on_cuda():
    dev = _cuda()
    word, sid = _card_keys("random", 10_000, 3, 45, torch.int32, dev, 3)
    before = sort.sort_launches
    sort.sort_packed_keys(word, sid, 3, 45)
    assert sort.sort_launches - before == 2 + len(sort.radix_passes(45)) == 8
    sort.sort_packed_keys(word[:0], sid[:0], 3, 45)  # no keys: no launch
    sort.sort_packed_keys(word, sid, 1, 2)
    assert sort.sort_launches - before == 8 + 3
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("sid_dtype", ["int32", "int64"])
def test_sort_memory_is_the_inputs_and_two_key_buffers_on_cuda(sid_dtype):
    dev = _cuda()
    E = 100_000_000
    word, sid = _card_keys("random", E, 3, 45, getattr(torch, sid_dtype),
                           dev, 5)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    inputs = torch.cuda.memory_allocated(dev)
    key = sort.sort_packed_keys(word, sid, 3, 45)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    assert inputs >= E * (8 + sid.element_size())
    assert peak <= (inputs + 2 * 8 * E) * 1.01
    del key
    torch.cuda.empty_cache()
