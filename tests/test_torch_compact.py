"""The port's compact_rows against simka_tpu's, run through the Pallas
gap-close kernel in interpret mode (SIMKA_TPU_PALLAS=1) and through
its fori_loop form, on the same numpy inputs. On the CPU the port's
wrapper takes its plain torch version; the CUDA kernel is held
against that plain version on the card (the ``cuda`` test below and
chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simka_tpu_torch
from simka_tpu.ops.compact import compact_rows as compact_ref
from simka_tpu_torch.ops import compact

FILL64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def _cols(E: int, frac: float, seed: int):
    rng = np.random.default_rng(seed)
    kept = rng.random(E) < frac
    return kept, (
        rng.integers(0, 2**63, size=E, dtype=np.uint64),
        rng.integers(0, 2**31, size=E).astype(np.int32),
        rng.integers(0, 2**32, size=E, dtype=np.uint64).astype(np.uint32),
    )


@pytest.mark.parametrize("pallas", ["1", "0"])
@pytest.mark.parametrize(
    "E,frac",
    [(E, f) for E in (4096, 5000, 100_000) for f in (0.0, 0.4, 1.0)]
    + [(1, 1.0), (1, 0.0), (7777, 0.0)],
)
def test_compact_rows_matches_jax(E, frac, pallas, monkeypatch):
    monkeypatch.setenv("SIMKA_TPU_PALLAS", pallas)
    kept, (c64, c32, cu32) = _cols(E, frac, E + int(frac * 10))
    fills = (FILL64, 0, np.uint32(0xFFFFFFFF))
    want = compact_ref(
        tuple(jnp.asarray(c) for c in (c64, c32, cu32)),
        jnp.asarray(kept), fills, block=4096,
    )
    got = compact.compact_rows(
        (
            torch.from_numpy(c64.view(np.int64)),
            torch.from_numpy(c32),
            torch.from_numpy(cu32.view(np.int32)),
        ),
        torch.from_numpy(kept),
        fills,
    )
    np.testing.assert_array_equal(got[0].numpy().view(np.uint64), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[2].numpy().view(np.uint32), want[2])


def _layout(n_cols: int, E: int, seed: int):
    """n_cols columns, i64 first then i32 (the path's layouts: 1 word;
    key + count; words + sid + count up to 5 x i64 + 2 x i32)."""
    rng = np.random.default_rng(seed)
    n64 = {1: 1, 2: 1, 5: 3, 7: 5}[n_cols]
    cols = [rng.integers(0, 2**63, size=E, dtype=np.uint64).view(np.int64)
            for _ in range(n64)]
    cols += [rng.integers(-(2**31), 2**31, size=E).astype(np.int32)
             for _ in range(n_cols - n64)]
    return cols


@pytest.mark.parametrize("n_cols", [1, 2, 5, 7])
@pytest.mark.parametrize("E", [1, 4095, (1 << 16) + 3])
@pytest.mark.parametrize("frac", [0.0, 0.37, 1.0])
def test_exact_length_form_matches_jax(E, frac, n_cols):
    """compact_rows(..., n=n) is the reference's compact_rows cut at n."""
    kept = np.random.default_rng(E + n_cols).random(E) < frac
    cols = _layout(n_cols, E, E + 7 * n_cols)
    n = int(kept.sum())
    fills = tuple(-1 if c.dtype == np.int64 else 0 for c in cols)
    want = compact_ref(tuple(jnp.asarray(c) for c in cols),
                       jnp.asarray(kept), fills, block=4096)
    got = compact.compact_rows(tuple(torch.from_numpy(c) for c in cols),
                               torch.from_numpy(kept), fills, n=n)
    for g, w, c in zip(got, want, cols):
        assert g.shape == (n,) and g.dtype == torch.from_numpy(c).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w)[:n])


def _tile_schedule(cols, kept, fills, tile, n=None, order=None,
                   per_thread=16):
    """numpy model of csrc/compact.cu's one-pass schedule: tiles of
    ``tile`` rows finish in ``order``; each takes its prefix from the
    counts of the tiles before it (what the look-back sums), ranks its
    kept rows from per-thread bit masks of ``per_thread`` rows and an
    exclusive scan over them, writes the run at the prefix as the
    16-byte body plus peeled head and tail, and (fill form) fills
    [E - D_incl, E - D_excl) with D the dropped rows before it."""
    E = kept.shape[0]
    n_tiles = -(-E // tile)
    counts = [int(kept[t * tile:(t + 1) * tile].sum()) for t in range(n_tiles)]
    out_rows = E if n is None else n
    outs = [np.full(out_rows, 0x5A, c.dtype) for c in cols]
    written = [np.zeros(out_rows, np.int64) for _ in cols]
    for t in (range(n_tiles) if order is None else order):
        base = t * tile
        m = kept[base:base + tile]
        rows = m.shape[0]
        prefix = sum(counts[:t])
        # ranks: per-thread bit counts, exclusive scan, in-thread popcount
        groups = [m[i:i + per_thread] for i in range(0, rows, per_thread)]
        excl = np.concatenate([[0], np.cumsum([g.sum() for g in groups])])
        rank = np.full(rows, -1)
        for gi, g in enumerate(groups):
            for b in np.flatnonzero(g):
                rank[gi * per_thread + b] = excl[gi] + g[:b].sum()
        kept_t = int(excl[-1])
        run = max(0, min(kept_t, out_rows - prefix))
        for c, o, w in zip(cols, outs, written):
            stage = np.empty(kept_t, c.dtype)
            stage[rank[rank >= 0]] = c[base:base + rows][rank >= 0]
            per = 16 // c.itemsize
            mis = prefix % per
            head = 0 if mis == 0 else min(per - mis, run)
            body = (run - head) // per * per
            assert (prefix + head) % per == 0 or body == 0
            for lo, hi in ((0, head), (head, head + body),
                           (head + body, run)):
                o[prefix + lo:prefix + hi] = stage[lo:hi]
                w[prefix + lo:prefix + hi] += 1
        if n is None:
            d_excl = base - prefix
            d_incl = d_excl + rows - kept_t
            for o, w, f in zip(outs, written, fills):
                o[E - d_incl:E - d_excl] = f
                w[E - d_incl:E - d_excl] += 1
    for w in written:  # every output slot written exactly once
        assert (w == 1).all()
    return outs


@pytest.mark.parametrize("tile", [4096, 48, 37])
@pytest.mark.parametrize("E,frac", [(1, 1.0), (4095, 0.37), (10_007, 0.37),
                                    (9000, 0.0), (9000, 1.0)])
@pytest.mark.parametrize("exact", [False, True])
def test_tile_schedule_model_matches_plain(E, frac, tile, exact):
    """The kernel's position arithmetic (tile prefixes, in-tile ranks,
    peeled stores, fill slots), tiles finishing in a shuffled order and
    tile sizes that do not divide E, equals compact_rows_plain."""
    rng = np.random.default_rng(E + tile)
    kept = rng.random(E) < frac
    cols = _layout(2, E, E)
    fills = (-1, 7)
    n = int(kept.sum()) if exact else None
    order = rng.permutation(-(-E // tile))
    got = _tile_schedule(cols, kept, fills, tile, n, order,
                         per_thread=16 if tile % 16 == 0 else 4)
    want = compact.compact_rows_plain(
        tuple(torch.from_numpy(c) for c in cols), torch.from_numpy(kept),
        fills, n)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())


def test_cpu_path_does_not_count_launches():
    before = compact.launches
    kept, (c64, _, _) = _cols(100, 0.5, 0)
    compact.compact_rows(
        (torch.from_numpy(c64.view(np.int64)),), torch.from_numpy(kept), (0,)
    )
    assert compact.launches == before


def test_compact_rows_rejects_bad_input():
    kept = torch.ones(8, dtype=torch.bool)
    with pytest.raises(ValueError):
        compact.compact_rows((torch.zeros(8, dtype=torch.int64),), kept, (0,),
                             n=9)
    with pytest.raises(ValueError):
        compact.compact_rows((torch.zeros(8, dtype=torch.float32),), kept, (0,))
    with pytest.raises(ValueError):
        compact.compact_rows((torch.zeros(7, dtype=torch.int64),), kept, (0,))
    with pytest.raises(ValueError):
        compact.compact_rows((torch.zeros(8, dtype=torch.int64),), kept, ())


def test_resolve_device_cuda_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        simka_tpu_torch.resolve_device("cuda")
    assert simka_tpu_torch.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        simka_tpu_torch.resolve_device("tpu")


@pytest.mark.cuda
@pytest.mark.parametrize("E", [1, 4095, (1 << 20) + 3])
@pytest.mark.parametrize("frac", [0.0, 0.37, 1.0])
def test_kernel_matches_plain_on_cuda(E, frac):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda")
    kept_np, (c64, c32, cu32) = _cols(E, frac, E)
    cols = tuple(
        torch.from_numpy(c).to(dev)
        for c in (c64.view(np.int64), c32, cu32.view(np.int32))
    )
    kept = torch.from_numpy(kept_np).to(dev)
    fills = (FILL64, 0, np.uint32(0xFFFFFFFF))
    n = int(kept.sum())
    for form in (None, n):
        before = compact.launches
        got = compact.compact_rows(cols, kept, fills, n=form)
        want = compact.compact_rows_plain(cols, kept, fills, n=form)
        torch.cuda.synchronize()
        assert compact.launches == before + 1
        assert int(compact.last_kept_total) == n
        for g, w in zip(got, want):
            assert torch.equal(g, w)

