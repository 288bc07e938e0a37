"""The port's probes (simka_tpu_torch.profiling.probes) against the TPU
probe kernels they ask again: each Pallas body from
scripts/profiling/*.py runs through pl.pallas_call in interpret mode
with the probe's own specs, on the same seeded inputs as the port's
plain version (the CPU path). Integer and one-hot results must be equal
exactly; the bf16 products on normal inputs within
probes.gram_tolerance x sum|a||b| (the two sum in other orders). The
DMA probes are compared inside the written window only (the TPU leaves
the rest undefined; the interpreter fills INT32_MIN, the port 0). On
the card the kernels are held against the same plain versions (the
``cuda`` test and chip_smoke.py)."""

import contextlib
import importlib.util
import io
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from simka_tpu_torch.profiling import probes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_script(name):
    """Import scripts/profiling/<name>.py. Importing runs its own probes,
    which fail on the CPU (compiled Mosaic only) and print FAILED. The
    scripts put a fixed checkout path first on sys.path; it is restored
    so that later imports resolve in this checkout."""
    path = os.path.join(REPO, "scripts", "profiling", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_probe_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    saved = list(sys.path)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved
    return mod


@pytest.fixture(scope="module")
def scripts():
    return {
        name: _load_script(name)
        for name in ("test_pallas_basic", "test_mosaic_reshape",
                     "test_mosaic_features", "test_dma_align")
    }


def _call(kernel, args, shape, dtype):
    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(shape, dtype), interpret=True,
    )(*args))


def _dma_call(kernel, x, scratch, off=None):
    """A DMA probe body with its own specs: HBM (ANY) operands, a VMEM
    scratch and two DMA semaphores, the offset as scalar prefetch."""
    scratch_shapes = [pltpu.VMEM(scratch, jnp.int32),
                      pltpu.SemaphoreType.DMA(()), pltpu.SemaphoreType.DMA(())]
    specs = dict(in_specs=[pl.BlockSpec(memory_space=pltpu.ANY)],
                 out_specs=pl.BlockSpec(memory_space=pltpu.ANY))
    out_shape = jax.ShapeDtypeStruct(x.shape, jnp.int32)
    if off is None:
        return np.asarray(pl.pallas_call(
            kernel, scratch_shapes=scratch_shapes, out_shape=out_shape,
            interpret=True, **specs,
        )(jnp.asarray(x)))
    return np.asarray(pl.pallas_call(
        kernel,
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=(1,), scratch_shapes=scratch_shapes,
            **specs,
        ),
        out_shape=out_shape, interpret=True,
    )(jnp.asarray(off), jnp.asarray(x)))


def _reference(s, name, args):
    """(output, window): the TPU probe's output on ``args`` and the
    flat [lo, hi) window it writes (None: all of it)."""
    pb, mr, mf, da = (s["test_pallas_basic"], s["test_mosaic_reshape"],
                      s["test_mosaic_features"], s["test_dma_align"])
    a = [jnp.asarray(x) for x in args]
    i32, f32 = jnp.int32, jnp.float32
    base = name.split("@")[0]
    if base == "basic_2d_vmem":
        return _call(pb.k1, a, (256, 256), f32), None
    if base == "basic_1d_vmem":
        return _call(pb.k1, a, (1024,), i32), None
    if base == "static_dma":
        return _dma_call(pb.k3, args[0], (1024,)), (0, 1024)
    if base == "static_row_dma":
        return _dma_call(pb.k4, args[0], (8, 128)), (1024, 2048)
    if base == "dynamic_row_dma":
        o = int(args[0][0])
        return (_dma_call(pb.k5, args[1], (8, 128), args[0]),
                ((o + 1) * 128, (o + 9) * 128))
    if base in ("dynamic_unaligned_dma", "dma_align"):
        o = int(args[0][0])
        kernel = pb.k6 if base == "dynamic_unaligned_dma" else da.kernel
        return (_dma_call(kernel, args[1], (1024,), args[0]),
                (o + 37, o + 37 + 1024))
    by_name = {
        "reshape_i32": (mr.k1, (2048, 1), i32),
        "reshape_f32": (mr.k2, (2048, 1), f32),
        "onehot": (mr.k3, (2048, 128), f32),
        "reshape_2d_i32": (mr.k4, (2048, 1), i32),
        "onehot_masked": (mr.k5, (2048, 128), f32),
        "onehot_gram": (mr.k6, (128, 128), f32),
        "concat_slice": (mr.k7, (2048, 1), i32),
        "gram_bf16": (mf.ka, (128, 128), f32),
        "gram_bf16_normal": (mf.ka, (128, 128), f32),
        "lane_shift": (mf.kb, (256, 128), i32),
        "sublane_slice": (mf.kc, (2048, 1), i32),
        "cond_gram": (mf.kd, (128, 128), f32),
        "cond_gram_normal": (mf.kd, (128, 128), f32),
        "cond_gram_negative": (mf.kd, (128, 128), f32),
        "max_pred": (mf.ke, (256, 128), i32),
        "max_pred_negative": (mf.ke, (256, 128), i32),
    }
    kernel, shape, dtype = by_name[base]
    return _call(kernel, a, shape, dtype), None


def _held_against_pallas(scripts, name, probe, args):
    """The port's CPU path of ``probe`` on ``args`` against the TPU
    kernel of ``name`` in interpret mode."""
    got = probe.fn(*args)
    if isinstance(got, tuple):
        got = got[0]
    got = got.numpy()
    want, window = _reference(scripts, name, [a.numpy() for a in args])
    assert got.shape == want.shape and got.dtype == want.dtype
    if window is not None:
        lo, hi = window
        np.testing.assert_array_equal(got.reshape(-1)[lo:hi],
                                      want.reshape(-1)[lo:hi])
        outside = np.ones(got.size, bool)
        outside[lo:hi] = False
        assert not got.reshape(-1)[outside].any()  # the port zero-fills
    elif probe.gram:
        bound = probes.gram_tolerance(args[0].shape[0]) * probes.gram_bound(
            args[0]).numpy()
        assert (np.abs(got.astype(np.float64) - want) <= bound).all()
        assert (got != 0).all()
    else:
        np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("name", [p.name for p in probes.PROBES])
def test_probe_matches_pallas_interpret(scripts, name):
    probe = next(p for p in probes.PROBES if p.name == name)
    got = _held_against_pallas(scripts, name, probe,
                               probes.probe_inputs(probe, 0, "cpu"))
    if name == "cond_gram_negative":
        assert not got.any()  # the false branch of kd's cond


@pytest.mark.parametrize("probe,edge",
                         [(e.probe, e.edge) for e in probes.DMA_EDGES])
def test_dma_edges_match_pallas_interpret(scripts, probe, edge):
    """The DMA probes at the offsets that complete the load and store
    residues mod 4, at the last offset in bounds and f6 at offset 0: the
    plain version against the TPU kernel in interpret mode, inside the
    written window (zeros outside it)."""
    p, args = probes.edge_inputs(probe, edge, 0, "cpu")
    _held_against_pallas(scripts, probe, p, args)


@pytest.mark.parametrize("probe,edge,shift", [
    (e.probe, e.edge, e.shift) for e in probes.ELEMENTWISE_EDGES])
def test_elementwise_edges_match_pallas_interpret(scripts, probe, edge,
                                                  shift):
    """f1, f2, k2, k7 and kc on views 4, 8 or 12 bytes past a 16-byte
    boundary (the elementwise kernel's scalar head and tail on the
    card): the plain version against the TPU kernel in interpret mode,
    exactly."""
    p, args = probes.edge_inputs(probe, edge, 0, "cpu")
    assert args[0].is_contiguous() and args[0].data_ptr() % 16 == 4 * shift
    _held_against_pallas(scripts, probe, p, args)


@pytest.mark.parametrize("probe,edge",
                         [(e.probe, e.edge) for e in probes.PREDICATE_EDGES])
def test_predicate_edges_match_pallas_interpret(scripts, probe, edge):
    """kd's and ke's max predicate on edge inputs (all values <= 0,
    -0.0, one positive at the last element, int32 minimum): the plain
    version against the TPU kernel in interpret mode, exactly."""
    p, args = probes.edge_inputs(probe, edge, 0, "cpu")
    got = p.fn(*args).numpy()
    want, _ = _reference(scripts, probe, [a.numpy() for a in args])
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    x = args[0].numpy()
    taken = x.astype(np.float32).max() > 0
    assert taken == (edge == "positive_last")
    if probe == "max_pred":
        np.testing.assert_array_equal(got, x if taken else x * 2)
    else:
        assert got.any() == taken


@pytest.mark.parametrize("probe,edge",
                         [(e.probe, e.edge) for e in probes.ONEHOT_EDGES])
def test_onehot_edges_match_pallas_interpret(scripts, probe, edge):
    """k3 and k5 on values below 0 only, at or past cols only, every
    class of value (int32's minimum and maximum, cols - 1, cols), and
    one row: the plain version against the TPU kernel in interpret
    mode, exactly. The TPU bodies are written for 2048 rows, so a
    shorter input runs there tiled to 2048 rows and its own rows are
    compared."""
    p, args = probes.edge_inputs(probe, edge, 0, "cpu")
    (x,) = args
    got = p.fn(x).numpy()
    rows = x.shape[0]
    tiled = np.resize(x.numpy(), (2048,) + tuple(x.shape[1:]))
    want, _ = _reference(scripts, probe, [tiled])
    assert got.shape == (rows, probes.LANES) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want[:rows])
    hot = (x.numpy().reshape(-1) >= 0) & (x.numpy().reshape(-1) < 128)
    np.testing.assert_array_equal(got.sum(1), hot.astype(np.float32))
    if edge in ("negative", "at_or_past_cols"):
        assert not got.any()


@pytest.mark.parametrize("fn", [probes.onehot, probes.onehot_masked])
def test_onehot_refuses_cols_not_a_multiple_of_4(fn):
    """The kernel writes rows of 16-byte float4s and has no scalar
    path: the wrapper refuses any other width, and an input that is not
    one value a row, on the CPU too."""
    masked = fn is probes.onehot_masked
    x = torch.zeros((8, 1) if masked else (8,), dtype=torch.int32)
    assert fn(x, 132).shape == (8, 132)
    for cols in (130, 2, 0, -4):
        with pytest.raises(ValueError, match="multiple of 4"):
            fn(x, cols)
    for bad in (torch.zeros((0, 1) if masked else (0,), dtype=torch.int32),
                torch.zeros((8, 2) if masked else (8, 1), dtype=torch.int32),
                torch.zeros((8, 1) if masked else (8,), dtype=torch.int64)):
        with pytest.raises(ValueError):
            fn(bad)


def test_dma_routes_at_the_probe_offsets():
    """The split the bulk copies take at test_dma_align.py's offsets and
    at probes.DMA_EDGES', from a 16-byte aligned base: an int32 offset
    that is a multiple of 4 loads by one bulk copy; 131 peels 1 element
    before the first 16-byte boundary and 3 after the last. Every store
    lands at offset + 37; 7131 is the last offset in bounds."""
    want = {0: ((0, 1024, 0), (3, 1020, 1)),
            128: ((0, 1024, 0), (3, 1020, 1)),
            131: ((1, 1020, 3), (0, 1024, 0)),
            777: ((3, 1020, 1), (2, 1020, 2)),
            1: ((3, 1020, 1), (2, 1020, 2)),
            2: ((2, 1020, 2), (1, 1020, 3)),
            3: ((1, 1020, 3), (0, 1024, 0)),
            7131: ((1, 1020, 3), (0, 1024, 0))}
    for off, (load, store) in want.items():
        x = torch.arange(8192, dtype=torch.int32)
        assert x.data_ptr() % 16 == 0
        out, info = probes.dma_align(torch.tensor([off], dtype=torch.int32), x)
        assert tuple(info[:3].tolist()) == load
        assert tuple(info[3:6].tolist()) == store
        assert int(info[6]) == 0
        np.testing.assert_array_equal(out[off + 37 : off + 1061].numpy(),
                                      np.arange(off, off + 1024) + 1)
    for off in (7132, 8000):
        with pytest.raises(ValueError):
            probes.dma_align(torch.tensor([off], dtype=torch.int32), x)


def test_run_all_reports_every_probe_on_cpu(capsys):
    results = probes.run_all("cpu", seed=3, strict=True)
    assert [r["name"] for r in results] == [p.name for p in probes.PROBES]
    assert all(r["ok"] for r in results)
    assert {r["group"] for r in results} == set(probes.GROUPS)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(probes.PROBES)
    assert all(ln.split(": ")[1].startswith("OK") for ln in lines)
    assert "load bulk 1020, peeled 1+3" in lines[
        [p.name for p in probes.PROBES].index("dma_align@131")]
    # the CPU launches nothing
    assert sum(probes.launches.values()) == 0
    assert sum(probes.kernel_launches.values()) == 0


def test_cli_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        probes.main()


@pytest.mark.cuda
def test_probe_kernels_match_plain_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the probes are CUDA kernels")
    before = dict(probes.launches)
    results = probes.run_all("cuda", seed=1, strict=True, log=None)
    assert all(r["ok"] for r in results)
    assert all(probes.launches[g] > before[g] for g in probes.GROUPS)
    assert all(n > 0 for n in probes.kernel_launches.values())
    # the edge inputs: the predicate's through the grid-wide reduce, the
    # DMA kernel's residues and last offset, the elementwise kernel's
    # scalar heads and tails, the one-hot kernel's values and one row
    before = dict(probes.kernel_launches)
    for e in probes.EDGES:
        probes.compare(*probes.edge_inputs(e.probe, e.edge, 1, "cuda"))
    after = probes.kernel_launches
    assert after["probe_max_positive"] - before["probe_max_positive"] == 6
    assert after["probe_dma_add1"] - before["probe_dma_add1"] == len(
        probes.DMA_EDGES)
    assert after["probe_map"] - before["probe_map"] == 3 + len(
        probes.ELEMENTWISE_EDGES)
    assert after["probe_onehot_f32"] - before["probe_onehot_f32"] == len(
        probes.ONEHOT_EDGES)
