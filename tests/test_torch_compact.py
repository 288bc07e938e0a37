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
    before = compact.launches
    got = compact.compact_rows(cols, kept, fills)
    want = compact.compact_rows_plain(cols, kept, fills)
    torch.cuda.synchronize()
    assert compact.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
