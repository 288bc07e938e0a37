"""Where a tile of the compaction kernel spends its time.

    python -m simka_tpu_torch.profiling.compact_phases

Builds ``csrc/compact.cu`` with ``-DSIMKA_COMPACT_STAMPS``, in which
thread 0 of every tile stamps ``%globaltimer`` at entry, after taking
its ticket, after its mask scan, once its prefix is known (the
look-back, with column 0 staged beside it) and at exit, then runs it
once in each form at the k=21 join shape (int64 key + int32 count,
313,342,848 rows, kept 0.37) and prints each phase's median and 90th
percentile over the tiles, and when the tiles published their counts
and prefixes. ``ncu`` and ``nsys`` do not run on the card's machine;
this is how the kernel's time is split there.
"""

from __future__ import annotations

import ctypes
import os
import sys
import tempfile

import numpy as np
import torch

ROWS = 313_342_848  # instances of the default k=21 full-size run
FRAC = 0.37  # their kept share at the join
MAX_TILES = 1 << 17  # csrc/compact.cu's kStampTiles
N_STAMPS = 7  # and its kStamps
PHASES = ("ticket", "mask scan", "prefix", "columns")


def summary(stamps: np.ndarray, label: str) -> list:
    """Lines on the phases of ``stamps``, [tiles, 7] globaltimer ns as
    the kernel writes them (entry, ticket, scan, prefix, exit, count
    published, prefix published)."""
    d = stamps.astype(np.int64)
    ph = np.diff(d[:, :5], axis=1) / 1e3
    lines = [f"{label}: {len(d)} tiles over "
             f"{(d[:, 4].max() - d[:, 0].min()) / 1e3:.1f} us; a tile "
             f"{np.median(d[:, 4] - d[:, 0]) / 1e3:.3f} us (median)"]
    for i, name in enumerate(PHASES):
        lines.append(f"  {name:10s} median {np.median(ph[:, i]):8.3f} us, "
                     f"p90 {np.percentile(ph[:, i], 90):8.3f} us")
    late = d[1:, 6] - d[1:, 5]  # tile 0 publishes its prefix at once
    if len(late):
        lines.append(f"  prefix published {np.median(late) / 1e3:.3f} us "
                     f"(median) after the tile's own count")
    return lines


def _build(tmp: str) -> str:
    from simka_tpu_torch.ops import _kernels

    out = os.path.join(tmp, "libsimka_kernels.so")
    _kernels.compile_library(out, defines=("-DSIMKA_COMPACT_STAMPS",))
    return out


def phases(seed: int = 0) -> None:
    from simka_tpu_torch import resolve_device
    from simka_tpu_torch.ops import _kernels, compact

    dev = resolve_device("cuda")
    with tempfile.TemporaryDirectory(prefix="compact_phases_") as tmp:
        path = _build(tmp)
        _kernels._lib = None
        _kernels.build = lambda verbose=False: path  # the stamped build
        lib = _kernels.lib()
        lib.simka_compact_stamps.argtypes = [ctypes.c_void_p]
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        kept = torch.rand(ROWS, generator=gen, device=dev) < FRAC
        cols = (torch.randint(0, 1 << 62, (ROWS,), generator=gen, device=dev),
                torch.randint(0, 1 << 30, (ROWS,), generator=gen, device=dev,
                              dtype=torch.int32))
        n = int(kept.sum())
        n_tiles = min(-(-ROWS // lib.simka_compact_tile_rows()), MAX_TILES)
        for form in (n, None):
            compact.compact_rows(cols, kept, (-1, 0), n=form)  # warm-up
            compact.compact_rows(cols, kept, (-1, 0), n=form)
            torch.cuda.synchronize()
            buf = np.zeros(MAX_TILES * N_STAMPS, np.uint64)
            if lib.simka_compact_stamps(buf.ctypes.data) != 0:
                raise RuntimeError("reading the stamps failed")
            label = "exact-length" if form is not None else "with fill"
            for line in summary(buf.reshape(-1, N_STAMPS)[:n_tiles], label):
                print(line)


def main() -> int:
    phases()
    return 0


if __name__ == "__main__":
    sys.exit(main())
