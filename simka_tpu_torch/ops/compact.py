"""Stable row compaction: kept rows first, in order; fill after.

The join and the extraction only ever need surviving rows made
CONTIGUOUS with their order preserved -- a stable compaction, not a
sort. On a CUDA tensor ``compact_rows`` launches the hand-written
kernel of ``csrc/compact.cu``; on a CPU tensor it takes the plain
torch version, ``compact_rows_plain``. There is no other switch: a
CUDA input either launches the kernel or raises.

Two forms: with ``n`` (the caller's count of kept rows) the columns
come back exactly ``[n]`` long and no fill is written; without it they
are ``[E]`` with the fill after the kept rows, as the JAX package's
``compact_rows`` returns them.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

# kernel launches on the CUDA path (the CPU path does not count)
launches = 0
# the kernel's own kept total of its last launch: a [1] int64 tensor on
# the card, read by nothing on the path (a check may compare it with n)
last_kept_total = None

_DTYPES = (torch.int32, torch.int64)


def _fill_bits(fill: int, dtype: torch.dtype) -> int:
    """``fill`` as the column's bit pattern, sign-extended to int64
    (a uint32 fill such as 0xFFFFFFFF in an int32 column is -1)."""
    bits = 32 if dtype == torch.int32 else 64
    v = int(fill) & ((1 << bits) - 1)
    return v - (1 << bits) if v >= 1 << (bits - 1) else v


def compact_rows_plain(
    arrays: Sequence[torch.Tensor], kept: torch.Tensor, fills: Sequence[int],
    n: Optional[int] = None,
) -> Tuple[torch.Tensor, ...]:
    """The plain torch version: gather the kept rows, then fill (or,
    with ``n``, the gathered rows alone)."""
    idx = kept.nonzero().squeeze(1)
    if n is not None:
        return tuple(a[idx] for a in arrays)
    k = idx.shape[0]
    outs = []
    for a, f in zip(arrays, fills):
        out = torch.empty_like(a)
        out[:k] = a[idx]
        out[k:] = _fill_bits(f, a.dtype)
        outs.append(out)
    return tuple(outs)


def _compact_rows_cuda(arrays, kept, fills, n):
    global launches, last_kept_total
    from simka_tpu_torch.ops import _kernels

    lib = _kernels.lib()
    E = kept.shape[0]
    n_cols = len(arrays)
    if n is None:
        outs = tuple(torch.empty_like(a) for a in arrays)
    else:
        outs = tuple(torch.empty(n, dtype=a.dtype, device=a.device)
                     for a in arrays)
    n_tiles = -(-E // lib.simka_compact_tile_rows())
    # [ticket counter, kept total, one status word per tile]
    scratch = torch.empty(n_tiles + 2, dtype=torch.int64, device=kept.device)
    ptrs = ctypes.c_void_p * n_cols
    ins_p = ptrs(*[a.data_ptr() for a in arrays])
    outs_p = ptrs(*[o.data_ptr() for o in outs])
    sizes = (ctypes.c_int * n_cols)(*[a.element_size() for a in arrays])
    fill_v = (ctypes.c_int64 * n_cols)(
        *[_fill_bits(f, a.dtype) for a, f in zip(arrays, fills)]
    )
    with torch.cuda.device(kept.device):
        code = lib.simka_compact_rows(
            kept.data_ptr(), E, n_cols,
            ctypes.addressof(ins_p), ctypes.addressof(outs_p),
            ctypes.addressof(sizes), ctypes.addressof(fill_v),
            E if n is None else n, int(n is None), scratch.data_ptr(),
            torch.cuda.current_stream(kept.device).cuda_stream,
        )
    _kernels.check(code, "compact_rows")
    launches += 1
    last_kept_total = scratch[1:2]
    return outs


def compact_rows(
    arrays: Sequence[torch.Tensor], kept: torch.Tensor, fills: Sequence[int],
    n: Optional[int] = None,
) -> Tuple[torch.Tensor, ...]:
    """Stably move rows with ``kept`` to the front; fill the tail.

    Args:
      arrays: [E] contiguous columns of int32 or int64 (uint32 values
        ride as int32), at most 8, on ``kept``'s device.
      kept: [E] bool.
      fills: per-column fill value for every position past the kept
        rows (given as the column's unsigned or signed value).
      n: the number of kept rows, when the caller holds it on the host.
        The card does not check it: with a wrong n the columns are
        wrong (never written past their end), and ``last_kept_total``
        holds the kernel's own count.

    Returns:
      without ``n``: new [E] columns with the kept rows first, in their
      original order, and the fill everywhere after them. With ``n``:
      new [n] columns of the kept rows alone.
    """
    arrays = tuple(arrays)
    if not arrays or len(arrays) != len(fills):
        raise ValueError("compact_rows needs one fill per column")
    if kept.dtype != torch.bool or kept.dim() != 1:
        raise ValueError(f"kept must be a 1-D bool tensor, got {kept.dtype}")
    E = kept.shape[0]
    for a in arrays:
        if a.shape != (E,) or a.device != kept.device:
            raise ValueError(
                f"column {tuple(a.shape)} on {a.device} does not match "
                f"kept [{E}] on {kept.device}"
            )
        if a.dtype not in _DTYPES:
            raise ValueError(f"column dtype {a.dtype} is not int32/int64")
    if n is not None and not 0 <= n <= E:
        raise ValueError(f"compact_rows: n={n} outside [0, {E}]")
    if kept.device.type == "cpu":
        return compact_rows_plain(arrays, kept, fills, n)
    if kept.device.type != "cuda":
        raise ValueError(f"compact_rows: unsupported device {kept.device}")
    if len(arrays) > 8:
        raise ValueError("compact_rows takes at most 8 columns")
    if E == 0:
        return tuple(torch.empty_like(a) for a in arrays)
    if not kept.is_contiguous() or not all(a.is_contiguous() for a in arrays):
        raise ValueError("compact_rows needs contiguous tensors on CUDA")
    return _compact_rows_cuda(arrays, kept, fills, n)
