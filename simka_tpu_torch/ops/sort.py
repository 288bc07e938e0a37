"""The join's sort of packed (k-mer, sample) keys.

``sort_packed_keys(word, sid, sbits, bits)`` returns the ascending keys
``(word << sbits) | sid``: on a CUDA tensor by the hand-written radix
sort of ``csrc/sort.cu`` (keys only, over the key's ``bits`` used bits,
the key formed in the sort's first pass), on a CPU tensor by its plain
version, ``torch.sort(...).values``. It replaces the sort of the
reference's join (``lax.sort`` in ``simka_tpu/ops/countjoin.py::
_rows_from_instances``).
"""

from __future__ import annotations

import ctypes

import torch

DIGIT_BITS = 8  # the widest digit a pass sorts (csrc/sort.cu)

# kernel launches on the CUDA path (the CPU path does not count): the
# histogram, the scan and one a digit pass and portion
sort_launches = 0


def radix_passes(bits: int) -> tuple:
    """The digit passes that sort keys below 2^bits (1 <= bits <= 63):
    (shift, width) pairs, least significant first, as few as digits of
    at most DIGIT_BITS bits allow, their widths within one of each other,
    together covering [0, bits)."""
    if not 1 <= bits <= 63:
        raise ValueError(f"radix_passes: bits={bits} outside 1..63")
    n = -(-bits // DIGIT_BITS)
    out, shift = [], 0
    for i in range(n):
        width = bits // n + (i < bits % n)
        out.append((shift, width))
        shift += width
    return tuple(out)


def sort_packed_keys(word: torch.Tensor, sid: torch.Tensor, sbits: int,
                     bits: int) -> torch.Tensor:
    """The keys ``(word << sbits) | sid`` in ascending order, [E] int64.

    ``word``: [E] int64; ``sid``: [E] int32 or int64, on the word's
    device. Precondition, not checked here (the join checks its rows'
    ranges beforehand, ``countjoin._checked_rows``; the extraction makes
    every word in range): 0 <= word < 2^(bits - sbits) and
    0 <= sid < 2^sbits, so every key lies below 2^bits. Equal keys are
    equal, so the order among them is moot.

    On CUDA tensors (contiguous) this launches the kernels of
    ``csrc/sort.cu`` or raises: the histogram, the scan and one a digit
    pass (``radix_passes(bits)``) and portion of the keys (one up to
    536 M keys); on CPU tensors it is the plain version,
    ``torch.sort(...).values``.
    """
    global sort_launches
    if (word.dim() != 1 or word.dtype != torch.int64
            or sid.shape != word.shape or sid.device != word.device
            or sid.dtype not in (torch.int32, torch.int64)):
        raise ValueError("sort_packed_keys: [E] int64 words and [E] int32 "
                         "or int64 sample ids on one device")
    passes = radix_passes(bits)
    if not 0 <= sbits < bits:
        raise ValueError(f"sort_packed_keys: sbits={sbits} with bits={bits}")
    dev = word.device
    if dev.type == "cpu":
        return torch.sort((word << sbits) | sid.to(torch.int64)).values
    if dev.type != "cuda":
        raise ValueError(f"sort_packed_keys: unsupported device {dev}")
    if not (word.is_contiguous() and sid.is_contiguous()):
        raise ValueError("sort_packed_keys needs contiguous tensors on CUDA")
    E = word.shape[0]
    if E == 0:
        return torch.empty(0, dtype=torch.int64, device=dev)
    from simka_tpu_torch.ops import _kernels

    lib = _kernels.lib()
    P = len(passes)
    tiles = -(-E // lib.simka_sort_tile_keys())
    portions = -(-tiles // lib.simka_sort_portion_tiles())
    keys = [torch.empty(E, dtype=torch.int64, device=dev) for _ in range(2)]
    status = torch.empty(tiles * 256, dtype=torch.int32, device=dev)
    small = torch.empty(P * (portions + 2) * 256, dtype=torch.int64,
                        device=dev)
    shifts = (ctypes.c_int * P)(*[s for s, _ in passes])
    widths = (ctypes.c_int * P)(*[w for _, w in passes])
    with torch.cuda.device(dev):
        code = lib.simka_radix_sort(
            word.data_ptr(), sid.data_ptr(), sid.element_size(), sbits, E, P,
            ctypes.addressof(shifts), ctypes.addressof(widths),
            keys[0].data_ptr(), keys[1].data_ptr(), status.data_ptr(),
            small.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check(code, "sort_packed_keys")
    sort_launches += 2 + P * portions
    return keys[(P - 1) % 2]
