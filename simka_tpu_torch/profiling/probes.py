"""The TPU capability probes, asked again of the GPU.

The JAX package kept four probe scripts under ``scripts/profiling/``
that asked Mosaic, the TPU kernel compiler, what it accepts: elementwise
bodies, DMAs at static, dynamic and unaligned offsets, reshapes,
one-hots, bf16 products contracting dim 0, a product under a device-side
predicate. Their answers shaped the JAX package's kernels (the unaligned
DMA's refusal is why ``gapclose`` never ran on the chip). Each probe
here computes what one of those kernels computes, at its shapes and
dtypes, with a kernel of ``csrc/probes.cu``; beside each is its plain
torch version ``<name>_plain``. A CUDA tensor launches the kernel or
raises; a CPU tensor takes the plain version.

The probes fall in four groups, one per script:

  pallas_basic     test_pallas_basic.py   f1..f6
  mosaic_reshape   test_mosaic_reshape.py k1..k7
  mosaic_features  test_mosaic_features.py ka..ke
  dma_align        test_dma_align.py      run (offsets 0, 128, 131, 777)

The DMA probes return (out, info): ``info`` [7] int32 reports how each
copy went -- elements peeled before the first 16-byte boundary, moved by
one bulk copy (``cp.async.bulk``, which needs 16-byte aligned addresses
and sizes), peeled after it; for the load, then the store; then an
out-of-bounds flag. Outside the written window the output is 0 (the TPU
left it undefined).

``EDGES`` lists edge inputs beside the probes' own (``edge_inputs``):
kd's and ke's max predicate, the DMA kernel at every load and store
residue and the last offset in bounds, the elementwise kernel on
inputs 4, 8 or 12 bytes past a 16-byte boundary, and the one-hot
kernel (k3, k5) on values below 0, at or past cols, and one row.

    python -m simka_tpu_torch.profiling.probes

runs every probe on the GPU and prints one ``name: OK`` or ``name: FAILED ...`` line per probe, each
kernel held against its plain version on the same inputs.
"""

from __future__ import annotations

import sys
from typing import Callable, List, NamedTuple

import numpy as np
import torch

# file:line of each group's pl.pallas_call
GROUPS = {
    "pallas_basic": "scripts/profiling/test_pallas_basic.py:27,39,61,92,123,158",
    "mosaic_reshape": "scripts/profiling/test_mosaic_reshape.py:11",
    "mosaic_features": "scripts/profiling/test_mosaic_features.py:11",
    "dma_align": "scripts/profiling/test_dma_align.py:35",
}

# kernel launches per group on the CUDA path (the CPU path does not count)
launches = dict.fromkeys(GROUPS, 0)
# the same launches by csrc/probes.cu kernel (the bf16 product is two
# kernels a call, probe_gram_partial and probe_gram_reduce)
kernel_launches = dict.fromkeys(("probe_map", "probe_dma_add1",
                                 "probe_onehot_f32", "probe_max_positive",
                                 "probe_gram_bf16"), 0)

# csrc/probes.cu's elementwise ops (simka_probe_map)
_SCALE_F32, _MUL, _ADD, _ROLL_ADD1, _ROLL_SUM, _LANE_BYTE, _SELECT = range(7)

LANES = 128  # the TPU probes' lane width (last dim)
DMA_LEN = 1024  # elements per DMA probe copy
INFO_FIELDS = ("load_head", "load_bulk", "load_tail",
               "store_head", "store_bulk", "store_tail", "out_of_bounds")


def gram_tolerance(rows: int) -> float:
    """Bound on |kernel - exact| / sum |a||b| for an f32 sum of ``rows``
    exact bf16 products: (rows - 1) additions of relative error 2^-24,
    doubled for an accumulator that truncates."""
    return 2.0 * rows * 2.0**-24


# ---- launching ----

def _is_cuda(*ts: torch.Tensor) -> bool:
    """True for CUDA tensors (checked contiguous), False for CPU ones."""
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError("probe inputs on different devices")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"probes run on cuda or cpu, not {dev}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("probe kernels need contiguous tensors")
    return True


def _launch(group: str, kernel: str, fn: str, *args, kernels: int = 1):
    """Call entry point ``fn``, which launches ``kernels`` kernels of
    ``kernel`` (a key of ``kernel_launches``)."""
    from simka_tpu_torch.ops import _kernels

    _kernels.check(getattr(_kernels.lib(), fn)(*args), fn)
    launches[group] += kernels
    kernel_launches[kernel] += kernels


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(t: torch.Tensor, shape, dtype) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(
            f"probe input {tuple(t.shape)} {t.dtype}, expected "
            f"{tuple(shape)} {dtype}"
        )


def _like_at_residue(x: torch.Tensor) -> torch.Tensor:
    """An empty contiguous tensor like x whose address is x's mod 16 (a
    view into a buffer a few elements longer): the elementwise kernel's
    16-byte loads of x and stores to it then start at one element."""
    shift = x.data_ptr() % 16 // x.element_size()
    buf = torch.empty(x.numel() + shift, dtype=x.dtype, device=x.device)
    return buf[shift:].view(x.shape)


def _map(group, op, x, arg=0, mul=1.0, flag=None):
    """out = op(x) elementwise (csrc/probes.cu's probe_map): the int32
    ops take ``arg``, _SCALE_F32 ``mul``, _SELECT the device ``flag``."""
    if x.numel() >= 1 << 31:
        raise ValueError(f"probe_map indexes in 32 bits: {x.numel()} elements")
    out = _like_at_residue(x)
    with torch.cuda.device(x.device):
        _launch(group, "probe_map", "simka_probe_map", op, x.data_ptr(),
                out.data_ptr(), x.numel(), int(arg), float(mul),
                None if flag is None else flag.data_ptr(), _stream(x))
    return out


def _max_positive(group, x):
    """The flag, a [1] int32 device word; the kernel's combine state is
    the two zeroed words after it, this call's own."""
    words = torch.zeros(3, dtype=torch.int32, device=x.device)
    flag = words[:1]
    with torch.cuda.device(x.device):
        _launch(group, "probe_max_positive", "simka_probe_max_positive",
                int(x.dtype == torch.int32), x.data_ptr(), x.numel(),
                flag.data_ptr(), words[1:].data_ptr(), _stream(x))
    return flag


GRAM_CHUNK = 64  # rows of x per CTA of csrc/probes.cu's product


def _gram(group, x, mode, cols, mod=1, flag=None):
    rows = x.shape[0]
    out = torch.empty((cols, cols), dtype=torch.float32, device=x.device)
    # one [cols, cols] f32 partial per chunk, summed in order by the
    # entry point's second kernel
    part = torch.empty((rows // GRAM_CHUNK, cols, cols), dtype=torch.float32,
                       device=x.device)
    with torch.cuda.device(x.device):
        _launch(group, "probe_gram_bf16", "simka_probe_gram_bf16", mode,
                x.data_ptr(), out.data_ptr(), rows, cols, mod,
                None if flag is None else flag.data_ptr(), part.data_ptr(),
                _stream(x), kernels=2)
    return out


# each DMA probe's window: (off_scale, src_add, dst_add, length); it
# copies x[src, src + length) + 1 to out[dst, dst + length), src = off *
# off_scale + src_add, dst = off * off_scale + dst_add
DMA_SPANS = {
    "static_dma": (0, 0, 0, DMA_LEN),
    "static_row_dma": (0, 0, 8 * LANES, 8 * LANES),
    "dynamic_row_dma": (LANES, 0, LANES, 8 * LANES),
    "dynamic_unaligned_dma": (1, 0, 37, DMA_LEN),
    "dma_align": (1, 0, 37, DMA_LEN),
}


def dma_window(name: str, off) -> tuple:
    """(src, dst, length) of DMA probe ``name`` (``dma_align@131`` or
    ``dma_align``) at the [1] int32 offset ``off`` (None for the static
    ones), read on the host."""
    off_scale, src_add, dst_add, length = DMA_SPANS[name.split("@")[0]]
    o = 0 if off is None else int(off.reshape(-1)[0])
    return o * off_scale + src_add, o * off_scale + dst_add, length


def _dma(group, name, x, off):
    off_scale, src_add, dst_add, length = DMA_SPANS[name]
    out = torch.zeros_like(x)
    info = torch.empty(len(INFO_FIELDS), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        _launch(group, "probe_dma_add1", "simka_probe_dma", x.data_ptr(),
                x.numel(), out.data_ptr(), out.numel(),
                None if off is None else off.data_ptr(), off_scale, src_add,
                dst_add, length, info.data_ptr(), _stream(x))
    return out, info


# ---- plain versions of the shared shapes ----

def _split16(addr: int, length: int):
    """(head, bulk, tail) elements of an int32 span at byte address
    ``addr``: up to the first 16-byte boundary, a multiple of 16 bytes,
    the rest (csrc/probes.cu's split16)."""
    mis = (addr >> 2) & 3
    head = min(0 if mis == 0 else 4 - mis, length)
    bulk = (length - head) // 4 * 4
    return head, bulk, length - head - bulk


def _dma_plain(name, x, off):
    src, dst, length = dma_window(name, off)
    flat = x.reshape(-1)
    out = torch.zeros_like(x)
    if min(src, dst) < 0 or max(src, dst) + length > flat.numel():
        raise ValueError(f"DMA span [{src}, {dst}) + {length} out of bounds")
    out.view(-1)[dst : dst + length] = flat[src : src + length] + 1
    info = (*_split16(x.data_ptr() + 4 * src, length),
            *_split16(out.data_ptr() + 4 * dst, length), 0)
    return out, torch.tensor(info, dtype=torch.int32, device=x.device)


def _gram_plain(a: torch.Tensor) -> torch.Tensor:
    """A^T A of a bf16-valued [rows, cols] f32 tensor, summed in f64
    (exact products, error far below the kernel's) and rounded to f32."""
    a = a.to(torch.float64)
    return (a.T @ a).to(torch.float32)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _onehot_mod(x: torch.Tensor, cols: int, mod: int) -> torch.Tensor:
    lane = torch.arange(cols, device=x.device, dtype=torch.int32) % mod
    return (x.reshape(-1, 1) == lane).to(torch.float32)


def gram_bound(x: torch.Tensor) -> torch.Tensor:
    """sum |a||b| of the product ``gram_bf16`` takes of x (the scale
    of its tolerance, ``gram_tolerance``)."""
    return _gram_plain(_bf16(x).abs())


# ---- row 2: test_pallas_basic.py ----

def basic_2d_vmem(x):
    """f1 (k1 on [256, 256] f32): x * 2."""
    _check(x, (256, 256), torch.float32)
    if not _is_cuda(x):
        return basic_2d_vmem_plain(x)
    return _map("pallas_basic", _SCALE_F32, x, mul=2.0)


def basic_2d_vmem_plain(x):
    return x * 2


def basic_1d_vmem(x):
    """f2 (k1 on [1024] int32): x * 2."""
    _check(x, (1024,), torch.int32)
    if not _is_cuda(x):
        return basic_1d_vmem_plain(x)
    return _map("pallas_basic", _MUL, x, 2)


def basic_1d_vmem_plain(x):
    return x * 2


def static_dma(x):
    """f3 (k3): out[0:1024] = x[0:1024] + 1, x [8192] int32, through
    shared memory by bulk copy."""
    _check(x, (8192,), torch.int32)
    if not _is_cuda(x):
        return static_dma_plain(x)
    return _dma("pallas_basic", "static_dma", x, None)


def static_dma_plain(x):
    return _dma_plain("static_dma", x, None)


def static_row_dma(x):
    """f4 (k4): rows 0:8 of [64, 128] int32, + 1, into rows 8:16."""
    _check(x, (64, LANES), torch.int32)
    if not _is_cuda(x):
        return static_row_dma_plain(x)
    return _dma("pallas_basic", "static_row_dma", x, None)


def static_row_dma_plain(x):
    return _dma_plain("static_row_dma", x, None)


def dynamic_row_dma(off, x):
    """f5 (k5): rows off:off+8 of [64, 128] int32, + 1, into rows
    off+1:off+9; ``off`` [1] int32 is read on the device (the TPU's
    scalar prefetch)."""
    _check(x, (64, LANES), torch.int32)
    _check(off, (1,), torch.int32)
    if not _is_cuda(x, off):
        return dynamic_row_dma_plain(off, x)
    return _dma("pallas_basic", "dynamic_row_dma", x, off)


def dynamic_row_dma_plain(off, x):
    return _dma_plain("dynamic_row_dma", x, off)


def dynamic_unaligned_dma(off, x):
    """f6 (k6): out[off+37 : off+37+1024] = x[off : off+1024] + 1, x
    [8192] int32, ``off`` [1] int32 read on the device."""
    _check(x, (8192,), torch.int32)
    _check(off, (1,), torch.int32)
    if not _is_cuda(x, off):
        return dynamic_unaligned_dma_plain(off, x)
    return _dma("pallas_basic", "dynamic_unaligned_dma", x, off)


def dynamic_unaligned_dma_plain(off, x):
    return _dma_plain("dynamic_unaligned_dma", x, off)


# ---- row 3: test_mosaic_reshape.py ----

def reshape_i32(x):
    """k1: [2048] int32 -> [2048, 1], + 1."""
    _check(x, (2048,), torch.int32)
    if not _is_cuda(x):
        return reshape_i32_plain(x)
    return _map("mosaic_reshape", _ADD, x, 1).view(2048, 1)


def reshape_i32_plain(x):
    return x.reshape(-1, 1) + 1


def reshape_f32(x):
    """k2: [2048] f32 -> [2048, 1], * 2.0."""
    _check(x, (2048,), torch.float32)
    if not _is_cuda(x):
        return reshape_f32_plain(x)
    return _map("mosaic_reshape", _SCALE_F32, x, mul=2.0).view(2048, 1)


def reshape_f32_plain(x):
    return x.reshape(-1, 1) * 2.0


def onehot(x, cols: int = LANES):
    """k3: [rows] int32 against the lane iota -> [rows, cols] f32 (the
    TPU probe's rows 2048, cols 128)."""
    _check_onehot(x, (x.shape[0],) if x.dim() == 1 else None, cols)
    if not _is_cuda(x):
        return onehot_plain(x, cols)
    return _onehot("mosaic_reshape", x, cols)


def onehot_plain(x, cols: int = LANES):
    return _onehot_mod(x, cols, cols)


def _check_onehot(x, shape, cols: int) -> None:
    """``x`` int32 of ``shape`` (None: a wrong rank) with rows >= 1, and
    ``cols`` a positive multiple of 4: the kernel writes each row as
    float4s and has no scalar path (on the CPU too, so both paths take
    the same inputs)."""
    if shape is None or shape[0] < 1:
        raise ValueError(f"one-hot input {tuple(x.shape)}: one value a row, "
                         "at least one row")
    _check(x, shape, torch.int32)
    if cols < 4 or cols % 4:
        raise ValueError(f"one-hot cols={cols}: the kernel writes rows of "
                         "16-byte float4s, so cols is a multiple of 4")


def _onehot(group, x, cols):
    out = torch.empty((x.shape[0], cols), dtype=torch.float32,
                      device=x.device)
    with torch.cuda.device(x.device):
        _launch(group, "probe_onehot_f32", "simka_probe_onehot_f32",
                x.data_ptr(), out.data_ptr(), x.shape[0], cols, _stream(x))
    return out


def reshape_2d_i32(x):
    """k4: (16, 128) int32 -> (2048, 1), + 1."""
    _check(x, (16, LANES), torch.int32)
    if not _is_cuda(x):
        return reshape_2d_i32_plain(x)
    return _map("mosaic_reshape", _ADD, x, 1).view(2048, 1)


def reshape_2d_i32_plain(x):
    return x.reshape(-1, 1) + 1


def onehot_masked(x, cols: int = LANES):
    """k5: [rows, 1] int32, one-hot against the lane iota under the
    mask x >= 0 -> [rows, cols] f32 (the TPU probe's rows 2048, cols
    128)."""
    _check_onehot(x, (x.shape[0], 1) if x.dim() == 2 else None, cols)
    if not _is_cuda(x):
        return onehot_masked_plain(x, cols)
    return _onehot("mosaic_reshape", x, cols)


def onehot_masked_plain(x, cols: int = LANES):
    lane = torch.arange(cols, device=x.device, dtype=torch.int32)
    return ((x >= 0) & (x == lane)).to(torch.float32)


def onehot_gram(x):
    """k6: A = one-hot of x [2048, 1] int32 == lane % 8 in bf16; A^T A
    contracting dim 0 -> [128, 128] f32, on the tensor cores."""
    _check(x, (2048, 1), torch.int32)
    if not _is_cuda(x):
        return onehot_gram_plain(x)
    return _gram("mosaic_reshape", x, 1, LANES, mod=8)


def onehot_gram_plain(x):
    return _gram_plain(_onehot_mod(x, LANES, 8))


def concat_slice(x):
    """k7: concat(x, x)[5:2053] + 1 of x [2048, 1] int32."""
    _check(x, (2048, 1), torch.int32)
    if not _is_cuda(x):
        return concat_slice_plain(x)
    return _map("mosaic_reshape", _ROLL_ADD1, x, 5)


def concat_slice_plain(x):
    return torch.cat([x, x])[5:2053] + 1


# ---- row 4: test_mosaic_features.py ----

def gram_bf16(x):
    """ka: x^T x of [2048, 128] f32 cast to bf16 -> [128, 128] f32, on
    the tensor cores."""
    _check(x, (2048, LANES), torch.float32)
    if not _is_cuda(x):
        return gram_bf16_plain(x)
    return _gram("mosaic_features", x, 0, LANES)


def gram_bf16_plain(x):
    return _gram_plain(_bf16(x))


def lane_shift(x):
    """kb: (x >> (lane % 4 * 8)) & 255 on [256, 128] int32."""
    _check(x, (256, LANES), torch.int32)
    if not _is_cuda(x):
        return lane_shift_plain(x)
    return _map("mosaic_features", _LANE_BYTE, x, LANES)


def lane_shift_plain(x):
    lane = torch.arange(LANES, device=x.device, dtype=torch.int32)
    return (x >> (lane % 4 * 8)) & 255


def sublane_slice(x):
    """kc: w = concat(x, x)[:, None]; w[3:2051] + w[:2048], x [2048]
    int32."""
    _check(x, (2048,), torch.int32)
    if not _is_cuda(x):
        return sublane_slice_plain(x)
    return _map("mosaic_features", _ROLL_SUM, x, 3).view(2048, 1)


def sublane_slice_plain(x):
    w = torch.cat([x, x])[:, None]
    return w[3:2051] + w[:2048]


def cond_gram(x):
    """kd: max(x) > 0 ? x^T x (bf16 -> f32) : 0 on [2048, 128] f32; the
    predicate is a device-side flag (one max-reduce launch), read by the
    product kernel: no host sync."""
    _check(x, (2048, LANES), torch.float32)
    if not _is_cuda(x):
        return cond_gram_plain(x)
    flag = _max_positive("mosaic_features", x)
    return _gram("mosaic_features", x, 0, LANES, flag=flag)


def cond_gram_plain(x):
    return torch.where(x.max() > 0, gram_bf16_plain(x), 0.0)


def max_pred(x):
    """ke: max(f32(x)) > 0 ? x : 2 x on [256, 128] int32 (a max-reduce
    to a device flag, then the select)."""
    _check(x, (256, LANES), torch.int32)
    if not _is_cuda(x):
        return max_pred_plain(x)
    flag = _max_positive("mosaic_features", x)
    return _map("mosaic_features", _SELECT, x, flag=flag)


def max_pred_plain(x):
    return torch.where(x.to(torch.float32).max() > 0, x, x * 2)


# ---- row 5: test_dma_align.py ----

def dma_align(off, x):
    """``run``: the f6 copy (x [8192] int32, off [1] int32 on the
    device) under test_dma_align.py's name."""
    _check(x, (8192,), torch.int32)
    _check(off, (1,), torch.int32)
    if not _is_cuda(x, off):
        return dma_align_plain(off, x)
    return _dma("dma_align", "dma_align", x, off)


def dma_align_plain(off, x):
    return _dma_plain("dma_align", x, off)


# ---- the probe table and the run over it ----

class Probe(NamedTuple):
    group: str
    name: str
    tpu: str  # the TPU kernel it asks again
    fn: Callable
    plain: Callable
    make: Callable  # numpy Generator -> numpy inputs
    gram: bool = False  # held within gram_tolerance, else exactly


def _i32(rng, shape, lo=-(1 << 31), hi=1 << 31):
    return rng.integers(lo, hi, size=shape, dtype=np.int64).astype(np.int32)


def _f32(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _small_ints(rng, shape):
    # integer values in [-8, 8]: every bf16 product and every f32 sum of
    # 2048 of them is exact, so kernel and plain agree bit for bit
    return rng.integers(-8, 9, size=shape).astype(np.float32)


def _dma_probes(group, name, tpu, fn, plain, offsets):
    return [
        Probe(group, f"{name}@{o}", tpu, fn, plain,
              lambda rng, o=o: (np.array([o], np.int32),
                                _i32(rng, (8192,))))
        for o in offsets
    ]


PROBES: List[Probe] = [
    Probe("pallas_basic", "basic_2d_vmem", "f1", basic_2d_vmem,
          basic_2d_vmem_plain, lambda rng: (_f32(rng, (256, 256)),)),
    Probe("pallas_basic", "basic_1d_vmem", "f2", basic_1d_vmem,
          basic_1d_vmem_plain, lambda rng: (_i32(rng, (1024,)),)),
    Probe("pallas_basic", "static_dma", "f3 (k3)", static_dma,
          static_dma_plain, lambda rng: (_i32(rng, (8192,)),)),
    Probe("pallas_basic", "static_row_dma", "f4 (k4)", static_row_dma,
          static_row_dma_plain, lambda rng: (_i32(rng, (64, LANES)),)),
    Probe("pallas_basic", "dynamic_row_dma", "f5 (k5)", dynamic_row_dma,
          dynamic_row_dma_plain,
          lambda rng: (np.array([4], np.int32), _i32(rng, (64, LANES)))),
    *_dma_probes("pallas_basic", "dynamic_unaligned_dma", "f6 (k6)",
                 dynamic_unaligned_dma, dynamic_unaligned_dma_plain, (131,)),
    Probe("mosaic_reshape", "reshape_i32", "k1", reshape_i32,
          reshape_i32_plain, lambda rng: (_i32(rng, (2048,)),)),
    Probe("mosaic_reshape", "reshape_f32", "k2", reshape_f32,
          reshape_f32_plain, lambda rng: (_f32(rng, (2048,)),)),
    Probe("mosaic_reshape", "onehot", "k3", onehot, onehot_plain,
          lambda rng: (_i32(rng, (2048,), -3, LANES + 3),)),
    Probe("mosaic_reshape", "reshape_2d_i32", "k4", reshape_2d_i32,
          reshape_2d_i32_plain, lambda rng: (_i32(rng, (16, LANES)),)),
    Probe("mosaic_reshape", "onehot_masked", "k5", onehot_masked,
          onehot_masked_plain,
          lambda rng: (_i32(rng, (2048, 1), -3, LANES + 3),)),
    Probe("mosaic_reshape", "onehot_gram", "k6", onehot_gram,
          onehot_gram_plain, lambda rng: (_i32(rng, (2048, 1), -1, 9),)),
    Probe("mosaic_reshape", "concat_slice", "k7", concat_slice,
          concat_slice_plain, lambda rng: (_i32(rng, (2048, 1)),)),
    Probe("mosaic_features", "gram_bf16", "ka", gram_bf16, gram_bf16_plain,
          lambda rng: (_small_ints(rng, (2048, LANES)),)),
    Probe("mosaic_features", "gram_bf16_normal", "ka", gram_bf16,
          gram_bf16_plain, lambda rng: (_f32(rng, (2048, LANES)),),
          gram=True),
    Probe("mosaic_features", "lane_shift", "kb", lane_shift,
          lane_shift_plain, lambda rng: (_i32(rng, (256, LANES)),)),
    Probe("mosaic_features", "sublane_slice", "kc", sublane_slice,
          sublane_slice_plain, lambda rng: (_i32(rng, (2048,)),)),
    Probe("mosaic_features", "cond_gram", "kd", cond_gram, cond_gram_plain,
          lambda rng: (_small_ints(rng, (2048, LANES)),)),
    Probe("mosaic_features", "cond_gram_normal", "kd", cond_gram,
          cond_gram_plain, lambda rng: (_f32(rng, (2048, LANES)),),
          gram=True),
    Probe("mosaic_features", "cond_gram_negative", "kd", cond_gram,
          cond_gram_plain,
          lambda rng: (-np.abs(_f32(rng, (2048, LANES))),)),
    Probe("mosaic_features", "max_pred", "ke", max_pred, max_pred_plain,
          lambda rng: (_i32(rng, (256, LANES), -1000, 1000),)),
    Probe("mosaic_features", "max_pred_negative", "ke", max_pred,
          max_pred_plain, lambda rng: (_i32(rng, (256, LANES), -1000, 1),)),
    *_dma_probes("dma_align", "dma_align", "run", dma_align,
                 dma_align_plain, (0, 128, 131, 777)),
]


INT32_MIN = -(1 << 31)


def _positive_last(x, v):
    x = x.copy()
    x.reshape(-1)[-1] = v
    return x


class Edge(NamedTuple):
    probe: str  # a probe's name (a DMA probe's without its @offset)
    edge: str
    make: Callable  # numpy Generator -> numpy inputs
    shift: int = 0  # inputs placed this many elements past a 16-byte boundary


# edge inputs of kd's and ke's max predicate; kd's small integers keep
# its product exact
PREDICATE_EDGES = [
    Edge("cond_gram", "all_nonpositive",
         lambda rng: (-np.abs(_small_ints(rng, (2048, LANES))),)),
    Edge("cond_gram", "negative_zero",
         lambda rng: (np.full((2048, LANES), -0.0, np.float32),)),
    Edge("cond_gram", "positive_last",
         lambda rng: (_positive_last(
             -np.abs(_small_ints(rng, (2048, LANES))), 1.0),)),
    Edge("max_pred", "all_nonpositive",
         lambda rng: (_i32(rng, (256, LANES), INT32_MIN, 1),)),
    Edge("max_pred", "int32_min",
         lambda rng: (np.full((256, LANES), INT32_MIN, np.int32),)),
    Edge("max_pred", "positive_last",
         lambda rng: (_positive_last(np.full((256, LANES), INT32_MIN,
                                             np.int32), 1),)),
]


def _dma_edge(name, off):
    return Edge(name, f"offset_{off}",
                lambda rng: (np.array([off], np.int32), _i32(rng, (8192,))))


# edge inputs of the DMA kernel: dma_align at offsets 1, 2, 3 (with the
# probes' 0, 128, 131 and 777, every load residue mod 4 and every store
# residue), at the last offset in bounds (7131 + 37 + 1024 = 8192), and
# the f6 copy at offset 0
DMA_EDGES = [*(_dma_edge("dma_align", o) for o in (1, 2, 3, 7131)),
             _dma_edge("dynamic_unaligned_dma", 0)]


def _probe(name: str) -> "Probe":
    return next(p for p in PROBES if p.name.split("@")[0] == name)


# edge inputs of the elementwise kernel: f1, f2, k2 and the rolled k7
# and kc on contiguous views whose base is 4, 8 or 12 bytes past a
# 16-byte boundary (a scalar head of 3, 2 or 1 elements and a tail of
# 1, 2 or 3)
ELEMENTWISE_EDGES = [
    Edge(name, f"base+{4 * shift}", _probe(name).make, shift)
    for name in ("basic_2d_vmem", "basic_1d_vmem", "reshape_f32",
                 "concat_slice", "sublane_slice")
    for shift in (1, 2, 3)
]

INT32_MAX = (1 << 31) - 1


def _onehot_values(shape):
    # every class of value once, then at random: below 0 (int32's
    # minimum included), each column's own, cols and past it (int32's
    # maximum included)
    def make(rng):
        v = np.array([INT32_MIN, -1, 0, 1, LANES - 1, LANES, LANES + 1,
                      INT32_MAX], np.int64)
        rest = rng.integers(-2 * LANES, 2 * LANES, size=int(np.prod(shape))
                            - v.size)
        return (np.concatenate([v, rest]).astype(np.int32).reshape(shape),)
    return make


# edge inputs of the one-hot kernel (k3, k5): values below 0 only, at or
# past cols only, every class of value, and one row
ONEHOT_EDGES = [
    Edge(name, edge, make)
    for name, shape in (("onehot", (2048,)), ("onehot_masked", (2048, 1)))
    for edge, make in (
        ("negative", lambda rng, s=shape: (_i32(rng, s, INT32_MIN, 0),)),
        ("at_or_past_cols",
         lambda rng, s=shape: (_i32(rng, s, LANES, 1 << 31),)),
        ("mixed", _onehot_values(shape)),
        ("rows_1", lambda rng, s=shape: (
            np.array([LANES - 1], np.int32).reshape((1,) + s[1:]),)),
    )
]

EDGES = PREDICATE_EDGES + DMA_EDGES + ELEMENTWISE_EDGES + ONEHOT_EDGES


def _placed(a: np.ndarray, shift: int, device) -> torch.Tensor:
    """``a`` as a contiguous tensor on ``device`` starting ``shift``
    elements past a 16-byte boundary (a view into a longer buffer)."""
    t = torch.from_numpy(a)
    buf = torch.empty(t.numel() + shift, dtype=t.dtype, device=device)
    v = buf[shift:].view(t.shape)
    if v.data_ptr() % 16 != shift * t.element_size() % 16:
        raise RuntimeError("the allocator's buffers are not 16-byte aligned")
    return v.copy_(t)


def edge_inputs(probe_name: str, edge: str, seed: int, device) -> tuple:
    """(the probe, its seeded inputs on ``device``) of one entry of
    ``EDGES``."""
    i, e = next((i, e) for i, e in enumerate(EDGES)
                if (e.probe, e.edge) == (probe_name, edge))
    rng = np.random.default_rng([seed, len(PROBES) + i])
    return _probe(probe_name), tuple(_placed(a, e.shift, device)
                                     for a in e.make(rng))


def probe_inputs(probe: Probe, seed: int, device) -> tuple:
    """The probe's seeded inputs as tensors on ``device``."""
    rng = np.random.default_rng([seed, PROBES.index(probe)])
    return tuple(torch.from_numpy(a).to(device) for a in probe.make(rng))


def route_text(info) -> str:
    """A DMA probe's info as 'load bulk 1020, peeled 1+3; store ...'."""
    v = [int(i) for i in info]
    if v[6]:
        return "out of bounds"
    return (f"load bulk {v[1]}, peeled {v[0]}+{v[2]}; "
            f"store bulk {v[4]}, peeled {v[3]}+{v[5]}")


def compare(probe: Probe, args) -> dict:
    """Run ``probe``'s kernel (or, on the CPU, its plain version) and
    its plain version on the same inputs; raise AssertionError on any
    difference beyond the probe's tolerance. Returns {"max_abs_err",
    "route"}."""
    got, want = probe.fn(*args), probe.plain(*args)
    route = None
    if isinstance(want, tuple):  # DMA probes: (out, info)
        (got, g_info), (want, w_info) = got, want
        route = route_text(g_info.cpu())
        if not torch.equal(g_info.cpu(), w_info.cpu()):
            raise AssertionError(
                f"{probe.name}: route {route} != plain "
                f"{route_text(w_info.cpu())}"
            )
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(
            f"{probe.name}: {tuple(got.shape)} {got.dtype} != plain "
            f"{tuple(want.shape)} {want.dtype}"
        )
    err = (got.to(torch.float64) - want.to(torch.float64)).abs()
    max_err = float(err.max()) if err.numel() else 0.0
    if probe.gram:
        bound = gram_tolerance(args[0].shape[0]) * gram_bound(args[0])
        if not bool((err <= bound.to(torch.float64)).all()):
            raise AssertionError(
                f"{probe.name}: max abs err {max_err} beyond "
                f"{gram_tolerance(args[0].shape[0]):.3g} x sum|a||b|"
            )
    elif not torch.equal(got, want):
        raise AssertionError(f"{probe.name}: max abs err {max_err} != 0")
    return {"max_abs_err": max_err, "route": route}


def run_all(device, seed: int = 0, strict: bool = True, log=print) -> list:
    """Every probe on ``device``, each against its plain version.

    Returns one dict per probe (group, name, tpu, ok, max_abs_err,
    route, error). With ``strict`` any failure raises; otherwise it is
    reported as FAILED, as the TPU scripts do.
    """
    device = torch.device(device)
    results = []
    for p in PROBES:
        r = {"group": p.group, "name": p.name, "tpu": p.tpu}
        try:
            r.update(compare(p, probe_inputs(p, seed, device)), ok=True,
                     error=None)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        except Exception as e:  # noqa: BLE001 -- reported, as the TPU scripts do
            if strict:
                raise
            r.update(ok=False, max_abs_err=None, route=None,
                     error=f"{type(e).__name__}: {str(e)[:200]}")
        if log is not None:
            extra = f" ({r['route']})" if r["route"] else ""
            log(f"{p.name}: OK{extra}" if r["ok"]
                else f"{p.name}: FAILED {r['error']}")
        results.append(r)
    return results


def main() -> int:
    from simka_tpu_torch import resolve_device

    results = run_all(resolve_device("cuda"), 0, strict=False)
    return 0 if all(r["ok"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
