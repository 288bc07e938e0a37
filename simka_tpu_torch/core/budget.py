"""Device-memory plan: which route a run takes and how a sweep is cut.

The in-memory path holds every k-mer instance on the device until the
join, so a run whose instance stream outgrows the device plan takes
the out-of-core hash-range sweep instead (``core.sweep``): per-sample
spectra, spilled per hash range, joined one range at a time, each
range's join sized to fit. The reference sizes its partitions to the
user's -max-memory the same way (src/SimkaPotara.hpp:617-723).

Two guards compose, as in ``simka_tpu.core.budget``:
- an estimate from the input files' sizes, scaled by the k-mer windows
  per byte of their first reads (``estimate_total_instances`` with k),
  routes a clearly oversized run straight out-of-core (run_simka);
- the in-memory ingest counts its instances exactly and raises
  DeviceBudgetExceeded at the plan, before the allocator fails;
  compute_statistics then restarts the run out-of-core.
"""

from __future__ import annotations

import os
from collections import Counter
from typing import Optional

import torch

# The join holds roughly this multiple of the raw row payload (the
# sort's values, indices and scratch, run counts, masks, compaction).
JOIN_WORKING_SET_FACTOR = 8

# Fraction of the device's memory the join may plan to use.
DEVICE_PLAN_FRACTION = 0.6

# Bytes of one row: each int64 k-mer word, an int32 sample id and, in
# a spectrum, an int32 count.
WORD_BYTES = 8
SID_BYTES = 4
COUNT_BYTES = 4


class DeviceBudgetExceeded(RuntimeError):
    """The in-memory ingest would exceed the device plan; the caller
    re-runs through the out-of-core sweep (``simka_tpu``'s
    HBMBudgetExceeded)."""


def device_budget_bytes(device: torch.device) -> int:
    """Bytes the join may plan with on ``device``.

    SIMKA_TPU_HBM_MB overrides (the reference package's knob, which
    its tests also use); otherwise the device's total memory (host
    RAM for the CPU) times the plan fraction.
    """
    env = os.environ.get("SIMKA_TPU_HBM_MB")
    if env:
        return int(float(env) * 1_000_000)
    if device.type == "cuda":
        total = torch.cuda.mem_get_info(device)[1]
    else:
        total = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    return int(total * DEVICE_PLAN_FRACTION)


def _shards_plan(devices, per_device) -> int:
    """``per_device(devices)`` for one device; for the device list of
    hash shards (``parallel.sharded``), the least over its distinct
    devices of ``per_device(d) * n // m``: a device that holds m of the
    n shards holds about m/n of the rows, so it serves n/m times its
    own plan (a device repeated n times plans as one)."""
    if isinstance(devices, torch.device):
        return per_device(devices)
    n = len(devices)
    return min(per_device(d) * n // m for d, m in Counter(devices).items())


def plan_bytes(devices) -> int:
    """Bytes a join may plan with over ``devices``, one device or a
    shard list (``_shards_plan``; ``simka_tpu``'s HBM plan times the
    mesh's shards, ``simka_tpu/core/budget.py:79-91``)."""
    return _shards_plan(devices, device_budget_bytes)


def instance_rows_budget(devices, n_words: int) -> int:
    """Max k-mer instance rows of ``n_words`` int64 words each that the
    in-memory join may accumulate on ``devices``, one device or the
    device list of hash shards, where each device holds only its own
    shards' instances (``_shards_plan``)."""
    per_row = (WORD_BYTES * n_words + SID_BYTES) * JOIN_WORKING_SET_FACTOR
    return _shards_plan(
        devices, lambda d: max(device_budget_bytes(d) // per_row, 1))


def spectrum_rows_budget(
    devices, n_words: int, max_memory_mb: Optional[int]
) -> int:
    """Max spectrum rows one sweep range's join may hold over
    ``devices``, one device or a shard list (``_shards_plan``: the
    out-of-core routes stage each shard's rows on its own device,
    ``parallel.sharded.stage_rows_by_hash``), capped by the user's
    -max-memory declaration over the whole range (the reference's
    knob, SimkaPotara.hpp:383-387; None: the plan alone), over the
    join's working set of rows of ``n_words`` int64 words, a sample id
    and a count."""
    row_bytes = WORD_BYTES * n_words + SID_BYTES + COUNT_BYTES
    budget = plan_bytes(devices)
    if max_memory_mb is not None:
        budget = min(budget, max(max_memory_mb, 1) * 1_000_000)
    return max(budget // (row_bytes * JOIN_WORKING_SET_FACTOR), 1)


def estimate_total_instances(datasets, k: Optional[int] = None) -> int:
    """Crude instance-count estimate from input file sizes (the role
    of gatb Bank::estimate, SimkaAlgorithm.cpp:428-433): ~1 k-mer
    instance per base, ~1 byte per base in FASTA/FASTQ, gz ~4x.

    With ``k`` (the port's routing), each file's bytes are scaled by the
    k-mer windows per byte of the reads at its head
    (``io.bank.windows_per_byte``): 100 bp FASTA reads hold 80 windows
    in about 104 bytes at k=21, 38 at k=63. Without it, the copy of
    ``simka_tpu``'s estimate.

    Used only to choose the cheaper route up front; the exact
    mid-ingest guard catches underestimates.
    """
    from simka_tpu_torch.io.bank import windows_per_byte

    total = 0
    for d in datasets:
        for bank in d.banks:
            for f in bank:
                try:
                    size = os.path.getsize(f)
                except OSError:
                    continue
                if f.endswith(".gz"):
                    size *= 4
                if k is not None:
                    size = round(size * windows_per_byte(f, k))
                total += size
    return total
