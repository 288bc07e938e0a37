"""Device-memory plan for the in-memory join.

The in-memory path holds every k-mer instance on the device until the
join, so a run whose instance stream outgrows the device must take the
out-of-core hash-range sweep instead -- which the port does not have
yet. Until it does, exceeding the plan raises NotImplementedError
before the allocator fails mid-run.
"""

from __future__ import annotations

import os

import torch

# The join holds roughly this multiple of the raw row payload (the
# sort's values, indices and scratch, run counts, masks, compaction).
JOIN_WORKING_SET_FACTOR = 8

# Fraction of the device's memory the join may plan to use.
DEVICE_PLAN_FRACTION = 0.6

# Bytes of one instance row: each int64 k-mer word and an int32
# sample id.
WORD_BYTES = 8
SID_BYTES = 4


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


def instance_rows_budget(device: torch.device, n_words: int) -> int:
    """Max k-mer instance rows of ``n_words`` int64 words each that the
    in-memory join may accumulate."""
    per_row = (WORD_BYTES * n_words + SID_BYTES) * JOIN_WORKING_SET_FACTOR
    return max(device_budget_bytes(device) // per_row, 1)
