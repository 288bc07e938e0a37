"""Where the device time of one ``simka`` run goes.

    python -m simka_tpu_torch.profiling.trace -in input.txt -out dir [simka options]

Runs the ``simka`` command (``simka_tpu_torch.cli``, on the GPU) twice
with the given options: once to warm up (kernel build, CUDA context,
allocator), then under ``torch.profiler``. Prints the profiled
wall-clock, the device busy time, the device idle share
(1 - busy / wall), the run's stage times from ``simka_metrics.json``,
and the device events with the most time.

Busy time is the union of the intervals of the events that ran on the
device (kernels, copies, fills), so events that overlap count once.
The aten ops that launched them are host intervals and are left out:
counting them too would count each kernel's time twice.
"""

from __future__ import annotations

import json
import os
import sys
import time
from collections import defaultdict
from typing import Iterable, List, Tuple

import torch

Interval = Tuple[float, float, str]  # start us, end us, name


def device_intervals(events: Iterable) -> List[Interval]:
    """(start, end, name) of the device events among ``events`` (the
    ``FunctionEvent``s of ``profile.events()``), in microseconds."""
    return [
        (e.time_range.start, e.time_range.end, e.name)
        for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]


def union_us(intervals: Iterable[Interval]) -> float:
    """Length of the union of the intervals."""
    total, end = 0.0, float("-inf")
    for s, e, _ in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def top_events(intervals: List[Interval], n: int = 12) -> list:
    """[(total us, count, name)] of the ``n`` names with most time."""
    by_name = defaultdict(lambda: [0.0, 0])
    for s, e, name in intervals:
        by_name[name][0] += e - s
        by_name[name][1] += 1
    rows = [(t, c, name) for name, (t, c) in by_name.items()]
    return sorted(rows, reverse=True)[:n]


def _out_dir(argv: list) -> str:
    return argv[argv.index("-out") + 1] if "-out" in argv else "./simka_results"


def profile_simka(argv: list) -> dict:
    """The warm-up run, then the profiled run of ``simka`` ``argv``.
    Returns wall_s, busy_s, idle_share, stages and top events."""
    from simka_tpu_torch import resolve_device
    from simka_tpu_torch.cli import main as cli_main

    resolve_device("cuda")  # raises without a GPU
    argv = list(argv) + ["-device", "cuda"]
    if cli_main(argv) != 0:
        raise RuntimeError("the warm-up run failed")
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        rc = cli_main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError("the profiled run failed")
    intervals = device_intervals(prof.events())
    if not intervals:
        raise RuntimeError("the trace holds no device event")
    busy = union_us(intervals) / 1e6
    with open(os.path.join(_out_dir(argv), "simka_metrics.json")) as f:
        counters = json.load(f)["counters"]
    return {
        "wall_s": wall,
        "busy_s": busy,
        "idle_share": 1.0 - busy / wall,
        "n_device_events": len(intervals),
        "stages": {k: v for k, v in sorted(counters.items())
                   if k.startswith("stage_")},
        "top": top_events(intervals),
    }


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    r = profile_simka(argv)
    print(f"wall {r['wall_s']:.4f} s (profiled), device busy "
          f"{r['busy_s']:.4f} s over {r['n_device_events']} device events, "
          f"idle share {r['idle_share']:.4f}; "
          + ", ".join(f"{k} {v}" for k, v in r["stages"].items()))
    for t, c, name in r["top"]:
        print(f"  {t / 1e3:10.3f} ms  x{c:<6d} {name[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
