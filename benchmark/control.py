"""The readings the limits of ``limits/`` are set from, on the chip.

    python3 -m benchmark.control --workload cami_high.default_dist \\
        --seeds 11 12 13 [--program]

For each seed, in one process: the cell's community, the plain
reference (``reference.py``, float64), and the control -- the same
reference put in the program's place and computed one precision lower
(float32 in place of the configuration's float64) -- judged as a run
judges the program's answers. With ``--program``, also one job of the
program on the seed's samples, judged the same way. Prints one JSON
line a seed: the numbers each side reads. The benchmark's own runs do
not run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from benchmark import community, harness, reference, registry


def readings(cell_name: str, seed: int, device: torch.device,
             program: bool, bench: dict,
             bench_dir: str = registry.BENCH_DIR) -> dict:
    """{"control": numbers[, "program": numbers]} of one seed."""
    cell = registry.cell(bench, cell_name)
    runner = harness.Runner(registry.config(cell["config"], bench_dir),
                            registry.traffic(cell["traffic"], bench_dir),
                            device)
    o = runner.options
    k, amin, amax = (runner.k, int(o["abundance_min"]),
                     int(o["abundance_max"]))
    simple, complex_ = (bool(o.get("simple_dist", False)),
                        bool(o.get("complex_dist", False)))
    samples = community.draw_community(seed, device, **runner.community)
    out = {}
    if program:
        runner.load(samples)
        job, stats, mats = runner.job(spans=False)
        runner.sources = []
        if job.route != "in-memory":
            raise RuntimeError(f"the job took the route {job.route!r}")
        prog = (stats, mats)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    ref, ref_mats = reference.answer(samples, k, amin, amax, simple, complex_,
                                     device)
    if program:
        out["program"] = reference.compare(*prog, ref, ref_mats, simple,
                                           complex_)
    ctl, ctl_mats = reference.answer(samples, k, amin, amax, simple,
                                     complex_, device, torch.float32)
    out["control"] = reference.compare(ctl, ctl_mats, ref, ref_mats, simple,
                                       complex_)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    bench = registry.spec()
    for seed in a.seeds:
        r = readings(a.workload, seed, torch.device("cuda", 0), a.program,
                     bench)
        print(json.dumps({"workload": a.workload, "seed": seed, **r}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
