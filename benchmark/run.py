"""The benchmark of ``simka_tpu_torch`` on the GPU: one run of one cell.

    python3 -m benchmark.run --workload cami_high.default_dist --seed 7 \\
        --seconds 40 --trace 0

Prints the run's result as one JSON line, the last of standard output,
and the numbers its answers were judged by, each beside its limit, as
the last lines of standard error. Exits 2, printing no result, without
as many CUDA cards as the cell asks for, and 3 if the run loaded JAX or
the JAX package (``simka_tpu``).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up starts here

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    import torch

    from benchmark import harness, registry

    bench = registry.spec()
    chips = int(registry.cell(bench, a.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{a.workload} needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        result = harness.run_cell(
            a.workload, a.seed, a.seconds, bool(a.trace),
            torch.device("cuda", 0), t_start=T_START, bench=bench)
    except harness.ForbiddenModules as e:
        print(f"the run loaded modules it must not: {e}", file=sys.stderr)
        return 3
    emit(result)
    return 0


def emit(result: dict) -> None:
    """The checks on standard error, then the result's line (a number
    that is not finite as its name, so that the line stays JSON)."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
        for key, v in c.items():
            if isinstance(v, float) and not math.isfinite(v):
                c[key] = repr(v)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    sys.exit(main())
