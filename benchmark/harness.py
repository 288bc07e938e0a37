"""One run of one cell: set-up, the measured window of jobs, the check
of every answer against the plain reference, and the result's line.

A job is one whole Simka comparison of the cell's samples, from reads
parsed and packed once in set-up to every distance matrix the traffic
asks for: ``simka_tpu_torch.core.pipeline.compute_statistics`` over
sources that replay the packed batches, then
``simka_tpu_torch.core.distances.compute_all_matrices``. One client
runs jobs back to back (a closed loop): a user waiting on each
comparison.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import math
import os
import shutil
import sys
import tempfile
import threading
import time
import traceback
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import community, reference, registry, tracing

# jobs the profiler traces at the window's start in a --trace 1 run
TRACE_JOBS = 8
# jobs of the cell's own shapes run in set-up
WARMUP_JOBS = 2
# top-level module names that no run may load: the JAX package the
# program was ported from, and JAX
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "simka_tpu")
# SimkaConfig options the reference implements
REFERENCE_OPTIONS = ("kmer_size", "abundance_min", "abundance_max",
                     "simple_dist", "complex_dist")


def forbidden_modules(names) -> List[str]:
    """The names whose top-level module (before the first dot) is one
    of FORBIDDEN_MODULES, compared whole."""
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN_MODULES)


@dataclasses.dataclass
class Job:
    wall_s: float
    matrices_s: float
    timers: Dict[str, float]
    route: Optional[str]
    error: Optional[str] = None


@dataclasses.dataclass
class Context:
    """What the metric readers (``metrics/*.py``) read."""

    setup_s: float
    parse_pack_s: float
    jobs: List[Job]  # the window's jobs, traced ones first
    window_s: float
    peak_bytes: int
    trace: Optional[tracing.Trace]
    traced_jobs: List[Job]
    shapes: dict  # sizes the kernels' bounds need


class ReplaySource:
    """One sample's packed batches, parsed once, handed to every job
    (``compute_statistics`` takes any source with ``iter_packed``)."""

    def __init__(self, batches: list, batch_reads: int, k: int):
        self.batches, self.batch_reads, self.k = batches, batch_reads, k

    def iter_packed(self, batch_reads: int, k: int = 21):
        if (batch_reads, k) != (self.batch_reads, self.k):
            raise ValueError(f"parsed with {self.batch_reads} reads a batch "
                             f"at k={self.k}, asked for {batch_reads}, k={k}")
        return iter(self.batches)


def _write_pipe(path: str, data: bytes, errors: list) -> None:
    try:
        with open(path, "wb") as f:
            f.write(data)
    except BrokenPipeError as e:  # the reader stopped early
        errors.append(e)


def parse_samples(samples: List[np.ndarray], k: int, batch_reads: int,
                  tmp_dir: str):
    """Each sample's FASTA through the program's parser and packer
    (``PackedReadSource.iter_packed``), fed through a named pipe so that
    nothing is written to disk. Returns (the batches of each sample, the
    seconds the parser took)."""
    from simka_tpu_torch.io import native
    from simka_tpu_torch.io.packed import PackedReadSource

    if not native.available():
        raise RuntimeError("the program's native parser did not build")
    out, seconds = [], 0.0
    for s, reads in enumerate(samples):
        path = os.path.join(tmp_dir, f"S{s}.fasta")
        os.mkfifo(path)
        errors: list = []
        writer = threading.Thread(target=_write_pipe, args=(
            path, community.fasta_bytes(reads), errors))
        writer.start()
        try:
            t0 = time.perf_counter()
            out.append(list(PackedReadSource([path]).iter_packed(
                batch_reads, k=k)))
            seconds += time.perf_counter() - t0
        finally:
            if writer.is_alive():  # the parser never opened the pipe
                os.close(os.open(path, os.O_RDONLY | os.O_NONBLOCK))
            writer.join()
            os.unlink(path)
        if errors:
            raise RuntimeError(f"sample {s}: the parser stopped reading")
    return out, seconds


def _digest(stats, mats) -> str:
    h = hashlib.sha256()
    for name in (reference.INT_FIELDS + reference.SIMPLE_FIELDS
                 + reference.COMPLEX_FIELDS + ("kullback_leibler",)):
        h.update(name.encode())
        h.update(np.ascontiguousarray(getattr(stats, name)).tobytes())
    for name in sorted(mats):
        h.update(name.encode())
        h.update(np.ascontiguousarray(mats[name]).tobytes())
    return h.hexdigest()


class Runner:
    """The program's side of a run: the cell's options and sources."""

    def __init__(self, cfg: dict, mix: dict, device: torch.device):
        from simka_tpu_torch.config import SimkaConfig

        self.device = device
        self.options = {**cfg["options"], **mix.get("options", {})}
        unknown = set(self.options) - set(REFERENCE_OPTIONS)
        if unknown:
            raise ValueError(f"options the reference does not implement: "
                             f"{sorted(unknown)}")
        self.sconfig = SimkaConfig(verbose=False, **self.options)
        self.k = int(self.options["kmer_size"])
        self.batch_reads = int(cfg["batch_reads"])
        self.community = cfg["community"]
        self.ids = [f"S{s}" for s in range(self.community["n_samples"])]
        self.sources: List[ReplaySource] = []

    def load(self, samples: List[np.ndarray]) -> float:
        """Parse and pack the samples once into the jobs' sources;
        returns the seconds the parser took."""
        tmp_dir = tempfile.mkdtemp(prefix="simka-bench-")
        try:
            batches, seconds = parse_samples(samples, self.k,
                                             self.batch_reads, tmp_dir)
        finally:
            shutil.rmtree(tmp_dir, ignore_errors=True)
        self.sources = [ReplaySource(b, self.batch_reads, self.k)
                        for b in batches]
        return seconds

    def job(self, spans: bool):
        """One comparison: (Job, stats, matrices)."""
        from simka_tpu_torch.core import distances, pipeline

        span = (torch.profiler.record_function if spans
                else lambda _: contextlib.nullcontext())
        obs: dict = {}
        t0 = time.perf_counter()
        with span(tracing.STATISTICS):
            stats = pipeline.compute_statistics(
                self.sources, self.ids, self.sconfig, self.device,
                batch_reads=self.batch_reads, observer=obs)
        t1 = time.perf_counter()
        with span(tracing.MATRICES):
            mats = distances.compute_all_matrices(stats)
        t2 = time.perf_counter()
        return (Job(t2 - t0, t2 - t1, dict(obs.get("stage_timers", {})),
                    obs.get("route")), stats, mats)


def _batch_shapes(sources: List[ReplaySource], k: int) -> dict:
    """The ingest's sizes from the packed batches the jobs are given:
    their count, bytes and window slots (rows x (L - k + 1))."""
    batches = [b for src in sources for b in src.batches]
    return {
        "batches": len(batches),
        "packed_bytes": sum(p.nbytes for p, _, _, _ in batches),
        "valid_bytes": sum(v.nbytes for _, v, _, _ in batches),
        "window_slots": sum(p.shape[0] * (4 * p.shape[1] - k + 1)
                            for p, _, _, _ in batches),
    }


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             device: torch.device, *, t_start: float,
             bench: Optional[dict] = None,
             bench_dir: str = registry.BENCH_DIR) -> dict:
    """One run of ``cell_name``: the result's line as a dict (``checks``
    last). ``t_start``: the host clock when the run began, where set-up
    starts."""
    bench = registry.spec() if bench is None else bench
    cell = registry.cell(bench, cell_name)
    cfg = registry.config(cell["config"], bench_dir)
    mix = registry.traffic(cell["traffic"], bench_dir)
    limits = registry.limits(cell_name, bench_dir)
    runner = Runner(cfg, mix, device)
    opts, k = runner.options, runner.k
    simple = bool(opts.get("simple_dist", False))
    complex_ = bool(opts.get("complex_dist", False))

    # ---- set-up
    samples = community.draw_community(seed, device, **runner.community)
    parse_s = runner.load(samples)
    for _ in range(WARMUP_JOBS):
        runner.job(spans=False)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start

    # ---- the window
    jobs: List[Job] = []
    answers: Dict[str, list] = {}  # digest -> [stats, mats, jobs]
    launches: List[Dict[str, int]] = []
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    t0 = time.perf_counter()
    while True:
        tracing_now = prof is not None and len(launches) < TRACE_JOBS
        before = tracing.launch_counts() if tracing_now else None
        try:
            job, stats, mats = runner.job(spans=tracing_now)
        except Exception:  # a job that raises is a failed job
            jobs.append(Job(math.nan, math.nan, {}, None,
                            traceback.format_exc()))
        else:
            jobs.append(job)
            key = _digest(stats, mats)
            if key in answers:
                answers[key][2] += 1
            else:
                answers[key] = [stats, mats, 1]
            del stats, mats
        if tracing_now:
            after = tracing.launch_counts()
            launches.append({n: after[n] - before[n] for n in after})
            if len(launches) == TRACE_JOBS:
                prof.__exit__(None, None, None)
        done_tracing = prof is None or len(launches) >= TRACE_JOBS
        if time.perf_counter() - t0 >= seconds and done_tracing:
            break
    window_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
            else 0)

    # ---- the check, once the program's state is freed
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref, ref_mats = reference.answer(
        samples, k, int(opts["abundance_min"]), int(opts["abundance_max"]),
        simple, complex_, device)
    reference_s = time.perf_counter() - t_ref
    failed = [j for j in jobs if j.error is not None or j.route != "in-memory"]
    checks = {"failed_jobs": len(failed), "stat_mismatch": 0,
              "matrix_gap": 0.0}
    for stats, mats, _ in answers.values():
        got = reference.compare(stats, mats, ref, ref_mats, simple, complex_)
        for name, v in got.items():
            checks[name] = max(checks[name], v)
    correct = bool(jobs) and all(checks[n] <= limits[n] for n in checks)
    for j in failed[:1]:
        print(j.error or f"a job took the route {j.route!r}", file=sys.stderr)

    # ---- metrics
    traced = None
    if prof is not None:
        traced = tracing.from_profile(prof, launches)
    shapes = {**ref["shapes"], **_batch_shapes(runner.sources, k),
              "k": k, "simple": simple, "complex": complex_}
    ctx = Context(setup_s, parse_s, jobs, window_s, peak, traced,
                  jobs[:len(launches)], shapes)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in registry.metrics_of(bench, cell_name, kind):
        value = registry.reader(m["name"], bench_dir)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": len(jobs),
              "failed": len(failed), "metrics": metrics, "device": dev}
    if traced is not None:
        dev["busy_s"] = traced.busy_s()
        dev["window_s"] = traced.window_s()
        result["breakdown"] = traced.breakdown()
    print(f"answers: {len(answers)} distinct of "
          f"{sum(a[2] for a in answers.values())} jobs; the reference took "
          f"{reference_s:.3f} s", file=sys.stderr)
    result["checks"] = {n: {"value": v, "limit": limits[n]}
                        for n, v in checks.items()}
    loaded = forbidden_modules(sys.modules)
    if loaded:
        raise ForbiddenModules(loaded)
    return result


class ForbiddenModules(RuntimeError):
    """The run loaded JAX or the JAX package."""

    def __init__(self, names):
        super().__init__("loaded: " + ", ".join(names))
        self.names = names
