"""The result's line, the module check and the refusal without a card."""

import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

import pytest
import torch

from benchmark import harness, registry, run
from benchmark.tests import toy

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_holds_exactly_the_contracts_keys(trace, tmp_path):
    bench = toy.bench()
    r = harness.run_cell("toy.default_dist", 3, 0.2, trace,
                         torch.device("cpu"), t_start=0.0, bench=bench,
                         bench_dir=toy.bench_dir(tmp_path))
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        run.emit(r)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert set(line) == KEYS | ({"breakdown"} if trace else set())
    assert list(line)[-1] == "checks"
    dev_keys = {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(line["device"]) == dev_keys | (
        {"busy_s", "window_s"} if trace else set())
    kind = "per_layer" if trace else "end_to_end"
    named = {m["name"] for m in bench[kind]}
    assert set(line["metrics"]) <= named
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:  # the CPU has no peak to read; a percentile needs two jobs
        want = {"job_s", "setup_s"} | (
            {"job_p90_s"} if line["attempted"] >= 2 else set())
        assert set(line["metrics"]) == want
    # the checks, each beside its limit, are the last lines of stderr
    tail = err.getvalue().strip().splitlines()[-len(line["checks"]):]
    for name, text in zip(line["checks"], tail):
        assert text.startswith(f"check {name} ") and " limit " in text


def test_a_number_that_is_not_finite_stays_json():
    r = {"correct": False, "checks": {"matrix_gap": {
        "value": float("inf"), "limit": 1e-10}}}
    out = io.StringIO()
    with redirect_stdout(out), redirect_stderr(io.StringIO()):
        run.emit(r)
    assert json.loads(out.getvalue())["checks"]["matrix_gap"]["value"] == "inf"


def test_module_check_compares_whole_top_level_names():
    assert harness.forbidden_modules(
        ["simka_tpu_torch", "simka_tpu_torch.x", "jaxtyping", "numpy",
         "flaxen.y"]) == []
    assert harness.forbidden_modules(
        ["simka_tpu.x", "jax.y", "simka_tpu", "jaxlib", "flax.core"]) == [
        "flax.core", "jax.y", "jaxlib", "simka_tpu", "simka_tpu.x"]


def test_the_harness_loads_neither_jax_nor_the_jax_package():
    code = ("import sys, benchmark.run, benchmark.harness, benchmark.control;"
            "from benchmark import harness;"
            "import simka_tpu_torch.core.pipeline;"
            "print(harness.forbidden_modules(sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=registry.ROOT,
                         capture_output=True, text=True, check=True).stdout
    assert out.strip() == "[]"


def test_the_command_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    cmd = registry.spec()["command"] + [
        "--workload", "cami_high.default_dist", "--seed", str(2**33 + 1),
        "--seconds", "1", "--trace", "0"]
    p = subprocess.run(cmd, cwd=registry.ROOT, capture_output=True,
                       text=True, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_a_run_that_loaded_the_jax_package_prints_no_result(monkeypatch,
                                                            tmp_path):
    monkeypatch.setitem(sys.modules, "simka_tpu.planted", object())
    with pytest.raises(harness.ForbiddenModules):
        harness.run_cell("toy.default_dist", 4, 0.1, False,
                         torch.device("cpu"), t_start=0.0, bench=toy.bench(),
                         bench_dir=toy.bench_dir(tmp_path))
