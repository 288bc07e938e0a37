"""On the card (``cuda``-marked; each test decides whether there is a
card): a toy cell's whole run reads correct, and the control does not."""

import pytest
import torch

from benchmark import control, harness
from benchmark.tests import toy


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", toy.CELLS)
def test_a_toy_cell_runs_correct_on_the_card(cell, trace, tmp_path):
    dev = card()
    r = harness.run_cell(cell, 2**31 + 21, 0.5, trace, dev, t_start=0.0,
                         bench=toy.bench(), bench_dir=toy.bench_dir(tmp_path))
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert r["device"]["memory_peak_bytes"] > 0
    if trace:
        assert r["device"]["busy_s"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", toy.CELLS)
def test_the_control_reads_not_correct_on_the_card(cell, tmp_path):
    dev = card()
    d = toy.bench_dir(tmp_path)
    limit = harness.registry.limits(cell, d)["matrix_gap"]
    for seed in (31, 32, 33):
        r = control.readings(cell, seed, dev, True, toy.bench(), d)
        assert r["control"]["matrix_gap"] > limit
        assert r["program"]["matrix_gap"] <= limit
