"""simka_tpu_torch.profiling.trace: the device busy time is the union
of the device events' intervals, host ops are left out, and the trace
needs a GPU. On the card the module runs as ``python -m
simka_tpu_torch.profiling.trace``."""

from types import SimpleNamespace

import pytest
import torch

from simka_tpu_torch.profiling import trace

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def _event(start, end, name, device_type=CUDA):
    return SimpleNamespace(time_range=SimpleNamespace(start=start, end=end),
                           name=name, device_type=device_type)


@pytest.mark.parametrize("intervals,want", [
    ([], 0.0),
    ([(0, 10)], 10.0),
    ([(0, 10), (20, 25)], 15.0),
    ([(0, 10), (5, 12)], 12.0),  # overlapping
    ([(5, 12), (0, 10), (1, 2)], 12.0),  # unsorted, nested
    ([(0, 10), (10, 20)], 20.0),  # touching
])
def test_union_us(intervals, want):
    assert trace.union_us([(s, e, "k") for s, e in intervals]) == want


def test_device_intervals_leave_out_host_ops():
    """An aten op and the kernel it launched span the same time; only
    the kernel counts, so its time is not counted twice."""
    events = [_event(0, 100, "aten::index_add_", CPU),
              _event(10, 60, "indexFuncLargeIndex"),
              _event(60, 70, "Memcpy HtoD")]
    got = trace.device_intervals(events)
    assert [n for _, _, n in got] == ["indexFuncLargeIndex", "Memcpy HtoD"]
    assert trace.union_us(got) == 60.0
    assert trace.top_events(got, n=1) == [(50.0, 1, "indexFuncLargeIndex")]


def test_trace_without_gpu_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        trace.main(["-in", str(tmp_path / "in.txt"), "-out", str(tmp_path)])
