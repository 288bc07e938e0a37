"""The harness finds each configuration, traffic mix, limit and metric
by name, also one added as a file alone, and BENCHMARK.json names only
parts that exist."""

import json
import os

import pytest

from benchmark import registry


def test_finds_the_benchmarks_own_parts_by_name():
    bench = registry.spec()
    for w in bench["workloads"]:
        cfg = registry.config(w["config"])
        assert cfg["name"] == w["config"]
        assert registry.traffic(w["traffic"])["name"] == w["traffic"]
        assert registry.limits(w["name"])["stat_mismatch"] == 0
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(registry.reader(m["name"]))


def test_benchmark_json_points_at_its_files():
    bench = registry.spec()
    names = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        cfg = registry.config(c["name"])
        assert set(c["reduced"]) <= set(cfg["community"]) | set(
            cfg["options"])
        assert set(c["reduced"]) == set(cfg["reduced"])
    assert {w["config"] for w in bench["workloads"]} == names
    e2e = {m["name"] for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells


def test_a_part_added_as_a_file_alone_is_found(tmp_path):
    d = tmp_path / "bench"
    for sub in ("configs", "traffic", "metrics", "limits"):
        (d / sub).mkdir(parents=True)
    (d / "configs" / "new_cfg.json").write_text(json.dumps({"name": "x"}))
    (d / "traffic" / "new_mix.json").write_text(
        json.dumps({"options": {"kmer_size": 15}}))
    (d / "metrics" / "new_metric.py").write_text(
        "def read(ctx):\n    return 2 * ctx\n")
    (d / "limits" / "default.json").write_text(
        json.dumps({"matrix_gap": 1e-10, "stat_mismatch": 0}))
    (d / "limits" / "new.cell.json").write_text(
        json.dumps({"matrix_gap": 1e-9}))
    assert registry.config("new_cfg", str(d)) == {"name": "x"}
    assert registry.traffic("new_mix", str(d))["options"]["kmer_size"] == 15
    assert registry.reader("new_metric", str(d))(21) == 42
    assert registry.limits("new.cell", str(d)) == {"matrix_gap": 1e-9,
                                                   "stat_mismatch": 0}
    assert registry.limits("other.cell", str(d))["matrix_gap"] == 1e-10


def test_metrics_of_a_cell_follow_their_workloads_lists():
    bench = {"per_layer": [{"name": "a"}, {"name": "b", "workloads": ["x"]},
                           {"name": "c", "workloads": ["y"]}]}
    assert [m["name"] for m in registry.metrics_of(bench, "x",
                                                   "per_layer")] == ["a", "b"]


@pytest.mark.parametrize("name", ["../etc", "a/b", "", " x", "a" * 65])
def test_names_outside_the_rule_are_refused(name):
    with pytest.raises(ValueError):
        registry.config(name)


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        registry.cell(registry.spec(), "no.such_cell")


def test_every_metric_file_is_named_in_benchmark_json():
    bench = registry.spec()
    named = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]}
    files = {f[:-3] for f in os.listdir(os.path.join(registry.BENCH_DIR,
                                                     "metrics"))
             if f.endswith(".py")}
    assert files == named
