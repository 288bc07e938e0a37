"""``simka_metrics.json`` on every route of the port, on the CPU: the
keys it holds, against a stored list, for the in-memory run, the
out-of-core routes (up front on each host-side tier and from the
estimate, and the mid-ingest restart), the -out-tmp route (counted,
resumed, and with the sweep) and -coordinator (one process, without
torch.distributed)."""

import json
import os

import pytest

from simka_tpu_torch.config import SimkaConfig
from simka_tpu_torch.core import budget, pipeline
from simka_tpu_torch.parallel import multihost
from simka_tpu_torch.utils.community import write_community

# every run's counters
RUN = {"device", "n_datasets", "n_shards", "nb_distinct_kmers", "reads"}
# run_simka's, on every route
SIMKA = RUN | {"kmer_size", "repartition_histogram"}
IN_MEMORY = SIMKA | {
    "route", "stage_parse_pack_s", "stage_h2d_s", "stage_extract_dispatch_s",
    "stage_join_s", "stage_h2d_wait_s", "stage_join_wait_s",
    "stage_kl_host_s"}
OUT_OF_CORE = SIMKA | {
    "route", "per_sample", "spectrum_rows", "spill_tier", "sweep_ranges",
    "stage_spectrum_s", "stage_spill_s", "stage_parse_pack_s", "stage_h2d_s",
    "stage_extract_dispatch_s", "stage_count_s", "stage_range_load_s",
    "stage_range_join_s"}
OUT_TMP = SIMKA | {"per_sample", "kmer_instances", "memory_budget_bytes",
                   "spectrum_rows"}
SWEEP = {"sweep_ranges", "sweep_range_load_s", "sweep_range_join_s",
         "sweep_partition_s", "sweep_write_s"}
COUNTED = {"id", "resumed", "rows", "load_s", "count_s", "save_s"}
# route: (stages, counters, each sample's keys in per_sample or None)
KEYS = {
    "in-memory": ({"count", "output"}, IN_MEMORY, None),
    "up-front-device": ({"count", "output"}, OUT_OF_CORE,
                        {"id", "rows", "spectrum_s"}),
    "up-front-ram": ({"count", "output"}, OUT_OF_CORE,
                     {"id", "rows", "spectrum_s", "spill_s"}),
    "up-front-estimate": ({"count", "output"}, OUT_OF_CORE,
                          {"id", "rows", "spectrum_s", "spill_s"}),
    "restart": ({"count", "output"}, OUT_OF_CORE,
                {"id", "rows", "spectrum_s"}),
    "out-tmp": ({"count", "merge", "output"}, OUT_TMP, COUNTED),
    "out-tmp-resume": ({"count", "merge", "output"},
                       OUT_TMP | {"datasets_resumed"},
                       {"id", "resumed", "rows", "load_s"}),
    "out-tmp-sweep": ({"count", "merge", "output"}, OUT_TMP | SWEEP,
                      COUNTED | {"spill_s"}),
    "coordinator": ({"count", "merge"},
                    RUN | {"n_processes", "shards_per_process",
                           "compact_launches"}, None),
}


@pytest.fixture(scope="module")
def community(tmp_path_factory):
    root = tmp_path_factory.mktemp("run_metrics")
    return write_community(str(root / "c"), seed=11, n_samples=3,
                           n_genomes=4, genome_len=3000,
                           reads_per_sample=400, n_frac=0.005,
                           fastq_samples=1)


def _metrics(community, out, run=pipeline.run_simka, **kw):
    config = {"input_filename": community, "output_dir": str(out),
              "simple_dist": True, "complex_dist": True, "verbose": False}
    config.update(kw.pop("config", {}))
    run(SimkaConfig(**config), "cpu", **kw)
    with open(os.path.join(str(out), "simka_metrics.json")) as f:
        return json.load(f)


def _run(route, community, tmp_path, monkeypatch):
    tmp = {"output_tmp_dir": str(tmp_path / "tmp")}
    if route == "in-memory":
        return _metrics(community, tmp_path / "out")
    if route in ("up-front-device", "up-front-ram"):
        return _metrics(community, tmp_path / "out",
                        tier=route.split("-")[-1])
    if route == "coordinator":
        return _metrics(community, tmp_path / "out",
                        run=multihost.run_simka_multihost)
    if route.startswith("out-tmp"):
        if route == "out-tmp-resume":
            _metrics(community, tmp_path / "first",
                     config={**tmp, "keep_tmp": True})
        if route == "out-tmp-sweep":
            tmp["sweep_ranges"] = 3
        return _metrics(community, tmp_path / "out", config=tmp)
    monkeypatch.setenv("SIMKA_TPU_HBM_MB", "0.05")
    if route == "restart":  # an estimate under the plan: in memory first
        monkeypatch.setattr(budget, "estimate_total_instances",
                            lambda *args: 0)
    return _metrics(community, tmp_path / "out")


@pytest.mark.parametrize("route", list(KEYS))
def test_metrics_keys_of_every_route(route, community, tmp_path,
                                     monkeypatch):
    m = _run(route, community, tmp_path, monkeypatch)
    stages, counters, sample = KEYS[route]
    assert set(m) == {"total_seconds", "stages", "counters"}
    assert set(m["stages"]) == stages
    assert set(m["counters"]) == counters
    if sample is not None:
        assert len(m["counters"]["per_sample"]) == 3
        for s in m["counters"]["per_sample"]:
            assert set(s) == sample
    if "route" in counters:
        want = "up-front" if route.startswith("up-front") else route
        assert m["counters"]["route"] == want
    assert 0 < sum(m["stages"].values()) <= m["total_seconds"] + 0.002
