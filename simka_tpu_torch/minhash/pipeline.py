"""SimkaMin commands of the port: `sketch`, `append` and `info`
(``simka_tpu.minhash.pipeline``'s ``sketch_command``,
``append_command`` and ``info_command``; simkaMinCore's subcommands,
src/simkaMin/SimkaMin.cpp:87-107).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from simka_tpu_torch.io.dsl import check_input_validity, parse_input_file
from simka_tpu_torch.minhash.sketch_file import SketchFile


def sketch_command(
    input_filename: str,
    output_path: str,
    kmer_size: int = 21,
    sketch_size: int = 100_000,
    seed: int = 100,
    use_filter: bool = False,
    max_reads: int = 0,
    min_read_size: int = 0,
    min_read_shannon_index: float = 0.0,
    verbose: bool = True,
    bloom_bits: Optional[int] = None,
    device="cuda",
    instance_limit: Optional[int] = None,
    stream_threshold: Optional[int] = None,
) -> Dict:
    """`simkaMinCore sketch`: one bottom-s sketch per dataset, written
    to ``output_path`` (the reference's sketch file).

    SimkaMin's -max-reads default is 0 = every read
    (SimkaMinCount.hpp:1402). ``bloom_bits``: the opt-in Bloom -filter
    emulation (``minhash/bloom.py``), which implies -filter. Two or more
    samples take the batched route unless ``bloom_bits`` is set; it
    leaves for the per-sample route past ``instance_limit`` or on
    underfill (``minhash/sketch.py``); ``stream_threshold`` sets where a
    per-sample sketch streams.

    Returns the run's metrics: ``sketch_route`` ("batched" or
    "per-sample") and ``sketch_route_reason``, ``sample_routes`` (per
    sample on the per-sample route: "one-shot", "streaming" or "bloom"),
    ``filter_cuts`` (-filter's cuts on the streaming route),
    ``prefilter_fraction``, ``instances`` and
    ``kept_instances`` (valid and kept windows hashed, a bail's
    included), and the stage times ``sketch.STAGES`` (parse_pack_s,
    h2d_s, hash_s, prefix_s, fetch_s, write_s; the Bloom replay's
    samples add only to write_s).
    """
    from simka_tpu_torch.io.packed import PackedReadSource
    from simka_tpu_torch.minhash.device import as_device
    from simka_tpu_torch.minhash.sketch import (
        _observer,
        compute_sketch,
        compute_sketches_batched,
    )

    dev = as_device(device)
    if not 1 <= kmer_size <= 31:
        raise ValueError(f"-kmer-size {kmer_size}: SimkaMin takes 1..31")
    datasets = parse_input_file(input_filename)
    check_input_validity(datasets)
    obs = _observer(None)
    sf = SketchFile.create(
        output_path, kmer_size, sketch_size, seed, len(datasets)
    )

    def make_source(ds):
        return PackedReadSource(
            ds.banks,
            min_read_size,
            min_read_shannon_index,
            max_reads=max_reads,
            encoding="gatb",
        )

    def write(i, ds, hashes, counts):
        t0 = time.perf_counter()
        sf.write_slot(i, hashes, counts)
        obs["write_s"] += time.perf_counter() - t0
        if verbose:
            print(f"[simka-tpu min] sketched {ds.id}: "
                  f"{len(hashes)} sketch k-mers")

    if bloom_bits is None and len(datasets) >= 2:
        batched = compute_sketches_batched(
            [make_source(ds) for ds in datasets], kmer_size, sketch_size,
            seed, use_filter, device=dev, instance_limit=instance_limit,
            observer=obs)
        if batched is not None:
            obs["sketch_route"] = "batched"
            for i, (ds, (hashes, counts)) in enumerate(zip(datasets,
                                                           batched)):
                write(i, ds, hashes, counts)
            sf.write_ids([d.id for d in datasets])
            return obs
    else:
        obs["sketch_route_reason"] = ("-filter-bloom" if bloom_bits
                                      is not None else "one sample")
    obs["sketch_route"] = "per-sample"
    for i, ds in enumerate(datasets):
        source = make_source(ds)
        if bloom_bits is not None:
            from simka_tpu_torch.minhash.bloom import compute_sketch_bloom

            obs["sample_routes"].append("bloom")
            hashes, counts = compute_sketch_bloom(
                source, kmer_size, sketch_size, seed, bloom_bits,
                device=dev)
        else:
            hashes, counts = compute_sketch(
                source, kmer_size, sketch_size, seed, use_filter,
                device=dev, stream_threshold=stream_threshold,
                observer=obs)
        write(i, ds, hashes, counts)
    sf.write_ids([d.id for d in datasets])
    return obs


def append_command(in1: str, in2: str) -> None:
    """`simkaMinCore append`: merge sketch file 2 into file 1."""
    SketchFile(in1).append(SketchFile(in2))


def info_command(path: str) -> str:
    return SketchFile(path).info()
