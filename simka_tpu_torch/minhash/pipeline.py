"""SimkaMin commands of the port, as ``simka_tpu.minhash.pipeline``'s:
simkaMinCore's `sketch`, `distance`, `export`, `append`, `info` and
`matrix-update` (src/simkaMin/SimkaMin.cpp:87-107), and the flows of
the scripts simkaMin.py (`run_simka_min`: sketch, distance, export) and
simkaMin_update.py (`run_simka_min_update`).

The distance runs on the device it is given: the kernel of
``csrc/min_distance.cu`` on the card, its plain torch version on the
CPU (``minhash/device_distance.py``). `run_simka_min` keeps the batched
route's prefixes on the device and computes the matrices from them
while a thread writes sketch.bin (the resident route), or computes them
from the sketch file in the reference's 100-sample tiles.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from simka_tpu_torch.core.output import dump_matrix_csv_gz
from simka_tpu_torch.io.dsl import check_input_validity, parse_input_file
from simka_tpu_torch.minhash.distance import (
    MATRIX_NAMES,
    BinaryMatrix,
    merge_matrices,
)
from simka_tpu_torch.minhash.sketch_file import SketchFile


def _make_source(ds, min_read_size: int, min_read_shannon_index: float,
                 max_reads: int, device: torch.device):
    from simka_tpu_torch.io.packed import PackedReadSource

    return PackedReadSource(ds.banks, min_read_size, min_read_shannon_index,
                            max_reads=max_reads, encoding="gatb",
                            pin=device.type == "cuda")


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
    observer: Optional[dict] = None,
    batched: bool = True,
) -> Dict:
    """`simkaMinCore sketch`: one bottom-s sketch per dataset, written
    to ``output_path`` (the reference's sketch file).

    SimkaMin's -max-reads default is 0 = every read
    (SimkaMinCount.hpp:1402). ``bloom_bits``: the opt-in Bloom -filter
    emulation (``minhash/bloom.py``), which implies -filter. Two or more
    samples take the batched route unless ``bloom_bits`` is set; it
    leaves for the per-sample route past ``instance_limit`` or on
    underfill (``minhash/sketch.py``); ``stream_threshold`` sets where a
    per-sample sketch streams. ``batched=False`` goes straight to the
    per-sample route (``run_simka_min`` after the batched route left).

    Returns the run's metrics (``observer``, when given, receives
    them): ``sketch_route`` ("batched" or
    "per-sample") and ``sketch_route_reason``, ``sample_routes`` (per
    sample on the per-sample route: "one-shot", "streaming" or "bloom"),
    ``filter_cuts`` (-filter's cuts on the streaming route),
    ``prefilter_fraction``, ``instances`` and
    ``kept_instances`` (valid and kept windows hashed, a bail's
    included), and the stage times ``sketch.STAGES`` (parse_pack_s,
    h2d_s, hash_s, prefix_s, fetch_s, write_s; the Bloom replay's
    samples add only to write_s).
    """
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
    obs = _observer(observer)
    sf = SketchFile.create(
        output_path, kmer_size, sketch_size, seed, len(datasets)
    )

    def make_source(ds):
        return _make_source(ds, min_read_size, min_read_shannon_index,
                            max_reads, dev)

    def write(i, ds, hashes, counts):
        t0 = time.perf_counter()
        sf.write_slot(i, hashes, counts)
        obs["write_s"] += time.perf_counter() - t0
        if verbose:
            print(f"[simka-tpu min] sketched {ds.id}: "
                  f"{len(hashes)} sketch k-mers")

    if batched and bloom_bits is None and len(datasets) >= 2:
        sketches = compute_sketches_batched(
            [make_source(ds) for ds in datasets], kmer_size, sketch_size,
            seed, use_filter, device=dev, instance_limit=instance_limit,
            observer=obs)
        if sketches is not None:
            obs["sketch_route"] = "batched"
            for i, (ds, (hashes, counts)) in enumerate(zip(datasets,
                                                           sketches)):
                write(i, ds, hashes, counts)
            sf.write_ids([d.id for d in datasets])
            return obs
    elif batched:
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


def _load_sketch_block(sf: SketchFile, start: int, n: int):
    return [sf.read_slot(start + i) for i in range(n)]


def _write_blocks(dist_dir: str, n1: int, n2: int, i0: int, j0: int,
                  jac: np.ndarray, bc: np.ndarray, mirror: bool) -> None:
    os.makedirs(dist_dir, exist_ok=True)
    for name, block in zip(MATRIX_NAMES, (jac, bc)):
        mat = BinaryMatrix(os.path.join(dist_dir, name + ".bin"), n1, n2)
        mat.write_block(i0, j0, block)
        if mirror:
            mat.write_block(j0, i0, block.T)


def distance_command(
    in1: str,
    in2: str,
    output_dir: str,
    start_i: int = 0,
    start_j: int = 0,
    n_i: int = 0,
    n_j: int = 0,
    device="cuda",
) -> None:
    """`simkaMinCore distance`: fill the block [start_i, + n_i) x
    [start_j, + n_j) of the binary matrices in ``output_dir`` on
    ``device`` (0 for n: every sample).

    Symmetric (reference SimkaMinDistance.hpp:619-753) when both inputs
    are the same file and start_i == start_j: the upper triangle,
    mirrored, zero diagonal. An off-diagonal tile of one file is
    written mirrored too.
    """
    from simka_tpu_torch.minhash.device_distance import (
        compute_distance_block_device,
    )

    sf1, sf2 = SketchFile(in1), SketchFile(in2)
    h1, h2 = sf1.header(), sf2.header()
    if h1.kmer_size != h2.kmer_size or h1.seed != h2.seed:
        # the reference enforces k and seed equality
        # (SimkaMinDistance.hpp:990-998)
        raise ValueError("sketch files differ in kmer-size or seed")
    n_i = n_i or h1.nb_datasets
    n_j = n_j or h2.nb_datasets
    same = os.path.abspath(in1) == os.path.abspath(in2)
    symmetric = same and start_i == start_j
    s1 = _load_sketch_block(sf1, start_i, n_i)
    s2 = s1 if symmetric else _load_sketch_block(sf2, start_j, n_j)
    jac, bc = compute_distance_block_device(s1, s2, symmetric, device)
    _write_blocks(output_dir, h1.nb_datasets, h2.nb_datasets, start_i,
                  start_j, jac, bc, mirror=same and not symmetric)


def export_command(
    distance_dir: str,
    in1: str,
    in2: str,
    output_dir: str,
) -> List[str]:
    """`simkaMinCore export`: binary matrices -> csv.gz with ids
    (reference SimkaMinDistanceMatrixExporterAlgorithm,
    SimkaMinDistanceMatrixExporter.hpp:233-446)."""
    ids1 = SketchFile(in1).ids()
    ids2 = SketchFile(in2).ids()
    os.makedirs(output_dir, exist_ok=True)
    out = []
    for fname in sorted(os.listdir(distance_dir)):
        if not (fname.startswith("mat_") and fname.endswith(".bin")):
            continue
        name = fname[: -len(".bin")]
        mat = np.fromfile(
            os.path.join(distance_dir, fname), dtype=np.float32
        ).reshape(len(ids1), len(ids2))
        out.append(dump_matrix_csv_gz(output_dir, name, mat, ids1))
    return out


def matrix_update_command(
    existing_dir: str, existing_vs_new_dir: str, new_vs_new_dir: str,
    n_old: int, n_new: int,
) -> None:
    """`simkaMinCore matrix-update` (hidden subcommand): grow every
    binary matrix in ``existing_dir`` in place (reference
    SimkaDistanceMatrixBinary::mergeMatrices)."""
    for name in MATRIX_NAMES:
        fn = name + ".bin"
        existing = np.fromfile(
            os.path.join(existing_dir, fn), dtype=np.float32
        ).reshape(n_old, n_old)
        evn = np.fromfile(
            os.path.join(existing_vs_new_dir, fn), dtype=np.float32
        ).reshape(n_old, n_new)
        nvn = np.fromfile(
            os.path.join(new_vs_new_dir, fn), dtype=np.float32
        ).reshape(n_new, n_new)
        merged = merge_matrices(existing, evn, nvn)
        merged.tofile(os.path.join(existing_dir, fn))


def _resident_bytes(bundle: dict) -> int:
    """Device bytes of the resident distance: the prefixes' hash and
    count streams and the corrected counts (16 B a row), and per pair
    its two indices and four tallies (40 B)."""
    n = bundle["n"]
    return bundle["hashes"].shape[0] * 16 + n * (n - 1) // 2 * 40


def _write_bundle(bundle: dict, datasets, sf: SketchFile, verbose: bool,
                  obs: dict) -> None:
    """The batched route's prefixes to the host, into the sketch file
    ``sf`` (``sketch_command``'s file, byte for byte)."""
    from simka_tpu_torch.minhash.sketch import fetch_batched_sketches

    t0 = time.perf_counter()
    sketches = fetch_batched_sketches(bundle)
    t1 = time.perf_counter()
    for i, (h, c) in enumerate(sketches):
        sf.write_slot(i, h, c)
        if verbose:
            print(f"[simka-tpu min] sketched {datasets[i].id}: "
                  f"{len(h)} sketch k-mers")
    sf.write_ids([d.id for d in datasets])
    obs["fetch_s"] += t1 - t0
    obs["write_s"] += time.perf_counter() - t1


def _run_min_device_resident(bundle: dict, datasets, sketch_path: str,
                             dist_dir: str, kmer_size: int,
                             sketch_size: int, seed: int, verbose: bool,
                             obs: dict) -> None:
    """The resident route: the batched route's prefixes stay on the
    device and go into the distance as they are
    (``device.assemble_sketch_grid``), while a thread fetches them and
    writes sketch.bin, the same file as the per-sample route's.

    A failed write is not swallowed: the thread is joined, the partial
    sketch.bin removed and the thread's exception raised.
    """
    from simka_tpu_torch.minhash.device import assemble_sketch_grid
    from simka_tpu_torch.minhash.device_distance import (
        distance_from_device_arrays,
    )

    n = len(datasets)
    sf = SketchFile.create(sketch_path, kmer_size, sketch_size, seed, n)
    failed: list = []

    def write_file():
        try:
            _write_bundle(bundle, datasets, sf, verbose, obs)
        except BaseException as e:  # raised on the main thread below
            failed.append(e)

    writer = threading.Thread(target=write_file, name="sketch-writer")
    writer.start()
    try:
        t0 = time.perf_counter()
        grid = assemble_sketch_grid(
            bundle["hashes"], bundle["counts"], bundle["n_kept"],
            bundle["n_before"], sketch_size=sketch_size,
            base_c=2 if bundle["use_filter"] else 1)
        jac, bc = distance_from_device_arrays(grid, grid, True)
        obs["distance_s"] += time.perf_counter() - t0
    finally:
        writer.join()
        if failed and os.path.exists(sketch_path):
            os.remove(sketch_path)
    if failed:
        raise failed[0]
    _write_blocks(dist_dir, n, n, 0, 0, jac, bc, mirror=False)


def run_simka_min(
    input_filename: str,
    output_dir: str,
    kmer_size: int = 21,
    sketch_size: int = 1_000_000,
    seed: int = 100,
    use_filter: bool = False,
    max_reads: int = 0,
    min_read_size: int = 0,
    min_read_shannon_index: float = 0.0,
    tile: int = 100,
    verbose: bool = True,
    bloom_bits: Optional[int] = None,
    device="cuda",
    instance_limit: Optional[int] = None,
    observer: Optional[dict] = None,
) -> List[str]:
    """The simkaMin.py flow: sketch, distance, export, into
    ``output_dir`` (sketch/sketch.bin, distance/mat_*.bin, the csv.gz).

    With two or more samples and no ``bloom_bits``, the batched sketch
    route runs first. When its prefixes and the pairs fit the device
    plan (``core/budget.py``) the distance reads them where they are
    (``min_route`` "resident"); otherwise sketch.bin is written from
    them and the distance reads the file in ``tile`` x ``tile`` blocks
    of `distance` (simkaMin.py:158-187; ``min_route`` "from-file"). When
    the batched route leaves (``instance_limit``, underfill) or does not
    apply, the samples are sketched per sample into sketch.bin and the
    tiles follow.

    ``observer``, when given, receives the sketch's metrics
    (``sketch_command``'s) and ``min_route``, ``distance_s`` and
    ``pair_launches`` (the kernel launches of the distance).
    """
    from simka_tpu_torch.core.budget import device_budget_bytes
    from simka_tpu_torch.minhash import device_distance
    from simka_tpu_torch.minhash.device import as_device
    from simka_tpu_torch.minhash.sketch import (
        _Bail,
        _bail,
        _batched_device_sketch,
        _batched_instance_limit,
        _observer,
    )

    dev = as_device(device)
    if not 1 <= kmer_size <= 31:
        raise ValueError(f"-kmer-size {kmer_size}: SimkaMin takes 1..31")
    obs = _observer(observer)
    obs["distance_s"] = 0.0
    launches0 = device_distance.launches
    datasets = parse_input_file(input_filename)
    check_input_validity(datasets)
    sketch_dir = os.path.join(output_dir, "sketch")
    dist_dir = os.path.join(output_dir, "distance")
    os.makedirs(sketch_dir, exist_ok=True)
    os.makedirs(dist_dir, exist_ok=True)
    sketch_path = os.path.join(sketch_dir, "sketch.bin")
    try:
        bundle = None
        tried = bloom_bits is None and len(datasets) >= 2
        if tried:
            limit = (_batched_instance_limit(dev) if instance_limit is None
                     else instance_limit)
            srcs = [_make_source(ds, min_read_size, min_read_shannon_index,
                                 max_reads, dev) for ds in datasets]
            try:
                bundle = _batched_device_sketch(
                    srcs, kmer_size, sketch_size, seed, use_filter, 1 << 15,
                    dev, limit, obs)
            except _Bail as e:
                _bail(str(e))
                obs["sketch_route_reason"] = str(e)
        if bundle is not None:
            obs["sketch_route"] = "batched"
            if _resident_bytes(bundle) <= device_budget_bytes(dev):
                obs["min_route"] = "resident"
                _run_min_device_resident(bundle, datasets, sketch_path,
                                         dist_dir, kmer_size, sketch_size,
                                         seed, verbose, obs)
                return export_command(dist_dir, sketch_path, sketch_path,
                                      output_dir)
            _write_bundle(bundle, datasets,
                          SketchFile.create(sketch_path, kmer_size,
                                            sketch_size, seed, len(datasets)),
                          verbose, obs)
            del bundle
        else:
            sketch_command(
                input_filename, sketch_path, kmer_size, sketch_size, seed,
                use_filter, max_reads, min_read_size, min_read_shannon_index,
                verbose=verbose, bloom_bits=bloom_bits, device=dev,
                observer=obs, batched=not tried)
        obs["min_route"] = "from-file"
        n = len(datasets)
        steps = -(-n // tile)
        t0 = time.perf_counter()
        for bi in range(steps):
            ni = min(tile, n - bi * tile)
            for bj in range(bi, steps):
                nj = min(tile, n - bj * tile)
                distance_command(sketch_path, sketch_path, dist_dir,
                                 start_i=bi * tile, start_j=bj * tile,
                                 n_i=ni, n_j=nj, device=dev)
        obs["distance_s"] += time.perf_counter() - t0
    finally:
        obs["pair_launches"] = device_distance.launches - launches0
    return export_command(dist_dir, sketch_path, sketch_path, output_dir)


def run_simka_min_update(
    existing_output_dir: str,
    new_input_filename: str,
    use_filter: bool = False,
    max_reads: int = 0,
    min_read_size: int = 0,
    min_read_shannon_index: float = 0.0,
    verbose: bool = True,
    bloom_bits: Optional[int] = None,
    device="cuda",
    observer: Optional[dict] = None,
) -> List[str]:
    """The simkaMin_update.py flow: sketch the new datasets with the
    existing header's (k, s, seed), distance existing-vs-new and
    new-vs-new on ``device``, matrix-update, append, export again.

    The filter and read options apply to the new datasets' sketch, as
    the reference's update script forwards them (simkaMin_update.py:
    119-130); the sketch header does not record them, so keeping them
    equal to the first run's is the caller's part. ``observer`` receives
    the new sketch's metrics.
    """
    import shutil

    sketch_path = os.path.join(existing_output_dir, "sketch", "sketch.bin")
    dist_dir = os.path.join(existing_output_dir, "distance")
    h = SketchFile(sketch_path).header()
    n_old = h.nb_datasets
    new_sketch = sketch_path + ".new"
    sketch_command(
        new_input_filename, new_sketch, h.kmer_size, h.sketch_size, h.seed,
        use_filter, max_reads, min_read_size, min_read_shannon_index,
        verbose=verbose, bloom_bits=bloom_bits, device=device,
        observer=observer)
    n_new = SketchFile(new_sketch).header().nb_datasets
    evn_dir = os.path.join(dist_dir, "existingVsNew")
    nvn_dir = os.path.join(dist_dir, "newVsNew")
    os.makedirs(evn_dir, exist_ok=True)
    os.makedirs(nvn_dir, exist_ok=True)
    distance_command(sketch_path, new_sketch, evn_dir, device=device)
    distance_command(new_sketch, new_sketch, nvn_dir, device=device)
    matrix_update_command(dist_dir, evn_dir, nvn_dir, n_old, n_new)
    SketchFile(sketch_path).append(SketchFile(new_sketch))
    os.remove(new_sketch)
    shutil.rmtree(evn_dir)
    shutil.rmtree(nvn_dir)
    return export_command(dist_dir, sketch_path, sketch_path,
                          existing_output_dir)
