"""`simka-tpu-torch min` subcommands, mirroring ``simka_tpu.minhash.cli``
(simkaMinCore, src/simkaMin/SimkaMin.cpp:87-107, with simkaMin.py's
`pipeline` and simkaMin_update.py's `update`), plus ``-device`` on the
subcommands that compute: `sketch`, `distance`, `pipeline` and `update`.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

def _device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("-device", choices=("cuda", "cpu"), default="cuda",
                   help="device to run on (default cuda)")


def build_min_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="simka-tpu-torch min")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("sketch", help="transform datasets into sketches")
    p.add_argument("-in", dest="input", required=True)
    p.add_argument("-out", dest="out", required=True)
    p.add_argument("-kmer-size", type=int, default=21)
    p.add_argument("-nb-kmers", type=int, default=100000)
    p.add_argument("-seed", type=int, default=100)
    p.add_argument("-filter", action="store_true")
    p.add_argument(
        "-filter-bloom",
        action="store_true",
        help="emulate the reference's approximate Bloom -filter "
        "mechanism (sized from -max-memory/-nb-cores) instead of the "
        "default exact >=2 semantics; implies -filter",
    )
    p.add_argument("-max-reads", type=int, default=0)
    p.add_argument("-min-read-size", type=int, default=0)
    p.add_argument("-min-shannon-index", type=float, default=0.0)
    p.add_argument("-nb-cores", type=int, default=0)
    p.add_argument("-max-memory", type=int, default=8000)
    _device_arg(p)

    p = sub.add_parser("distance", help="compute distances between sketches")
    p.add_argument("-in1", required=True)
    p.add_argument("-in2", required=True)
    p.add_argument("-out", dest="out", required=True)
    p.add_argument("-start-i", type=int, default=0)
    p.add_argument("-start-j", type=int, default=0)
    p.add_argument("-n-i", type=int, default=0)
    p.add_argument("-n-j", type=int, default=0)
    p.add_argument("-nb-cores", type=int, default=0)
    _device_arg(p)

    p = sub.add_parser("export", help="binary matrices -> csv.gz")
    p.add_argument("-in", dest="input", required=True)
    p.add_argument("-in1", required=True)
    p.add_argument("-in2", required=True)
    p.add_argument("-out", dest="out", required=True)
    p.add_argument("-nb-cores", type=int, default=0)

    p = sub.add_parser("append", help="append sketch file 2 to file 1")
    p.add_argument("-in1", required=True)
    p.add_argument("-in2", required=True)

    p = sub.add_parser("info", help="print sketch file info")
    p.add_argument("-in", dest="input", required=True)

    p = sub.add_parser("pipeline",
                       help="sketch + distance + export (simkaMin.py flow)")
    p.add_argument("-in", dest="input", required=True)
    p.add_argument("-out", dest="out", required=True)
    p.add_argument("-kmer-size", type=int, default=21)
    p.add_argument("-nb-kmers", type=int, default=1000000)
    p.add_argument("-seed", type=int, default=100)
    p.add_argument("-filter", action="store_true")
    p.add_argument("-filter-bloom", action="store_true")
    p.add_argument("-max-reads", type=int, default=0)
    p.add_argument("-min-read-size", type=int, default=0)
    p.add_argument("-min-shannon-index", type=float, default=0.0)
    p.add_argument("-nb-cores", type=int, default=0)
    p.add_argument("-max-memory", type=int, default=8000)
    _device_arg(p)

    p = sub.add_parser("update", help="add new datasets to an existing run")
    p.add_argument("-in", dest="input", required=True)
    p.add_argument("-out", dest="out", required=True,
                   help="existing pipeline output dir")
    p.add_argument("-filter", action="store_true")
    p.add_argument("-filter-bloom", action="store_true")
    p.add_argument("-max-reads", type=int, default=0)
    p.add_argument("-min-read-size", type=int, default=0)
    p.add_argument("-min-shannon-index", type=float, default=0.0)
    p.add_argument("-nb-cores", type=int, default=0)
    p.add_argument("-max-memory", type=int, default=8000)
    _device_arg(p)

    p = sub.add_parser("matrix-update", help="grow binary matrices in place")
    p.add_argument("-in", dest="input", required=True,
                   help="existing distance dir")
    p.add_argument("-in-evn", required=True, help="existingVsNew distance dir")
    p.add_argument("-in-nvn", required=True, help="newVsNew distance dir")
    p.add_argument("-n-old", type=int, required=True)
    p.add_argument("-n-new", type=int, required=True)
    return parser


def min_main(argv, observer: Optional[dict] = None) -> int:
    """Run one `min` subcommand; ``observer``, when given, receives the
    metrics of a `sketch`, `pipeline` or `update` run
    (``pipeline.sketch_command``, ``run_simka_min``,
    ``run_simka_min_update``)."""
    args = build_min_parser().parse_args(argv)
    from simka_tpu_torch.minhash import pipeline as mp

    bloom_bits = None
    if getattr(args, "filter_bloom", False):
        from simka_tpu_torch.minhash.bloom import bloom_bits_from_config

        bloom_bits = bloom_bits_from_config(args.max_memory, args.nb_cores)
        print(
            f"[simka-min] -filter-bloom: reference Bloom mechanism "
            f"emulation, {bloom_bits} bits, 7 hash functions "
            f"(approximate; NOT bit-compatible with reference -filter "
            f"output -- gatb-core's Bloom internals are absent from "
            f"the reference tree; see minhash/bloom.py)",
            file=sys.stderr,
            flush=True,
        )
    elif getattr(args, "filter", False):
        # the reference sizes a Bloom filter from -max-memory
        # (SimkaMinCount.hpp:1155-1161); the exact total-count >= 2
        # semantics need none. stderr keeps stdout machine-clean.
        print(
            "[simka-min] -filter: exact >=2-occurrence semantics "
            "(deterministic; reference Bloom is approximate), "
            "-max-memory not used",
            file=sys.stderr,
            flush=True,
        )

    if args.cmd == "sketch":
        mp.sketch_command(
            args.input, args.out, args.kmer_size, args.nb_kmers,
            args.seed, args.filter, args.max_reads, args.min_read_size,
            args.min_shannon_index, bloom_bits=bloom_bits,
            device=args.device, observer=observer,
        )
    elif args.cmd == "distance":
        mp.distance_command(
            args.in1, args.in2, args.out, args.start_i, args.start_j,
            args.n_i, args.n_j, device=args.device,
        )
    elif args.cmd == "export":
        mp.export_command(args.input, args.in1, args.in2, args.out)
    elif args.cmd == "append":
        mp.append_command(args.in1, args.in2)
    elif args.cmd == "info":
        print(mp.info_command(args.input))
    elif args.cmd == "pipeline":
        mp.run_simka_min(
            args.input, args.out, args.kmer_size, args.nb_kmers,
            args.seed, args.filter, args.max_reads, args.min_read_size,
            args.min_shannon_index, bloom_bits=bloom_bits,
            device=args.device, observer=observer,
        )
    elif args.cmd == "update":
        mp.run_simka_min_update(
            args.out, args.input, args.filter, args.max_reads,
            args.min_read_size, args.min_shannon_index,
            bloom_bits=bloom_bits, device=args.device, observer=observer,
        )
    elif args.cmd == "matrix-update":
        mp.matrix_update_command(
            args.input, args.in_evn, args.in_nvn, args.n_old, args.n_new
        )
    return 0


if __name__ == "__main__":
    sys.exit(min_main(sys.argv[1:]))
