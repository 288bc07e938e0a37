"""Command-line interface of the port: the `simka` tool in exact mode,
and SimkaMin's `min` subcommands (``minhash/cli.py``).

The flags are ``simka_tpu.cli``'s, plus ``-device {cuda,cpu}``
(default cuda; asking for cuda without a GPU is an error, never a
silent CPU run). -n-shards shards the k-mer space over the first n
cards (with -device cpu, over n copies of the CPU); -coordinator runs
one process a host under torch.distributed, NCCL on the cards and gloo
on the CPU, each process's shards its host's cards by the same
-n-shards rule (-n-shards 1 or CUDA_VISIBLE_DEVICES: one process a
card; ``parallel/``).

Run as: python -m simka_tpu_torch.cli [min <subcommand>] -in input.txt
-out dir [-device cuda]
"""

from __future__ import annotations

import argparse
import sys

from simka_tpu_torch.config import SimkaConfig


def build_simka_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="simka-tpu-torch",
        description=(
            "Comparative metagenomics on one GPU: k-mer spectra and "
            "ecological distance matrices between N samples"
        ),
    )
    p.add_argument("-in", dest="input", required=True, help="input file of samples (one per line: id: f1,f2;f3...)")
    p.add_argument("-out", dest="out", default="./simka_results", help="output directory for distance matrices")
    p.add_argument("-out-tmp", dest="out_tmp", default=None, help="temporary directory: per-sample count checkpoints under <dir>/count/ (resume, add datasets)")
    p.add_argument("-keep-tmp", action="store_true", help="keep temporary files (the checkpoints, for later runs)")
    p.add_argument("-kmer-size", type=int, default=21, help="size of a kmer (1..127)")
    p.add_argument("-abundance-min", type=int, default=2, help="min abundance a kmer needs to be considered")
    p.add_argument("-abundance-max", type=int, default=999999999, help="max abundance a kmer can have")
    p.add_argument("-kmer-shannon-index", type=float, default=0.0, help="minimal Shannon index a kmer should have")
    p.add_argument("-max-reads", type=int, default=-1, help="max reads per sample (-1 all, 0 auto)")
    p.add_argument("-min-read-size", type=int, default=0, help="minimal read size")
    p.add_argument("-read-shannon-index", type=float, default=0.0, help="minimal read Shannon index")
    p.add_argument("-simple-dist", action="store_true", help="compute all simple distances")
    p.add_argument("-complex-dist", action="store_true", help="compute all complex distances")
    p.add_argument("-nb-cores", type=int, default=0, help="accepted for compatibility")
    p.add_argument("-max-memory", type=int, default=5000, help="max memory (MB): one join's budget; a larger join takes the out-of-core hash-range sweep")
    p.add_argument("-sweep-ranges", type=int, default=0, help="with -out-tmp: force the out-of-core sweep over N hash ranges (0: only past -max-memory)")
    p.add_argument("-verbose", type=int, default=1, help="verbosity")
    p.add_argument("-n-shards", type=int, default=0, help="k-mer-space shards (0 = all local cards; with -device cpu, n copies of the CPU); with -coordinator, each process's")
    p.add_argument("-data-info", action="store_true", help="compute (and display) input information only")
    p.add_argument("-coordinator", default=None, help="coordinator address host:port for multi-host runs (one process a host over its cards; -n-shards 1 or CUDA_VISIBLE_DEVICES for one a card)")
    p.add_argument("-num-hosts", type=int, default=None, help="number of processes in the multi-host run")
    p.add_argument("-host-id", type=int, default=None, help="this process's id (0-based)")
    for flag in ("-count-cmd", "-merge-cmd", "-count-file", "-merge-file"):
        p.add_argument(flag, default=None, help=argparse.SUPPRESS)
    p.add_argument("-max-count", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("-max-merge", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("-device", choices=("cuda", "cpu"), default="cuda", help="device to run on (default cuda)")
    return p


def parse_simka_args(argv) -> tuple:
    """The `simka` command's flags as (the parsed arguments, the run's
    SimkaConfig)."""
    args = build_simka_parser().parse_args(argv)
    return args, SimkaConfig(
        input_filename=args.input,
        output_dir=args.out,
        output_tmp_dir=args.out_tmp,
        kmer_size=args.kmer_size,
        abundance_min=args.abundance_min,
        abundance_max=args.abundance_max,
        min_kmer_shannon_index=args.kmer_shannon_index,
        max_reads=args.max_reads,
        min_read_size=args.min_read_size,
        min_read_shannon_index=args.read_shannon_index,
        simple_dist=args.simple_dist,
        complex_dist=args.complex_dist,
        nb_cores=args.nb_cores,
        max_memory_mb=args.max_memory,
        keep_tmp=args.keep_tmp,
        verbose=bool(args.verbose),
        n_shards=args.n_shards,
        sweep_ranges=args.sweep_ranges,
    )


def simka_main(argv) -> int:
    args, config = parse_simka_args(argv)
    if args.count_cmd or args.merge_cmd or args.count_file or args.merge_file:
        print(
            "[simka-tpu-torch] note: the reference's cluster job flags are "
            "accepted but inert; use -coordinator/-num-hosts/-host-id "
            "for multi-host runs (torch.distributed)",
            flush=True,
        )
    if args.data_info:
        from simka_tpu_torch.core.pipeline import run_data_info

        run_data_info(config)
        return 0
    if args.coordinator:
        import torch.distributed as dist

        from simka_tpu_torch.parallel.multihost import (
            init_distributed,
            run_simka_multihost,
        )

        init_distributed(args.coordinator, args.num_hosts, args.host_id,
                         args.device)
        try:
            run_simka_multihost(config, device=args.device)
        finally:
            dist.destroy_process_group()
        return 0
    from simka_tpu_torch.core.pipeline import run_simka

    run_simka(config, device=args.device)
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        if argv and argv[0] == "min":
            from simka_tpu_torch.minhash.cli import min_main

            return min_main(argv[1:])
        return simka_main(argv)
    except (FileNotFoundError, ValueError) as e:
        print(f"simka-tpu-torch: error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
