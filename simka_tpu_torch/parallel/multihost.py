"""Several hosts: the `simka` tool as one process a host under
torch.distributed (``simka_tpu.parallel.multihost``).

The reference's cluster mode is job scripts and a shared filesystem
(SimkaPotara.hpp:884-897). Here, as in ``simka_tpu``:

1. every process counts the spectra of ITS datasets (a static
   round-robin manifest, ``datasets_for_process``), with its own
   checkpoints under ``<tmp>/host{rank}`` -- no communication;
2. the spectrum rows are routed to the shard that owns their k-mer's
   hash and exchanged with ``all_to_all_single``. A process's shards
   are its local devices (``local_shards``: every card of its host by
   default, as ``simka_tpu``'s mesh holds every process's devices), so
   the global shard count G is the sum of every process's; a row's
   global shard is ``mix_hash`` of ``simka_tpu``'s uint32 words mod G,
   its owner the process whose range of global shard indices holds it,
   processes in rank order (``shard_routes``: ``simka_tpu``'s device
   ``hash % n_dev`` in the mesh's order). The rows are binned by owner
   and traded, first the row counts each pair of processes trades,
   then each column with those splits; each process then splits what
   it received by local shard and moves each part to its device;
3. each process joins its shards (``parallel.sharded.
   sharded_raw_stats``); the per-bank solid totals are summed over the
   local shards, then over the processes (``all_reduce``), before any
   pair term reads them, then the raw statistics are summed
   (``max_count`` by a max), converted once, and process 0 writes the
   matrices.

A process's home device is its first shard: with -device cuda the
card NCCL uses, with -device cpu the CPU and gloo. With -n-shards 1
the home card is the card of index ``rank % torch.cuda.device_count()``
(one process a card). Two processes whose home cards are one card of
one host are refused through the process group's store before any
collective (``check_home_cards``). Nothing falls back: where NCCL
fails on the card, the run fails. Once torch.distributed is
initialised every exchange and reduction goes through the backend, at
one rank too; a process that did not initialise it runs the same path
alone, as ``simka_tpu`` does.
"""

from __future__ import annotations

import os
import socket
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from simka_tpu_torch.ops.countjoin import JoinStats


def init_distributed(coordinator: str, num_hosts: Optional[int] = None,
                     host_id: Optional[int] = None,
                     device: str = "cuda") -> None:
    """torch.distributed for a multi-host run (``simka_tpu``'s
    ``init_distributed``): ``coordinator`` is the rank-0 host's
    ``host:port``, ``num_hosts`` the process count (default 1) and
    ``host_id`` this process's rank (default 0); NCCL on ``cuda``,
    gloo on ``cpu``. The process's home card is chosen by
    ``run_simka_multihost``, before its first collective."""
    world = 1 if num_hosts is None else num_hosts
    rank = 0 if host_id is None else host_id
    if not 0 <= rank < world:
        raise ValueError(f"-host-id {rank} outside [0, {world})")
    dist.init_process_group(
        "nccl" if device == "cuda" else "gloo",
        init_method=(coordinator if "://" in coordinator
                     else f"tcp://{coordinator}"),
        world_size=world, rank=rank,
    )


def local_shards(device: str, rank: int, n_shards: int) -> List[torch.device]:
    """This process's shards (``parallel.sharded.shard_devices`` by the
    reference's rule): -n-shards n over the first n cards of the host
    (0: every card), the card of index ``rank`` modulo the card count
    when one shard is asked for or fewer than n cards exist; with
    -device cpu, n copies of the CPU."""
    from simka_tpu_torch import resolve_device
    from simka_tpu_torch.parallel.sharded import shard_devices

    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return shard_devices(n_shards, dev)


def home_card(dev: torch.device) -> str:
    """The host and the physical card of ``dev``: the card's UUID, the
    same in processes that see the card under other indices
    (CUDA_VISIBLE_DEVICES)."""
    return f"{socket.gethostname()} {torch.cuda.get_device_properties(dev).uuid}"


def check_home_cards(store, rank: int, world: int, card: str) -> None:
    """Every process's home card (``home_card``) traded through
    ``store`` (the process group's); ValueError, in every process, when
    two of them are one card, which NCCL refuses or waits on. Each
    call takes its own keys, so a process group may run it again."""
    call = (store.add("simka_home_calls", 1) - 1) // world
    store.set(f"simka_home/{call}/{rank}", card)
    cards = [store.get(f"simka_home/{call}/{r}").decode()
             for r in range(world)]
    for a in range(world):
        for b in range(a + 1, world):
            if cards[a] == cards[b]:
                raise ValueError(
                    f"-coordinator processes {a} and {b} both run on card "
                    f"{cards[a]}: launch one process a host (its shards "
                    "are every card of the host), or give each process "
                    "its own card with -n-shards 1 (card rank % cards) or "
                    "CUDA_VISIBLE_DEVICES")


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def _rank_world():
    if _distributed():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _all_reduce(t: torch.Tensor, op=None) -> torch.Tensor:
    """In-place sum (or ``op``) over the processes; nothing without
    torch.distributed."""
    if _distributed():
        dist.all_reduce(t, op=dist.ReduceOp.SUM if op is None else op)
    return t


def shards_per_rank(n_local: int, home: torch.device) -> List[int]:
    """Every process's local shard count, in rank order (an
    ``all_reduce`` of one slot a process, on ``home``)."""
    rank, world = _rank_world()
    counts = torch.zeros(world, dtype=torch.int64, device=home)
    counts[rank] = n_local
    return _all_reduce(counts).tolist()


def datasets_for_process(n_datasets: int, process_id: int,
                         num_processes: int) -> List[int]:
    """Static sample-sharding manifest: which dataset indices this
    process ingests and counts (round-robin for balance)."""
    return list(range(process_id, n_datasets, num_processes))


def shard_routes(words: Sequence[torch.Tensor], k: int,
                 per_rank: Sequence[int]) -> tuple:
    """Each k-mer's (owner process, local shard), int64: its global
    shard ``shard_ids(words, k, G)``, G = sum(per_rank), is
    ``simka_tpu``'s device ``mix_hash % n_dev`` in a mesh of every
    process's devices in rank order; its owner is the process whose
    range of global indices holds it, its local shard the index within
    that range."""
    from simka_tpu_torch.parallel.sharded import shard_ids

    sizes = torch.tensor(per_rank, dtype=torch.int64, device=words[0].device)
    g = shard_ids(words, k, int(sizes.sum()))
    owner = torch.repeat_interleave(
        torch.arange(len(per_rank), device=sizes.device), sizes)[g]
    return owner, g - (torch.cumsum(sizes, 0) - sizes)[owner]


def _exchange(cols: Sequence[torch.Tensor], dest: Optional[torch.Tensor],
              world: int) -> tuple:
    """Every process's rows for this one: the rows binned by destination
    (the stable compaction a destination, ``parallel.sharded.
    split_rows``, in place of the reference's filler sort; one process
    sends its rows untouched and takes no ``dest``), the split sizes
    traded with one ``all_to_all_single``, then one for each column
    with those splits."""
    from simka_tpu_torch.parallel.sharded import split_rows

    parts = split_rows(cols, dest, world)
    if not _distributed():
        return parts[0]
    dev = cols[0].device
    send = torch.tensor([p[0].shape[0] for p in parts], dtype=torch.int64,
                        device=dev)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send)
    send_sizes, recv_sizes = send.tolist(), recv.tolist()
    out = []
    for c in range(len(cols)):
        binned = torch.cat([p[c] for p in parts])
        got = torch.empty(sum(recv_sizes), dtype=binned.dtype, device=dev)
        dist.all_to_all_single(got, binned, output_split_sizes=recv_sizes,
                               input_split_sizes=send_sizes)
        out.append(got)
    return tuple(out)


def _all_reduce_raw(raw: JoinStats) -> JoinStats:
    """Raw statistics summed over the processes, ``max_count`` by a max:
    every int64 field but that one in one flat ``all_reduce``."""
    if not _distributed():
        return raw
    names = [f for f in JoinStats._fields if f != "max_count"]
    flat = torch.cat([getattr(raw, f).reshape(-1) for f in names])
    _all_reduce(flat)
    top = _all_reduce(raw.max_count.reshape(1).clone(), dist.ReduceOp.MAX)
    vals, at = {}, 0
    for f in names:
        t = getattr(raw, f)
        vals[f] = flat[at:at + t.numel()].view(t.shape)
        at += t.numel()
    return JoinStats(**vals, max_count=top.reshape(()))


def multihost_join_from_spectra(
    words32: Sequence[np.ndarray], sid: np.ndarray, counts: np.ndarray,
    abundance_min: int, abundance_max: int, *, k: int, n_banks: int,
    shards: Sequence[torch.device], per_rank: Sequence[int],
    simple: bool = False, complex_: bool = False,
) -> JoinStats:
    """This process's spectrum rows (``simka_tpu``'s uint32 words, the
    sample ids and counts of its datasets, on the host) joined with
    every other process's: shipped once to its home device
    (``shards[0]``), exchanged to their owner processes and split there
    by local shard (``shard_routes``), each part joined on its shard's
    device, the totals and the raw statistics reduced over the
    processes. ``per_rank``: every process's shard count
    (``shards_per_rank``). Every process calls it; each returns the
    global ``JoinStats`` on its home device. One process with one shard
    routes nothing."""
    from simka_tpu_torch.ops.countjoin import _finish
    from simka_tpu_torch.ops.spectrum import words_from_host
    from simka_tpu_torch.parallel.sharded import (
        raw_sharded_join_from_spectra,
        split_rows,
    )

    rank, world = _rank_world()
    home = shards[0]
    words = words_from_host(list(words32), k, home)
    nw = len(words)
    cols = (*words,
            torch.from_numpy(np.asarray(sid, np.int32)).to(home),
            torch.from_numpy(np.asarray(counts, np.int32)).to(home))
    del words
    cols = _exchange(
        cols, shard_routes(cols[:nw], k, per_rank)[0] if world > 1 else None,
        world)
    if len(shards) > 1:
        cols = split_rows(cols, shard_routes(cols[:nw], k, per_rank)[1],
                          len(shards))
    else:
        cols = [cols]
    parts = [(tuple(c.to(d) for c in p[:nw]), p[nw].to(d), p[nw + 1].to(d))
             for p, d in zip(cols, shards)]
    del cols
    raw = raw_sharded_join_from_spectra(
        parts, abundance_min, abundance_max, n_banks=n_banks,
        kmer_bits=2 * k, simple=simple, complex_=complex_,
        all_reduce=_all_reduce,
    )
    return _finish(_all_reduce_raw(raw), complex_)


def run_simka_multihost(config, device: str = "cuda",
                        shards: Optional[Sequence] = None) -> None:
    """Multi-host `simka` (``simka_tpu``'s ``run_simka_multihost``):
    every process counts its manifest datasets and the join runs over
    every process's shards. Launch one process a host with the same
    arguments plus -coordinator / -num-hosts / -host-id: its shards are
    ``local_shards`` (every card of the host by default; -n-shards 1,
    or CUDA_VISIBLE_DEVICES, for one process a card), or ``shards``, a
    device list of ``device``'s kind where a device may repeat (as the
    tests pass ``[cpu] * n``). Process 0 writes the matrices. A process
    without torch.distributed runs alone."""
    from simka_tpu_torch import resolve_device
    from simka_tpu_torch.core.distances import compute_all_matrices
    from simka_tpu_torch.core.output import write_all_matrices
    from simka_tpu_torch.core.pipeline import (
        count_one_dataset,
        resolve_max_reads,
    )
    from simka_tpu_torch.core.stats import SimkaStatistics
    from simka_tpu_torch.io.dsl import check_input_validity, parse_input_file
    from simka_tpu_torch.ops import compact
    from simka_tpu_torch.ops.kmers import n_uint32_words
    from simka_tpu_torch.parallel.sharded import check_shards
    from simka_tpu_torch.utils.metrics import RUN_STAGES, Metrics, Spans, span

    datasets = parse_input_file(config.input_filename)
    check_input_validity(datasets)
    ids = [d.id for d in datasets]
    n = len(ids)
    k = config.kmer_size
    pid, n_proc = _rank_world()
    shards = (local_shards(device, pid, config.n_shards) if shards is None
              else check_shards(shards, resolve_device(device)))
    dev = shards[0]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if _distributed():
            check_home_cards(dist.distributed_c10d._get_default_store(),
                             pid, n_proc, home_card(dev))
    per_rank = shards_per_rank(len(shards), dev)
    mine = datasets_for_process(n, pid, n_proc)
    spans = Spans()  # the run and its stages (utils.metrics.RUN_STAGES)
    metrics = Metrics(spans)
    metrics.set("n_datasets", n)
    metrics.set("n_processes", n_proc)
    metrics.set("device", str(dev))
    metrics.set("n_shards", sum(per_rank))
    metrics.set("shards_per_process", per_rank)

    def log(msg):
        if config.verbose:
            print(f"[simka-tpu-torch host {pid}] {msg}", flush=True)

    log(f"shards {[str(d) for d in shards]} of {sum(per_rank)}")
    # -max-reads 0 (auto) resolves to the SAME cap on every process: the
    # per-group read estimates of each process's datasets, summed over
    # the processes, then (min + mean) / 2 of the global list
    if config.max_reads == 0:
        from simka_tpu_torch.io.bank import estimate_dataset_reads

        local = torch.zeros(n, dtype=torch.int64, device=dev)
        for s in mine:
            local[s] = estimate_dataset_reads(
                datasets[s].banks, config.min_read_size,
                config.min_read_shannon_index,
            ) // max(len(datasets[s].banks), 1)
        cap = resolve_max_reads(_all_reduce(local).tolist(), 0)
        log(f"auto -max-reads resolved globally to {cap}")
    else:
        cap = resolve_max_reads([], config.max_reads)

    ckpt = None
    if config.output_tmp_dir:
        from simka_tpu_torch.core.checkpoint import CountCheckpoint

        # per-process checkpoints: a process only ever recounts its own
        # manifest's datasets
        ckpt = CountCheckpoint(os.path.join(config.output_tmp_dir,
                                            f"host{pid}"))
    word_parts = [[] for _ in range(n_uint32_words(k))]
    sids, cnts = [], []
    nb_reads = torch.zeros(n, dtype=torch.int64, device=dev)
    with span(RUN_STAGES["count"], spans):
        for s in mine:
            words, counts, nr, resumed = count_one_dataset(
                datasets[s], config, cap, dev, ckpt=ckpt, log=log)
            if resumed:
                metrics.count("datasets_resumed", 1)
            if len(counts):  # an empty simka_tpu checkpoint may have
                # another word count (ROADMAP section 3)
                for i, w in enumerate(words):
                    word_parts[i].append(w)
                sids.append(np.full(len(counts), s, np.int32))
                cnts.append(counts.astype(np.int32))
            nb_reads[s] = nr
    metrics.count("reads", int(nb_reads.sum()))

    def column(parts, dtype):
        return np.concatenate(parts) if parts else np.empty(0, dtype)

    with span(RUN_STAGES["merge"], spans):
        js = multihost_join_from_spectra(
            [column(p, np.uint32) for p in word_parts],
            column(sids, np.int32), column(cnts, np.int32),
            config.abundance_min, config.abundance_max, k=k, n_banks=n,
            shards=shards, per_rank=per_rank, simple=config.simple_dist,
            complex_=config.complex_dist,
        ).to_numpy()
        nb_reads = _all_reduce(nb_reads).cpu().numpy()
    if pid == 0:
        stats = SimkaStatistics.from_join_stats(
            js, ids, k, nb_reads, config.simple_dist, config.complex_dist)
        matrices = compute_all_matrices(stats)
        os.makedirs(config.output_dir, exist_ok=True)
        write_all_matrices(config.output_dir, matrices, ids)
        metrics.set("nb_distinct_kmers", stats.nb_distinct_kmers)
        # this process's launches of the compaction kernel (0 on the CPU)
        metrics.set("compact_launches", compact.launches)
        metrics.save(os.path.join(config.output_dir, "simka_metrics.json"))
        if config.verbose:
            print(stats.summary())
