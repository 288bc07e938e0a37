"""Reference-fidelity Bloom `-filter` emulation (opt-in, ``-filter-bloom``).

The reference's `-filter` interposes a Bloom filter in front of the
bottom-s heap: a k-mer instance whose Bloom lookup misses only inserts
its bits (it is not counted); the instance that finds all bits set
enters the count table at 2 (SimkaMinCount.hpp:341-382). The Bloom is
sized from `-max-memory`: ``max(maxMemory * MB * 8 / nbThreads,
10000)`` bits with 7 hash functions (SimkaMinCount.hpp:1155-1161).

The default `-filter` applies the exact total-count >= 2 semantics
(``minhash/sketch.py``). This module replays the reference's
*mechanism*: a plain Bloom over the same bit count with 7
murmur3-derived hash functions of the canonical k-mer value (gatb 2-bit
encoding), and the reference's per-instance control flow. The hashing
of each read batch runs on the device (``device.hash_kmer_words``, the
CUDA kernel on the card); the replay is sequential and stays on the
host. ``bloom_bits_from_config``, ``BloomReplay`` and
``replay_sketch_bloom`` are copies of ``simka_tpu.minhash.bloom``'s.
"""

from __future__ import annotations

import heapq
from typing import Tuple

import numpy as np

from simka_tpu_torch.minhash.murmur import murmur3_u64

# 7 hash functions (SimkaMinCount.hpp:1160); seeds arbitrary-but-fixed
# (gatb-core's seed table is not in the reference tree).
_BLOOM_SEEDS = (
    0x9747B28C,
    0x41C64E6D,
    0x6C078965,
    0x3243F6A8,
    0x1F83D9AB,
    0x5BE0CD19,
    0x452821E6,
)


def bloom_bits_from_config(max_memory_mb: int, nb_cores: int) -> int:
    """Reference Bloom sizing: max(maxMemory*MB*8/threads, 10000)
    (SimkaMinCount.hpp:1158-1159). nb_cores=0 ("all") maps to 1
    thread, so the output does not depend on the host's core count."""
    bits = (max_memory_mb * (1 << 20) * 8) // max(nb_cores, 1)
    return max(bits, 10000)


class BloomReplay:
    """Streaming replay of SelectKmersCommand::processFiltered
    (SimkaMinCount.hpp:341-382): feed instance batches in read order,
    then take the admitted sketch.

    The Bloom is only consulted while the heap is filling, or when the
    instance's hash beats the current heap top -- so which instances
    insert Bloom bits depends on the evolving heap state; the replay
    preserves that exactly. The bit array is packed 8 bits a byte.
    """

    def __init__(self, sketch_size: int, n_bits: int):
        self.sketch_size = sketch_size
        self.n_bits = n_bits
        self._bytes = np.zeros((n_bits + 7) // 8, np.uint8)
        self._counts: dict = {}
        self._heap: list = []  # max-heap of admitted hashes via negation

    def feed(self, hashes: np.ndarray, kmer_values: np.ndarray) -> None:
        """One read batch's instances, in stream order."""
        if len(hashes) == 0:
            return
        # [B, 7] bit positions, vectorized per batch; split into the
        # byte index and the in-byte mask for the packed array
        pos = np.empty((len(kmer_values), len(_BLOOM_SEEDS)), np.uint64)
        for j, s in enumerate(_BLOOM_SEEDS):
            pos[:, j] = murmur3_u64(kmer_values, s) % np.uint64(
                self.n_bits
            )
        byte_idx = (pos >> np.uint64(3)).astype(np.int64)
        bit_mask = (
            np.uint8(1) << (pos & np.uint64(7)).astype(np.uint8)
        )

        bits = self._bytes
        counts = self._counts
        heap = self._heap
        sketch_size = self.sketch_size
        h_list = hashes.tolist()  # python ints: fast loop + exact cmp
        for i, h in enumerate(h_list):
            if len(heap) < sketch_size:
                bi, bm = byte_idx[i], bit_mask[i]
                if ((bits[bi] & bm) == bm).all():
                    if h not in counts:
                        heapq.heappush(heap, -h)
                        counts[h] = 2
                    else:
                        counts[h] += 1
                else:
                    np.bitwise_or.at(bits, bi, bm)
            else:
                # strict <: equality with the top is dropped without
                # touching the Bloom (SimkaMinCount.hpp:361)
                if h < -heap[0]:
                    bi, bm = byte_idx[i], bit_mask[i]
                    if ((bits[bi] & bm) == bm).all():
                        if h not in counts:
                            evicted = -heapq.heappop(heap)
                            del counts[evicted]
                            heapq.heappush(heap, -h)
                            counts[h] = 2
                        else:
                            counts[h] += 1
                    else:
                        np.bitwise_or.at(bits, bi, bm)

    def result(self) -> Tuple[np.ndarray, np.ndarray]:
        """(hashes ascending uint64, counts uint32)."""
        counts = self._counts
        if not counts:
            return np.empty(0, np.uint64), np.empty(0, np.uint32)
        out_h = np.sort(
            np.fromiter(counts.keys(), np.uint64, len(counts))
        )
        out_c = np.array(
            [counts[int(h)] for h in out_h], np.uint32
        )
        return out_h, out_c


def replay_sketch_bloom(
    hashes: np.ndarray,
    kmer_values: np.ndarray,
    sketch_size: int,
    n_bits: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """One-shot replay over a full in-memory instance stream."""
    rp = BloomReplay(sketch_size, n_bits)
    rp.feed(hashes, kmer_values)
    return rp.result()


def _hashed_read_chunks(seqs, kmer_size: int, seed: int, batch_reads: int,
                        device):
    """Yield, per chunk of ``batch_reads`` reads of ``seqs`` (a list,
    iterator or zero-arg provider of read byte strings), the (hashes,
    words) of its valid k-mer windows in read order, on ``device``:
    gatb codes encoded on the host, canonical words (complement
    ``code ^ 2``) and their hashes on the device."""
    import torch

    from simka_tpu_torch.core.pipeline import _iter_read_chunks
    from simka_tpu_torch.io.bank import encode_batch_gatb
    from simka_tpu_torch.minhash.device import hash_valid_words
    from simka_tpu_torch.ops.kmers import extract_kmers_codes

    for chunk in _iter_read_chunks(seqs, batch_reads):
        width = max(max((len(r) for r in chunk), default=0), kmer_size)
        codes, _ = encode_batch_gatb(chunk, max_len=width)
        ex = extract_kmers_codes(torch.from_numpy(codes).to(device),
                                 kmer_size, comp_xor=2)
        yield hash_valid_words(ex.words[0], ex.keep, seed)


def compute_sketch_bloom(
    seqs,
    kmer_size: int,
    sketch_size: int,
    seed: int,
    bloom_bits: int,
    batch_reads: int = 1 << 15,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Bottom-s sketch with the reference's Bloom admission mechanism.

    Per read batch: gatb encoding on the host, canonical k-mers and
    their murmur hashes on ``device``, the valid windows' (hash, k-mer
    value) pairs compacted there and copied back; admission is the
    replay above, so the instance stream is never held whole. k <= 31
    only: the emulation hashes the k-mer VALUE, one int64 word.
    """
    from simka_tpu_torch.minhash.device import as_device

    if kmer_size > 31:
        raise ValueError(
            "-filter-bloom emulation supports k <= 31 (needs single-"
            "word canonical k-mer values); use the default exact "
            "-filter for larger k"
        )
    replay = BloomReplay(sketch_size, bloom_bits)
    for h, w in _hashed_read_chunks(seqs, kmer_size, seed, batch_reads,
                                    as_device(device)):
        replay.feed(h.cpu().numpy().view(np.uint64),
                    w.cpu().numpy().view(np.uint64))
    return replay.result()
