"""Count-phase checkpoints: resume + incremental dataset addition.

The reference's resume system is sentinel files over a shared
filesystem: datasets with ``count_synchro/<bank>.ok`` are skipped and
their partition files reused; ``-keep-tmp`` preserves them so new
datasets can be added without recounting (SimkaPotara.hpp:838-842,
README.md:205-207).

Here a checkpoint is the per-sample counted SPECTRUM -- one npz of
(kmer words, counts) plus the metadata the reference keeps in the .ok
file (nbReads, distinct, total, chord N2) -- keyed by everything that
affects counting (k, read filters, max-reads, file list). A stale or
mismatching checkpoint is recounted, mirroring "remove file ... to
count again".

A copy of ``simka_tpu.core.checkpoint`` (the port imports no module of
that package): the file format is the interface, so a checkpoint
written by either package loads in the other. Words are stored in
``simka_tpu``'s big-endian uint32 layout (``ops.kmers.uint32_words``).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import List, Optional, Tuple

import numpy as np

FORMAT_VERSION = 1


def count_key(
    files: List[str],
    kmer_size: int,
    min_read_size: int,
    min_read_shannon_index: float,
    max_reads: int,
    min_kmer_shannon_index: float = 0.0,
) -> str:
    """Hash of everything that changes a sample's counted spectrum."""
    payload = json.dumps(
        {
            "v": FORMAT_VERSION,
            "files": files,
            "sizes": [
                os.path.getsize(f) if os.path.exists(f) else -1
                for f in files
            ],
            "k": kmer_size,
            "min_read_size": min_read_size,
            "min_shannon": min_read_shannon_index,
            "max_reads": max_reads,
            "min_kmer_shannon": min_kmer_shannon_index,
        },
        sort_keys=True,
    )
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


class CountCheckpoint:
    """Per-dataset spectrum store under <tmp>/count/."""

    def __init__(self, tmp_dir: str):
        self.dir = os.path.join(tmp_dir, "count")
        os.makedirs(self.dir, exist_ok=True)

    def path(self, dataset_id: str) -> str:
        return os.path.join(self.dir, f"{dataset_id}.npz")

    def load(
        self, dataset_id: str, key: str
    ) -> Optional[Tuple[Tuple[np.ndarray, ...], np.ndarray, int]]:
        p = self.path(dataset_id)
        if not os.path.exists(p):
            return None
        try:
            z = np.load(p, allow_pickle=False)
            if str(z["key"]) != key:
                return None
            nw = int(z["n_words"])
            words = tuple(z[f"w{i}"] for i in range(nw))
            return words, z["counts"], int(z["nb_reads"])
        except Exception:
            return None

    def save(
        self,
        dataset_id: str,
        key: str,
        words: Tuple[np.ndarray, ...],
        counts: np.ndarray,
        nb_reads: int,
    ) -> str:
        p = self.path(dataset_id)
        payload = {
            "key": key,
            "n_words": len(words),
            "counts": counts.astype(np.int64),
            "nb_reads": nb_reads,
            # the reference's .ok metadata lines (SimkaCount.cpp:355-368)
            "nb_distinct": len(counts),
            "nb_kmers": int(counts.sum()) if len(counts) else 0,
            "chord_n2": int((counts.astype(np.int64) ** 2).sum())
            if len(counts)
            else 0,
        }
        for i, w in enumerate(words):
            payload[f"w{i}"] = w
        tmp = p + ".tmp.npz"  # savez appends .npz unless present
        np.savez_compressed(tmp, **payload)
        os.replace(tmp, p)
        return p
