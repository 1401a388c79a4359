"""JSONL dataset: sharded loading, epoch shuffling, token-budget batching
(a copy of rwkvtts_tpu/data/jsonl_dataset.py). Host-side numpy only;
batches are padded to a fixed width by the collator.
"""
from __future__ import annotations

import glob as globlib
import json
import os
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np


def load_jsonl_rows(
    patterns: Sequence[str],
    shard_index: int = 0,
    num_shards: int = 1,
    max_rows: Optional[int] = None,
) -> List[Dict[str, Any]]:
    """Read rows from jsonl files (glob patterns), keeping every
    num_shards-th row offset by shard_index (DistributedSampler-style)."""
    files: List[str] = []
    for pat in patterns:
        files.extend(sorted(globlib.glob(os.path.expanduser(pat))))
    rows: List[Dict[str, Any]] = []
    i = 0
    for path in files:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                if i % num_shards == shard_index:
                    rows.append(json.loads(line))
                    if max_rows is not None and len(rows) >= max_rows:
                        return rows
                i += 1
    return rows


def _row_cost(row: Dict[str, Any]) -> int:
    """Approximate token cost of a row (for the budget clamp)."""
    n = 0
    for k in ("semantic_tokens", "tts_speech_tokens", "audio_tokens", "labels"):
        v = row.get(k)
        if isinstance(v, list):
            n += len(v) if not (v and isinstance(v[0], list)) else len(v[0]) * len(v)
    n += len(str(row.get("text", ""))) // 2
    return max(n, 1)


class JsonlDataset:
    """Epoch-shuffled batch iterator with a token budget: a batch shrinks
    until its estimated token count fits ``max_tokens``.

    collate_fn(rows) -> dict of numpy arrays."""

    def __init__(
        self,
        rows: List[Dict[str, Any]],
        collate_fn: Callable[[List[Dict[str, Any]]], Dict[str, np.ndarray]],
        batch_size: int,
        seed: int = 0,
        max_tokens: Optional[int] = None,
        drop_last: bool = True,
    ):
        self.rows = rows
        self.collate_fn = collate_fn
        self.batch_size = batch_size
        self.seed = seed
        self.max_tokens = max_tokens
        self.drop_last = drop_last

    def __len__(self):
        n = len(self.rows) // self.batch_size
        return n if self.drop_last else -(-len(self.rows) // self.batch_size)

    def epoch(self, epoch_idx: int, start_batch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Iterate one epoch from batch `start_batch` (mid-epoch resume)."""
        rng = np.random.default_rng(self.seed + epoch_idx)
        order = rng.permutation(len(self.rows))
        for b in range(start_batch, len(self)):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            batch_rows = [self.rows[i] for i in idx]
            if self.max_tokens is not None:
                while len(batch_rows) > 1 and sum(map(_row_cost, batch_rows)) > self.max_tokens:
                    batch_rows = batch_rows[:-1]
            yield self.collate_fn(batch_rows)
