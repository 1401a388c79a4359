"""Spark training straight from audio: BiCodec tokenizes each batch's rows
as the batch is collated (counterpart of rwkvtts_tpu/data/inline_spark.py;
the reference's train_spark_rwkv7speech_multiple_dataset.py reads
webdataset tars and tokenizes inline).

The codec (``codecs/spark_tokenizer.SparkAudioTokenizer``) runs on its
device, one row at a time, on the host thread that collates; the
collator after it is the task's own (``collate_plain``,
``collate_with_properties``, ``collate_global_tokens``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence

import numpy as np

Collate = Callable[[Sequence[Dict[str, Any]]], Dict[str, np.ndarray]]


def tokenize_rows(rows: Sequence[Dict[str, Any]], audio_tokenizer) -> List[Dict[str, Any]]:
    """Rows carrying raw {audio, text, ...} -> rows with their BiCodec
    global_tokens (32) and semantic_tokens; rows that already carry
    semantic_tokens pass as they are."""
    out: List[Dict[str, Any]] = []
    for r in rows:
        if "semantic_tokens" in r:
            out.append(r)
            continue
        glob, sem = audio_tokenizer.tokenize(np.asarray(r["audio"], np.float32))
        out.append({**r, "global_tokens": glob.reshape(-1).tolist(),
                    "semantic_tokens": sem.reshape(-1).tolist()})
    return out


def inline_collate(collate: Collate, audio_tokenizer) -> Collate:
    """`collate` (a token-domain collator with its tokenizer and options
    bound) over rows tokenized through `audio_tokenizer` first."""

    def fn(rows: Sequence[Dict[str, Any]]) -> Dict[str, np.ndarray]:
        return collate(tokenize_rows(rows, audio_tokenizer))

    return fn

