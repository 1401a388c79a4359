"""Collators of the S2S single-FFN and two-tower TTS families (a numpy copy
of rwkvtts_tpu/data/s2s_collator.py).

  * S2S (train_rwkv7s2s_single_ffn_asr_jsonl.py): text-mode or audio-mode
    batches over the combined vocabulary; audio ids are offset past the
    text vocabulary on the input side (utils/enlarge_rwkv_vocab_for_s2s.py)
    and raw as labels.
  * Two-tower (train_rwkv_tts.py): rows {text, global_tokens,
    semantic_tokens}; the audio stream is [global | semantic + 4096 | EOS]
    in the 12,289-token joint vocabulary (model/llm/rwkv_tts.py:205), the
    labels are the audio ids.

Both pad on the right. The models' forwards pack the segments right-aligned
themselves; their ``generate`` does too (the JAX package's does not).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

IGNORE = -100
SEMANTIC_OFFSET = 4096
EOS_AUDIO_ID = 12288  # the last of the joint vocabulary's 12,289 ids


def _pad_batch(rows: List[np.ndarray], pad_to: Optional[int], fill=0):
    width = pad_to or max(len(r) for r in rows)
    out = np.full((len(rows), width), fill, np.int64)
    mask = np.zeros((len(rows), width), np.int32)
    for i, r in enumerate(rows):
        r = r[:width]
        out[i, :len(r)] = r
        mask[i, :len(r)] = 1
    return out, mask


def collate_s2s(
    rows: Sequence[Dict[str, Any]],
    tokenizer,
    *,
    text_vocab: int = 65536,
    is_text: bool = True,
    pad_to: Optional[int] = None,
) -> Dict[str, Any]:
    """Text-mode batches train the text head on `text`; audio-mode batches
    the audio head on `audio_tokens` (the first row of a 2-D array). The
    batch names its mode under `_is_text`."""
    seqs: List[np.ndarray] = []
    for r in rows:
        if is_text:
            seqs.append(np.asarray(tokenizer.encode(r["text"]), np.int64))
        else:
            a = np.asarray(r["audio_tokens"], np.int64)
            if a.ndim > 1:
                a = a[0]
            seqs.append(a + text_vocab)
    ids, mask = _pad_batch(seqs, pad_to)
    labels = np.where(mask > 0, ids if is_text else ids - text_vocab, IGNORE)
    return {"input_ids": ids, "attention_mask": mask, "labels": labels, "_is_text": is_text}


def collate_two_tower(
    rows: Sequence[Dict[str, Any]],
    tokenizer,
    *,
    pad_audio_to: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    text_rows = [np.asarray(tokenizer.encode(r["text"]), np.int64) for r in rows]
    audio_rows = [np.concatenate([np.asarray(r["global_tokens"], np.int64),
                                  np.asarray(r["semantic_tokens"], np.int64) + SEMANTIC_OFFSET,
                                  [EOS_AUDIO_ID]]) for r in rows]
    text_ids, text_mask = _pad_batch(text_rows, None)
    audio_ids, audio_mask = _pad_batch(audio_rows, pad_audio_to)
    return {"text_ids": text_ids, "text_mask": text_mask, "audio_ids": audio_ids,
            "audio_mask": audio_mask, "labels": np.where(audio_mask > 0, audio_ids, IGNORE)}
