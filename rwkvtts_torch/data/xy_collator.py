"""XY hierarchical time-shift layout (a numpy copy of
rwkvtts_tpu/data/xy_collator.py; the reference's
train_scripts/train_xy_llm.py:90-215 and XY_LM.md).

  * the text "[S0]{text}[CTL0]" on channel 0; audio ids on channel 0 are
    shifted by text_shift_size (65536)
  * diagonal placement: audio frame t of channel ch lands at step
    T1 + t + ch (channel ch delayed by ch steps)
  * other cells: channel 0 the text pad, channels 1-7 the speech pad
  * labels = the next step's ids; the text region (but its last step) and
    pad cells ignored; each channel's terminal label on the closing
    staircase is its pad (the text pad on channel 0)
  * rows carry pre-extracted ``audio_tokens`` (8, T2), as the JSONL
    (Higgs) variant does
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

IGNORE = -100


def build_sample(text_ids: Sequence[int], speech_tokens: np.ndarray, *, num_channels: int,
                 text_shift_size: int, speech_vocab_size: int, text_vocab_size: int):
    """One sample: text ids and raw codec ids (num_channels, T2) ->
    (input_ids (T, 8), labels (T, 8)), T = T1 + T2 + num_channels - 1."""
    text_ids = np.asarray(text_ids, dtype=np.int64)
    speech = np.asarray(speech_tokens, dtype=np.int64).copy()
    if speech.shape[0] != num_channels:
        raise ValueError(f"build_sample: {speech.shape[0]} speech channels, want {num_channels}")
    speech[0] += text_shift_size

    T1, T2 = len(text_ids), speech.shape[1]
    total = T1 + T2 + num_channels - 1
    speech_pad, text_pad = speech_vocab_size - 1, text_vocab_size - 1

    ids = np.full((total, num_channels), speech_pad, dtype=np.int64)
    ids[:T1, 0] = text_ids
    ids[T1:, 0] = text_pad
    for ch in range(num_channels):
        ids[T1 + ch:T1 + ch + T2, ch] = speech[ch]

    labels = np.full((total, num_channels), IGNORE, dtype=np.int64)
    labels[:-1] = ids[1:]
    if T1 > 1:
        labels[:T1 - 1] = IGNORE
    labels[labels == speech_pad] = IGNORE
    labels[labels == text_pad] = IGNORE
    for ch in range(num_channels):  # the closing staircase: each channel's pad
        labels[T1 + T2 - 1 + ch, ch] = text_pad if ch == 0 else speech_pad
    return ids, labels


def collate(rows, tokenizer, *, num_channels: int = 8, text_shift_size: int = 65536,
            speech_vocab_size: int = 1024, text_vocab_size: int = 66660,
            pad_to: Optional[int] = None, pad_multiple: int = 64) -> Dict[str, np.ndarray]:
    """rows: {text, audio_tokens (8, T2)}; the text is wrapped as
    [S0]{text}[CTL0] and encoded by `tokenizer` (whose added tokens carry
    the markers). Right-padded to `pad_to`, or to a multiple of
    `pad_multiple`: {input_ids, labels (B, T, 8), attention_mask (B, T)}."""
    samples = [
        build_sample(tokenizer.encode(f"[S0]{r['text']}[CTL0]"), np.asarray(r["audio_tokens"]),
                     num_channels=num_channels, text_shift_size=text_shift_size,
                     speech_vocab_size=speech_vocab_size, text_vocab_size=text_vocab_size)
        for r in rows]
    maxlen = max(s[0].shape[0] for s in samples)
    if pad_to is None:
        pad_to = -(-maxlen // pad_multiple) * pad_multiple
    B = len(samples)
    input_ids = np.full((B, pad_to, num_channels), speech_vocab_size - 1, dtype=np.int64)
    input_ids[:, :, 0] = text_vocab_size - 1
    labels = np.full((B, pad_to, num_channels), IGNORE, dtype=np.int64)
    mask = np.zeros((B, pad_to), dtype=np.int32)
    for i, (ids, labs) in enumerate(samples):
        n = ids.shape[0]
        input_ids[i, :n] = ids
        labels[i, :n] = labs
        mask[i, :n] = 1
    return {"input_ids": input_ids, "labels": labels, "attention_mask": mask}


def undo_diagonal(frames: np.ndarray, *, text_shift_size: int = 65536,
                  num_channels: int = 8) -> np.ndarray:
    """Generated frames (T, 8) -> codec codes (8, T - 7): the staircase
    undone and channel 0 un-shifted (XY_LM.md's decode walkthrough)."""
    T2 = max(frames.shape[0] - (num_channels - 1), 0)
    out = np.zeros((num_channels, T2), dtype=np.int64)
    for ch in range(num_channels):
        out[ch] = frames[ch:ch + T2, ch]
    out[0] -= text_shift_size
    return out
