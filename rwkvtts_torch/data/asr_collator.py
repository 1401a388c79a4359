"""ASR data collation (counterpart of rwkvtts_tpu/data/asr_collator.py):
rows {"audio": a wav path or float list, "text": transcript, "language":
"zh" | "en"} -> the batch dict ``models/asr.forward`` and ``transcribe``
read, as numpy.

The contract of the reference:
  * instruction strings, hints and EOS id 0
    (train_scripts/train_rwkv7_asr_jsonl.py:360-366, model/llm/rwkv_asr.py:184);
  * labels = the answer's token ids + EOS, -100 elsewhere (the model packs
    the segments);
  * Whisper's log-mel as the frozen encoder's input
    (``codecs/xy_tokenizer.whisper_log_mel`` at `n_mels`, by default 80 as
    the JAX package's; whisper-large-v3 takes 128).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from rwkvtts_torch.utils import audio_io

INSTRUCTIONS = {
    "zh": "User: 把以下音频转写为中文。\n",
    "en": "User: Convert the audios to English.\n",
}
HINTS = "\nAssistant:"
EOS_ID = 0
SAMPLE_RATE = 16000  # Whisper's rate: HOP and whisper_log_mel assume it
MAX_AUDIO_SECONDS = 30  # Whisper's window
HOP = 160  # mel frames at 100 Hz of 16 kHz audio


def _pad_right(rows: List[np.ndarray], width: int, fill=0):
    out = np.full((len(rows), width), fill, dtype=np.int64)
    mask = np.zeros((len(rows), width), dtype=np.int32)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
        mask[i, :len(r)] = 1
    return out, mask


def collate(
    rows: Sequence[Dict[str, Any]],
    tokenizer,
    *,
    n_mels: int = 80,
    pad_frames_to: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """The whisper variant's batch: mel (B, T_mel, n_mels) f32 and
    mel_mask, text_ids / text_mask (the instruction), hints_ids /
    hints_mask, labels / labels_mask, each right-padded to its longest
    row. Audio is taken at 16 kHz, at most 30 s a row; the mel is
    Whisper's log-mel at `n_mels`, on the CPU, padded to `pad_frames_to`
    frames where that is longer."""
    from rwkvtts_torch.codecs.xy_tokenizer import whisper_log_mel

    wavs, text_rows, label_rows = [], [], []
    for r in rows:
        a = r["audio"]
        wav = audio_io.load_wav(a, SAMPLE_RATE) if isinstance(a, str) else np.asarray(a, np.float32)
        wavs.append(wav[:MAX_AUDIO_SECONDS * SAMPLE_RATE])
        text_rows.append(np.asarray(tokenizer.encode(INSTRUCTIONS[r.get("language", "zh")]),
                                    np.int64))
        label_rows.append(np.asarray(tokenizer.encode(r["text"]) + [EOS_ID], np.int64))

    T_wav = -(-max(len(w) for w in wavs) // HOP) * HOP
    wav_batch = np.zeros((len(wavs), T_wav), np.float32)
    frame_valid = np.zeros((len(wavs),), np.int64)
    for i, w in enumerate(wavs):
        wav_batch[i, :len(w)] = w
        frame_valid[i] = len(w) // HOP
    mel = whisper_log_mel(torch.from_numpy(wav_batch), n_mels=n_mels).numpy()
    if pad_frames_to is not None and mel.shape[1] < pad_frames_to:
        mel = np.pad(mel, ((0, 0), (0, pad_frames_to - mel.shape[1]), (0, 0)))
    mel_mask = (np.arange(mel.shape[1])[None, :] < frame_valid[:, None]).astype(np.int32)

    text_ids, text_mask = _pad_right(text_rows, max(len(t) for t in text_rows))
    labels, labels_mask = _pad_right(label_rows, max(len(t) for t in label_rows), fill=-100)
    hints = np.asarray(tokenizer.encode(HINTS), np.int64)
    B = len(rows)
    return {
        "mel": np.asarray(mel, np.float32),
        "mel_mask": mel_mask,
        "text_ids": text_ids,
        "text_mask": text_mask,
        "hints_ids": np.tile(hints[None, :], (B, 1)),
        "hints_mask": np.ones((B, len(hints)), np.int32),
        "labels": labels,
        "labels_mask": labels_mask,
    }
