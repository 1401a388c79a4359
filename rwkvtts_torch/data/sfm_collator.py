"""SFM flow training collation (counterpart of
rwkvtts_tpu/data/sfm_collator.py; reference train_scripts/train_sfm_flow.py:268-347).

Each batch needs the speech tokens, their mel (the 24 kHz HiFi-GAN
log-mel, two frames a token) and the x-vector. Rows carry precomputed
`speech_token` and optionally `embedding` (up to 192 dimensions kept) and
`speech_feat`; without `speech_feat` the mel is computed on the host from
`audio` with ``codecs/dsp.log_mel_hifigan``. The output is numpy.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch


def collate(
    rows: Sequence[Dict[str, Any]],
    *,
    token_mel_ratio: int = 2,
    n_mels: int = 80,
    spk_embed_dim: int = 192,
    pad_tokens_to: Optional[int] = None,
    sample_rate: int = 24000,
) -> Dict[str, np.ndarray]:
    """{tokens (B, Tt) int64, token_mask (B, Tt), feat (B, Tt x ratio,
    n_mels), feat_mask (B, Tt x ratio), embedding (B, spk_embed_dim)}, the
    masks f32. Tt is `pad_tokens_to` (longer rows are cut) or the longest
    row; a row's mel frames beyond its tokens x ratio are dropped."""
    from rwkvtts_torch.codecs import dsp

    B = len(rows)
    tok_rows = [np.asarray(r["speech_token"], np.int64) for r in rows]
    Tt = pad_tokens_to or max(len(t) for t in tok_rows)
    tokens = np.zeros((B, Tt), np.int64)
    tmask = np.zeros((B, Tt), np.float32)
    feats = np.zeros((B, Tt * token_mel_ratio, n_mels), np.float32)
    fmask = np.zeros((B, Tt * token_mel_ratio), np.float32)
    emb = np.zeros((B, spk_embed_dim), np.float32)
    for i, r in enumerate(rows):
        t = tok_rows[i][:Tt]
        tokens[i, :len(t)] = t
        tmask[i, :len(t)] = 1
        if "speech_feat" in r:
            f = np.asarray(r["speech_feat"], np.float32)
        else:
            wav = torch.from_numpy(np.asarray(r["audio"], np.float32)[None])
            f = dsp.log_mel_hifigan(wav, sample_rate=sample_rate)[0].numpy()
        n = min(len(t) * token_mel_ratio, f.shape[0])
        feats[i, :n] = f[:n]
        fmask[i, :n] = 1
        if "embedding" in r:
            emb[i] = np.asarray(r["embedding"], np.float32)[:spk_embed_dim]
    return {"tokens": tokens, "token_mask": tmask, "feat": feats, "feat_mask": fmask,
            "embedding": emb}
