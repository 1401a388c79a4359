"""The whisper-style pieces of the XY tokenizer that the S3 speech
tokenizer shares (counterpart of part of rwkvtts_tpu/codecs/xy_tokenizer.py):
the sinusoidal positions, the pre-LN transformer layer with full attention
over the valid frames, and the whisper log-mel. The rest of the XY codec
(encoder stacks, RVQ, Vocos decoder) is not ported yet.

Plain PyTorch in float32; the JAX package computes these in XLA, not in a
kernel. Channels-last (B, T, C).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from rwkvtts_torch.codecs import dsp, nn

Params = nn.Params


def sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's sinusoidal positions (length, channels), sin then cos."""
    inc = math.log(10000) / (channels // 2 - 1)
    inv = np.exp(-inc * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


def _tf_layer_init(g: torch.Generator, d: int, ffn: int) -> Params:
    dev = g.device
    return {
        "attn_ln": nn.layer_norm_init(d, dev),
        "q": nn.linear_init(g, d, d),
        "k": nn.linear_init(g, d, d, bias=False),
        "v": nn.linear_init(g, d, d),
        "out": nn.linear_init(g, d, d),
        "final_ln": nn.layer_norm_init(d, dev),
        "fc1": nn.linear_init(g, d, ffn),
        "fc2": nn.linear_init(g, ffn, d),
    }


def _tf_layer(p: Params, x: torch.Tensor, heads: int, mask: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    """One pre-LN block; `mask` (B, T) > 0 marks the frames attended to."""
    B, T, D = x.shape
    dk = D // heads
    h = nn.layer_norm(p["attn_ln"], x, eps=1e-5)
    split = lambda y: y.reshape(B, T, heads, dk).transpose(1, 2)
    q, k, v = (split(nn.linear(p[n], h)) for n in ("q", "k", "v"))
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(dk)
    if mask is not None:
        scores = torch.where(mask[:, None, None, :] > 0, scores, -1e10)
    o = (torch.softmax(scores, -1) @ v).transpose(1, 2).reshape(B, T, D)
    x = x + nn.linear(p["out"], o)
    h = nn.layer_norm(p["final_ln"], x, eps=1e-5)
    return x + nn.linear(p["fc2"], nn.gelu(nn.linear(p["fc1"], h)))


def _tf_stack(ps, x: torch.Tensor, heads: int, mask: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    for p in ps:
        x = _tf_layer(p, x, heads, mask)
    return x


def whisper_log_mel(wav: torch.Tensor, sample_rate: int = 16000, n_fft: int = 400,
                    hop: int = 160, n_mels: int = 80) -> torch.Tensor:
    """Whisper's log-mel: the centred STFT's power without its last frame,
    the slaney mel, log10(clamp(mel, 1e-10)) clamped to within 8 of its
    maximum, then (x + 4) / 4. wav (B, T) -> (B, T // hop, n_mels)."""
    real, imag = dsp.stft(wav, n_fft, hop)
    real, imag = real[:, :-1], imag[:, :-1]
    power = real ** 2 + imag ** 2
    fb = torch.from_numpy(dsp.mel_filterbank(sample_rate, n_fft, n_mels, 0.0, None))
    log_spec = torch.log10(torch.clamp_min(power @ fb.to(power), 1e-10))
    log_spec = torch.maximum(log_spec, log_spec.amax(dim=(1, 2), keepdim=True) - 8.0)
    return (log_spec + 4.0) / 4.0
