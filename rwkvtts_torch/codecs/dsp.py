"""STFT, inverse STFT and the mel spectrogram as HiFT and BiCodec use them
(counterpart of rwkvtts_tpu/codecs/dsp.py): a Hann window (zero-padded
to n_fft when shorter), the analysis as products against windowed
real-DFT bases (torch.stft(center=True, onesided=True) semantics), the
synthesis with Hann-squared overlap-add normalisation (torch.istft(
center=True) semantics), and the slaney mel filterbank (torchaudio's
norm="slaney", mel_scale="slaney"); the JAX package's formulas, so the
two agree to rounding.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(n: int) -> np.ndarray:
    """The periodic Hann window of n samples."""
    return (0.5 - 0.5 * np.cos(2 * math.pi * np.arange(n) / n)).astype(np.float32)


@lru_cache(maxsize=16)
def _dft_bases(n_fft: int, win_length: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Hann-windowed real-DFT analysis bases, each (n_fft, n_fft // 2 + 1);
    a window shorter than n_fft sits centred in zeros."""
    w = hann_window(n_fft)
    if win_length is not None and win_length < n_fft:
        w = np.zeros(n_fft, np.float32)
        lo = (n_fft - win_length) // 2
        w[lo:lo + win_length] = hann_window(win_length)
    ang = 2 * math.pi * np.outer(np.arange(n_fft), np.arange(n_fft // 2 + 1)) / n_fft
    return (np.cos(ang) * w[:, None]).astype(np.float32), (-np.sin(ang) * w[:, None]).astype(np.float32)


@lru_cache(maxsize=16)
def _synthesis_bases(n_fft: int) -> Tuple[np.ndarray, np.ndarray]:
    """irfft as products: x_t = (1/n) [X_0 + 2 sum_mid Re(X_k e^{i 2 pi k t / n}) + X_nyq (-1)^t]."""
    F_ = n_fft // 2 + 1
    ang = 2 * math.pi * np.outer(np.arange(F_), np.arange(n_fft)) / n_fft
    scale = np.full((F_, 1), 2.0, np.float32)
    scale[0] = 1.0
    if n_fft % 2 == 0:
        scale[-1] = 1.0
    return ((np.cos(ang) * scale / n_fft).astype(np.float32),
            (-np.sin(ang) * scale / n_fft).astype(np.float32))


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(a).to(device=like.device, dtype=like.dtype)


def stft(x: torch.Tensor, n_fft: int, hop_length: int, win_length: Optional[int] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, T) -> (real, imag), each (B, n_frames, n_fft // 2 + 1), centred
    (reflect padding of n_fft // 2 each side); the window is win_length
    long (default n_fft)."""
    x = F.pad(x[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    frames = x.unfold(-1, n_fft, hop_length)
    cos_b, sin_b = _dft_bases(n_fft, win_length)
    return frames @ _const(cos_b, x), frames @ _const(sin_b, x)


def istft(real: torch.Tensor, imag: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """(real, imag) each (B, n_frames, n_fft // 2 + 1) -> (B, T), centred."""
    w_cos, w_sin = _synthesis_bases(n_fft)
    win = _const(hann_window(n_fft), real)
    frames = (real @ _const(w_cos, real) + imag @ _const(w_sin, real)) * win
    B, n_frames, _ = frames.shape
    T_full = n_fft + hop_length * (n_frames - 1)
    idx = (torch.arange(n_fft, device=real.device)[None, :]
           + hop_length * torch.arange(n_frames, device=real.device)[:, None]).reshape(-1)
    sig = torch.zeros(B, T_full, dtype=real.dtype, device=real.device)
    sig.index_add_(1, idx, frames.reshape(B, -1))
    wsq = torch.zeros(T_full, dtype=real.dtype, device=real.device)
    wsq.index_add_(0, idx, (win * win).repeat(n_frames))
    sig = sig / torch.clamp_min(wsq, 1e-11)
    return sig[:, n_fft // 2:T_full - n_fft // 2]


def _hz_to_mel_slaney(f):
    f = np.asarray(f, np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    logstep = math.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_hz / f_sp + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    f / f_sp)


def _mel_to_hz_slaney(m):
    m = np.asarray(m, np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, math.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), f_sp * m)


@lru_cache(maxsize=16)
def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: Optional[float] = None) -> np.ndarray:
    """(n_fft // 2 + 1, n_mels) slaney-normalised triangles on the slaney mel
    scale (librosa's and torchaudio's norm="slaney", mel_scale="slaney")."""
    fmax = fmax or sample_rate / 2
    mels = np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax), n_mels + 2)
    f_pts = _mel_to_hz_slaney(mels)
    freqs = np.linspace(0, sample_rate / 2, n_fft // 2 + 1)
    fb = np.zeros((len(freqs), n_mels))
    for m in range(n_mels):
        lo, ctr, hi = f_pts[m], f_pts[m + 1], f_pts[m + 2]
        up = (freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - freqs) / max(hi - ctr, 1e-10)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    fb *= (2.0 / (f_pts[2:n_mels + 2] - f_pts[:n_mels]))[None, :]
    return fb.astype(np.float32)


def mel_spectrogram(x: torch.Tensor, sample_rate: int, n_fft: int, win_length: int,
                    hop_length: int, n_mels: int, fmin: float = 0.0,
                    fmax: Optional[float] = None) -> torch.Tensor:
    """x (B, T) -> (B, n_frames, n_mels): the magnitude (power 1) of the
    centred STFT through the slaney filterbank (torchaudio's
    MelSpectrogram as BiCodec configures it)."""
    real, imag = stft(x, n_fft, hop_length, win_length)
    mag = torch.sqrt(real * real + imag * imag + 1e-24)
    return mag @ _const(mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax), x)
