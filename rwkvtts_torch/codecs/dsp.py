"""STFT, inverse STFT and the mel spectrogram as HiFT and BiCodec use them
(counterpart of rwkvtts_tpu/codecs/dsp.py): a Hann window (zero-padded
to n_fft when shorter), the analysis as products against windowed
real-DFT bases (torch.stft(center=True, onesided=True) semantics), the
synthesis with Hann-squared overlap-add normalisation (torch.istft
semantics, centred or not), the mel filterbank (slaney-normalised on the
slaney scale, torchaudio's norm="slaney", mel_scale="slaney", or kaldi's
unnormalised HTK bins), the HiFi-GAN log-mel of the flow prompt, and the
antialiased linear resize of jax.image.resize; the JAX package's formulas,
so the two agree to rounding.
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


def stft(x: torch.Tensor, n_fft: int, hop_length: int, win_length: Optional[int] = None,
         center: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, T) -> (real, imag), each (B, n_frames, n_fft // 2 + 1), centred
    (reflect padding of n_fft // 2 each side) unless `center` is off; the
    window is win_length long (default n_fft)."""
    if center:
        x = F.pad(x[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    frames = x.unfold(-1, n_fft, hop_length)
    cos_b, sin_b = _dft_bases(n_fft, win_length)
    return frames @ _const(cos_b, x), frames @ _const(sin_b, x)


def istft(real: torch.Tensor, imag: torch.Tensor, n_fft: int, hop_length: int,
          center: bool = True) -> torch.Tensor:
    """(real, imag) each (B, n_frames, n_fft // 2 + 1) -> (B, T): the
    overlap-add of n_fft + hop (n_frames - 1) samples, trimmed by n_fft // 2
    each side when `center` (torch.istft(center=True), HiFT's and BiCodec's
    heads); uncentred, the whole overlap-add (the XY Vocos head trims it
    itself)."""
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
    return sig[:, n_fft // 2:T_full - n_fft // 2] if center else sig


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


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


@lru_cache(maxsize=16)
def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: Optional[float] = None, norm: str = "slaney",
                   mel_scale: str = "slaney") -> np.ndarray:
    """(n_fft // 2 + 1, n_mels) triangles on the slaney (or "htk") mel
    scale, slaney-normalised unless norm="none": librosa's and
    torchaudio's norm="slaney", mel_scale="slaney" (BiCodec, HiFT,
    whisper), or kaldi's fbank bins (norm="none", mel_scale="htk")."""
    fmax = fmax or sample_rate / 2
    to_mel, to_hz = ((_hz_to_mel_slaney, _mel_to_hz_slaney) if mel_scale == "slaney"
                     else (_hz_to_mel_htk, _mel_to_hz_htk))
    f_pts = to_hz(np.linspace(to_mel(fmin), to_mel(fmax), n_mels + 2))
    freqs = np.linspace(0, sample_rate / 2, n_fft // 2 + 1)
    fb = np.zeros((len(freqs), n_mels))
    for m in range(n_mels):
        lo, ctr, hi = f_pts[m], f_pts[m + 1], f_pts[m + 2]
        up = (freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - freqs) / max(hi - ctr, 1e-10)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    if norm == "slaney":
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


def log_mel_hifigan(x: torch.Tensor, sample_rate: int = 24000, n_fft: int = 1920,
                    win_length: int = 1920, hop_length: int = 480, n_mels: int = 80,
                    fmin: float = 0.0, fmax: Optional[float] = 8000.0) -> torch.Tensor:
    """The HiFi-GAN / matcha log-mel, the CosyVoice2 flow prompt's feature:
    reflect padding of (n_fft - hop) / 2 each side, an uncentred STFT, the
    magnitude (+1e-9 under the root), the slaney mel, ln(clamp(mel, 1e-5)).
    x (B, T) -> (B, frames, n_mels)."""
    pad = (n_fft - hop_length) // 2
    x = F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    real, imag = stft(x, n_fft, hop_length, win_length, center=False)
    mag = torch.sqrt(real * real + imag * imag + 1e-9)
    mel = mag @ _const(mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax), x)
    return torch.log(torch.clamp_min(mel, 1e-5))


def resize_linear(x: torch.Tensor, n_out: int) -> torch.Tensor:
    """x (B, T, C) resized along T to n_out frames as jax.image.resize(...,
    "linear") does it (antialias on): output frame i samples the input at
    s = (i + 0.5) T / n_out - 0.5 through a triangle kernel widened by
    T / n_out when shrinking; the weights of each output frame are
    normalised over the input frames and zero where s falls outside
    [-0.5, T - 0.5]. F.interpolate has no antialias for 1-D."""
    T = x.shape[1]
    inv = T / n_out
    s = (np.arange(n_out) + 0.5) * inv - 0.5
    w = np.maximum(0.0, 1.0 - np.abs(s[None, :] - np.arange(T)[:, None]) / max(inv, 1.0))
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1.0), 0.0)
    w = np.where((s >= -0.5) & (s <= T - 0.5), w, 0.0)  # (T, n_out)
    return torch.einsum("btc,to->boc", x, torch.from_numpy(w.astype(np.float32)).to(x))
