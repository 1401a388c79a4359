"""STFT and inverse STFT as HiFT uses them (counterpart of the part of
rwkvtts_tpu/codecs/dsp.py it uses): a Hann window, the analysis as
products against windowed real-DFT bases (torch.stft(center=True,
onesided=True) semantics) and the synthesis with Hann-squared
overlap-add normalisation (torch.istft(center=True) semantics), the JAX
package's formulas, so the two agree to rounding.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(n: int) -> np.ndarray:
    """The periodic Hann window of n samples."""
    return (0.5 - 0.5 * np.cos(2 * math.pi * np.arange(n) / n)).astype(np.float32)


@lru_cache(maxsize=16)
def _dft_bases(n_fft: int) -> Tuple[np.ndarray, np.ndarray]:
    """Hann-windowed real-DFT analysis bases, each (n_fft, n_fft // 2 + 1)."""
    w = hann_window(n_fft)
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


def stft(x: torch.Tensor, n_fft: int, hop_length: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, T) -> (real, imag), each (B, n_frames, n_fft // 2 + 1), centred
    (reflect padding of n_fft // 2 each side)."""
    x = F.pad(x[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    frames = x.unfold(-1, n_fft, hop_length)
    cos_b, sin_b = _dft_bases(n_fft)
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
