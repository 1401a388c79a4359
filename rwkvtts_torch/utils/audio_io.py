"""Host-side audio IO: WAV read/write (stdlib), resampling (scipy),
volume normalization (a copy of rwkvtts_tpu/utils/audio_io.py).

Replaces the reference's soundfile/soxr path
(third_party/sparktts/utils/audio.py:33-120) with torch-free equivalents.
"""
from __future__ import annotations

import wave
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np


def audio_volume_normalize(audio: np.ndarray, coeff: float = 0.2) -> np.ndarray:
    """Percentile-based loudness normalization (parity with
    sparktts/utils/audio.py:33-74)."""
    temp = np.sort(np.abs(audio))
    if temp[-1] < 0.1:
        audio = audio / max(temp[-1], 1e-3) * 0.1
        temp = np.sort(np.abs(audio))
    temp = temp[temp > 0.01]
    L = temp.shape[0]
    if L <= 10:
        return audio
    volume = np.mean(temp[int(0.9 * L) : int(0.99 * L)])
    audio = audio * np.clip(coeff / volume, 0.1, 10)
    max_value = np.max(np.abs(audio))
    if max_value > 1:
        audio = audio / max_value
    return audio


def resample(audio: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    if sr_in == sr_out:
        return audio
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(sr_in, sr_out)
    return resample_poly(audio, sr_out // g, sr_in // g).astype(np.float32)


def load_wav(
    path: Union[str, Path],
    sampling_rate: Optional[int] = None,
    volume_normalize: bool = False,
) -> np.ndarray:
    """Read a (PCM) WAV file to float32 mono in [-1, 1]."""
    with wave.open(str(path), "rb") as w:
        return _decode_wave(w, sampling_rate, volume_normalize)


def load_wav_bytes(
    data: bytes,
    sampling_rate: Optional[int] = None,
    volume_normalize: bool = False,
) -> np.ndarray:
    """Decode in-memory WAV bytes (webdataset/parquet audio cells) to
    float32 mono — the torch-free replacement for the reference's
    `sf.read(io.BytesIO(...))` (data/utils/create_lm_corpus_from_raw.py:77-80)."""
    import io

    with wave.open(io.BytesIO(data), "rb") as w:
        return _decode_wave(w, sampling_rate, volume_normalize)


def _decode_wave(
    w: "wave.Wave_read",
    sampling_rate: Optional[int],
    volume_normalize: bool,
) -> np.ndarray:
    sr = w.getframerate()
    n = w.getnframes()
    width = w.getsampwidth()
    channels = w.getnchannels()
    raw = w.readframes(n)
    if width == 2:
        audio = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        audio = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        audio = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if channels > 1:
        audio = audio.reshape(-1, channels)[:, 0]
    if sampling_rate is not None and sr != sampling_rate:
        audio = resample(audio, sr, sampling_rate)
    if volume_normalize:
        audio = audio_volume_normalize(audio)
    return audio.astype(np.float32)


def save_wav(path: Union[str, Path], audio: np.ndarray, sampling_rate: int) -> None:
    """Write float32 [-1, 1] mono audio as 16-bit PCM WAV."""
    audio = np.clip(np.asarray(audio, np.float32), -1.0, 1.0)
    pcm = (audio * 32767.0).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sampling_rate)
        w.writeframes(pcm.tobytes())
