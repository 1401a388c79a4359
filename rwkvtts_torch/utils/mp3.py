"""MP3 encoding via a ctypes binding of the system libmp3lame (counterpart
of rwkvtts_tpu/utils/mp3.py).

The reference service answers in wav or mp3 (its service/
rwkv_tts_service.py:72-99, the `audio_format` field). No Python mp3
package is needed: the system's libmp3lame.so.0 is bound directly through
ctypes. Where the library is absent, ``encode_mp3`` raises RuntimeError
and the server answers wav only.
"""
from __future__ import annotations

import ctypes
import ctypes.util
from typing import Optional

import numpy as np

_LAME_NAMES = ("libmp3lame.so.0", "libmp3lame.so", "mp3lame")
_lame: Optional[ctypes.CDLL] = None
_checked = False

# lame.h vbr_mode / MPEG_mode constants
_MODE_MONO = 3
_MODE_JOINT_STEREO = 1


def _load() -> Optional[ctypes.CDLL]:
    global _lame, _checked
    if _checked:
        return _lame
    _checked = True
    for name in _LAME_NAMES:
        path = name if name.startswith("lib") else ctypes.util.find_library(name)
        if not path:
            continue
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            continue
        lib.lame_init.restype = ctypes.c_void_p
        for fn, args in (
            ("lame_set_in_samplerate", (ctypes.c_void_p, ctypes.c_int)),
            ("lame_set_out_samplerate", (ctypes.c_void_p, ctypes.c_int)),
            ("lame_set_num_channels", (ctypes.c_void_p, ctypes.c_int)),
            ("lame_set_mode", (ctypes.c_void_p, ctypes.c_int)),
            ("lame_set_brate", (ctypes.c_void_p, ctypes.c_int)),
            ("lame_set_quality", (ctypes.c_void_p, ctypes.c_int)),
            ("lame_init_params", (ctypes.c_void_p,)),
            ("lame_close", (ctypes.c_void_p,)),
        ):
            getattr(lib, fn).argtypes = list(args)
            getattr(lib, fn).restype = ctypes.c_int
        lib.lame_encode_buffer.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_short), ctypes.POINTER(ctypes.c_short),
            ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
        ]
        lib.lame_encode_buffer.restype = ctypes.c_int
        lib.lame_encode_flush.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
        ]
        lib.lame_encode_flush.restype = ctypes.c_int
        _lame = lib
        break
    return _lame


def available() -> bool:
    return _load() is not None


def encode_mp3(
    wav: np.ndarray, sample_rate: int, bitrate_kbps: int = 128,
    quality: int = 2,
) -> bytes:
    """float32 mono wav in [-1, 1] -> MP3 bytes (CBR).

    Raises RuntimeError when libmp3lame is absent — callers surface that
    as an explicit wav-only API response.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "mp3 encoding unavailable: libmp3lame not found on this host "
            "(the service supports wav responses only)"
        )
    wav = np.asarray(wav, np.float32).reshape(-1)
    pcm = np.clip(wav * 32767.0, -32768, 32767).astype(np.int16)

    gfp = lib.lame_init()
    if not gfp:
        raise RuntimeError("lame_init failed")
    try:
        lib.lame_set_in_samplerate(gfp, int(sample_rate))
        lib.lame_set_out_samplerate(gfp, int(sample_rate))
        lib.lame_set_num_channels(gfp, 1)
        lib.lame_set_mode(gfp, _MODE_MONO)
        lib.lame_set_brate(gfp, int(bitrate_kbps))
        lib.lame_set_quality(gfp, int(quality))
        if lib.lame_init_params(gfp) < 0:
            raise RuntimeError(
                f"lame_init_params rejected sample_rate={sample_rate}"
            )
        # lame.h guidance: mp3buf_size >= 1.25 * n + 7200
        out = bytearray()
        chunk = 64 * 1024
        buf_size = int(1.25 * chunk) + 7200
        buf = ctypes.create_string_buffer(buf_size)
        for start in range(0, len(pcm), chunk):
            seg = np.ascontiguousarray(pcm[start : start + chunk])
            n = lib.lame_encode_buffer(
                gfp,
                seg.ctypes.data_as(ctypes.POINTER(ctypes.c_short)),
                None,
                len(seg), buf, buf_size,
            )
            if n < 0:
                raise RuntimeError(f"lame_encode_buffer error {n}")
            out += buf.raw[:n]
        n = lib.lame_encode_flush(gfp, buf, buf_size)
        if n < 0:
            raise RuntimeError(f"lame_encode_flush error {n}")
        out += buf.raw[:n]
        return bytes(out)
    finally:
        lib.lame_close(gfp)
