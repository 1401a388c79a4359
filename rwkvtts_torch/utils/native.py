"""The port's host C++ components, built with g++ at first use and bound
through ctypes (counterpart of rwkvtts_tpu/utils/native.py):

  * ``csrc/world_tokenizer.cpp``: the world tokenizer's byte trie
    (``NativeTrieEncoder``, which every ``utils/tokenizer.WorldTokenizer``
    encodes through);
  * ``csrc/tar_stream.cpp``: the tar shard streamer with a reader thread
    and a bounded queue (``NativeTarStream``, which every reader of
    ``data/webdataset`` goes through).

These are host code, not GPU kernels: ``_build.sources()`` picks only the
``.cu`` / ``.cuh`` files, so the CUDA library's hash does not move with
them. Each library is named after a hash of its source and flags, and
built in a private directory, then renamed into ``csrc/build/``: a
concurrent or interrupted build never leaves a half-written library under
the final name. A build or load that fails raises; nothing falls back to a
Python path in its place (the Python versions serve only as the plain
versions the libraries are tested against).
"""
from __future__ import annotations

import atexit
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
import weakref
from pathlib import Path
from typing import Any, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
EXTRA_FLAGS = {"tar_stream": ("-pthread",), "world_tokenizer": ()}

# seconds the g++ run of each library took in this process (absent: none ran)
build_seconds: Dict[str, float] = {}
_LOCK = threading.Lock()


def _flags(name: str) -> Tuple[str, ...]:
    return (*GXX_FLAGS, *EXTRA_FLAGS[name])


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(_flags(name)).encode())
    h.update((CSRC / f"{name}.cpp").read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """g++ of csrc/<name>.cpp unless a library for this source exists."""
    out = library_path(name)
    if out.is_file():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: the native {name} library cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib = Path(tmp) / out.name
        cmd = [gxx, *GXX_FLAGS, "-o", str(lib), str(CSRC / f"{name}.cpp"), *EXTRA_FLAGS[name]]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {name}.cpp:\n{proc.stderr[-4000:]}")
        os.replace(lib, out)
    build_seconds[name] = time.perf_counter() - t0
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The library of csrc/<name>.cpp, built if needed; raises if it cannot
    be built or loaded."""
    with _LOCK:
        path = build(name)
    return ctypes.CDLL(str(path))


@functools.lru_cache(maxsize=1)
def _trie_lib() -> ctypes.CDLL:
    lib = load("world_tokenizer")
    lib.wt_create.restype = ctypes.c_void_p
    lib.wt_create.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.wt_encode.restype = ctypes.c_int64
    lib.wt_encode.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
                              ctypes.POINTER(ctypes.c_int32), ctypes.c_int64]
    lib.wt_destroy.argtypes = [ctypes.c_void_p]
    return lib


# wt_encode's code for an output buffer too small for the ids
_OVERFLOW = -1_000_000_000


class NativeTrieEncoder:
    """Greedy longest match over a byte trie (csrc/world_tokenizer.cpp)."""

    def __init__(self, vocab_items: Iterable[Tuple[int, bytes]]):
        """vocab_items: (id, token bytes) pairs."""
        self._lib = _trie_lib()
        blob = b"".join(int(tid).to_bytes(4, "little") + len(bs).to_bytes(4, "little") + bs
                        for tid, bs in vocab_items)
        self._h = self._lib.wt_create(blob, len(blob))
        if not self._h:
            raise RuntimeError("wt_create failed")

    def encode_bytes(self, src: bytes, cap: Optional[int] = None) -> List[int]:
        """The ids of `src`. `cap` sizes the output buffer (default: enough,
        one id a byte at most); the JAX wrapper's errors: RuntimeError when
        the ids overflow it, ValueError on a byte no token starts with."""
        cap = max(len(src), 16) if cap is None else cap
        out = (ctypes.c_int32 * cap)()
        n = int(self._lib.wt_encode(self._h, src, len(src), out, cap))
        if n == _OVERFLOW:
            raise RuntimeError("token buffer overflow")
        if n < 0:
            pos = -n - 1
            raise ValueError(f"unencodable byte {src[pos]:#x} at position {pos}")
        return list(out[:n])

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.wt_destroy(self._h)
            self._h = None


@functools.lru_cache(maxsize=1)
def _tar_lib() -> ctypes.CDLL:
    lib = load("tar_stream")
    lib.ts_open.restype = ctypes.c_void_p
    lib.ts_open.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32]
    lib.ts_next.restype = ctypes.c_int32
    lib.ts_next.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32,
                            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32)]
    lib.ts_errors.restype = ctypes.c_int64
    lib.ts_errors.argtypes = [ctypes.c_void_p]
    lib.ts_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    lib.ts_close.argtypes = [ctypes.c_void_p]
    return lib


_OPEN_TAR_STREAMS: "weakref.WeakSet[NativeTarStream]" = weakref.WeakSet()


@atexit.register
def _close_tar_streams() -> None:
    # join the reader threads before the interpreter tears down: a C++
    # thread still parsing while Python unloads crashes the exit
    for s in list(_OPEN_TAR_STREAMS):
        s.close()


class NativeTarStream:
    """The shards' regular members in archive order, read by a background
    thread (csrc/tar_stream.cpp) into a queue of `queue_cap` members."""

    def __init__(self, paths: Sequence[str], queue_cap: int = 64):
        self._lib = _tar_lib()
        self._errors = 0
        blob = "\n".join(str(p) for p in paths).encode()
        self._h = self._lib.ts_open(blob, len(blob), queue_cap)
        if not self._h:
            raise RuntimeError("ts_open failed")
        _OPEN_TAR_STREAMS.add(self)

    def __iter__(self) -> Iterator[Tuple[int, Optional[str], Any]]:
        """Yields (shard index, member name, bytes), and (shard index, None,
        cut) where a shard that failed its reads was abandoned, right after
        its last delivered member: `cut` names the member whose data was
        cut, or is None for a cut elsewhere (a header, padding, an
        unreadable file). The shard index keys sample grouping (equal
        basenames in two shards are two samples)."""
        name_buf = ctypes.create_string_buffer(4096)
        data_p = ctypes.POINTER(ctypes.c_uint8)()
        n = ctypes.c_int64()
        shard = ctypes.c_int32()
        while self._h:
            rc = self._lib.ts_next(self._h, name_buf, len(name_buf), ctypes.byref(data_p),
                                   ctypes.byref(n), ctypes.byref(shard))
            if rc == 0:
                return
            if rc == 2:
                yield shard.value, None, name_buf.value.decode("utf-8", "replace") or None
                continue
            try:
                data = ctypes.string_at(data_p, n.value)
            finally:
                self._lib.ts_free(data_p)
            yield shard.value, name_buf.value.decode("utf-8", "replace"), data

    @property
    def errors(self) -> int:
        """Shards abandoned so far (until close)."""
        return int(self._lib.ts_errors(self._h)) if self._h else self._errors

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._errors = int(self._lib.ts_errors(self._h))
            self._lib.ts_close(self._h)
            self._h = None

    def __enter__(self) -> "NativeTarStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        self.close()
