"""Build-on-demand for the package's CUDA kernels, bound through ctypes.

Every ``csrc/*.cu`` file is compiled to an object by its own ``nvcc``
process, all started together, and one more ``nvcc`` call links the
objects into a shared library with a plain C interface (no PyTorch
headers, so the build takes seconds, not minutes), loaded with
``ctypes``. The library is cached in ``csrc/build/`` under a hash of the
sources and flags, so an edited kernel rebuilds and an unchanged one loads
at once.

The build is never attempted at import time: the first kernel launch asks
for the library. Without ``nvcc`` the call raises; no caller falls back to
another implementation when that happens.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# seconds the nvcc run of this process took (0.0 while none ran)
last_build_seconds = 0.0


def sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
        "rwkvtts_torch cannot be built on this machine"
    )


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"librwkvtts_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists.

    Writes nvcc's output (ptxas register and shared-memory counts) beside
    the library as ``<lib>.log``."""
    global last_build_seconds
    out = library_path()
    if out.is_file():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # everything goes to a private directory, then the library is renamed:
    # a concurrent or interrupted build never leaves a half-written library
    # under the final name
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        cmds, procs = [], []
        for src in (p for p in sources() if p.suffix == ".cu"):
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                   "-o", str(Path(tmp) / (src.stem + ".o"))]
            cmds.append(cmd)
            procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
        objs = [c[-1] for c in cmds]
        link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(Path(tmp) / "lib.so"), *objs]
        log, failed = [], []
        for cmd, proc in zip(cmds, procs):
            text = proc.communicate()[0]
            log.append(" ".join(cmd) + "\n" + text)
            if proc.returncode != 0:
                failed.append(text)
        if not failed:
            proc = subprocess.run(link, capture_output=True, text=True)
            log.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(proc.stderr)
        out.with_suffix(".log").write_text("".join(log))
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed)[-4000:])
        os.replace(Path(tmp) / "lib.so", out)
    last_build_seconds = time.perf_counter() - t0
    return out


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C entry points and their argument types (each returns cudaError_t as int)
_SIGNATURES = {
    "wkv7_fwd": [
        _I, _I, _I, _I,              # dtype, B, T, H
        _P, _P, _P, _P, _P, _P,      # r, w_raw, k, v, z, b
        _P, _P,                      # s0, resets
        _P, _P,                      # y, s_out
        _P,                          # anchors (training; null for the primal)
        _P,                          # stream
    ],
    "wkv7_bwd": [
        _I, _I, _I, _I,              # dtype, B, T, H
        _P, _P, _P, _P, _P, _P,      # r, w_raw, k, v, z, b
        _P, _P, _P,                  # s0, resets, anchors
        _P, _P,                      # dy, dsfin
        _P, _P, _P, _P, _P, _P,      # dr, dw_raw, dk, dv, dz, db
        _P,                          # ds0
        _P,                          # stream
    ],
    "wkv7_fused_fwd": [
        _I, _I, _I, _I, _F,          # dtype, B, T, H, ln_eps
        _P, _P, _P, _P, _P,          # r, w_raw, k_raw, v, a
        _P, _P, _P, _P, _P,          # k_k, k_a, r_k, ln_w, ln_b
        _P, _P,                      # s0, resets
        _P, _P,                      # y, s_out
        _P,                          # anchors (training; null for the primal)
        _P,                          # stream
    ],
    "wkv7_fused_bwd": [
        _I, _I, _I, _I, _F,          # dtype, B, T, H, ln_eps
        _P, _P, _P, _P, _P,          # r, w_raw, k_raw, v, a
        _P, _P, _P, _P,              # k_k, k_a, r_k, ln_w
        _P, _P, _P,                  # s0, resets, anchors
        _P, _P,                      # dy, dsfin
        _P, _P, _P, _P, _P,          # dr, dw_raw, dk_raw, dv, da
        _P, _P,                      # dparams, ds0
        _P,                          # stream
    ],
    "wkv7_step": [
        _I, _I, _I,                  # state dtype, dtype, B * H
        _P, _P,                      # s_in, s_out (may be the same buffer)
        _P, _P, _P, _P, _P, _P,      # r, w_raw, k, v, z, b
        _P,                          # y
        _P,                          # stream
    ],
    "decode_b64_step": [
        _I, _I, _I, _F, _F,          # L, C, B, norm_eps, ln_x_eps
        _P, _P, _P, _P,              # x, h_out, ln0 (scale, bias)
        _P, _P,                      # ln_out (scale, bias)
        _P, _P, _P, _P, _P, _P,      # rkv_q/s, li_q/s, lo_q/s
        _P, _P, _P, _P, _P, _P,      # out_q/s, fk_q/s, fv_q/s
        _P,                          # smalls
        _P, _P, _P,                  # att_x, ffn_x, wkv (updated in place)
        _P,                          # workspace
        ctypes.POINTER(_I),          # K pieces of the 5 products (launch plan)
        _I,                          # programmatic dependent launch (1) or not (0)
        ctypes.POINTER(_I),          # launch counts by kernel (3 ints, increased)
        _P,                          # stream
    ],
    "decode_b1_step": [
        _I, _I, _I, _F, _F,          # L, C, state dtype, norm_eps, ln_x_eps
        _P, _P, _P, _P,              # x, h_out, ln0 (scale, bias)
        _P, _P,                      # ln_out (scale, bias)
        _P, _P, _P, _P, _P,          # rkv_q/s, li_q/s, lo (bf16)
        _P, _P, _P, _P, _P, _P,      # out_q/s, fk_q/s, fv_q/s
        _P,                          # smalls
        _P, _P, _P,                  # att_x, ffn_x, wkv (updated in place)
        _P,                          # workspace
        ctypes.POINTER(_I),          # K pieces of the 4 int8 products (launch plan)
        _I,                          # programmatic dependent launch (1) or not (0)
        ctypes.POINTER(_I),          # launch counts by kernel (3 ints, increased)
        _P,                          # stream
    ],
}


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    lib.decode_b64_workspace_bytes.argtypes = [ctypes.c_int]
    lib.decode_b64_workspace_bytes.restype = ctypes.c_size_t
    lib.decode_b1_workspace_bytes.argtypes = [ctypes.c_int]
    lib.decode_b1_workspace_bytes.restype = ctypes.c_size_t
    lib.decode_b1_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.decode_b1_smem_bytes.restype = ctypes.c_int
    for name in ("decode_b64_gemm_smem_bytes", "wkv7_fused_smem_bytes", "wkv7_bwd_smem_bytes",
                 "wkv7_fwd_smem_bytes"):
        getattr(lib, name).argtypes = [ctypes.c_int]
        getattr(lib, name).restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = library().cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
