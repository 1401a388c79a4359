"""WKV7 whole-sequence forward through the hand-written CUDA kernel
``csrc/wkv7_fwd.cu``, which replaces the TPU kernel
rwkvtts_tpu/ops/wkv7_pallas.py::_fwd_kernel on its primal path.

Contract (that of ``wkv7_pallas`` without gradients): r, w_raw, k, v, z,
b are (B, T, H, 64) in one dtype (bf16 or f32); ``state`` is (B, H, 64,
64) f32 (rows the value dim) or None; ``resets`` is (B, T) bool or None.
Returns y in v's dtype and the final state in f32.

Tensors on the CPU take the plain version, ``ops/wkv7.py::wkv7_scan``.
Tensors on a CUDA device launch the kernel, or raise: there is no
fallback.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from rwkvtts_torch import _build
from rwkvtts_torch.ops.wkv7 import wkv7_scan

HEAD = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches made by wkv7_fwd; reset_launches() zeroes it
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def wkv7_fwd(
    r: torch.Tensor, w_raw: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    z: torch.Tensor, b: torch.Tensor,
    state: Optional[torch.Tensor] = None,
    resets: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    dev = r.device.type
    if dev == "cpu":
        return wkv7_scan(r, w_raw, k, v, z, b, state, resets)
    if dev != "cuda":
        raise ValueError(f"wkv7_fwd: no implementation for device {r.device}")
    return _launch(r, w_raw, k, v, z, b, state, resets)


def _launch(r, w_raw, k, v, z, b, state, resets):
    global launches
    B, T, H, N = r.shape
    if N != HEAD:
        raise ValueError(f"wkv7_fwd: head size {N}, the kernel takes {HEAD}")
    if r.dtype not in _DTYPES:
        raise TypeError(f"wkv7_fwd: dtype {r.dtype} (takes f32 or bf16)")
    for name, t in zip("rwkvzb", (r, w_raw, k, v, z, b)):
        if t.shape != r.shape or t.dtype != r.dtype or t.device != r.device:
            raise ValueError(f"wkv7_fwd: {name} is {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}; r is {tuple(r.shape)} {r.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"wkv7_fwd: {name} is not contiguous")
    if state is not None:
        if (state.shape != (B, H, N, N) or state.dtype != torch.float32
                or state.device != r.device or not state.is_contiguous()):
            raise ValueError("wkv7_fwd: state must be contiguous (B, H, 64, 64) f32 "
                             "on r's device")
    if resets is not None:
        if (resets.shape != (B, T) or resets.dtype != torch.bool
                or resets.device != r.device or not resets.is_contiguous()):
            raise ValueError("wkv7_fwd: resets must be contiguous (B, T) bool on "
                             "r's device")
    lib = _build.library()
    y = torch.empty_like(v)
    s_out = torch.empty(B, H, N, N, dtype=torch.float32, device=r.device)
    ptr = lambda t: None if t is None else ctypes.c_void_p(t.data_ptr())
    err = lib.wkv7_fwd(
        _DTYPES[r.dtype], B, T, H,
        *(ptr(t) for t in (r, w_raw, k, v, z, b, state, resets, y, s_out)),
        ctypes.c_void_p(torch.cuda.current_stream(r.device).cuda_stream),
    )
    _build.check(err, "wkv7_fwd")
    launches += 1
    return y, s_out
