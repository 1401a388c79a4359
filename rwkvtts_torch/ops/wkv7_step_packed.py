"""One WKV7 decode step over a batch of per-head states, in place
(counterpart of rwkvtts_tpu/ops/wkv7_step_pallas.py).

``wkv7_step_packed`` is the wrapper: tensors on a CUDA device launch the
hand-written kernel of ``csrc/wkv7_step.cu`` (which replaces the TPU kernel
``_step_kernel``), tensors on the CPU take ``wkv7_step_plain``. The state
keeps the natural (B, H, N, N) layout, row i the value dim and column j the
key dim; the TPU's head-pair lane packing (P, N, 2N) is a layout of its
vector registers and is not carried over (``bridge.wkv_to_packed`` converts
for the tests). The state is stepped in f32 and kept in its carry dtype,
f32 or bf16; y comes back in v's dtype.

With ``inplace`` (the slot pool's mode, as the TPU kernel's
``input_output_aliases={0: 0}``) the new state is written over the given
one and that same tensor is returned; without it a fresh buffer is.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from rwkvtts_torch import _build

N = 64  # the head size the CUDA kernel takes

# CUDA kernel launches made by wkv7_step_packed; reset_launches() zeroes it
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def wkv7_step_plain(
    state: torch.Tensor, r: torch.Tensor, w_raw: torch.Tensor, k: torch.Tensor,
    v: torch.Tensor, z: torch.Tensor, b: torch.Tensor, *, inplace: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The step in plain PyTorch. state (B, H, N, N); r..b (B, H, N).
    Everything in f32; the state is returned in its own dtype (a bf16
    carry stays bf16), y in v's dtype."""
    s = state.float()
    w = torch.exp(-torch.exp(w_raw.float()))
    r, k, vf, z, b = (x.float() for x in (r, k, v, z, b))
    sa = torch.einsum("bhij,bhj->bhi", s, z)
    s = s * w[:, :, None, :] + sa[..., None] * b[:, :, None, :] + vf[..., None] * k[:, :, None, :]
    y = torch.einsum("bhij,bhj->bhi", s, r)
    if inplace:
        state.copy_(s)
        return y.to(v.dtype), state
    return y.to(v.dtype), s.to(state.dtype)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # csrc/common.cuh DT_*


def wkv7_step_packed(
    state: torch.Tensor, r: torch.Tensor, w_raw: torch.Tensor, k: torch.Tensor,
    v: torch.Tensor, z: torch.Tensor, b: torch.Tensor, *, inplace: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step. Returns (y (B, H, N) in v's dtype, new state)."""
    dev = state.device.type
    if dev == "cpu":
        return wkv7_step_plain(state, r, w_raw, k, v, z, b, inplace=inplace)
    if dev != "cuda":
        raise ValueError(f"wkv7_step_packed: no implementation for device {state.device}")
    return _launch(state, r, w_raw, k, v, z, b, inplace)


def _launch(state, r, w_raw, k, v, z, b, inplace):
    global launches
    if state.dim() != 4 or state.shape[2:] != (N, N):
        raise ValueError(f"wkv7_step_packed: state is {tuple(state.shape)}, want (B, H, {N}, {N}) "
                         f"(the kernel takes head size {N})")
    if state.dtype not in _DTYPES or not state.is_contiguous():
        raise ValueError("wkv7_step_packed: state must be contiguous f32 or bf16")
    Bn, H = state.shape[:2]
    vecs = {"r": r, "w_raw": w_raw, "k": k, "v": v, "z": z, "b": b}
    for name, t in vecs.items():
        if (t.shape != (Bn, H, N) or t.dtype != v.dtype or t.device != state.device
                or not t.is_contiguous()):
            raise ValueError(f"wkv7_step_packed: {name} must be contiguous ({Bn}, {H}, {N}) "
                             f"{v.dtype} on {state.device}, got {tuple(t.shape)} {t.dtype}")
    if v.dtype not in _DTYPES:
        raise ValueError(f"wkv7_step_packed: r..b must be f32 or bf16, got {v.dtype}")
    out = state if inplace else torch.empty_like(state)
    y = torch.empty(Bn, H, N, dtype=v.dtype, device=state.device)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    err = _build.library().wkv7_step(
        _DTYPES[state.dtype], _DTYPES[v.dtype], Bn * H, ptr(state), ptr(out),
        *(ptr(t) for t in vecs.values()), ptr(y),
        ctypes.c_void_p(torch.cuda.current_stream(state.device).cuda_stream),
    )
    launches += 1
    _build.check(err, "wkv7_step")
    return y, out
