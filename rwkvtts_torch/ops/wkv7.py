"""WKV7, the RWKV-7 time-mix recurrence (counterpart of
rwkvtts_tpu/ops/wkv7.py).

Per 64-dim head and step, state S (N_v x N_k) f32, rows the value dim:

    w_t  = exp(-exp(w_raw_t))
    sa_t = S_{t-1} @ z_t
    S_t  = S_{t-1} * w_t[None, :] + sa_t[:, None] * b_t[None, :] + v_t[:, None] * k_t[None, :]
    y_t  = S_t @ r_t

``wkv7_scan`` is the plain version of the whole-sequence forward (the CPU
path and the reference the CUDA kernel is held to); ``wkv7`` is what the
model calls: it goes through ``ops/wkv7_cuda.py``, which launches the CUDA
kernel for tensors on a CUDA device and runs ``wkv7_scan`` for tensors on
the CPU.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def decay_from_raw(w_raw: torch.Tensor) -> torch.Tensor:
    """w = exp(-exp(w_raw)); w_raw is the soft-clamped log-log decay."""
    return torch.exp(-torch.exp(w_raw.float()))


def init_state(batch: int, n_head: int, head_size: int, device=None) -> torch.Tensor:
    return torch.zeros(batch, n_head, head_size, head_size, dtype=torch.float32,
                       device=device)


def wkv7_scan(
    r: torch.Tensor, w_raw: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    z: torch.Tensor, b: torch.Tensor,
    state: Optional[torch.Tensor] = None,
    resets: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-step loop. Inputs (B, T, H, N); state (B, H, N, N) f32; resets
    (B, T) bool (the state is zeroed before a position whose flag is set).

    Returns (y in v's dtype, final state f32)."""
    B, T, H, N = r.shape
    out_dtype = v.dtype
    s = init_state(B, H, N, r.device) if state is None else state.float()
    w = decay_from_raw(w_raw)
    r, k, v, z, b = (x.float() for x in (r, k, v, z, b))
    ys = []
    for t in range(T):
        if resets is not None:
            s = torch.where(resets[:, t, None, None, None], 0.0, s)
        sa = torch.einsum("bhij,bhj->bhi", s, z[:, t])
        s = (
            s * w[:, t, :, None, :]
            + sa[..., None] * b[:, t, :, None, :]
            + v[:, t, ..., None] * k[:, t, :, None, :]
        )
        ys.append(torch.einsum("bhij,bhj->bhi", s, r[:, t]))
    y = torch.stack(ys, 1) if ys else torch.zeros_like(v)
    return y.to(out_dtype), s


def wkv7_step(
    state: torch.Tensor, r: torch.Tensor, w_raw: torch.Tensor, k: torch.Tensor,
    v: torch.Tensor, z: torch.Tensor, b: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step. state (B, H, N, N); r..b (B, H, N). The state is
    stepped in f32 and returned in its own dtype (a bf16 carry stays
    bf16). Returns (y in v's dtype, new state)."""
    s = state.float()
    w = decay_from_raw(w_raw)
    r, k, vf, z, b = (x.float() for x in (r, k, v, z, b))
    sa = torch.einsum("bhij,bhj->bhi", s, z)
    s = s * w[:, :, None, :] + sa[..., None] * b[:, :, None, :] + vf[..., None] * k[:, :, None, :]
    y = torch.einsum("bhij,bhj->bhi", s, r)
    return y.to(v.dtype), s.to(state.dtype)


def wkv7(
    r: torch.Tensor, w_raw: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    z: torch.Tensor, b: torch.Tensor,
    state: Optional[torch.Tensor] = None,
    resets: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whole-sequence WKV7 as the model calls it: the CUDA kernel on a CUDA
    device, ``wkv7_scan`` on the CPU (see ops/wkv7_cuda.py)."""
    from rwkvtts_torch.ops import wkv7_cuda

    return wkv7_cuda.wkv7_fwd(r, w_raw, k, v, z, b, state, resets)
