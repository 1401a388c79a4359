"""WKV7 through the hand-written CUDA kernels (counterpart of
rwkvtts_tpu/ops/wkv7_pallas.py): ``wkv7_fwd`` and ``wkv7`` over
``csrc/wkv7_fwd.cu`` and ``csrc/wkv7_bwd.cu``, which replace the TPU kernels
``_fwd_kernel`` and ``_bwd_kernel``; ``wkv7_fused`` over
``csrc/wkv7_fused.cu``, which replaces ``_fwd_kernel_fused`` and
``_bwd_kernel_fused``.

Contracts (those of ``wkv7_pallas`` and ``wkv7_pallas_fused``): r, w_raw,
k, v, z, b (or r, w_raw, k_raw, v, a) are (B, T, H, 64) in one dtype
(bf16 or f32); the fused variant's k_k, k_a, r_k, ln_w, ln_b are (H, 64);
``state`` is (B, H, 64, 64) f32 (rows the value dim) or None; ``resets``
is (B, T) bool or None. Both return y in v's dtype and the final state in
f32, and are differentiable: the input gradients come back in the input
dtypes, the per-head ones as (H, 64) f32 and the state's in f32.

All four kernels work in chunks of 16 steps on the tensor cores
(csrc/wkv7_chunk.cuh), a CTA a (b, h). The forwards save, for
training, only the state after every 16th step (the anchors); the
backwards recompute each chunk from it, so they are exact for any decay
whose chunk sum stays in f32's range. ``fwd_plan``, ``bwd_plan`` and
``fused_plan`` are their launch arithmetic.

Tensors on the CPU take the plain versions under autograd
(``ops/wkv7.py::wkv7_scan`` and ``wkv7_fused_plain``). Tensors on a CUDA
device launch the kernels, or raise: there is no fallback.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from rwkvtts_torch import _build
from rwkvtts_torch.ops.wkv7 import wkv7_fused_plain, wkv7_scan

HEAD = 64
CHUNK = 16  # steps between the states the training forward saves (csrc/wkv7_core.cuh)
THREADS = 256  # threads a CTA of the chunked kernels (csrc/wkv7_chunk.cuh NT)
SMEM_LIMIT = 232448  # shared memory bytes a CTA may take on the H100
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches by C entry point; reset_launches() zeroes them
launches = {"wkv7_fwd": 0, "wkv7_bwd": 0, "wkv7_fused_fwd": 0, "wkv7_fused_bwd": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _launch(name: str, like: torch.Tensor, *args) -> None:
    """Call the C entry point `name` on the current stream of `like`'s
    device, raise on a CUDA error, count the launch."""
    fn = getattr(_build.library(), name)
    _build.check(fn(*args, _stream(like)), name)
    launches[name] += 1


def _check(what: str, seq: dict, state, resets, params: Optional[dict] = None) -> None:
    """Refuse what the kernels do not take: one shape, dtype and device for
    the sequence inputs, head size 64, contiguous tensors."""
    ref = next(iter(seq.values()))
    B, T, H, N = ref.shape
    if N != HEAD:
        raise ValueError(f"{what}: head size {N}, the kernel takes {HEAD}")
    if ref.dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {ref.dtype} (takes f32 or bf16)")
    for name, t in seq.items():
        if t.shape != ref.shape or t.dtype != ref.dtype or t.device != ref.device:
            raise ValueError(f"{what}: {name} is {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}; r is {tuple(ref.shape)} {ref.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
    for name, t in (params or {}).items():
        if (t.shape != (H, N) or t.dtype != torch.float32 or t.device != ref.device
                or not t.is_contiguous()):
            raise ValueError(f"{what}: {name} must be contiguous ({H}, {N}) f32 on r's device")
    if state is not None:
        if (state.shape != (B, H, N, N) or state.dtype != torch.float32
                or state.device != ref.device or not state.is_contiguous()):
            raise ValueError(f"{what}: state must be contiguous (B, H, 64, 64) f32 "
                             "on r's device")
    if resets is not None:
        if (resets.shape != (B, T) or resets.dtype != torch.bool
                or resets.device != ref.device or not resets.is_contiguous()):
            raise ValueError(f"{what}: resets must be contiguous (B, T) bool on "
                             "r's device")


def _device(what: str, t: torch.Tensor) -> str:
    dev = t.device.type
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no implementation for device {t.device}")
    return dev


def _chunk_tiles():
    """Floats of csrc/wkv7_chunk.cuh's tiles: a chunk's [16][64] vectors,
    a [64][64] state and a 16 x 16 matrix, rows padded by 4."""
    ld, ldm = HEAD + 4, CHUNK + 4
    return CHUNK * ld, HEAD * ld, CHUNK * ldm


def _plan(what: str, B: int, T: int, H: int, smem: dict) -> dict:
    if T < 1 or B < 1 or H < 1:
        raise ValueError(f"{what}: B={B}, T={T}, H={H}: every size must be >= 1")
    if B * H > 2**31 - 1:
        raise ValueError(f"{what}: B * H = {B * H} CTAs, more than a grid holds")
    for name, n in smem.items():
        if n > SMEM_LIMIT:
            raise ValueError(f"{what}: the {name} takes {n} bytes of shared memory, "
                             f"the card gives {SMEM_LIMIT}")
    return {"chunk": CHUNK, "n_chunks": -(-T // CHUNK), "grid": B * H, "threads": THREADS}


def fwd_plan(B: int, T: int, H: int, dtype: torch.dtype = torch.bfloat16) -> dict:
    """The launch arithmetic of csrc/wkv7_fwd.cu (its constants in
    csrc/wkv7_chunk.cuh): one CTA of 256 threads a (b, h) walking
    ceil(T / 16) chunks, and its shared memory bytes for inputs of `dtype`:
    the f32 tiles of the fused forward (FWD_FLOATS) and the 6 step inputs of
    two chunks (the library's ``wkv7_fwd_smem_bytes`` gives the same on the
    card); two CTAs fit an SM in bf16. Raises ValueError for what the kernel
    cannot take."""
    vec, st, mat = _chunk_tiles()
    esize = torch.empty(0, dtype=dtype).element_size()
    smem = 4 * (12 * vec + st + 5 * mat + 5 * HEAD + 2 * CHUNK) + 2 * 6 * CHUNK * HEAD * esize
    return {**_plan("wkv7_fwd", B, T, H, {"forward": smem}), "smem_bytes": smem}


def fused_plan(B: int, T: int, H: int) -> dict:
    """The launch arithmetic of csrc/wkv7_fused.cu (its constants in
    csrc/wkv7_chunk.cuh): one CTA of 256 threads a (b, h) walking
    ceil(T / 16) chunks, and the shared memory bytes each kernel's CTA takes
    (the library's ``wkv7_fused_smem_bytes`` gives the same on the card).
    Raises ValueError for what the kernels cannot take."""
    vec, st, mat = _chunk_tiles()
    fwd = 4 * (12 * vec + st + 5 * mat + 5 * HEAD + 2 * CHUNK)
    bwd = 4 * (20 * vec + 4 * st + 9 * mat + 6 * HEAD + 3 * CHUNK)
    plan = _plan("wkv7_fused", B, T, H, {"forward": fwd, "backward": bwd})
    return {**plan, "fwd_smem_bytes": fwd, "bwd_smem_bytes": bwd}


def bwd_plan(B: int, T: int, H: int, dtype: torch.dtype = torch.bfloat16) -> dict:
    """The launch arithmetic of csrc/wkv7_bwd.cu (its constants in
    csrc/wkv7_chunk.cuh, UNFUSED_BWD_*): one CTA of 256 threads a (b, h)
    walking ceil(T / 16) chunks backward, and its shared memory bytes for
    inputs of `dtype`: the f32 tiles and the 7 step inputs of two chunks
    (the library's ``wkv7_bwd_smem_bytes`` gives the same on the card).
    Raises ValueError for what the kernel cannot take."""
    vec, st, mat = _chunk_tiles()
    esize = torch.empty(0, dtype=dtype).element_size()
    smem = 4 * (19 * vec + 4 * st + 9 * mat + 6 * HEAD + 2 * CHUNK) + 2 * 7 * CHUNK * HEAD * esize
    return {**_plan("wkv7_bwd", B, T, H, {"backward": smem}), "smem_bytes": smem}


def _saved_states(B: int, T: int, H: int, like: torch.Tensor) -> torch.Tensor:
    """What the training forward saves for the backward: the anchors, the
    state after every 16th step and after the last, (B, H, ceil(T/16), 64,
    64) f32. Nothing is saved a step."""
    return torch.empty(B, H, -(-T // CHUNK), HEAD, HEAD, dtype=torch.float32,
                       device=like.device)


# ---------------------------------------------------------------------------
# WKV7 (wkv7_fwd.cu + wkv7_bwd.cu)
# ---------------------------------------------------------------------------


def wkv7_fwd(
    r: torch.Tensor, w_raw: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    z: torch.Tensor, b: torch.Tensor,
    state: Optional[torch.Tensor] = None,
    resets: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward primal (no gradient, nothing saved): y and the final
    state, through the kernel on a CUDA device, ``wkv7_scan`` on the CPU."""
    if _device("wkv7_fwd", r) == "cpu":
        return wkv7_scan(r, w_raw, k, v, z, b, state, resets)
    return _fwd(r, w_raw, k, v, z, b, state, resets, save=False)[:2]


def _fwd(r, w_raw, k, v, z, b, state, resets, save: bool):
    _check("wkv7_fwd", dict(r=r, w_raw=w_raw, k=k, v=v, z=z, b=b), state, resets)
    B, T, H, N = r.shape
    fwd_plan(B, T, H, r.dtype)  # refuses what the kernel cannot take
    y = torch.empty_like(v)
    s_out = torch.empty(B, H, N, N, dtype=torch.float32, device=r.device)
    anchors = _saved_states(B, T, H, r) if save else None
    _launch("wkv7_fwd", r, _DTYPES[r.dtype], B, T, H,
            *map(_ptr, (r, w_raw, k, v, z, b, state, resets, y, s_out, anchors)))
    return y, s_out, anchors


class WKV7(torch.autograd.Function):
    """``wkv7`` on CUDA tensors: the forward kernel, saving the chunk-boundary
    states when a gradient is needed, and the chunked backward kernel, which
    recomputes each chunk from them."""

    @staticmethod
    def forward(ctx, r, w_raw, k, v, z, b, state, resets):
        save = any(ctx.needs_input_grad[:7])
        y, s_out, anchors = _fwd(r, w_raw, k, v, z, b, state, resets, save)
        if save:
            ctx.save_for_backward(r, w_raw, k, v, z, b, state, resets, anchors)
        ctx.set_materialize_grads(False)
        return y, s_out

    @staticmethod
    def backward(ctx, dy, dsfin):
        r, w_raw, k, v, z, b, state, resets, anchors = ctx.saved_tensors
        B, T, H, N = r.shape
        bwd_plan(B, T, H, r.dtype)
        dy = torch.zeros_like(v) if dy is None else dy.to(v.dtype).contiguous()
        dsfin = None if dsfin is None else dsfin.float().contiguous()
        grads = [torch.empty_like(x) for x in (r, w_raw, k, v, z, b)]
        ds0 = torch.empty_like(state) if ctx.needs_input_grad[6] else None
        _launch("wkv7_bwd", r, _DTYPES[r.dtype], B, T, H,
                *map(_ptr, (r, w_raw, k, v, z, b, state, resets, anchors, dy, dsfin,
                            *grads, ds0)))
        return (*grads, ds0, None)


def wkv7(
    r: torch.Tensor, w_raw: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    z: torch.Tensor, b: torch.Tensor,
    state: Optional[torch.Tensor] = None,
    resets: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable WKV7: ``WKV7`` on a CUDA device, ``wkv7_scan`` under
    autograd on the CPU."""
    if _device("wkv7", r) == "cpu":
        return wkv7_scan(r, w_raw, k, v, z, b, state, resets)
    if r.shape[1] == 0:
        raise ValueError("wkv7: empty sequence")
    r, w_raw, k, v, z, b = (x.contiguous() for x in (r, w_raw, k, v, z, b))
    return WKV7.apply(r, w_raw, k, v, z, b, state, resets)


# ---------------------------------------------------------------------------
# WKV7 with the fused elementwise band (wkv7_fused.cu)
# ---------------------------------------------------------------------------


def _fused_fwd(r, w_raw, k_raw, v, a, prm, state, resets, ln_eps, save: bool):
    _check("wkv7_fused", dict(r=r, w_raw=w_raw, k_raw=k_raw, v=v, a=a), state, resets,
           dict(zip(("k_k", "k_a", "r_k", "ln_w", "ln_b"), prm)))
    B, T, H, N = r.shape
    plan = fused_plan(B, T, H)
    y = torch.empty_like(v)
    s_out = torch.empty(B, H, N, N, dtype=torch.float32, device=r.device)
    anchors = (torch.empty(B, H, plan["n_chunks"], N, N, dtype=torch.float32, device=r.device)
               if save else None)
    _launch("wkv7_fused_fwd", r, _DTYPES[r.dtype], B, T, H, float(ln_eps),
            *map(_ptr, (r, w_raw, k_raw, v, a, *prm, state, resets, y, s_out, anchors)))
    return y, s_out, anchors


class WKV7Fused(torch.autograd.Function):
    """``wkv7_fused`` on CUDA tensors: the fused forward kernel (saving the
    chunk-entry states when a gradient is needed) and the fused backward
    kernel, which recomputes each chunk from them; the per-head gradients
    are summed over the batch here."""

    @staticmethod
    def forward(ctx, r, w_raw, k_raw, v, a, k_k, k_a, r_k, ln_w, ln_b, state, resets,
                ln_eps):
        prm = (k_k, k_a, r_k, ln_w, ln_b)
        save = any(ctx.needs_input_grad[:11])
        y, s_out, anchors = _fused_fwd(r, w_raw, k_raw, v, a, prm, state, resets, ln_eps,
                                       save)
        if save:
            ctx.save_for_backward(r, w_raw, k_raw, v, a, *prm, state, resets, anchors)
            ctx.ln_eps = ln_eps
        ctx.set_materialize_grads(False)
        return y, s_out

    @staticmethod
    def backward(ctx, dy, dsfin):
        (r, w_raw, k_raw, v, a, k_k, k_a, r_k, ln_w, ln_b, state, resets,
         anchors) = ctx.saved_tensors
        B, T, H, N = r.shape
        dy = torch.zeros_like(v) if dy is None else dy.to(v.dtype).contiguous()
        dsfin = None if dsfin is None else dsfin.float().contiguous()
        grads = [torch.empty_like(x) for x in (r, w_raw, k_raw, v, a)]
        dparams = torch.empty(5, B, H, N, dtype=torch.float32, device=r.device)
        ds0 = torch.empty_like(state) if ctx.needs_input_grad[10] else None
        _launch("wkv7_fused_bwd", r, _DTYPES[r.dtype], B, T, H, float(ctx.ln_eps),
                *map(_ptr, (r, w_raw, k_raw, v, a, k_k, k_a, r_k, ln_w, state, resets,
                            anchors, dy, dsfin, *grads, dparams, ds0)))
        dprm = dparams.sum(1)  # (5, H, N): the per-(b, h) rows summed over the batch
        return (*grads, *dprm.unbind(0), ds0, None, None)


def wkv7_fused(
    r: torch.Tensor, w_raw: torch.Tensor, k_raw: torch.Tensor, v: torch.Tensor,
    a: torch.Tensor, k_k: torch.Tensor, k_a: torch.Tensor, r_k: torch.Tensor,
    ln_w: torch.Tensor, ln_b: torch.Tensor,
    state: Optional[torch.Tensor] = None,
    resets: Optional[torch.Tensor] = None,
    ln_eps: float = 64e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable fused-prep WKV7 (the contract of ``wkv7_pallas_fused``):
    ``WKV7Fused`` on a CUDA device, ``wkv7_fused_plain`` under autograd on
    the CPU. Returns (the pre-gate y in v's dtype, final state f32)."""
    if _device("wkv7_fused", r) == "cpu":
        return wkv7_fused_plain(r, w_raw, k_raw, v, a, k_k, k_a, r_k, ln_w, ln_b,
                                state, resets, ln_eps)
    if r.shape[1] == 0:
        raise ValueError("wkv7_fused: empty sequence")
    r, w_raw, k_raw, v, a = (x.contiguous() for x in (r, w_raw, k_raw, v, a))
    prm = tuple(p.float().contiguous() for p in (k_k, k_a, r_k, ln_w, ln_b))
    return WKV7Fused.apply(r, w_raw, k_raw, v, a, *prm, state, resets, ln_eps)
