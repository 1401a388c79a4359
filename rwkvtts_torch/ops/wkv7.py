"""WKV7, the RWKV-7 time-mix recurrence (counterpart of
rwkvtts_tpu/ops/wkv7.py).

Per 64-dim head and step, state S (N_v x N_k) f32, rows the value dim:

    w_t  = exp(-exp(w_raw_t))
    sa_t = S_{t-1} @ z_t
    S_t  = S_{t-1} * w_t[None, :] + sa_t[:, None] * b_t[None, :] + v_t[:, None] * k_t[None, :]
    y_t  = S_t @ r_t

``wkv7_scan`` is the plain version of the whole-sequence forward, and
PyTorch autograd through it the plain backward (the CPU path and the
reference the CUDA kernels are held to); ``wkv7_fused_plain`` is the same
for the fused-prep variant. ``wkv7`` is what the model calls: it goes
through ``ops/wkv7_cuda.py``, which launches the CUDA kernels for tensors
on a CUDA device and runs ``wkv7_scan`` for tensors on the CPU.
``wkv7_step``, the one-step decode form, goes the same way through
``ops/wkv7_step_packed.py``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from rwkvtts_torch.ops.norm import group_norm, l2_normalize


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


def _neumann_inverse(a: torch.Tensor, chunk: int) -> torch.Tensor:
    """(I - A)^{-1} of a strictly lower-triangular (..., L, L) A: A is
    nilpotent (A^L = 0), so the inverse is prod_i (I + A^{2^i}), exactly,
    in ceil(log2 L) products."""
    eye = torch.eye(chunk, dtype=a.dtype, device=a.device)
    out = eye + a
    power = a
    for _ in range(max(0, (chunk - 1).bit_length() - 1)):
        power = power @ power
        out = out @ (eye + power)
    return out


def _chunk_body(s0, r, logw, k, v, z, b, resets):
    """One chunk of L steps as dense products. s0 (B, H, N, N) f32 entry
    state; r..b (B, L, H, N) f32 with logw = log w; resets (B, L) int.
    Returns (the state after the chunk, y (B, L, H, N))."""
    L = r.shape[1]
    # c counts the resets up to each position: positions of one segment
    # share it, and the entry state reaches only those with c = 0
    c = torch.cumsum(resets, 1)
    # a reset's decay multiplies a state that is masked away: 0 keeps the
    # ratios below finite
    logw = torch.where(resets[:, :, None, None] > 0, 0.0, logw)
    g = torch.cumsum(logw, 1)  # inclusive, (B, L, H, N)
    e_g = torch.exp(g)
    qt = r * e_g  # r_t decayed from the chunk's entry through step t
    zt = z * e_g * torch.exp(-logw)  # z_t decayed through step t - 1
    kt = k / e_g
    bt = b / e_g

    def pair(x, y):  # (B, H, L, L): x_t . y_s over the key dim
        return torch.einsum("blhn,bmhn->bhlm", x, y)

    same = (c[:, :, None] == c[:, None, :])[:, None]
    strict = torch.tril(torch.ones(L, L, dtype=torch.bool, device=r.device), -1)
    incl = torch.tril(torch.ones(L, L, dtype=torch.bool, device=r.device))
    m_strict = (same & strict).float()
    m_incl = (same & incl).float()
    A = pair(zt, bt) * m_strict
    Kz = pair(zt, kt) * m_strict
    inv = _neumann_inverse(A, L)

    mask0 = (c == 0)[:, :, None, None]
    z0 = torch.where(mask0, zt, 0.0)
    q0 = torch.where(mask0, qt, 0.0)
    # sa = (I - A)^{-1} (z0 S0^T + Kz v): the rows sa_t of the chunk
    sa_in = torch.einsum("blhn,bhin->blhi", z0, s0) + torch.einsum("bhlm,bmhi->blhi", Kz, v)
    sa = torch.einsum("bhlm,bmhi->blhi", inv, sa_in)
    y = (torch.einsum("blhn,bhin->blhi", q0, s0)
         + torch.einsum("bhlm,bmhi->blhi", pair(qt, bt) * m_incl, sa)
         + torch.einsum("bhlm,bmhi->blhi", pair(qt, kt) * m_incl, v))
    # the sources of the chunk's last segment survive to its end, and the
    # entry state survives if no reset came
    c_last = c[:, -1]
    live = (c == c_last[:, None])[:, :, None, None]
    g_last = g[:, -1]  # (B, H, N)
    k_fin = torch.where(live, kt, 0.0) * torch.exp(g_last)[:, None]
    b_fin = torch.where(live, bt, 0.0) * torch.exp(g_last)[:, None]
    s0_live = (c_last == 0).float()[:, None, None, None]
    s_out = (s0 * s0_live * torch.exp(g_last)[:, :, None, :]
             + torch.einsum("blhi,blhn->bhin", sa, b_fin)
             + torch.einsum("blhi,blhn->bhin", v, k_fin))
    return s_out, y


def wkv7_chunked(
    r: torch.Tensor, w_raw: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    z: torch.Tensor, b: torch.Tensor,
    state: Optional[torch.Tensor] = None,
    resets: Optional[torch.Tensor] = None,
    *, chunk: int = 32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """WKV7 in chunks of `chunk` steps, each a few dense products (the
    counterpart of rwkvtts_tpu/ops/wkv7.py::wkv7_chunked, and the algebra
    the chunked CUDA kernels of csrc/wkv7_fused.cu follow). Same contract
    as ``wkv7_scan``; T is padded inside to a multiple of `chunk` with
    steps of decay 1 and no update. Differentiable by autograd; no main
    path calls it."""
    B, T, H, N = r.shape
    out_dtype = v.dtype
    s = init_state(B, H, N, r.device) if state is None else state.float()
    logw = -torch.exp(w_raw.float())
    r, k, v, z, b = (x.float() for x in (r, k, v, z, b))
    rs = (torch.zeros(B, T, dtype=torch.int64, device=r.device) if resets is None
          else resets.long())
    pad = (-T) % chunk
    if pad:
        zpad = lambda x: torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        r, logw, k, v, z, b = map(zpad, (r, logw, k, v, z, b))  # logw = 0: w = 1
        rs = torch.nn.functional.pad(rs, (0, pad))
    ys = []
    for c0 in range(0, T + pad, chunk):
        sl = slice(c0, c0 + chunk)
        s, y = _chunk_body(s, r[:, sl], logw[:, sl], k[:, sl], v[:, sl], z[:, sl],
                           b[:, sl], rs[:, sl])
        ys.append(y)
    y = torch.cat(ys, 1)[:, :T] if ys else torch.zeros_like(v)
    return y.to(out_dtype), s


# ---------------------------------------------------------------------------
# Two-level / sequence-parallel WKV7 (spans)
# ---------------------------------------------------------------------------
#
# The state update S' = S (diag(w) + z b^T) + v k^T is linear in S, so a
# stretch of steps maps its entry state affinely: S_out = S_in @ P + Q and
# y_t = y0_t + S_in @ c_t, with (y0, Q) the stretch run from a zero state
# and (c, P) its linear part. A sequence cut into spans then takes one
# local pass a span (the spans in parallel, or on different ranks) and a
# compose over the spans' (Q, P), which alone crosses spans. Resets compose
# exactly: a reset zeroes both parts downstream of it.


def _chunk_affine(r, logw, k, z, b, resets):
    """A chunk's affine operators in its entry state (JAX's
    ``_chunk_prep_affine``): the transfer mx (S_out = S0 @ mx + const)
    and the correction rows cy (y_l = const + S0 @ cy_l), which are
    ``_chunk_body`` at entry state I and v = 0."""
    B, L, H, N = r.shape
    eye = torch.eye(N, dtype=torch.float32, device=r.device).expand(B, H, N, N)
    return _chunk_body(eye, r, logw, k, torch.zeros_like(r), z, b, resets)


def _span_affine(r, logw, k, v, z, b, resets, *, chunk: int):
    """One span's local pass, entry state unknown, inputs (B, Ts, H, N) f32
    with Ts a multiple of `chunk`. Returns (y0, cyp, q, pmat): the outputs
    from a zero entry state, the correction rows (y = y0 + S_in @ cyp), the
    exit state from zero and the transfer (S_out = S_in @ pmat + q)."""
    B, Ts, H, N = r.shape
    s = init_state(B, H, N, r.device)
    pmat = torch.eye(N, dtype=torch.float32, device=r.device).expand(B, H, N, N)
    ys, cyps = [], []
    for c0 in range(0, Ts, chunk):
        sl = slice(c0, c0 + chunk)
        part = (r[:, sl], logw[:, sl], k[:, sl])
        s_next, y = _chunk_body(s, *part, v[:, sl], z[:, sl], b[:, sl], resets[:, sl])
        mx, cy = _chunk_affine(*part, z[:, sl], b[:, sl], resets[:, sl])
        # the chunk's correction lifted to the span's entry:
        # S_chunk_in @ cy = S_span_in @ (pmat @ cy)
        cyps.append(torch.einsum("bhmn,blhn->blhm", pmat, cy))
        ys.append(y)
        s, pmat = s_next, pmat @ mx
    return torch.cat(ys, 1), torch.cat(cyps, 1), s, pmat


def _compose(state, q, pmat):
    """Fold the spans' affine maps from the entry state: q, pmat (S, B, H,
    N, N) in span order. Returns (each span's entry state (S, B, H, N, N),
    the exit state)."""
    s_in = []
    s = state
    for q_j, p_j in zip(q.unbind(0), pmat.unbind(0)):
        s_in.append(s)
        s = s @ p_j + q_j
    return torch.stack(s_in), s


def wkv7_chunked_sp(
    r: torch.Tensor, w_raw: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    z: torch.Tensor, b: torch.Tensor,
    state: Optional[torch.Tensor] = None,
    resets: Optional[torch.Tensor] = None,
    *, chunk: int = 32, spans: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-level chunked WKV7, the plain version (the counterpart of
    rwkvtts_tpu/ops/wkv7.py::wkv7_chunked_sp): `spans` spans in parallel,
    chunks of `chunk` steps within each, then the compose. Same contract
    as ``wkv7_scan``, computed in f32; T is padded to a multiple of
    chunk * spans with steps of decay 1 and no update."""
    B, T, H, N = r.shape
    out_dtype = v.dtype
    s0 = init_state(B, H, N, r.device) if state is None else state.float()
    logw = -torch.exp(w_raw.float())
    r, k, v, z, b = (x.float() for x in (r, k, v, z, b))
    rs = (torch.zeros(B, T, dtype=torch.int64, device=r.device) if resets is None
          else resets.long())
    pad = (-T) % (chunk * spans)
    if pad:
        zpad = lambda x: torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        r, logw, k, v, z, b = map(zpad, (r, logw, k, v, z, b))  # logw = 0: w = 1
        rs = torch.nn.functional.pad(rs, (0, pad))
    Ts = (T + pad) // spans
    fold = lambda x: x.reshape((B * spans, Ts) + x.shape[2:])  # spans into the batch
    y0, cyp, q, pmat = _span_affine(*map(fold, (r, logw, k, v, z, b, rs)), chunk=chunk)
    by_span = lambda x: x.reshape((B, spans) + x.shape[1:]).transpose(0, 1)
    s_in, s_fin = _compose(s0, by_span(q), by_span(pmat))
    y = by_span(y0) + torch.einsum("sbhim,sblhm->sblhi", s_in, by_span(cyp))
    y = y.transpose(0, 1).reshape(B, T + pad, H, N)[:, :T]
    return y.to(out_dtype), s_fin


# w_raw of a padding step: w = exp(-exp(-30)) is 1 in f32
_PAD_W_RAW = -30.0


def wkv7_spans(
    r: torch.Tensor, w_raw: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    z: torch.Tensor, b: torch.Tensor,
    state: Optional[torch.Tensor] = None,
    resets: Optional[torch.Tensor] = None,
    *, spans: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """WKV7 over `spans` spans through the whole-sequence kernels (the
    route the model takes for ``wkv_spans`` > 1): each span's (y0, q) is one
    run of ``wkv7`` from a zero state and its (cyp, pmat) a second run with
    the identity as entry state and v = 0, the spans folded into the batch,
    in f32; then the compose (small batched products).

    Inside a train step on a mesh with sp > 1 the inputs are this rank's
    part of T, it holds spans / sp of the spans, and the spans' (q, pmat)
    are all-gathered over sp (differentiably) before the compose; `state`
    is the entry state of the whole sequence and the returned state its
    exit state. A local T that the local spans do not divide is padded
    with steps of decay 1 and no update. Same contract as ``wkv7``."""
    from rwkvtts_torch.parallel import mesh as mesh_lib

    B, T, H, N = r.shape
    out_dtype = v.dtype
    sp = mesh_lib.sp_size()
    if spans % sp:
        raise ValueError(f"wkv_spans = {spans} is not a multiple of sp = {sp}")
    local = spans // sp
    s0 = init_state(B, H, N, r.device) if state is None else state.float()
    r, w_raw, k, v, z, b = (x.float() for x in (r, w_raw, k, v, z, b))
    pad = (-T) % local
    if pad:
        zpad = lambda x, val=0.0: torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad), value=val)
        r, k, v, z, b = map(zpad, (r, k, v, z, b))
        w_raw = zpad(w_raw, _PAD_W_RAW)
        if resets is not None:
            resets = torch.nn.functional.pad(resets, (0, pad))
    Ts = (T + pad) // local
    fold = lambda x: x.reshape((B * local, Ts) + x.shape[2:]).contiguous()
    r, w_raw, k, v, z, b = map(fold, (r, w_raw, k, v, z, b))
    rs = None if resets is None else fold(resets.bool())
    eye = torch.eye(N, dtype=torch.float32, device=r.device).expand(B * local, H, N, N)
    y0, q = wkv7(r, w_raw, k, v, z, b, None, rs)
    cyp, pmat = wkv7(r, w_raw, k, torch.zeros_like(v), z, b, eye.contiguous(), rs)
    by_span = lambda x: x.reshape((B, local) + x.shape[1:]).transpose(0, 1)
    q, pmat = by_span(q), by_span(pmat)
    if sp > 1:
        m = mesh_lib.current()
        qp = mesh_lib.AllGather.apply(torch.stack([q, pmat], 1), m, "sp")
        qp = qp.reshape((spans, 2) + q.shape[1:])
        s_in, s_fin = _compose(s0, qp[:, 0], qp[:, 1])
        s_in = s_in[m.coords["sp"] * local:(m.coords["sp"] + 1) * local]
    else:
        s_in, s_fin = _compose(s0, q, pmat)
    y = by_span(y0) + torch.einsum("sbhim,sblhm->sblhi", s_in, by_span(cyp))
    y = y.transpose(0, 1).reshape(B, T + pad, H, N)[:, :T]
    return y.to(out_dtype), s_fin


def wkv7_step(
    state: torch.Tensor, r: torch.Tensor, w_raw: torch.Tensor, k: torch.Tensor,
    v: torch.Tensor, z: torch.Tensor, b: torch.Tensor, *, inplace: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step. state (B, H, N, N); r..b (B, H, N). The state is
    stepped in f32 and returned in its own dtype (a bf16 carry stays
    bf16). Returns (y in v's dtype, new state).

    A CUDA tensor launches the step kernel (ops/wkv7_step_packed.py, f32 or
    bf16 carry); a CPU tensor runs its plain version. The card never runs
    the plain step. ``inplace`` writes the new state over the given one
    (the slot pool's mode, which the model's ``decode_wkv_packed`` selects,
    as the TPU kernel updates its operand in place); otherwise a fresh
    buffer is returned. Both compute the same function, the one the JAX
    package's XLA step computes too."""
    from rwkvtts_torch.ops import wkv7_step_packed

    return wkv7_step_packed.wkv7_step_packed(state, r, w_raw, k, v, z, b, inplace=inplace)


def wkv7_fused_plain(
    r: torch.Tensor, w_raw: torch.Tensor, k_raw: torch.Tensor, v: torch.Tensor,
    a: torch.Tensor, k_k: torch.Tensor, k_a: torch.Tensor, r_k: torch.Tensor,
    ln_w: torch.Tensor, ln_b: torch.Tensor,
    state: Optional[torch.Tensor] = None,
    resets: Optional[torch.Tensor] = None,
    ln_eps: float = 64e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """WKV7 with the time-mix elementwise band around it, composed as the
    model's unfused path composes it (models/rwkv7.py, block_forward):
    kk = l2_normalize(k_raw k_k), k_eff = k_raw (1 + (a - 1) k_a), the
    recurrence on (r, w_raw, k_eff, v, -kk, kk a), the ln_x GroupNorm and
    the bonus (r k_eff r_k) v. Everything is computed in f32, as the fused
    kernels (and rwkvtts_tpu's wkv7_pallas_fused) do.

    r..a: (B, T, H, N); k_k..ln_b: (H, N); state (B, H, N, N) f32. Returns
    (y in v's dtype, final state f32)."""
    B, T, H, N = r.shape
    r, w_raw, k_raw, vf, a = (x.float() for x in (r, w_raw, k_raw, v, a))
    k_k, k_a, r_k = (p.float() for p in (k_k, k_a, r_k))
    kk = l2_normalize(k_raw * k_k)
    k_eff = k_raw * (1 + (a - 1) * k_a)
    y, s = wkv7_scan(r, w_raw, k_eff, vf, -kk, kk * a, state, resets)
    y = group_norm(y.reshape(B, T, H * N), ln_w.reshape(-1), ln_b.reshape(-1), H, ln_eps)
    bonus = (r * k_eff * r_k).sum(-1, keepdim=True) * vf
    return (y.reshape(B, T, H, N) + bonus).to(v.dtype), s


def wkv7(
    r: torch.Tensor, w_raw: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    z: torch.Tensor, b: torch.Tensor,
    state: Optional[torch.Tensor] = None,
    resets: Optional[torch.Tensor] = None,
    *, spans: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whole-sequence WKV7 as the model calls it, differentiable: the CUDA
    kernels on a CUDA device, ``wkv7_scan`` on the CPU (see
    ops/wkv7_cuda.py). ``spans`` > 1 takes the two-level route
    ``wkv7_spans`` over the same kernels, which is also the
    sequence-parallel one."""
    if spans > 1:
        return wkv7_spans(r, w_raw, k, v, z, b, state, resets, spans=spans)
    from rwkvtts_torch.ops import wkv7_cuda

    return wkv7_cuda.wkv7(r, w_raw, k, v, z, b, state, resets)
