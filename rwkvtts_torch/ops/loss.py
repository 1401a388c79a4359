"""Loss functions (counterpart of rwkvtts_tpu/ops/loss.py).

``fused_linear_cross_entropy`` never keeps the (B*T, V) logits alive: the
rows are cut into chunks, and each chunk's head product and log-softmax
run under ``torch.utils.checkpoint``, so the backward recomputes one
chunk's logits at a time. The head product is a plain ``torch.matmul``
(the JAX package leaves it to XLA, outside any Pallas kernel), on f32
copies of the operands: bf16 inputs are exact in f32, so this is JAX's
bf16 product with f32 accumulation and f32 logits.

Its options give the label-smoothing KL loss (cosyvoice's
LabelSmoothingLoss) and the L2Wrap max-logit regulariser as an explicit
auxiliary term.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from rwkvtts_torch.parallel import mesh as mesh_lib

IGNORE_INDEX = -100


def _chunk_ce(hidden, w_head, bias, labels, valid, smoothing: float = 0.0):
    """CE (or label-smoothed KL) of one chunk of rows: hidden (M, C) f32,
    labels (M,). Returns (sum of losses, sum of max-logit squares) over
    the valid rows."""
    logits = hidden @ w_head
    if bias is not None:
        logits = logits + bias.float()
    V = logits.shape[-1]
    lse = torch.logsumexp(logits, -1)
    picked = logits.gather(-1, labels.clamp_min(0)[:, None])[:, 0]
    if smoothing:
        conf = 1.0 - smoothing
        off = smoothing / max(V - 1, 1)
        logp_gold = picked - lse
        sum_logp = logits.sum(-1) - V * lse
        _log = lambda x: math.log(x) if x > 0 else 0.0
        t_logt = conf * _log(conf) + (V - 1) * off * _log(off)
        loss = t_logt - (conf * logp_gold + off * (sum_logp - logp_gold))
    else:
        loss = lse - picked
    zero = torch.zeros((), dtype=loss.dtype, device=loss.device)
    nll = torch.where(valid, loss, zero)
    maxlogit = logits.amax(-1)
    max_sq = torch.where(valid, maxlogit * maxlogit, zero)
    return nll.sum(), max_sq.sum()


def fused_linear_cross_entropy(
    hidden: torch.Tensor,
    w_head: torch.Tensor,
    labels: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    ignore_index: int = IGNORE_INDEX,
    chunk: int = 1024,
    l2_wrap: float = 0.0,
    shift: bool = False,
    smoothing: float = 0.0,
    normalize_length: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean CE over the valid labels without the full (B, T, V) logits.

    hidden (B, T, C); w_head (C, V); labels (B, T) int. With ``shift``,
    hidden[t] predicts labels[t + 1]. ``smoothing`` > 0 gives the
    label-smoothing KL; ``normalize_length=False`` divides by the batch
    size instead of the token count. ``l2_wrap`` > 0 adds
    l2_wrap / (2 B T) * sum(max_logit^2). Returns (loss, n_valid).

    Inside a train step on a mesh (parallel/mesh.current()) the rows and
    positions are this rank's part of the global batch, and every
    denominator is the global one (n_valid summed over the ranks, the
    global B, the global B T): the rank's loss is its part of the global
    mean, the ranks' losses and gradients sum to the single-device ones, and
    the n_valid returned is the global count. Under sp, with ``shift``, the
    last position predicts the next rank's first label."""
    mesh = mesh_lib.current()
    B, T, C = hidden.shape
    T_all = T * (1 if mesh is None else mesh.shape["sp"])
    if shift and T_all > T:
        labels = torch.cat([labels[:, 1:], mesh_lib.sp_next_first(labels, ignore_index)], 1)
    elif shift:
        hidden = hidden[:, :-1]
        labels = labels[:, 1:]
        T -= 1
    if shift:
        T_all -= 1
    M = B * T
    h = hidden.reshape(M, C).float()
    lab = labels.reshape(M)
    valid = lab != ignore_index
    w = w_head.float()
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    max_sq = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for s in range(0, M, chunk):
        part = slice(s, s + chunk)
        args = (h[part], w, bias, lab[part], valid[part], smoothing)
        if torch.is_grad_enabled():
            nll, m2 = checkpoint(_chunk_ce, *args, use_reentrant=False)
        else:
            nll, m2 = _chunk_ce(*args)
        total = total + nll
        max_sq = max_sq + m2
    n_valid = mesh_lib.global_sum(valid.sum())
    B_all = mesh_lib.global_rows(B)
    denom = n_valid.clamp_min(1) if normalize_length else B_all
    loss = total / denom
    if l2_wrap > 0.0:
        loss = loss + (l2_wrap / (2.0 * B_all * T_all)) * max_sq
    return loss, n_valid


def cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    *,
    ignore_index: int = IGNORE_INDEX,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain mean CE on materialised logits (..., V)."""
    logits = logits.float()
    valid = labels != ignore_index
    lse = torch.logsumexp(logits, -1)
    picked = logits.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    nll = torch.where(valid, lse - picked, torch.zeros((), device=logits.device))
    n = valid.sum()
    return nll.sum() / n.clamp_min(1), n
