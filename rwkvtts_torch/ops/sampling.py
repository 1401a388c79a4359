"""Sampling: temperature / top-k / top-p, and Cosy's repetition-aware
sampling (counterpart of rwkvtts_tpu/ops/sampling.py).

JAX's ``jax.random.categorical(key, logits)`` is ``argmax(logits + g)``
with ``g`` Gumbel noise of the logits' shape. The port makes the noise an
explicit input: ``sample`` takes either ``noise`` (for the fused top-k +
nucleus branch, the shape of the k candidates; otherwise the shape of the
logits) or a ``torch.Generator`` from which it draws ``-log(-log(u))``;
``ras_sample`` takes the noise of both its draws. Fed the same noise, port
and JAX pick the same tokens.

``sample_rows`` is the slot pool's sampler: per-row temperature and top-p
vectors and a static top-k cap. Its noise is ``row_noise``, a counter hash
of (the request's seed, its own step index, the candidate index) in torch
integer ops: the same bits on the CPU and the card, no host sync, and a
row's draw independent of what else shares the pool. The Cosy pool's
per-row RAS (rwkvtts_tpu's ``ras_sample_rows``) is ``ras_sample`` given
``ras_row_noise``: both draws hashed the same way, each with its own salt.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def apply_temperature(logits: torch.Tensor, temperature) -> torch.Tensor:
    return logits.float() / max(float(temperature), 1e-6)


def top_k_mask(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k largest logits per row; mask the rest."""
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, NEG_INF, logits)


def top_p_mask(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering: keep the smallest prefix of the sorted
    distribution whose mass reaches p (crossing token included; the argmax
    always survives)."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, -1)
    cum = torch.cumsum(probs, -1)
    keep = cum - probs < p
    keep[..., 0] = True
    kth = torch.where(keep, sorted_logits, torch.inf).amin(-1, keepdim=True)
    return torch.where(logits < kth, NEG_INF, logits)


def gumbel(shape, generator: torch.Generator, device=None) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(u)), u uniform in (0, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def ras_noise(generator: torch.Generator, n_steps: int, batch: int, k: int, vocab: int,
              device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Gumbel noise of `n_steps` RAS draws from `generator`, step by
    step in the order ``ras_sample`` draws them (nucleus, then fallback):
    (nucleus (n_steps, batch, k), fallback (n_steps, batch, vocab)) on
    `device`. A CPU generator gives the same draws whatever the device."""
    steps = [(gumbel((batch, k), generator, generator.device),
              gumbel((batch, vocab), generator, generator.device)) for _ in range(n_steps)]
    return tuple(torch.stack(t).to(device) for t in zip(*steps))


def _categorical(logits, noise, generator):
    """argmax(logits + noise), the noise in the logits' dtype (as
    ``jax.random.categorical`` draws it)."""
    if noise is None:
        if generator is None:
            raise ValueError("sample: pass `noise` or a `generator`")
        noise = gumbel(logits.shape, generator, logits.device)
    elif noise.shape != logits.shape:
        raise ValueError(f"sample: noise {tuple(noise.shape)} for candidates "
                         f"{tuple(logits.shape)}")
    return torch.argmax(logits + noise.to(logits.dtype), -1)


def sample(
    logits: torch.Tensor, *, temperature=1.0, top_k: int = 0, top_p: float = 1.0,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    rank_bf16: bool = False,
) -> torch.Tensor:
    """Token ids (...,) from logits (..., V).

    `rank_bf16` ranks the full vocabulary in bf16 on the raw logits (the
    top-k is order-preserving under the temperature), then applies the
    temperature and the nucleus in f32 on the k survivors only: candidate
    selection at bf16 resolution, exact f32 probabilities on the kept set.
    It needs the fused top-k + nucleus branch (0 < top_k < V, top_p < 1)
    and raises elsewhere, where the JAX package falls back to f32
    ranking without a word."""
    V = logits.shape[-1]
    fused = bool(top_k) and 0 < top_k < V and top_p < 1.0
    if rank_bf16:
        if not fused:
            raise ValueError(f"sample: rank_bf16 needs 0 < top_k < {V} and top_p < 1 "
                             f"(got top_k={top_k}, top_p={top_p})")
        vals, idx = _top_bf16(logits, top_k)
        return _nucleus_draw(apply_temperature(vals, temperature), idx, top_p, noise,
                             generator)
    x = apply_temperature(logits, temperature)
    if fused:
        # fused top-k + nucleus: topk returns values sorted descending, so
        # the nucleus mask is a cumsum over k values (no full-vocab sort)
        return _nucleus_draw(*torch.topk(x, top_k, dim=-1), top_p, noise, generator)
    if top_k:
        x = top_k_mask(x, top_k)
    if top_p < 1.0:
        x = top_p_mask(x, top_p)
    return _categorical(x, noise, generator)


def _top_bf16(logits: torch.Tensor, k: int):
    """The k largest of the logits rounded to bf16, descending, ties in
    index order (lax.top_k's documented order: bf16 makes ties common,
    and the order decides which candidate takes which noise)."""
    vals, idx = torch.sort(logits.to(torch.bfloat16), dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _nucleus_draw(vals, idx, top_p: float, noise, generator) -> torch.Tensor:
    """A draw among the top-k candidates (vals sorted descending, f32, and
    their ids) after the nucleus mask: the argmax always survives."""
    probs = torch.softmax(vals, -1)
    keep = torch.cumsum(probs, -1) - probs < top_p
    keep[..., 0] = True
    vals = torch.where(keep, vals, NEG_INF)
    choice = _categorical(vals, noise, generator)
    return torch.gather(idx, -1, choice[..., None])[..., 0]


def ras_sample(
    logits: torch.Tensor, recent: torch.Tensor, *, top_p: float = 0.8, top_k: int = 25,
    win_size: int = 10, tau_r: float = 0.1,
    noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
    rank_bf16: bool = False,
) -> torch.Tensor:
    """Repetition-aware sampling (VALL-E 2; reference
    third_party/cosyvoice/utils/common.py:108-113): a top-k + nucleus draw,
    replaced by a draw from the full distribution where the drawn token
    already appears >= win_size * tau_r times in `recent`.

    logits (B, V); recent (B, win_size) past draws (-1 pads). The two
    draws take Gumbel noise: `noise` = (nucleus (B, k), fallback (B, V)),
    or drawn from `generator` (nucleus first). `rank_bf16` ranks the
    vocabulary and draws the fallback in bf16 (its noise rounded to bf16,
    as JAX draws it); the nucleus on the k survivors stays f32."""
    x = logits.to(torch.bfloat16 if rank_bf16 else torch.float32)
    k = min(top_k, x.shape[-1])
    if noise is None:
        if generator is None:
            raise ValueError("ras_sample: pass `noise` or a `generator`")
        noise = (gumbel((x.shape[0], k), generator, x.device),
                 gumbel(x.shape, generator, x.device))
    vals, idx = _top_bf16(x, k) if rank_bf16 else torch.topk(x, k, dim=-1)
    # >= 1 token survives: top_p <= 0 means greedy
    tok = _nucleus_draw(vals.float(), idx, top_p, noise[0], None)
    rep = (recent == tok[:, None]).sum(-1)
    fallback = _categorical(x, noise[1], None)
    return torch.where(rep >= win_size * tau_r, fallback, tok)


_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finalizer on int64 tensors holding values below
    2^32; every product stays below 2^59."""
    x = ((x ^ (x >> 16)) * 0x45D9F3B) & _M32
    x = ((x ^ (x >> 16)) * 0x45D9F3B) & _M32
    return x ^ (x >> 16)


def row_noise(seed: torch.Tensor, n: torch.Tensor, k: int, salt: int = 0x632BE5AB
              ) -> torch.Tensor:
    """Gumbel noise (B, k) that is a pure function of each row's (seed,
    step index n) and the candidate index: the hash's top 24 bits give u in
    (0, 1), then -log(-log(u)). Another `salt` gives an independent draw
    of the same (seed, n)."""
    h = _mix32((seed.long() & _M32) ^ 0x5BD1E995)
    h = _mix32(h ^ (n.long() & _M32))
    j = torch.arange(k, device=seed.device, dtype=torch.long)
    x = _mix32((h[:, None] + _mix32(j + salt)[None, :]) & _M32)
    u = ((x >> 8).float() + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def sample_rows(
    logits: torch.Tensor, *, temperature: torch.Tensor, top_k: int, top_p: torch.Tensor,
    noise: Optional[torch.Tensor] = None, seed: Optional[torch.Tensor] = None,
    n: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Token ids (B,) from logits (B, V) with per-row temperature and top-p
    ((B,) vectors) and a static top-k cap (0 or >= V: the whole
    vocabulary); the nucleus keeps >= 1 token a row, so top_p = 0 is
    greedy. The Gumbel noise is `noise` (B, k) of the candidate shape, or
    ``row_noise(seed, n, k)``."""
    x = logits.float() / temperature.float().clamp_min(1e-6)[:, None]
    V = x.shape[-1]
    k = top_k if 0 < top_k < V else V
    vals, idx = torch.topk(x, k, dim=-1)
    probs = torch.softmax(vals, -1)
    keep = torch.cumsum(probs, -1) - probs < top_p.float()[:, None]
    keep[:, 0] = True
    vals = torch.where(keep, vals, NEG_INF)
    if noise is None:
        if seed is None or n is None:
            raise ValueError("sample_rows: pass `noise` or the rows' `seed` and `n`")
        noise = row_noise(seed, n, k)
    choice = _categorical(vals, noise, None)
    return torch.gather(idx, -1, choice[:, None])[:, 0]


# the salt of ras_row_noise's second (fallback) draw
_FALLBACK_SALT = 0x1B873593


def ras_row_noise(seed: torch.Tensor, n: torch.Tensor, k: int, vocab: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two RAS draws of each row as pure functions of its (seed, step
    index n): (nucleus (B, k), fallback (B, vocab)), ``row_noise`` with two
    salts."""
    return row_noise(seed, n, k), row_noise(seed, n, vocab, _FALLBACK_SALT)
