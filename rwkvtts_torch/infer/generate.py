"""Autoregressive generation (counterpart of rwkvtts_tpu/infer/generate.py):
Spark B=64 batched generation (``spark_generate_mega_b64``), Spark
generation of any batch through the model's decode step with an early
exit between chunks (``spark_prefill_carry`` + ``spark_decode_chunk``,
``spark_generate_early_exit``), the voice designer's global-token draw
(``spark_global_generate``), and the Cosy B=1 chunked decode of the
streaming path (``cosy_prefill_carry`` + ``cosy_decode_chunk`` on the
whole-step decode route).

Prefill runs the full-sequence model (the WKV7 kernel on a card), the
state is packed for the decode step, then every step is: head product
(model dtype) -> f32 logits -> sample -> EOS latch -> embedding -> the
decode step (the decode kernels on a card) -> hidden cast to the model
dtype. The loops are plain Python loops that keep the EOS latch, the
counters and the RAS window on the device: the host reads a chunk's
tokens once, after it. On a CPU everything runs the plain versions.

Random draws come from a ``torch.Generator`` or from ``noise``: per-step
Gumbel noise of the sampler's candidate shape (ops/sampling.py), row i
for the i-th step of the call, which lets a caller feed the JAX
package's draws.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from rwkvtts_torch.models import cosy, rwkv7, spark
from rwkvtts_torch.ops import decode_mega as dm
from rwkvtts_torch.ops import decode_mega_b64 as dmb
from rwkvtts_torch.ops import sampling

# repetition-aware sampling (reference cosy_llm.py): the window of recent
# draws and the share of it that triggers the full-distribution fallback
RAS_WINDOW, RAS_TAU = 10, 0.1


@torch.inference_mode()
def spark_generate_mega_b64(
    params, mega, cfg: spark.SparkTTSConfig,
    tokens: torch.Tensor, modality: torch.Tensor, attention_mask: torch.Tensor,
    *,
    max_new_tokens: int = 1024,
    temperature: float = 1.0,
    top_k: int = 50,
    top_p: float = 0.95,
    eos_id: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched Spark semantic-token generation, 64 rows.

    tokens/modality/attention_mask: left-padded prompt (64, T). Random
    draws come from `generator`, or from `noise[step]` (per-step Gumbel
    noise of the sampler's candidate shape, see ops/sampling.py).
    Returns (generated (64, max_new_tokens) int64, lengths (64,)); after
    EOS a row repeats eos_id."""
    if eos_id is None:
        eos_id = cfg.eos_token_id
    bb = cfg.backbone
    Bn = tokens.shape[0]
    if Bn != dmb.B:
        raise ValueError(f"the decode step takes B={dmb.B}, got {Bn}")

    h, state = spark.prefill(params, cfg, tokens, modality, attention_mask)
    state = dmb.pack_state(state)
    head = params["head"].to(bb.dtype)
    done = torch.zeros(Bn, dtype=torch.bool, device=tokens.device)
    toks = []
    for i in range(max_new_tokens):
        logits = (h @ head).float()
        tok = sampling.sample(
            logits, temperature=temperature, top_k=top_k, top_p=top_p,
            noise=None if noise is None else noise[i], generator=generator,
        )
        tok = torch.where(done, eos_id, tok)
        done = done | (tok == eos_id)
        toks.append(tok)
        x = spark.decode_embed(params, cfg, tok)
        h, state = dmb.decode_step_mega_b64(mega, bb, x, state)
        h = h.to(bb.dtype)
    out = torch.stack(toks, 1)
    is_eos = out == eos_id
    lengths = torch.where(is_eos.any(-1), torch.argmax(is_eos.int(), -1),
                          max_new_tokens)
    return out, lengths


@torch.inference_mode()
def spark_prefill_carry(params, cfg: spark.SparkTTSConfig, tokens: torch.Tensor,
                        modality: torch.Tensor, attention_mask: torch.Tensor):
    """Prefill a left-padded prompt (B, T) and build the carry of
    ``spark_decode_chunk``: (h (B, C), the packed decode state, done (B,),
    n (B,))."""
    h, state = spark.prefill(params, cfg, tokens, modality, attention_mask)
    B, dev = tokens.shape[0], tokens.device
    return (h, rwkv7.pack_decode_state(state, cfg.backbone),
            torch.zeros(B, dtype=torch.bool, device=dev),
            torch.zeros(B, dtype=torch.long, device=dev))


@torch.inference_mode()
def spark_decode_chunk(
    params, cfg: spark.SparkTTSConfig, carry, *,
    chunk_len: int = 64,
    min_new_tokens: int = 0,
    temperature: float = 1.0,
    top_k: int = 50,
    top_p: float = 0.95,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
):
    """Decode `chunk_len` semantic tokens from a carried state through
    ``rwkv7.decode_step`` (the WKV step kernel on a card). Each step:
    logits = h @ head (f32), EOS masked while fewer than `min_new_tokens`
    were drawn, the draw, the EOS latch (a finished row repeats EOS), the
    embedding, the step. Returns (carry, toks (B, chunk_len) on the
    device, done (B,)); the carry's state is updated in place where the
    model's decode_wkv_packed asks for it."""
    eos, bb = cfg.eos_token_id, cfg.backbone
    params = rwkv7.layer_decode_views(params, bb)
    head = params["head"].to(bb.dtype)
    h, state, done, n = carry
    toks = []
    for i in range(chunk_len):
        logits = (h @ head).float()
        if min_new_tokens > 0:
            logits[:, eos] = torch.where(n < min_new_tokens, sampling.NEG_INF, logits[:, eos])
        tok = sampling.sample(logits, temperature=temperature, top_k=top_k, top_p=top_p,
                              noise=None if noise is None else noise[i], generator=generator)
        tok = torch.where(done, eos, tok)
        done = done | (tok == eos)
        toks.append(tok)
        h, state = rwkv7.decode_step(params, bb, spark.decode_embed(params, cfg, tok), state)
        n = n + 1
    return (h, state, done, n), torch.stack(toks, 1), done


def spark_generate_early_exit(
    params, cfg: spark.SparkTTSConfig, tokens: torch.Tensor, modality: torch.Tensor,
    attention_mask: torch.Tensor, *,
    max_new_tokens: int = 1024,
    chunk_len: int = 64,
    noise: Optional[torch.Tensor] = None,
    **sample_kw,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Spark generation in chunks of `chunk_len` steps that stops once every
    row has drawn EOS: one host read a chunk (is every row done?), so a
    short utterance costs its own length plus at most one chunk.
    `noise` (max_new_tokens, B, width) feeds step i its row i; otherwise
    pass `generator` (and the sampling settings) through `sample_kw`.
    Returns (generated (B, max_new_tokens), lengths (B,)) on the host; a
    row is EOS from its end on."""
    eos = cfg.eos_token_id
    carry = spark_prefill_carry(params, cfg, tokens, modality, attention_mask)
    chunks, n = [], 0
    while n < max_new_tokens:
        cl = min(chunk_len, max_new_tokens - n)
        carry, toks, done = spark_decode_chunk(
            params, cfg, carry, chunk_len=cl,
            noise=None if noise is None else noise[n:n + cl], **sample_kw)
        chunks.append(toks)
        n += cl
        if bool(done.all()):
            break
    out = torch.cat(chunks, 1).cpu()
    out = torch.cat([out, torch.full((out.shape[0], max_new_tokens - n), eos,
                                     dtype=out.dtype)], 1)
    is_eos = out == eos
    lengths = torch.where(is_eos.any(-1), torch.argmax(is_eos.int(), -1), max_new_tokens)
    return out, lengths


@torch.inference_mode()
def spark_global_generate(
    params, cfg: spark.SparkTTSConfig, tokens: torch.Tensor, modality: torch.Tensor,
    attention_mask: torch.Tensor, *,
    num_tokens: int = 32,
    temperature: float = 1.0,
    top_k: int = 50,
    top_p: float = 0.95,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The voice designer's draw: exactly `num_tokens` global (speaker) ids
    from the shared head restricted to [0, audio_global_vocab_size), each
    embedded through the global_embedder for the next step. Returns
    (toks (B, num_tokens), lengths (B,)) on the device."""
    bb = cfg.backbone
    h, state = spark.prefill(params, cfg, tokens, modality, attention_mask)
    state = rwkv7.pack_decode_state(state, bb)
    params = rwkv7.layer_decode_views(params, bb)
    head = params["head"].to(bb.dtype)
    toks = []
    for i in range(num_tokens):
        logits = (h @ head).float()
        logits[:, cfg.audio_global_vocab_size:] = sampling.NEG_INF
        tok = sampling.sample(logits, temperature=temperature, top_k=top_k, top_p=top_p,
                              noise=None if noise is None else noise[i], generator=generator)
        toks.append(tok)
        h, state = rwkv7.decode_step(params, bb, params["global_embedder"][tok].to(bb.dtype),
                                     state)
    B = tokens.shape[0]
    return torch.stack(toks, 1), torch.full((B,), num_tokens, dtype=torch.long,
                                            device=tokens.device)


@torch.inference_mode()
def cosy_prefill_carry(params, cfg: cosy.CosyConfig, tokens: torch.Tensor,
                       modality: torch.Tensor, attention_mask: torch.Tensor, *,
                       wkv_dtype: torch.dtype):
    """Prefill a B=1 prompt and build the carry of ``cosy_decode_chunk``:
    (h (1, C), decode state with the WKV state in `wkv_dtype`, done (1,),
    recent (1, RAS_WINDOW) of -1, n (1,))."""
    if tokens.shape[0] != 1:
        raise ValueError(f"the Cosy decode step takes B=1, got {tokens.shape[0]}")
    h, state = cosy.prefill(params, cfg, tokens, modality, attention_mask)
    dev = tokens.device
    return (h, dm.pack_state(state, wkv_dtype), torch.zeros(1, dtype=torch.bool, device=dev),
            torch.full((1, RAS_WINDOW), -1, dtype=torch.long, device=dev),
            torch.zeros(1, dtype=torch.long, device=dev))


@torch.inference_mode()
def cosy_decode_chunk(
    params, mega, cfg: cosy.CosyConfig, carry,
    noise: Tuple[torch.Tensor, torch.Tensor], *,
    min_new_tokens: int = 0,
    top_k: int = 25,
    top_p: float = 0.8,
):
    """Decode a chunk of Cosy speech tokens from a carried state through
    the B=1 decode step (``ops/decode_mega.decode_step_mega``), one a row
    of `noise` = (nucleus (n, 1, k), fallback (n, 1, V)), the Gumbel noise
    of the two RAS draws. Each step: logits = h @ head + bias (f32), EOS
    masked while fewer than `min_new_tokens` were drawn, RAS sampling, the
    EOS latch, the rolling window of recent draws. Returns (carry, toks
    (1, n) on the device, done (1,)); the carry's state is updated in
    place."""
    bb = cfg.backbone
    eos = cfg.eos_token_id
    h, state, done, recent, n = carry
    head = params["head"].to(bb.dtype)
    bias = params["head_bias"].float()
    toks = []
    for i in range(noise[0].shape[0]):
        logits = (h @ head).float() + bias
        logits[:, eos] = torch.where(n < min_new_tokens, sampling.NEG_INF, logits[:, eos])
        tok = sampling.ras_sample(logits, recent, top_p=top_p, top_k=top_k, win_size=RAS_WINDOW,
                                  tau_r=RAS_TAU, noise=(noise[0][i], noise[1][i]))
        tok = torch.where(done, eos, tok)
        done = done | (tok == eos)
        recent = torch.cat([recent[:, 1:], tok[:, None]], 1)
        toks.append(tok)
        h, state = dm.decode_step_mega(mega, bb, cosy.decode_embed(params, cfg, tok), state)
        h = h.to(bb.dtype)
        n = n + 1
    return (h, state, done, recent, n), torch.stack(toks, 1), done
