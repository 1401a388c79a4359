"""Autoregressive generation (counterpart of rwkvtts_tpu/infer/generate.py):
Spark B=64 batched generation (``spark_generate_mega_b64``), Spark
generation of any batch through the model's decode step, all steps
(``spark_generate``, ``greedy_spark_generate``) or with an early
exit between chunks (``spark_prefill_carry`` + ``spark_decode_chunk``,
``spark_generate_early_exit``), the voice designer's global-token draw
(``spark_global_generate``); Cosy generation with RAS sampling on either
decode route, the model's ``rwkv7.decode_step`` or the B=1 whole-step
kernel (``cosy_prefill_carry`` + ``cosy_decode_chunk``, the streaming
path's chunks, and ``cosy_generate``), and Cosy B=64 batched generation
through the B=64 whole-step kernel (``cosy_generate_mega_b64``); XY
8-channel generation with its staggered flush automaton on either the
model's decode step or the B=64 whole-step kernel (``xy_generate``); the
plain latched decode of the ASR, S2S and two-tower families
(``latched_decode``).

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
package's draws (XY: a list of one such tensor a channel, the widths
differ).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from rwkvtts_torch.models import cosy, rwkv7, spark, xy
from rwkvtts_torch.ops import decode_mega as dm
from rwkvtts_torch.ops import decode_mega_b64 as dmb
from rwkvtts_torch.ops import sampling

# repetition-aware sampling (reference cosy_llm.py): the window of recent
# draws and the share of it that triggers the full-distribution fallback
RAS_WINDOW, RAS_TAU = 10, 0.1


def _eos_lengths(out: torch.Tensor, eos: int, max_new_tokens: int) -> torch.Tensor:
    """Each row's length: the index of its first EOS, or max_new_tokens."""
    is_eos = out == eos
    return torch.where(is_eos.any(-1), torch.argmax(is_eos.int(), -1), max_new_tokens)


@torch.inference_mode()
def latched_decode(
    views, cfg: rwkv7.RWKV7Config, h: torch.Tensor, state, head: torch.Tensor, embed,
    eos: int, n: int, *,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`n` steps of ``rwkv7.decode_step`` from a prefilled h (B, C) and a
    packed state, each: logits = h @ head (f32), the draw (greedy at
    temperature 0, otherwise ``sampling.sample`` on `noise[i]` or
    `generator`), the EOS latch (a finished row repeats `eos`),
    `embed(tok)` -> the step, the last step's included. The ASR, S2S and
    two-tower families decode through it. Returns (toks (B, n), lengths
    (B,))."""
    done = torch.zeros(h.shape[0], dtype=torch.bool, device=h.device)
    toks = []
    for i in range(n):
        logits = (h @ head).float()
        if temperature <= 0.0:
            tok = torch.argmax(logits, -1)
        else:
            tok = sampling.sample(logits, temperature=temperature, top_k=top_k, top_p=top_p,
                                  noise=None if noise is None else noise[i], generator=generator)
        tok = torch.where(done, eos, tok)
        done = done | (tok == eos)
        toks.append(tok)
        h, state = rwkv7.decode_step(views, cfg, embed(tok), state)
    out = torch.stack(toks, 1)
    return out, _eos_lengths(out, eos, n)


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
    rank_bf16: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched Spark semantic-token generation, 64 rows.

    tokens/modality/attention_mask: left-padded prompt (64, T). Random
    draws come from `generator`, or from `noise[step]` (per-step Gumbel
    noise of the sampler's candidate shape, see ops/sampling.py). With
    `rank_bf16` the logits stay in the head's bf16 and the sampler ranks
    there (``sampling.sample``'s flag). Returns (generated (64,
    max_new_tokens) int64, lengths (64,)); after EOS a row repeats
    eos_id."""
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
        logits = h @ head
        tok = sampling.sample(
            logits if rank_bf16 else logits.float(), temperature=temperature, top_k=top_k,
            top_p=top_p, noise=None if noise is None else noise[i], generator=generator,
            rank_bf16=rank_bf16,
        )
        tok = torch.where(done, eos_id, tok)
        done = done | (tok == eos_id)
        toks.append(tok)
        x = spark.decode_embed(params, cfg, tok)
        h, state = dmb.decode_step_mega_b64(mega, bb, x, state)
        h = h.to(bb.dtype)
    out = torch.stack(toks, 1)
    return out, _eos_lengths(out, eos_id, max_new_tokens)


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


def spark_generate(
    params, cfg: spark.SparkTTSConfig, tokens: torch.Tensor, modality: torch.Tensor,
    attention_mask: torch.Tensor, *,
    max_new_tokens: int = 1024,
    min_new_tokens: int = 0,
    temperature: float = 1.0,
    top_k: int = 50,
    top_p: float = 0.95,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched Spark semantic-token generation of any batch (the JAX
    package's XLA route): the prefill of the left-padded prompt (B, T)
    (the WKV7 forward kernel on a card), then `max_new_tokens` steps of
    ``spark_decode_chunk`` through ``rwkv7.decode_step`` (the WKV step
    kernel on a card), each step's decode included, as JAX's scan runs
    them; no early exit. `params` may be the model's tree or
    ``rwkv7.pack_decode_params``'s. Draws from `generator` or from
    `noise[step]` (per-step Gumbel noise of the sampler's candidate shape).
    Returns (generated (B, max_new_tokens), lengths (B,)) on the device;
    after EOS a row repeats EOS."""
    carry = spark_prefill_carry(params, cfg, tokens, modality, attention_mask)
    _, out, _ = spark_decode_chunk(params, cfg, carry, chunk_len=max_new_tokens,
                                   min_new_tokens=min_new_tokens, temperature=temperature,
                                   top_k=top_k, top_p=top_p, generator=generator, noise=noise)
    return out, _eos_lengths(out, cfg.eos_token_id, max_new_tokens)


def greedy_spark_generate(params, cfg: spark.SparkTTSConfig, tokens: torch.Tensor,
                          modality: torch.Tensor, attention_mask: torch.Tensor, **kw):
    """Greedy ``spark_generate``, as JAX's: temperature 1e-6 and top-k 1,
    so logits that tie at the top after the scaling (bf16 logits do) are
    drawn among by noise from a generator seeded 0 on the tokens' device;
    `kw` as ``spark_generate``'s (``max_new_tokens``, ``min_new_tokens``)."""
    g = torch.Generator(device=tokens.device).manual_seed(0)
    return spark_generate(params, cfg, tokens, modality, attention_mask, temperature=1e-6,
                          top_k=1, top_p=1.0, generator=g, **kw)


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
    return out, _eos_lengths(out, eos, max_new_tokens)


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


def _cosy_loop(params, cfg: cosy.CosyConfig, carry, decode, n_steps: int, noise, generator, *,
               min_new_tokens: int, top_k: int, top_p: float, rank_bf16: bool = False):
    """`n_steps` Cosy decode steps (the body of rwkvtts_tpu's
    _make_cosy_step): logits = h @ head (model dtype) -> f32 + bias (with
    `rank_bf16` they stay in the model dtype, the bias cast to it, and
    ``ras_sample`` ranks in bf16), EOS
    masked while fewer than `min_new_tokens` were drawn, RAS sampling (the
    Gumbel noise of step i from noise[0][i] / noise[1][i], or drawn from
    `generator`), the EOS latch (a finished row repeats EOS), the rolling
    window of recent draws, the embedding, ``decode(x, state)``. carry =
    (h, state, done, recent, n). Returns (carry, toks (B, n_steps))."""
    bb, eos = cfg.backbone, cfg.eos_token_id
    h, state, done, recent, n = carry
    head = params["head"].to(bb.dtype)
    bias = params["head_bias"].to(bb.dtype if rank_bf16 else torch.float32)
    toks = []
    for i in range(n_steps):
        logits = h @ head
        logits = (logits if rank_bf16 else logits.float()) + bias
        if min_new_tokens > 0:
            logits[:, eos] = torch.where(n < min_new_tokens, sampling.NEG_INF, logits[:, eos])
        tok = sampling.ras_sample(logits, recent, top_p=top_p, top_k=top_k, win_size=RAS_WINDOW,
                                  tau_r=RAS_TAU, generator=generator, rank_bf16=rank_bf16,
                                  noise=None if noise is None else (noise[0][i], noise[1][i]))
        tok = torch.where(done, eos, tok)
        done = done | (tok == eos)
        recent = torch.cat([recent[:, 1:], tok[:, None]], 1)
        toks.append(tok)
        h, state = decode(cosy.decode_embed(params, cfg, tok), state)
        h = h.to(bb.dtype)
        n = n + 1
    return (h, state, done, recent, n), torch.stack(toks, 1)


def _b1_decoder(params, cfg: cosy.CosyConfig, mega):
    """The backbone step of a Cosy decode: the B=1 whole-step kernel
    (``decode_mega.decode_step_mega``) on `mega`, or, without it, the
    model's ``rwkv7.decode_step`` (the WKV step kernel on a card) on the
    per-layer views of `params` (``rwkv7.pack_decode_params``'s tree)."""
    bb = cfg.backbone
    if mega is not None:
        return lambda x, st: dm.decode_step_mega(mega, bb, x, st)
    views = rwkv7.layer_decode_views(params, bb)
    return lambda x, st: rwkv7.decode_step(views, bb, x, st)


@torch.inference_mode()
def cosy_prefill_carry(params, cfg: cosy.CosyConfig, tokens: torch.Tensor,
                       modality: torch.Tensor, attention_mask: torch.Tensor, *,
                       mega_state: bool = False, wkv_dtype: torch.dtype = torch.bfloat16):
    """Prefill a left-padded prompt (B, T) and build the carry of
    ``cosy_decode_chunk``: (h (B, C), the decode state, done (B,), recent
    (B, RAS_WINDOW) of -1, n (B,)). With `mega_state` the state is the B=1
    whole-step kernel's (B must be 1; the WKV state in `wkv_dtype`, bf16
    the deployed carry), otherwise ``rwkv7.pack_decode_state``'s."""
    if mega_state and tokens.shape[0] != 1:
        raise ValueError(f"the B=1 decode step takes B=1, got {tokens.shape[0]}")
    h, state = cosy.prefill(params, cfg, tokens, modality, attention_mask)
    B, dev = tokens.shape[0], tokens.device
    state = (dm.pack_state(state, wkv_dtype) if mega_state
             else rwkv7.pack_decode_state(state, cfg.backbone))
    return (h, state, torch.zeros(B, dtype=torch.bool, device=dev),
            torch.full((B, RAS_WINDOW), -1, dtype=torch.long, device=dev),
            torch.zeros(B, dtype=torch.long, device=dev))


@torch.inference_mode()
def cosy_decode_chunk(
    params, cfg: cosy.CosyConfig, carry, noise: Tuple[torch.Tensor, torch.Tensor], *,
    mega=None,
    min_new_tokens: int = 0,
    top_k: int = 25,
    top_p: float = 0.8,
    rank_bf16: bool = False,
):
    """Decode a chunk of Cosy speech tokens from a carried state
    (``cosy_prefill_carry``'s, with ``mega_state`` iff `mega` is given):
    through the B=1 whole-step kernel on `mega` (``decode_mega.pack_mega``),
    or through ``rwkv7.decode_step`` on `params`; a step a row of `noise` =
    (nucleus (n, B, k), fallback (n, B, V)), the Gumbel noise of the two
    RAS draws; `rank_bf16` as ``_cosy_loop``'s. Returns (carry, toks (B,
    n) on the device, done (B,)); the carry's state is updated in place
    where the step does so."""
    carry, toks = _cosy_loop(params, cfg, carry, _b1_decoder(params, cfg, mega), noise[0].shape[0],
                             noise, None, min_new_tokens=min_new_tokens, top_k=top_k, top_p=top_p,
                             rank_bf16=rank_bf16)
    return carry, toks, carry[2]


@torch.inference_mode()
def cosy_generate(
    params, cfg: cosy.CosyConfig, tokens: torch.Tensor, modality: torch.Tensor,
    attention_mask: torch.Tensor, *,
    max_new_tokens: int = 1024,
    min_new_tokens: int = 0,
    top_k: int = 25,
    top_p: float = 0.8,
    mega=None,
    chunk_len: int = 64,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    rank_bf16: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """CosyVoice speech-token generation (rwkvtts_tpu's cosy_generate):
    RAS sampling, EOS suppressed below `min_new_tokens`. The decode runs
    through ``rwkv7.decode_step`` on `params` (``rwkv7.pack_decode_params``'s
    tree), or through the B=1 whole-step kernel on `mega` (B = 1, the WKV
    state carried in bf16). It goes in chunks of `chunk_len` steps
    and stops once every row has drawn EOS (one host read a chunk); the
    rows are those of a run of all max_new_tokens steps. Draws: step i
    takes noise[0][i] / noise[1][i] (shapes (max_new_tokens, B, k) and
    (max_new_tokens, B, V)), or a chunk's noise is drawn from `generator`
    on its own device (``sampling.ras_noise``) and moved to the prompt's.
    `rank_bf16`: the sampler ranks the bf16 logits (``_cosy_loop``).
    Returns (generated (B, max_new_tokens), EOS after a row's end, and
    lengths (B,)) on the device."""
    if noise is None and generator is None:
        raise ValueError("cosy_generate: pass the draws' `noise` or a `generator`")
    eos, V = cfg.eos_token_id, cfg.speech_head_size
    B, dev = tokens.shape[0], tokens.device
    carry = cosy_prefill_carry(params, cfg, tokens, modality, attention_mask,
                               mega_state=mega is not None)
    chunks, n = [], 0
    while n < max_new_tokens:
        cl = min(chunk_len, max_new_tokens - n)
        draws = ((noise[0][n:n + cl], noise[1][n:n + cl]) if noise is not None
                 else sampling.ras_noise(generator, cl, B, min(top_k, V), V, dev))
        carry, toks, done = cosy_decode_chunk(params, cfg, carry, draws, mega=mega,
                                              min_new_tokens=min_new_tokens, top_k=top_k,
                                              top_p=top_p, rank_bf16=rank_bf16)
        chunks.append(toks)
        n += cl
        if bool(done.all()):
            break
    out = torch.cat(chunks, 1)
    out = torch.cat([out, torch.full((B, max_new_tokens - n), eos, dtype=out.dtype, device=dev)], 1)
    return out, _eos_lengths(out, eos, max_new_tokens)


@torch.inference_mode()
def cosy_generate_mega_b64(
    params, mega, cfg: cosy.CosyConfig, tokens: torch.Tensor, modality: torch.Tensor,
    attention_mask: torch.Tensor, *,
    max_new_tokens: int = 1024,
    min_new_tokens: int = 0,
    top_k: int = 25,
    top_p: float = 0.8,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    rank_bf16: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``cosy_generate`` with the decode routed through the B=64 whole-step
    kernel (``decode_mega_b64.decode_step_mega_b64`` on `mega`, what
    ``pack_mega_b64`` returns): the Cosy layout of batched offline
    generation. All max_new_tokens steps run. tokens/modality/
    attention_mask: a left-padded prompt of exactly 64 rows. Returns
    (generated (64, max_new_tokens), EOS after a row's end, and lengths
    (64,)) on the device."""
    eos, bb = cfg.eos_token_id, cfg.backbone
    if tokens.shape[0] != dmb.B:
        raise ValueError(f"the decode step takes B={dmb.B}, got {tokens.shape[0]}")
    h, state = cosy.prefill(params, cfg, tokens, modality, attention_mask)
    B, dev = tokens.shape[0], tokens.device
    carry = (h, dmb.pack_state(state), torch.zeros(B, dtype=torch.bool, device=dev),
             torch.full((B, RAS_WINDOW), -1, dtype=torch.long, device=dev),
             torch.zeros(B, dtype=torch.long, device=dev))
    _, out = _cosy_loop(params, cfg, carry,
                        lambda x, st: dmb.decode_step_mega_b64(mega, bb, x, st),
                        max_new_tokens, noise, generator, min_new_tokens=min_new_tokens,
                        top_k=top_k, top_p=top_p, rank_bf16=rank_bf16)
    return out, _eos_lengths(out, eos, max_new_tokens)


@torch.inference_mode()
def xy_generate(
    params, cfg: xy.XYConfig, input_ids: torch.Tensor, attention_mask: torch.Tensor, *,
    max_new_tokens: int = 512,
    min_new_tokens: int = 0,
    temperature: float = 1.0,
    allow_eos: bool = True,
    mega=None,
    generator: Optional[torch.Generator] = None,
    noise=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """XY 8-channel generation with the staggered flush automaton
    (rwkvtts_tpu's xy_generate; the reference's
    ``CustomGenerationMixin._sample``, xy_llm.py:39-146).

    input_ids (B, T, 8), a left-padded prompt. Each step: the 8 channels'
    logits; channel 0 masked to the audio range [text_shift, text_shift +
    speech_vocab), plus its EOS (the text pad) with `allow_eos`, the EOS
    masked while a row has fewer than `min_new_tokens` audio steps; an
    independent temperature draw a channel; then the flush: once channel 0
    leaves the audio range a row counts down 7 steps, emitting EOS on
    channel 0 and, on channel i, PAD once the countdown is below 8 - i; a
    finished row emits EOS / PAD frames; the frame's embedding goes
    through the backbone step. As in the JAX package, `allow_eos` keeps
    the EOS drawable after `min_new_tokens`, so the flush is reachable.

    The backbone step is the B=64 whole-step kernel on `mega` (what
    ``decode_mega_b64.pack_mega_b64`` returns; B must be 64), or, without
    it, ``rwkv7.decode_step`` on the per-layer views of `params` (the WKV
    step kernel on a card); the heads and embeddings come from `params`
    either way. Draws: channel c of step i takes noise[c][i] (a list of
    one (max_new_tokens, B, V_c) tensor a channel), or Gumbel noise drawn
    from `generator`. All max_new_tokens steps run. Returns (frames (B,
    max_new_tokens, 8), n_audio (B,)) on the device. n_audio counts, as the
    JAX package does, each step whose channel-0 draw is audio until the
    row finishes, the draws of its 7 countdown steps included (whose
    frames carry EOS); the audio steps before the flush are those before
    channel 0's first EOS (``XYPipeline`` cuts there)."""
    if noise is None and generator is None:
        raise ValueError("xy_generate: pass the draws' `noise` or a `generator`")
    bb, nch = cfg.backbone, cfg.num_channels
    B, dev = input_ids.shape[0], input_ids.device
    if mega is not None and B != dmb.B:
        raise ValueError(f"the decode step takes B={dmb.B}, got {B}")
    lo, hi = cfg.text_shift_size, cfg.text_shift_size + cfg.speech_vocab_size
    eos0, pad = cfg.text_pad_id, cfg.speech_pad_id

    h, state = xy.prefill(params, cfg, input_ids, attention_mask)
    if mega is not None:
        state = dmb.pack_state(state)
        step = lambda x, st: dmb.decode_step_mega_b64(mega, bb, x, st)
    else:
        state = rwkv7.pack_decode_state(state, bb)
        views = rwkv7.layer_decode_views(params, bb)
        step = lambda x, st: rwkv7.decode_step(views, bb, x, st)
    ids0 = torch.arange(cfg.text_vocab_size, device=dev)
    allowed0 = (ids0 >= lo) & (ids0 < hi)
    if allow_eos:
        allowed0 = allowed0 | (ids0 == eos0)
    stagger = nch - torch.arange(1, nch, device=dev)  # channel i pads once countdown < 8 - i
    countdown = torch.full((B,), -1, dtype=torch.long, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    n = torch.zeros(B, dtype=torch.long, device=dev)
    frames = []
    for i in range(max_new_tokens):
        logits = xy.channel_logits(params, cfg, h)
        l0 = torch.where(allowed0, logits[0], sampling.NEG_INF)
        if min_new_tokens > 0:
            l0[:, eos0] = torch.where(n < min_new_tokens, sampling.NEG_INF, l0[:, eos0])
        logits[0] = l0
        frame = torch.stack([
            sampling.sample(lc, temperature=temperature, generator=generator,
                            noise=None if noise is None else noise[c][i])
            for c, lc in enumerate(logits)], -1)

        is_audio = (frame[:, 0] >= lo) & (frame[:, 0] < hi)
        countdown = torch.where(~is_audio & (countdown < 0), nch - 1, countdown)
        flushing = countdown >= 0
        ch0 = torch.where(flushing | done, eos0, frame[:, 0])
        pads = (flushing[:, None] & (countdown[:, None] < stagger)) | done[:, None]
        frame = torch.cat([ch0[:, None], torch.where(pads, pad, frame[:, 1:])], 1)
        countdown = torch.where(flushing, countdown - 1, countdown)
        n = n + (is_audio & ~done)
        done = done | (flushing & (countdown < 0))
        frames.append(frame)

        h, state = step(xy.decode_embed(params, cfg, frame), state)
        h = h.to(bb.dtype)
    return torch.stack(frames, 1), n
