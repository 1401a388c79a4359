"""Autoregressive generation (counterpart of two paths of
rwkvtts_tpu/infer/generate.py): Spark B=64 batched generation
(``spark_generate_mega_b64``) and the Cosy B=1 chunked decode of the
streaming path (``cosy_prefill_carry`` + ``cosy_decode_chunk`` on the
whole-step decode route).

Prefill runs the full-sequence model (the WKV7 kernel on a card), the
state is packed for the decode step, then every step is: head product
(model dtype) -> f32 logits -> sample -> EOS latch -> embedding -> the
decode step (the decode kernels on a card) -> hidden cast to the model
dtype. The loops are plain Python loops that keep the EOS latch, the
counters and the RAS window on the device: the host reads a chunk's
tokens once, after it. On a CPU everything runs the plain versions.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from rwkvtts_torch.models import cosy, spark
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
