"""Autoregressive Spark generation (counterpart of the Spark B=64 path of
rwkvtts_tpu/infer/generate.py, ``spark_generate_mega_b64``).

Prefill runs the full-sequence model (the WKV7 kernel on a card), the
state is packed to bf16, then every step is: head product (model dtype)
-> f32 logits -> sample -> EOS latch -> semantic embedding -> the B=64
decode step (the decode kernels on a card) -> hidden cast to the model
dtype. The loop is a plain Python loop; on a CPU everything runs the
plain versions.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from rwkvtts_torch.models import spark
from rwkvtts_torch.ops import decode_mega_b64 as dmb
from rwkvtts_torch.ops import sampling


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
