"""Spark-TTS RWKV-7 speech LM in PyTorch (counterpart of
rwkvtts_tpu/models/spark.py): config, parameters, the modality embedding
layout, the training forward (loss), the prompt prefill and the per-step
embedding of generation."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from rwkvtts_torch.models import rwkv7
from rwkvtts_torch.ops import loss as loss_ops

# modality codes used by collators and embed_layout
MOD_PAD = 0
MOD_TEXT = 1
MOD_GLOBAL = 2
MOD_TAG = 3
MOD_SEMANTIC = 4

# tts_tag_embedder rows
TAG_GLOBAL = 0
TAG_SEMANTIC = 1
TAG_START_TTS = 2


@dataclasses.dataclass(frozen=True)
class SparkTTSConfig:
    backbone: rwkv7.RWKV7Config
    text_vocab_size: int = 65536
    audio_global_vocab_size: int = 4096
    dropout: float = 0.02  # on the input embeddings, in training

    @property
    def semantic_vocab_size(self) -> int:  # incl. EOS
        return self.backbone.vocab_size

    @property
    def eos_token_id(self) -> int:
        return self.backbone.vocab_size - 1  # 8192


def default_config(hidden_size=768, num_layers=12, dtype=torch.bfloat16,
                   dropout=0.02, **kw) -> SparkTTSConfig:
    bb = rwkv7.RWKV7Config(vocab_size=8193, hidden_size=hidden_size,
                           num_layers=num_layers, dtype=dtype, **kw)
    return SparkTTSConfig(backbone=bb, dropout=dropout)


def init_params(g: torch.Generator, cfg: SparkTTSConfig) -> Dict[str, Any]:
    """f32 parameters drawn from `g`, on the generator's device (the JAX
    package's tree, shapes and distributions; other values)."""
    C = cfg.backbone.hidden_size
    p = rwkv7.init_params(g, cfg.backbone)
    emb = lambda v: torch.randn(v, C, generator=g, device=g.device) * 0.02
    p["text_embedder"] = emb(cfg.text_vocab_size)
    p["global_embedder"] = emb(cfg.audio_global_vocab_size)
    p["tts_tag_embedder"] = emb(3)
    return p


def embed_layout(params, cfg: SparkTTSConfig, tokens: torch.Tensor,
                 modality: torch.Tensor) -> torch.Tensor:
    """(B,T) ids + (B,T) modality codes -> (B,T,C) embeddings: four
    gathers and a select; pad positions embed to zero."""
    dt = cfg.backbone.dtype

    def clip(tbl, n):
        return params[tbl][tokens.clamp(0, n - 1)].to(dt)

    m = modality[..., None]
    out = torch.where(m == MOD_TEXT, clip("text_embedder", cfg.text_vocab_size), 0.0)
    out = torch.where(m == MOD_GLOBAL,
                      clip("global_embedder", cfg.audio_global_vocab_size), out)
    out = torch.where(m == MOD_TAG, clip("tts_tag_embedder", 3), out)
    out = torch.where(m == MOD_SEMANTIC, clip("embedding", cfg.semantic_vocab_size), out)
    return out.to(dt)


def forward(
    params, cfg: SparkTTSConfig, tokens: torch.Tensor, modality: torch.Tensor,
    labels: Optional[torch.Tensor] = None,
    attention_mask: Optional[torch.Tensor] = None,
    resets: Optional[torch.Tensor] = None,
    dropout_generator: Optional[torch.Generator] = None,
    l2_wrap: float = 0.0,
):
    """Training / eval forward. With labels -> (loss, n_valid), the fused
    linear CE with the internal label shift; without -> hidden (B, T, C).
    Input dropout (cfg.dropout) draws from `dropout_generator` (on the
    tokens' device) and is off without one."""
    x = embed_layout(params, cfg, tokens, modality)
    if dropout_generator is not None and cfg.dropout > 0:
        keep = torch.rand(x.shape, generator=dropout_generator,
                          device=x.device) >= cfg.dropout
        x = torch.where(keep, x / (1 - cfg.dropout), 0.0).to(x.dtype)
    h = rwkv7.forward(params, cfg.backbone, inputs_embeds=x,
                      attention_mask=attention_mask, resets=resets)
    if labels is None:
        return h
    return loss_ops.fused_linear_cross_entropy(h, params["head"], labels, shift=True,
                                               l2_wrap=l2_wrap)


def prefill(params, cfg: SparkTTSConfig, tokens, modality,
            attention_mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Any]:
    """Run the prompt; returns (last hidden (B,C), model state)."""
    x = embed_layout(params, cfg, tokens, modality)
    h, st = rwkv7.forward(params, cfg.backbone, inputs_embeds=x,
                          attention_mask=attention_mask, return_state=True)
    return h[:, -1, :], st


def decode_embed(params, cfg: SparkTTSConfig, token_ids: torch.Tensor) -> torch.Tensor:
    """Embedding of sampled semantic tokens (B,) -> (B,C)."""
    return params["embedding"][token_ids].to(cfg.backbone.dtype)
