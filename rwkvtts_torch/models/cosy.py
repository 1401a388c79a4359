"""CosyVoice RWKV-7 speech LM in PyTorch (counterpart of
rwkvtts_tpu/models/cosy.py): config, parameters, the embedding layout, the
forward, the prompt prefill, the per-step embedding and the EOS state
reset.

Layout [SOS][text][TASK][speech ...]; the speech vocabulary is 6561 S3
tokens plus EOS (id 6561), so the head has 6562 outputs and a bias. The
backbone has no token table or head of its own (``vocab_size`` 0): the
text, special and speech tables live here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from rwkvtts_torch.models import rwkv7
from rwkvtts_torch.ops import loss as loss_ops

MOD_PAD = 0
MOD_TEXT = 1
MOD_SPECIAL = 2  # llm_embedding rows (SOS_EOS = 0, TASK = 1)
MOD_SPEECH = 3

SOS_EOS = 0
TASK_ID = 1

END_OF_PROMPT_TEXT_ID = 65531  # instruction / content split marker


@dataclasses.dataclass(frozen=True)
class CosyConfig:
    backbone: rwkv7.RWKV7Config
    text_vocab_size: int = 65536
    speech_token_size: int = 6561  # EOS == speech_token_size
    lsm_weight: float = 0.0  # label smoothing of the training loss
    length_normalized_loss: bool = True  # divide by the tokens, else by the rows
    drop_ratio: float = 0.0  # input-embedding dropout in training

    @property
    def speech_head_size(self) -> int:
        return self.speech_token_size + 1

    @property
    def eos_token_id(self) -> int:
        return self.speech_token_size


def default_config(hidden_size=768, num_layers=12, dtype=torch.bfloat16, **kw) -> CosyConfig:
    bb = rwkv7.RWKV7Config(vocab_size=0, hidden_size=hidden_size, num_layers=num_layers,
                           dtype=dtype, **kw)
    return CosyConfig(backbone=bb)


def init_params(g: torch.Generator, cfg: CosyConfig) -> Dict[str, Any]:
    """f32 parameters drawn from `g`, on the generator's device (the JAX
    package's tree, shapes and distributions; other values)."""
    C = cfg.backbone.hidden_size
    p = rwkv7.init_params(g, cfg.backbone)
    normal = lambda *shape: torch.randn(shape, generator=g, device=g.device) * 0.02
    p["text_embedding"] = normal(cfg.text_vocab_size, C)
    p["llm_embedding"] = normal(2, C)
    p["speech_embedding"] = normal(cfg.speech_head_size, C)
    p["head"] = normal(C, cfg.speech_head_size)
    p["head_bias"] = torch.zeros(cfg.speech_head_size, device=g.device)
    return p


def embed_layout(params, cfg: CosyConfig, tokens: torch.Tensor,
                 modality: torch.Tensor) -> torch.Tensor:
    """(B,T) ids + (B,T) modality codes -> (B,T,C) embeddings; pad
    positions embed to zero."""
    dt = cfg.backbone.dtype
    clip = lambda tbl, n: params[tbl][tokens.clamp(0, n - 1)].to(dt)
    m = modality[..., None]
    out = torch.where(m == MOD_TEXT, clip("text_embedding", cfg.text_vocab_size), 0.0)
    out = torch.where(m == MOD_SPECIAL, clip("llm_embedding", 2), out)
    out = torch.where(m == MOD_SPEECH, clip("speech_embedding", cfg.speech_head_size), out)
    return out.to(dt)


def forward(params, cfg: CosyConfig, tokens, modality, labels=None, attention_mask=None,
            resets=None, dropout_generator: Optional[torch.Generator] = None):
    """A [SOS][text][TASK][speech] batch. Without labels -> hidden (B, T, C);
    with labels, pre-aligned by the collator (position t predicts
    labels[t], the reference's lm_target[:, 1:], cosy_llm.py:121) ->
    (loss, n_valid): the fused linear CE through the biased head with
    label smoothing ``lsm_weight``, divided by the tokens or, without
    ``length_normalized_loss``, by the rows. Input dropout (``drop_ratio``)
    draws from `dropout_generator` (on the tokens' device) and is off
    without one."""
    x = embed_layout(params, cfg, tokens, modality)
    if dropout_generator is not None and cfg.drop_ratio > 0:
        keep = torch.rand(x.shape, generator=dropout_generator,
                          device=x.device) >= cfg.drop_ratio
        x = torch.where(keep, x / (1 - cfg.drop_ratio), 0.0).to(x.dtype)
    h = rwkv7.forward(params, cfg.backbone, inputs_embeds=x,
                      attention_mask=attention_mask, resets=resets)
    if labels is None:
        return h
    return loss_ops.fused_linear_cross_entropy(
        h, params["head"], labels, bias=params.get("head_bias"), shift=False,
        smoothing=cfg.lsm_weight, normalize_length=cfg.length_normalized_loss)


def prefill(params, cfg: CosyConfig, tokens, modality, attention_mask=None):
    """Run the prompt; returns (last hidden (B, C), model state)."""
    x = embed_layout(params, cfg, tokens, modality)
    h, st = rwkv7.forward(params, cfg.backbone, inputs_embeds=x,
                          attention_mask=attention_mask, return_state=True)
    return h[:, -1, :], st


def decode_embed(params, cfg: CosyConfig, token_ids: torch.Tensor) -> torch.Tensor:
    """Embedding of sampled speech tokens (B,) -> (B, C)."""
    return params["speech_embedding"][token_ids].to(cfg.backbone.dtype)


def reset_shift_states(state):
    """EOS handling (reference cosy_llm.py:248-252): zero the token-shift
    states, keep the WKV state."""
    return {"att_x": torch.zeros_like(state["att_x"]), "wkv": state["wkv"],
            "ffn_x": torch.zeros_like(state["ffn_x"])}
