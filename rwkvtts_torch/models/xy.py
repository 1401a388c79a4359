"""XY/Higgs 8-channel RWKV-7 speech LM in PyTorch (counterpart of
rwkvtts_tpu/models/xy.py): config, parameters, the summed channel
embeddings, the training forward (the sum of the 8 per-channel CEs), the
per-channel logits of a step, the prompt prefill and the per-step
embedding of a sampled frame.

Channel 0 is the extended text vocabulary (65536 world + 1024 [SP*] + 10
[S*] + 90 [CTL*]), channels 1-7 the 1024-entry speech vocabulary; audio
on channel 0 lives at [text_shift_size, text_shift_size + 1024). The
backbone has no token table or head of its own (``vocab_size`` 0): the
8 tables and 8 heads live here, as {"0": ..., "7": ...} dicts. The heads
are ``torch.matmul``, as the JAX package leaves them to XLA.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch

from rwkvtts_torch.models import rwkv7
from rwkvtts_torch.ops import loss as loss_ops


@dataclasses.dataclass(frozen=True)
class XYConfig:
    backbone: rwkv7.RWKV7Config
    text_vocab_size: int = 66660  # 65536 + 1024 [SP*] + 10 [S*] + 90 [CTL*]
    speech_vocab_size: int = 1024
    num_channels: int = 8
    text_shift_size: int = 65536
    lsm_weight: float = 0.0
    drop_ratio: float = 0.0

    @property
    def speech_pad_id(self) -> int:
        return self.speech_vocab_size - 1

    @property
    def text_pad_id(self) -> int:
        return self.text_vocab_size - 1


def default_config(hidden_size=768, num_layers=12, dtype=torch.bfloat16, **kw) -> XYConfig:
    bb = rwkv7.RWKV7Config(vocab_size=0, hidden_size=hidden_size, num_layers=num_layers,
                           dtype=dtype, **kw)
    return XYConfig(backbone=bb)


def _vocab(cfg: XYConfig, i: int) -> int:
    return cfg.text_vocab_size if i == 0 else cfg.speech_vocab_size


def init_params(g: torch.Generator, cfg: XYConfig) -> Dict[str, Any]:
    """f32 parameters drawn from `g`, on the generator's device (the JAX
    package's tree, shapes and distributions; other values). Each table's
    pad row is zero (the reference's ``zero_embs``)."""
    C = cfg.backbone.hidden_size
    p = rwkv7.init_params(g, cfg.backbone)
    normal = lambda *shape: torch.randn(shape, generator=g, device=g.device) * 0.02
    embs, heads = {}, {}
    for i in range(cfg.num_channels):
        V = _vocab(cfg, i)
        embs[str(i)] = normal(V, C)
        embs[str(i)][cfg.text_pad_id if i == 0 else cfg.speech_pad_id] = 0.0
        heads[str(i)] = normal(C, V)
    p["embs"], p["heads"] = embs, heads
    return p


def decode_embed(params, cfg: XYConfig, frame: torch.Tensor) -> torch.Tensor:
    """(..., 8) channel tokens -> (..., C): the sum of the per-channel
    table rows, in the model dtype."""
    dt = cfg.backbone.dtype
    out = params["embs"]["0"][frame[..., 0]].to(dt)
    for i in range(1, cfg.num_channels):
        out = out + params["embs"][str(i)][frame[..., i]].to(dt)
    return out


embed_channels = decode_embed  # (B, T, 8) -> (B, T, C), the same sum


def forward(params, cfg: XYConfig, input_ids: torch.Tensor,
            labels: Optional[torch.Tensor] = None,
            attention_mask: Optional[torch.Tensor] = None,
            resets: Optional[torch.Tensor] = None,
            dropout_generator: Optional[torch.Generator] = None):
    """input_ids / labels (B, T, 8); labels are pre-shifted by the collator
    (position t predicts labels[t]). Without labels -> hidden (B, T, C);
    with them -> (the sum of the 8 channels' mean CEs, the sum of their
    valid counts), each CE with cfg.lsm_weight label smoothing. Input
    dropout (cfg.drop_ratio) draws from `dropout_generator` (on the ids'
    device) and is off without one."""
    x = embed_channels(params, cfg, input_ids)
    if dropout_generator is not None and cfg.drop_ratio > 0:
        keep = torch.rand(x.shape, generator=dropout_generator,
                          device=x.device) >= cfg.drop_ratio
        x = torch.where(keep, x / (1 - cfg.drop_ratio), 0.0).to(x.dtype)
    h = rwkv7.forward(params, cfg.backbone, inputs_embeds=x,
                      attention_mask=attention_mask, resets=resets)
    if labels is None:
        return h
    total, total_n = 0.0, 0
    for i in range(cfg.num_channels):
        li, ni = loss_ops.fused_linear_cross_entropy(
            h, params["heads"][str(i)], labels[..., i], shift=False, smoothing=cfg.lsm_weight)
        total, total_n = total + li, total_n + ni
    return total, total_n


def channel_logits(params, cfg: XYConfig, h: torch.Tensor) -> List[torch.Tensor]:
    """Per-channel logits of one step, h (B, C): a list of (B, V_i) f32
    (the product in the model dtype)."""
    dt = cfg.backbone.dtype
    return [(h @ params["heads"][str(i)].to(dt)).float() for i in range(cfg.num_channels)]


def prefill(params, cfg: XYConfig, input_ids: torch.Tensor,
            attention_mask: Optional[torch.Tensor] = None):
    """Run the prompt (B, T, 8); returns (last hidden (B, C), model state)."""
    x = embed_channels(params, cfg, input_ids)
    h, st = rwkv7.forward(params, cfg.backbone, inputs_embeds=x,
                          attention_mask=attention_mask, return_state=True)
    return h[:, -1, :], st
