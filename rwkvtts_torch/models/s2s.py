"""Speech-to-speech single-FFN RWKV-7 (counterpart of
rwkvtts_tpu/models/s2s.py; the reference's RWKV7S2S_SingleFFN,
model/llm/rwkv_s2s_single_ffn.py:276-330).

One block stack over a combined [text | audio] vocabulary and two output
heads, text (65,536) and audio (8,192), chosen per call. Audio ids enter
the embedding offset by the text vocabulary (the enlarged-vocabulary
contract of ``convert/speech_init.s2s_enlarge_vocab``).

``generate`` differs from the JAX package's on purpose where a prompt is
padded: it packs the prompt right-aligned by its mask before the prefill
(``ops/packing.right_align_pack``, as the ASR and two-tower forwards
pack), so each row's last position is its last token. The JAX package
prefills the prompt as given, and the collator pads on the right, so a
shorter row's state decays through its pads and its first draw reads a
pad position (ROADMAP, known faults of the reference). A batch without
pads, or padded on the left, is the same either way.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from rwkvtts_torch.infer.generate import latched_decode
from rwkvtts_torch.models import rwkv7
from rwkvtts_torch.ops import loss as loss_ops
from rwkvtts_torch.ops.packing import right_align_pack

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class S2SConfig:
    backbone: rwkv7.RWKV7Config
    text_vocab_size: int = 65536
    audio_vocab_size: int = 8192


def default_config(
    hidden_size=1024, num_layers=24, vocab_size=65536 + 8192,
    text_vocab=65536, audio_vocab=8192, dtype=torch.bfloat16, **kw,
) -> S2SConfig:
    bb = rwkv7.RWKV7Config(vocab_size=vocab_size, hidden_size=hidden_size,
                           num_layers=num_layers, dtype=dtype, with_head=False, **kw)
    return S2SConfig(backbone=bb, text_vocab_size=text_vocab, audio_vocab_size=audio_vocab)


def init_params(g: torch.Generator, cfg: S2SConfig) -> Params:
    """f32 parameters drawn from `g`, on its device: the backbone with its
    combined embedding, and the two heads (C, V), orthogonal."""
    p = rwkv7.init_params(g, cfg.backbone)
    C = cfg.backbone.hidden_size
    for name, V in (("head", cfg.text_vocab_size), ("audio_head", cfg.audio_vocab_size)):
        p[name] = rwkv7._orthogonal(g, (C, V), 0.5 * math.sqrt(V / C) if V > C else 0.5)
    return p


def _head(params: Params, is_text: bool) -> torch.Tensor:
    return params["head"] if is_text else params["audio_head"]


@torch.inference_mode()
def generate(
    params: Params, cfg: S2SConfig, input_ids: torch.Tensor, *,
    is_text: bool = True,
    attention_mask: Optional[torch.Tensor] = None,
    max_new_tokens: int = 256,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
    eos_id: int = 0,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Autoregressive decode on the chosen head (text or audio): the prompt
    packed right-aligned and prefilled (kernel 2 on a card), then
    max_new_tokens steps of ``infer/generate.latched_decode`` (kernel 7;
    audio draws offset by text_vocab_size on the input side).
    Greedy at temperature 0; otherwise ``ops/sampling.sample`` with `noise`
    (max_new_tokens, B, width), row i for step i, or `generator`. Returns
    (tokens (B, max_new_tokens), lengths (B,))."""
    bb, dt = cfg.backbone, cfg.backbone.dtype
    emb = params["embedding"][input_ids.long()].to(dt)
    if attention_mask is not None:
        emb, attention_mask, _ = right_align_pack([(emb, attention_mask, None)], emb.shape[1])
    h, state = rwkv7.forward(params, bb, inputs_embeds=emb, attention_mask=attention_mask,
                             return_state=True)
    offset = 0 if is_text else cfg.text_vocab_size
    return latched_decode(
        rwkv7.layer_decode_views(params, bb), bb, h[:, -1], rwkv7.pack_decode_state(state, bb),
        _head(params, is_text).to(dt), lambda tok: params["embedding"][tok + offset].to(dt),
        eos_id, max_new_tokens, temperature=temperature, top_k=top_k, top_p=top_p,
        noise=noise, generator=generator)


def forward(
    params: Params, cfg: S2SConfig, input_ids: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    is_text: bool = True,
    labels: Optional[torch.Tensor] = None,
    l2_wrap: float = 1e-4,
):
    """The shared stack, then the head chosen by `is_text`: with labels
    (loss, n_valid), else that head's f32 logits (B, T, V)."""
    h = rwkv7.forward(params, cfg.backbone, input_ids=input_ids.long(),
                      attention_mask=attention_mask)
    w = _head(params, is_text)
    if labels is not None:
        return loss_ops.fused_linear_cross_entropy(h, w, labels.long(), shift=True,
                                                   l2_wrap=l2_wrap)
    return (h @ w.to(h.dtype)).float()
