"""Two-tower text->audio TTS (counterpart of
rwkvtts_tpu/models/tts_two_tower.py; the reference's RWKV7TTSModel,
model/llm/rwkv_tts.py:8-172).

  * the text tower: an RWKV-7 with no head, its hidden states through a
    linear projector;
  * the audio tower: an RWKV-7 LM over the 12,289-token joint vocabulary
    (4,096 global + 8,193 semantic incl. EOS; rwkv_tts.py:205);
  * layout [projected text][audio tokens], each packed right-aligned by its
    mask (``ops/packing.right_align_pack``), labels -100 over the text.

``generate`` prefills the projected text into the audio tower (kernel 2
on a card) and samples audio tokens on ``rwkv7.decode_step`` (kernel 7).
Unlike the JAX package's, it packs the projected prompt right-aligned
first, as ``forward`` does: the JAX package prefills it as given, so with
the collator's right padding a shorter row's state decays through its
pads (ROADMAP, known faults of the reference). Unpadded or left-padded
prompts are the same either way.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from rwkvtts_torch.infer.generate import latched_decode
from rwkvtts_torch.models import rwkv7
from rwkvtts_torch.ops import loss as loss_ops
from rwkvtts_torch.ops.packing import right_align_pack

Params = Dict[str, Any]

GLOBAL_VOCAB = 4096
SEMANTIC_VOCAB = 8193  # incl. EOS 8192
AUDIO_VOCAB = GLOBAL_VOCAB + SEMANTIC_VOCAB  # 12289
# audio token ids: [0, 4096) global, [4096, 12289) semantic (+4096 offset)
SEMANTIC_OFFSET = GLOBAL_VOCAB
EOS_AUDIO_ID = AUDIO_VOCAB - 1


@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    text: rwkv7.RWKV7Config
    audio: rwkv7.RWKV7Config


def default_config(
    text_hidden=768, text_layers=12, audio_hidden=768, audio_layers=12,
    dtype=torch.bfloat16, **kw,
) -> TwoTowerConfig:
    return TwoTowerConfig(
        text=rwkv7.RWKV7Config(vocab_size=65536, hidden_size=text_hidden,
                               num_layers=text_layers, dtype=dtype, with_head=False, **kw),
        audio=rwkv7.RWKV7Config(vocab_size=AUDIO_VOCAB, hidden_size=audio_hidden,
                                num_layers=audio_layers, dtype=dtype, **kw),
    )


def init_params(g: torch.Generator, cfg: TwoTowerConfig) -> Params:
    """f32 parameters drawn from `g`, on its device: the JAX tree's names
    and shapes."""
    Ct, Ca, dev = cfg.text.hidden_size, cfg.audio.hidden_size, g.device
    return {
        "text_lm": rwkv7.init_params(g, cfg.text),
        "projector": {"w": torch.randn(Ct, Ca, generator=g, device=dev) * 0.02,
                      "b": torch.zeros(Ca, device=dev)},
        "audio_lm": rwkv7.init_params(g, cfg.audio),
    }


def _text_tower(params: Params, cfg: TwoTowerConfig, text_ids: torch.Tensor,
                text_mask: torch.Tensor) -> torch.Tensor:
    """The text tower's projected hidden states (B, T_text, C_audio)."""
    h = rwkv7.forward(params["text_lm"], cfg.text, input_ids=text_ids.long(),
                      attention_mask=text_mask)
    p = params["projector"]
    return h @ p["w"].to(h.dtype) + p["b"].to(h.dtype)


def forward(
    params: Params, cfg: TwoTowerConfig,
    text_ids: torch.Tensor, text_mask: torch.Tensor,
    audio_ids: torch.Tensor, audio_mask: torch.Tensor, labels: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward -> (loss, n_valid); labels over the audio positions
    (audio_ids' shape, -100 allowed)."""
    dt = cfg.audio.dtype
    text_emb = _text_tower(params, cfg, text_ids, text_mask).to(dt)
    audio_emb = params["audio_lm"]["embedding"][audio_ids.long().clamp_min(0)].to(dt)
    packed, mask, packed_labels = right_align_pack(
        [(text_emb, text_mask, None), (audio_emb, audio_mask, labels)],
        text_emb.shape[1] + audio_emb.shape[1])
    h = rwkv7.forward(params["audio_lm"], cfg.audio, inputs_embeds=packed, attention_mask=mask)
    return loss_ops.fused_linear_cross_entropy(h, params["audio_lm"]["head"], packed_labels,
                                               shift=True)


@torch.inference_mode()
def generate(
    params: Params, cfg: TwoTowerConfig, text_ids: torch.Tensor, text_mask: torch.Tensor, *,
    max_new_tokens: int = 1024,
    temperature: float = 1.0,
    top_k: int = 50,
    top_p: float = 0.95,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The projected text prefilled into the audio tower, then
    max_new_tokens sampled steps of ``infer/generate.latched_decode``
    (`noise` (max_new_tokens, B, width), row i for step i, or `generator`).
    Returns (tokens (B, max_new_tokens), lengths (B,))."""
    bb, dt = cfg.audio, cfg.audio.dtype
    text_emb = _text_tower(params, cfg, text_ids, text_mask).to(dt)
    packed, mask, _ = right_align_pack([(text_emb, text_mask, None)], text_emb.shape[1])
    h, state = rwkv7.forward(params["audio_lm"], bb, inputs_embeds=packed, attention_mask=mask,
                             return_state=True)
    lp = rwkv7.layer_decode_views(params["audio_lm"], bb)
    return latched_decode(
        lp, bb, h[:, -1], rwkv7.pack_decode_state(state, bb), lp["head"].to(dt),
        lambda tok: lp["embedding"][tok].to(dt), EOS_AUDIO_ID, max_new_tokens,
        temperature=temperature, top_k=top_k, top_p=top_p, noise=noise, generator=generator)
