"""RWKV-7 ASR model family (counterpart of rwkvtts_tpu/models/asr.py).

Two variants, as in the reference:
  * "whisper": a frozen Whisper encoder -> projector1 -> an audio-adapter
    RWKV-7 with no embedding and no head -> projector -> the LLM
    (model/llm/rwkv_asr_whisper.py:48-238);
  * "discrete": an audio LM over audio token ids (its own embedding, no
    head) -> projector -> the LLM (model/llm/rwkv_asr.py:16-165).

The LLM reads [instruction][audio][hints][answer], each segment packed
right-aligned by its valid count (``ops/packing.right_align_pack``), so a
row's last position is its last valid token; labels are -100 except over
the answer. ``transcribe`` prefills [instruction][audio][hints] the same
way (kernel 2 on a card, in the adapter and in the LLM) and then decodes
on ``rwkv7.decode_step`` (kernel 7), greedy or sampled.

Instruction contract (train_scripts/train_rwkv7_asr_jsonl.py:360-366):
``data/asr_collator.py``'s INSTRUCTIONS and HINTS, EOS id 0.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from rwkvtts_torch.infer.generate import latched_decode
from rwkvtts_torch.models import rwkv7, whisper
from rwkvtts_torch.ops import loss as loss_ops
from rwkvtts_torch.ops.packing import right_align_pack

Params = Dict[str, Any]

EOS_ID = 0  # world-vocab <|endoftext|> (rwkv_asr.py:184)


@dataclasses.dataclass(frozen=True)
class ASRConfig:
    llm: rwkv7.RWKV7Config
    adapter: rwkv7.RWKV7Config  # the audio LM; an embedding only for "discrete"
    variant: str = "whisper"  # "whisper" | "discrete"
    whisper: Optional[whisper.WhisperEncoderConfig] = None


def default_config(
    hidden_size=768, num_layers=12, adapter_layers=6, audio_vocab=8193,
    variant="whisper", dtype=torch.bfloat16, **kw,
) -> ASRConfig:
    llm = rwkv7.RWKV7Config(vocab_size=65536, hidden_size=hidden_size,
                            num_layers=num_layers, dtype=dtype, **kw)
    adapter = rwkv7.RWKV7Config(
        vocab_size=audio_vocab, hidden_size=hidden_size, num_layers=adapter_layers,
        dtype=dtype, with_head=False, with_embedding=(variant == "discrete"), **kw)
    wcfg = whisper.WhisperEncoderConfig(d_model=hidden_size) if variant == "whisper" else None
    return ASRConfig(llm=llm, adapter=adapter, variant=variant, whisper=wcfg)


def init_params(g: torch.Generator, cfg: ASRConfig) -> Params:
    """f32 parameters drawn from `g`, on its device: the JAX tree's names
    and shapes."""
    C_a, C_l, dev = cfg.adapter.hidden_size, cfg.llm.hidden_size, g.device
    p: Params = {
        "adapter": rwkv7.init_params(g, cfg.adapter),
        "projector": {"w": torch.randn(C_a, C_l, generator=g, device=dev) * 0.02,
                      "b": torch.zeros(C_l, device=dev)},
        "llm": rwkv7.init_params(g, cfg.llm),
    }
    if cfg.variant == "whisper":
        d = cfg.whisper.d_model
        p["whisper"] = whisper.init_params(g, cfg.whisper)
        p["projector1"] = {"w": torch.randn(d, C_a, generator=g, device=dev) * 0.02,
                           "b": torch.zeros(C_a, device=dev)}
    return p


def _proj(p: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"].to(x.dtype) + p["b"].to(x.dtype)


def audio_embeds(params: Params, cfg: ASRConfig, batch: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The audio tower: (embeds (B, Ta, C_llm), mask (B, Ta)).

    whisper: batch['mel'] (B, T_mel, n_mels) and batch['mel_mask'];
    discrete: batch['audio_ids'] (B, Ta) and batch['audio_mask']. The
    Whisper encoder is frozen: it runs without autograd, in f32, and its
    output is cast to the adapter's dtype."""
    if cfg.variant == "whisper":
        mask = batch.get("mel_mask")
        with torch.no_grad():  # the frozen frontend (rwkv_asr_whisper.py:91-93)
            enc = whisper.apply(params["whisper"], cfg.whisper, batch["mel"], mask)
        h = _proj(params["projector1"], enc.to(cfg.adapter.dtype))
        mask = mask[:, ::2][:, :h.shape[1]] if mask is not None else None
        h = rwkv7.forward(params["adapter"], cfg.adapter, inputs_embeds=h, attention_mask=mask)
    else:
        mask = batch.get("audio_mask")
        h = rwkv7.forward(params["adapter"], cfg.adapter, input_ids=batch["audio_ids"].long(),
                          attention_mask=mask)
    if mask is None:
        mask = torch.ones(h.shape[:2], dtype=torch.int32, device=h.device)
    return _proj(params["projector"], h), mask


def _embed(params: Params, cfg: ASRConfig, ids: torch.Tensor) -> torch.Tensor:
    return params["llm"]["embedding"][ids.long().clamp_min(0)].to(cfg.llm.dtype)


def _prompt(params: Params, cfg: ASRConfig, batch, answer=None):
    """[instruction][audio][hints] (+ the answer segment), packed
    right-aligned: (embeds, mask, labels)."""
    aud, aud_mask = audio_embeds(params, cfg, batch)
    segments = [(_embed(params, cfg, batch["text_ids"]), batch["text_mask"], None),
                (aud.to(cfg.llm.dtype), aud_mask, None),
                (_embed(params, cfg, batch["hints_ids"]), batch["hints_mask"], None)]
    if answer is not None:
        segments.append(answer)
    return right_align_pack(segments, sum(s[0].shape[1] for s in segments))


def forward(params: Params, cfg: ASRConfig, batch: Dict[str, torch.Tensor],
            l2_wrap: float = 1e-4) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward -> (loss, n_valid_tokens).

    batch: text_ids / text_mask (the instruction), mel / mel_mask or
    audio_ids / audio_mask, hints_ids / hints_mask, labels / labels_mask;
    each segment padded on either side (only the masks matter)."""
    lab = batch["labels"].long()
    answer = (_embed(params, cfg, torch.where(lab == -100, 0, lab)), batch["labels_mask"], lab)
    packed, mask, labels = _prompt(params, cfg, batch, answer)
    h = rwkv7.forward(params["llm"], cfg.llm, inputs_embeds=packed, attention_mask=mask)
    return loss_ops.fused_linear_cross_entropy(h, params["llm"]["head"], labels, shift=True,
                                               l2_wrap=l2_wrap)


@torch.inference_mode()
def transcribe(
    params: Params, cfg: ASRConfig, batch: Dict[str, torch.Tensor],
    max_new_tokens: int = 128, temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
    noise: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched decode (rwkv_asr_cuda_whisper.py:694-717): prefill
    [instruction][audio][hints], then max_new_tokens steps of
    ``infer/generate.latched_decode`` (the last step's decode too, as the
    JAX scan does). Greedy at temperature 0, otherwise
    ``ops/sampling.sample`` with `noise` (max_new_tokens, B, width), row i
    for step i, or draws from `generator`.

    Returns (token ids (B, max_new_tokens), lengths (B,)), EOS from a
    row's first EOS on."""
    llm = cfg.llm
    packed, mask, _ = _prompt(params, cfg, batch)
    h, state = rwkv7.forward(params["llm"], llm, inputs_embeds=packed, attention_mask=mask,
                             return_state=True)
    return latched_decode(
        rwkv7.layer_decode_views(params["llm"], llm), llm, h[:, -1],
        rwkv7.pack_decode_state(state, llm), params["llm"]["head"].to(llm.dtype),
        lambda tok: _embed(params, cfg, tok), EOS_ID, max_new_tokens,
        temperature=temperature, top_k=top_k, top_p=top_p, noise=noise, generator=generator)
