"""XY/Higgs TTS pipeline: text -> 8-channel frames -> codec -> wav
(counterpart of rwkvtts_tpu/infer/xy_pipeline.py; SURVEY.md §3.5,
XY_LM.md:103-178).

The prompt "[S{speaker}]{text}[CTL{control}]" goes through ``xy_generate``
on the model's decode step (the prefill's WKV7 kernel and the WKV step
kernel on a card); the frames lose their diagonal delay and channel 0
its text shift (``undo_diagonal``); then the codec the LM was trained on
decodes the codes: XY_Tokenizer (24 kHz, 1920 samples a code; windowed
``decode_long`` past 30 s) or Higgs (16 kHz, 320 samples a code), in f32
with TF32 off. Two faults of the JAX pipeline are not copied: it cuts the
frames at ``xy_generate``'s n_audio, which also counts audio draws of the
flush's countdown steps, so its codes can end in flush frames whose
channel 0 is the EOS (out of the codebook; JAX's gather clamps it); the
port cuts at channel 0's first EOS. And it reports the sample rate its
constructor was given (24000 by default, for Higgs too); the port reports
the rate of the codec that decoded.

Everything runs on `device`, a CUDA device unless the caller asks for the
CPU; the LM's and the codec's parameters are moved there.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from rwkvtts_torch.codecs import higgs, nn
from rwkvtts_torch.codecs import xy_tokenizer as xt
from rwkvtts_torch.data import xy_collator
from rwkvtts_torch.infer import generate as gen
from rwkvtts_torch.models import rwkv7
from rwkvtts_torch.utils.tokenizer import WorldTokenizer

# the XY LM's channel-0 tokens past the world vocabulary, in id order:
# 1024 [SP*], 10 [S*] (speakers), 90 [CTL*] (controls)
XY_ADDED_TOKENS = (tuple(f"[SP{i}]" for i in range(1024)) + tuple(f"[S{i}]" for i in range(10))
                   + tuple(f"[CTL{i}]" for i in range(90)))


def xy_text_tokenizer() -> WorldTokenizer:
    """The world tokenizer with the XY LM's added tokens (ids 65536-66659)."""
    return WorldTokenizer(added_tokens=XY_ADDED_TOKENS)


@dataclasses.dataclass
class XYTTSResult:
    wav: np.ndarray
    sample_rate: int
    codes: np.ndarray  # (nq, T)
    llm_s: float
    codec_s: float


def _to(tree, device):
    return None if tree is None else rwkv7.tree_map(lambda t: t.to(device), tree)


class XYPipeline:
    def __init__(
        self,
        lm_cfg,
        lm_params,
        text_tokenizer,
        codec_cfg=None,  # xy_tokenizer.XYTokenizerConfig | higgs.HiggsConfig
        codec_params=None,
        speaker_id: int = 0,
        codec_kind: str = "xy",  # the token family the LM was trained on
        *,
        device="cuda",
    ):
        if codec_kind not in ("xy", "higgs"):
            raise ValueError(f"codec_kind must be 'xy' or 'higgs': {codec_kind}")
        self.device = dev = torch.device(device)
        self.cfg = lm_cfg
        self.params = rwkv7.pack_decode_params(_to(lm_params, dev), lm_cfg.backbone)
        self.tok = text_tokenizer
        self.codec_kind = codec_kind
        if codec_cfg is None:
            codec_cfg = xt.XYTokenizerConfig() if codec_kind == "xy" else higgs.HiggsConfig()
        self.codec_cfg, self.codec_params = codec_cfg, _to(codec_params, dev)
        self.sample_rate = (codec_cfg.output_sample_rate if codec_kind == "xy"
                            else codec_cfg.sample_rate)
        self.speaker_id = speaker_id

    def generate_frames(self, text: str, speaker_id: Optional[int] = None, control_id: int = 0,
                        max_new_tokens: int = 1024, seed: int = 0, temperature: float = 1.0,
                        noise=None) -> np.ndarray:
        """The codec codes (nq, T_audio) of one utterance: the frames of its
        audio steps (those before channel 0's first EOS) and the 7 flush
        steps after them, undiagonalised. Draws from a generator seeded
        with `seed` on the device, or from `noise` (``xy_generate``'s
        per-channel list)."""
        sid = self.speaker_id if speaker_id is None else speaker_id
        text_ids = self.tok.encode(f"[S{sid}]{text}[CTL{control_id}]")
        nch, dev = self.cfg.num_channels, self.device
        ids = torch.full((1, len(text_ids), nch), self.cfg.speech_pad_id, dtype=torch.long)
        ids[0, :, 0] = torch.tensor(text_ids)
        mask = torch.ones(1, len(text_ids), dtype=torch.int32)
        frames, _ = gen.xy_generate(
            self.params, self.cfg, ids.to(dev), mask.to(dev), max_new_tokens=max_new_tokens,
            temperature=temperature, noise=noise,
            generator=None if noise is not None else torch.Generator(dev).manual_seed(seed))
        ch0 = frames[0, :, 0].cpu().numpy()
        eos = np.flatnonzero(ch0 == self.cfg.text_pad_id)
        n = int(eos[0]) if len(eos) else max_new_tokens  # the audio steps before the flush
        return xy_collator.undo_diagonal(frames[0, :n + nch - 1].cpu().numpy(),
                                         text_shift_size=self.cfg.text_shift_size,
                                         num_channels=nch)

    def synthesize(self, text: str, **kw) -> XYTTSResult:
        """``generate_frames`` (its keywords pass through), then the codec;
        the wav is empty without a codec or codes."""
        t0 = time.perf_counter()
        codes = self.generate_frames(text, **kw)
        t1 = time.perf_counter()
        p, cfg = self.codec_params, self.codec_cfg
        wav = np.zeros(0, np.float32)
        if p is not None and codes.shape[-1] > 0:
            with nn.f32():
                if self.codec_kind == "xy" and codes.shape[-1] > 30 * cfg.frame_rate:
                    wav = xt.decode_long(p, cfg, codes)
                else:
                    decode = xt.decode if self.codec_kind == "xy" else higgs.decode
                    batch = torch.from_numpy(codes)[:, None, :].to(self.device)
                    wav = decode(p, cfg, batch)[0].cpu().numpy()
        t2 = time.perf_counter()
        return XYTTSResult(wav=wav, sample_rate=self.sample_rate, codes=codes,
                           llm_s=t1 - t0, codec_s=t2 - t1)
