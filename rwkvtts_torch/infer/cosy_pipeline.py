"""CosyVoice2-style TTS orchestrator: frontend -> RWKV-7 speech LM -> flow
-> HiFT (counterpart of rwkvtts_tpu/infer/cosy_pipeline.py).

  * zero-shot prompt (``frontend_zero_shot``): the S3 tokenizer's speech
    tokens and CAM++'s x-vector of the 16 kHz clip, the HiFi-GAN log-mel of
    the clip at the output rate, trimmed to 2 frames a token; the two
    frontends are the port's (``s3_params`` / ``campplus_params``) or
    callables the caller passes;
  * LM (``generate_speech_tokens``): [SOS][prompt text + text][TASK][prompt
    speech] prefill, RAS sampling, min / max length from the content
    length, through ``generate.cosy_generate`` on one of two decode
    routes: the B=1 whole-step kernel on ``decode_mega.pack_mega``'s int8
    weights (the default for a bf16 LM on a card), or the model's
    ``rwkv7.decode_step`` on ``pack_decode_params``'s tree (the default
    for an f32 LM, on the CPU, or with int8 / int4 decode weights, the JAX
    package's; the WKV step kernel on a card); ``decode_megakernel`` True /
    False picks one. ``quantize_int8`` / ``quantize_int4`` /
    ``fuse_projections`` shape that tree (``rwkv7.pack_decode_params``);
    ``sample_rank_bf16`` ranks the sampler's candidates in bf16
    (``sampling.ras_sample``), here and in the streaming path;
  * ``token2wav``: the flow (10 Euler CFM steps, or the SFM fast decode
    for an SFM flow) over prompt + tokens, an optional speed resize of the
    mel, HiFT;
  * the modes: ``synthesize`` (zero-shot), ``synthesize_cross_lingual``,
    ``synthesize_instruct``, ``voice_convert`` (no LM),
    ``synthesize_streaming`` (``infer/streaming.stream_synthesize``, on the
    same decode route) and ``synthesize_long`` (long text: the frontend
    once, ``text_frontend.basic_normalize`` and ``split_paragraph`` into
    chunks of at most ``token_max_n`` text tokens, each chunk synthesized
    with its own prefill, so the state never grows across sentences, and
    the wavs and tokens concatenated).

Everything runs on `device`, a CUDA device unless the caller asks for
the CPU (where the kernels' plain versions run). Random draws come from the
seed: the LM's from a CPU generator (the same tokens on the CPU and the
card), the flow's noise from ``seed`` and HiFT's from ``seed + 1``.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from rwkvtts_torch.codecs import campplus as cp
from rwkvtts_torch.codecs import dsp
from rwkvtts_torch.codecs import flow as flow_lib
from rwkvtts_torch.codecs import hift as hift_lib
from rwkvtts_torch.codecs import s3_tokenizer as s3
from rwkvtts_torch.data import cosy_collator, text_frontend
from rwkvtts_torch.data.spark_collator import pad_prompts_left
from rwkvtts_torch.infer import generate as gen
from rwkvtts_torch.models import rwkv7
from rwkvtts_torch.ops import decode_mega as dm
from rwkvtts_torch.utils import audio_io


@dataclasses.dataclass
class CosyTTSResult:
    """A synthesis: the wav, its speech tokens, the wall seconds of each
    stage (the frontend's only where this call ran it) and the RTF of the
    stages after the frontend; ``synthesize_long`` also gives its text
    chunks and each chunk's token count."""
    wav: np.ndarray
    sample_rate: int
    speech_tokens: np.ndarray
    rtf: float
    llm_s: float
    flow_s: float
    vocoder_s: float
    frontend_s: float = 0.0
    chunks: Optional[List[str]] = None
    chunk_tokens: Optional[List[int]] = None


class CosyPipeline:
    def __init__(
        self,
        lm_cfg,
        lm_params,
        text_tokenizer,
        flow_cfg: Optional[flow_lib.FlowConfig] = None,
        flow_params=None,
        hift_cfg: Optional[hift_lib.HiFTConfig] = None,
        hift_params=None,
        speech_tokenizer_fn: Optional[Callable] = None,  # 16 kHz wav -> token ids
        spk_embed_fn: Optional[Callable] = None,  # 16 kHz wav -> (192,) x-vector
        s3_cfg: Optional[s3.S3TokenizerConfig] = None,
        s3_params=None,
        campplus_cfg: Optional[cp.CampplusConfig] = None,
        campplus_params=None,
        quantize_int8: bool = False,
        quantize_int4: bool = False,
        fuse_projections: bool = True,
        decode_megakernel: Optional[bool] = None,
        sample_rank_bf16: bool = False,
        *,
        device="cuda",
    ):
        self.device = dev = torch.device(device)
        bb = lm_cfg.backbone
        self.lm_cfg = lm_cfg
        lm_params = _tree_to(lm_params, dev)
        # decode route: the B=1 whole-step kernel on its int8 pack (the
        # prefill reads the originals), or the model's decode step on the
        # decode weights pack_decode_params shapes (fused or not, bf16,
        # int8 or int4); a quantize flag picks the latter
        quantized = quantize_int8 or quantize_int4
        if quantized and decode_megakernel:
            raise ValueError("quantize_int8 / quantize_int4 shape the rwkv7.decode_step route's "
                             "weights; the B=1 kernel streams its own int8 pack: drop "
                             "decode_megakernel=True or the quantize flag")
        kernel = _kernel_route(False if quantized else decode_megakernel, dev, bb)
        self.lm_mega = dm.pack_mega(lm_params, bb) if kernel else None
        self.lm_params = lm_params if kernel else rwkv7.pack_decode_params(
            lm_params, bb, quantize_int8=quantize_int8, quantize_int4=quantize_int4,
            fuse_projections=fuse_projections)
        # bf16 candidate ranking in the LM's sampler (sampling.ras_sample)
        self.lm_rank_bf16 = sample_rank_bf16
        # the whole-step kernel's WKV carry: bf16, the JAX package's default
        self.wkv_dtype = torch.bfloat16
        self.tok = text_tokenizer
        self.flow_cfg, self.flow_params = flow_cfg, _tree_to(flow_params, dev)
        self.hift_cfg, self.hift_params = hift_cfg, _tree_to(hift_params, dev)
        self.sample_rate = (hift_cfg or hift_lib.HiFTConfig()).sampling_rate
        # the port's frontends where no callable is given (closures over
        # their weights, not over the pipeline: no reference cycle keeps a
        # dropped pipeline's weights on the card)
        self.s3_cfg = s3_cfg or s3.S3TokenizerConfig()
        self.s3_params = _tree_to(s3_params, dev)
        if speech_tokenizer_fn is None and s3_params is not None:
            speech_tokenizer_fn = functools.partial(_on_wav, s3.tokenize, self.s3_params,
                                                    self.s3_cfg, dev)
        self.campplus_cfg = campplus_cfg or cp.CampplusConfig()
        self.campplus_params = _tree_to(campplus_params, dev)
        if spk_embed_fn is None and campplus_params is not None:
            spk_embed_fn = functools.partial(_on_wav, cp.embed_wav, self.campplus_params,
                                             self.campplus_cfg, dev)
        self.speech_tokenizer_fn, self.spk_embed_fn = speech_tokenizer_fn, spk_embed_fn

    # -- LM stage ---------------------------------------------------------

    def generate_speech_tokens(
        self,
        text: str,
        prompt_text: str = "",
        prompt_speech_tokens: Sequence[int] = (),
        max_new_tokens: int = 2048,
        seed: int = 0,
        top_p: float = 0.8,
        top_k: int = 25,
    ) -> np.ndarray:
        """[SOS][prompt_text + text][TASK][prompt speech] -> speech ids: at
        least 2x and at most 20x the content length (capped by
        max_new_tokens) tokens, EOS excluded."""
        text_ids = self.tok.encode(prompt_text) + self.tok.encode(text)
        batch = pad_prompts_left([cosy_collator.build_prompt(text_ids, list(prompt_speech_tokens))])
        content_len = cosy_collator.content_length(text_ids)
        tokens, modality, mask = (torch.from_numpy(batch[k]).to(self.device)
                                  for k in ("tokens", "modality", "attention_mask"))
        toks, lengths = gen.cosy_generate(
            self.lm_params, self.lm_cfg, tokens, modality, mask,
            max_new_tokens=min(int(content_len * 20), max_new_tokens),
            min_new_tokens=int(content_len * 2), top_k=top_k, top_p=top_p, mega=self.lm_mega,
            generator=torch.Generator().manual_seed(seed), rank_bf16=self.lm_rank_bf16)
        return toks[0, :int(lengths[0])].cpu().numpy()

    # -- token2wav ----------------------------------------------------------

    @torch.inference_mode()
    def token2wav(
        self,
        speech_tokens: Sequence[int],
        prompt_tokens: Sequence[int] = (),
        prompt_mel: Optional[np.ndarray] = None,     # (2 * len(prompt_tokens), 80)
        spk_embedding: Optional[np.ndarray] = None,  # (192,)
        n_timesteps: int = 10,
        seed: int = 0,
        speed: float = 1.0,
    ) -> np.ndarray:
        """Speech tokens -> wav (non-streaming): the flow over prompt +
        tokens (noise from `seed`; the SFM fast decode for an SFM flow with
        its head), the mel resized to 1 / `speed` of its
        frames (jax.image.resize's antialiased linear, ``dsp.resize_linear``),
        then HiFT (noise from `seed + 1`)."""
        mel = self.token2mel(speech_tokens, prompt_tokens, prompt_mel, spk_embedding,
                             n_timesteps, seed, speed)
        return self.mel2wav(mel, seed)

    @torch.inference_mode()
    def token2mel(self, speech_tokens, prompt_tokens=(), prompt_mel=None, spk_embedding=None,
                  n_timesteps: int = 10, seed: int = 0, speed: float = 1.0) -> torch.Tensor:
        """``token2wav``'s flow stage: the mel (1, frames, n_mels) on the
        device."""
        if self.flow_params is None or self.hift_params is None:
            raise RuntimeError("flow / HiFT parameters not loaded")
        fcfg, dev = self.flow_cfg, self.device
        tokens = np.concatenate([np.asarray(prompt_tokens, np.int64),
                                 np.asarray(speech_tokens, np.int64)])[None]
        if spk_embedding is None:
            spk_embedding = np.zeros((fcfg.spk_embed_dim,), np.float32)
        if prompt_mel is None:
            prompt_mel = np.zeros((0, fcfg.output_size), np.float32)
        tokens = torch.from_numpy(tokens).to(dev)
        noise = flow_lib.NoiseTable(seed, fcfg.output_size, dev)(fcfg.token_mel_ratio * tokens.shape[1])
        mask = torch.ones(tokens.shape, device=dev)
        spk = torch.from_numpy(np.asarray(spk_embedding, np.float32)[None]).to(dev)
        if fcfg.sfm and "sfm_head" in self.flow_params:
            # the SFM fast decode (reference model/flow/flow.py:132-180): the
            # prompt rides as tokens, its mel frames are sliced off
            mel = flow_lib.sfm_inference(self.flow_params, fcfg, tokens, mask, spk, noise,
                                         n_timesteps=n_timesteps)[:, prompt_mel.shape[0]:]
        else:
            mel = flow_lib.inference(
                self.flow_params, fcfg, tokens, mask,
                torch.from_numpy(np.asarray(prompt_mel, np.float32)[None]).to(dev),
                prompt_mel.shape[0], spk, noise, n_timesteps=n_timesteps)
        if speed != 1.0:  # the reference's speed control (cli/model.py:398-401)
            mel = dsp.resize_linear(mel, int(mel.shape[1] / speed))
        return mel

    @torch.inference_mode()
    def mel2wav(self, mel: torch.Tensor, seed: int = 0) -> np.ndarray:
        """``token2wav``'s vocoder stage: HiFT (noise from `seed + 1`)."""
        wav, _ = hift_lib.inference(self.hift_params, self.hift_cfg, mel,
                                    generator=torch.Generator().manual_seed(seed + 1))
        return wav[0].cpu().numpy()

    # -- zero-shot ----------------------------------------------------------

    @torch.inference_mode()
    def frontend_zero_shot(self, prompt_wav: np.ndarray, prompt_sr: int = 16000):
        """(prompt speech tokens, prompt mel, speaker embedding) of a clip:
        the S3 tokens and the x-vector of the clip at 16 kHz, the flow
        prompt's log-mel of the clip at the output rate, trimmed to 2
        frames a token (the reference frontend's contract)."""
        if self.speech_tokenizer_fn is None or self.spk_embed_fn is None:
            raise RuntimeError("the zero-shot frontend needs the speech tokenizer and the speaker "
                               "embedding (s3_params / campplus_params or the callables), or "
                               "pass precomputed prompt features")
        wav = np.asarray(prompt_wav, np.float32)
        wav16 = audio_io.resample(wav, prompt_sr, 16000)
        tokens = np.asarray(self.speech_tokenizer_fn(wav16), np.int64)
        emb = np.asarray(self.spk_embed_fn(wav16), np.float32)
        n_mels = self.flow_cfg.output_size if self.flow_cfg is not None else 80
        wav_out = torch.from_numpy(audio_io.resample(wav, prompt_sr, self.sample_rate))
        mel = dsp.log_mel_hifigan(wav_out[None].to(self.device), sample_rate=self.sample_rate,
                                  n_mels=n_mels)[0].cpu().numpy()
        n = min(mel.shape[0] // 2, len(tokens))
        return tokens[:n], mel[:2 * n], emb

    def synthesize(
        self,
        text: str,
        prompt_text: str = "",
        prompt_wav: Optional[np.ndarray] = None,
        prompt_speech_tokens: Sequence[int] = (),
        prompt_mel: Optional[np.ndarray] = None,
        spk_embedding: Optional[np.ndarray] = None,
        seed: int = 0,
        speed: float = 1.0,
        lm_prompt_tokens: Optional[Sequence[int]] = None,
        **gen_kw,
    ) -> CosyTTSResult:
        """Zero-shot synthesis, from a prompt wav (16 kHz) or precomputed
        prompt features. `lm_prompt_tokens` replaces the speech prompt the
        LM sees ([] for the cross-lingual and instruct modes); the flow
        always gets the whole prompt condition."""
        t0 = time.perf_counter()
        if prompt_wav is not None:
            prompt_speech_tokens, prompt_mel, spk_embedding = self.frontend_zero_shot(prompt_wav)
        if lm_prompt_tokens is None:
            lm_prompt_tokens = prompt_speech_tokens
        t1 = time.perf_counter()
        tokens = self.generate_speech_tokens(text, prompt_text, lm_prompt_tokens, seed=seed,
                                             **gen_kw)
        t2 = time.perf_counter()
        mel = self.token2mel(tokens, prompt_speech_tokens, prompt_mel, spk_embedding, seed=seed,
                             speed=speed)
        if self.device.type == "cuda":  # the flow's time, not HiFT's
            torch.cuda.synchronize(self.device)
        t3 = time.perf_counter()
        wav = self.mel2wav(mel, seed)
        t4 = time.perf_counter()
        return CosyTTSResult(wav=wav, sample_rate=self.sample_rate, speech_tokens=tokens,
                             rtf=(t4 - t1) / max(len(wav) / self.sample_rate, 1e-9),
                             llm_s=t2 - t1, flow_s=t3 - t2, vocoder_s=t4 - t3,
                             frontend_s=t1 - t0)

    def synthesize_long(
        self,
        text: str,
        prompt_text: str = "",
        prompt_wav: Optional[np.ndarray] = None,
        prompt_speech_tokens: Sequence[int] = (),
        prompt_mel: Optional[np.ndarray] = None,
        spk_embedding: Optional[np.ndarray] = None,
        seed: int = 0,
        token_max_n: int = 80,
        **gen_kw,
    ) -> CosyTTSResult:
        """Long text (the reference's cli/cosyvoice.py:78-99): the
        zero-shot frontend once, the text normalized
        (``text_frontend.basic_normalize``) and split at sentence ends into
        chunks of at most `token_max_n` text tokens (``split_paragraph``
        with the pipeline's tokenizer), chunk i synthesized with
        ``synthesize(..., seed=seed + i)`` in the same voice, each with its
        own prefill (the state never grows across sentences), and the wavs
        and the tokens concatenated. `gen_kw` reaches every chunk's
        ``synthesize`` (e.g. ``max_new_tokens``, ``speed``)."""
        t0 = time.perf_counter()
        if prompt_wav is not None:
            prompt_speech_tokens, prompt_mel, spk_embedding = self.frontend_zero_shot(prompt_wav)
        frontend_s = time.perf_counter() - t0
        norm = text_frontend.basic_normalize(text)
        chunks = text_frontend.split_paragraph(norm, self.tok.encode,
                                               token_max_n=token_max_n) or [norm]
        t1 = time.perf_counter()
        parts = [self.synthesize(chunk, prompt_text, None, prompt_speech_tokens, prompt_mel,
                                 spk_embedding, seed=seed + i, **gen_kw)
                 for i, chunk in enumerate(chunks)]
        wav = np.concatenate([r.wav for r in parts])
        return CosyTTSResult(
            wav=wav, sample_rate=self.sample_rate,
            speech_tokens=np.concatenate([r.speech_tokens for r in parts]),
            rtf=(time.perf_counter() - t1) / max(len(wav) / self.sample_rate, 1e-9),
            llm_s=sum(r.llm_s for r in parts), flow_s=sum(r.flow_s for r in parts),
            vocoder_s=sum(r.vocoder_s for r in parts), frontend_s=frontend_s, chunks=chunks,
            chunk_tokens=[len(r.speech_tokens) for r in parts])

    def synthesize_cross_lingual(
        self,
        text: str,
        prompt_wav: Optional[np.ndarray] = None,
        prompt_speech_tokens: Sequence[int] = (),
        prompt_mel: Optional[np.ndarray] = None,
        spk_embedding: Optional[np.ndarray] = None,
        **kw,
    ) -> CosyTTSResult:
        """Cross-lingual mode: the LM gets no prompt text and no prompt
        speech (the target language is free); the flow keeps the prompt
        condition for the voice."""
        return self.synthesize(text, prompt_text="", prompt_wav=prompt_wav,
                               prompt_speech_tokens=prompt_speech_tokens, prompt_mel=prompt_mel,
                               spk_embedding=spk_embedding, lm_prompt_tokens=[], **kw)

    def synthesize_instruct(
        self,
        text: str,
        instruct_text: str,
        prompt_wav: Optional[np.ndarray] = None,
        prompt_text: Optional[str] = None,
        prompt_speech_tokens: Sequence[int] = (),
        prompt_mel: Optional[np.ndarray] = None,
        spk_embedding: Optional[np.ndarray] = None,
        **kw,
    ) -> CosyTTSResult:
        """Instruct mode: the instruction is LM prompt text ended by
        <|endofprompt|>; without a prompt transcript the LM's speech prompt
        is dropped, with one it is kept."""
        lm_text = instruct_text + "<|endofprompt|>" + (prompt_text or "")
        return self.synthesize(text, prompt_text=lm_text, prompt_wav=prompt_wav,
                               prompt_speech_tokens=prompt_speech_tokens, prompt_mel=prompt_mel,
                               spk_embedding=spk_embedding,
                               lm_prompt_tokens=None if prompt_text is not None else [], **kw)

    def voice_convert(
        self,
        source_wav: np.ndarray,
        prompt_wav: Optional[np.ndarray] = None,
        prompt_speech_tokens: Sequence[int] = (),
        prompt_mel: Optional[np.ndarray] = None,
        spk_embedding: Optional[np.ndarray] = None,
        seed: int = 0,
        speed: float = 1.0,
    ) -> CosyTTSResult:
        """Voice conversion: the S3 tokens of the source speech (16 kHz)
        through flow + HiFT in the prompt's voice; no LM."""
        if self.speech_tokenizer_fn is None:
            raise RuntimeError("voice conversion needs the speech tokenizer")
        if prompt_wav is not None:
            prompt_speech_tokens, prompt_mel, spk_embedding = self.frontend_zero_shot(prompt_wav)
        t0 = time.perf_counter()
        source_tokens = np.asarray(self.speech_tokenizer_fn(source_wav), np.int64)
        wav = self.token2wav(source_tokens, prompt_speech_tokens, prompt_mel, spk_embedding,
                             seed=seed, speed=speed)
        t2 = time.perf_counter()
        return CosyTTSResult(wav=wav, sample_rate=self.sample_rate, speech_tokens=source_tokens,
                             rtf=(t2 - t0) / max(len(wav) / self.sample_rate, 1e-9),
                             llm_s=0.0, flow_s=t2 - t0, vocoder_s=0.0)

    def synthesize_streaming(
        self,
        text: str,
        prompt_text: str = "",
        prompt_speech_tokens: Sequence[int] = (),
        prompt_mel: Optional[np.ndarray] = None,
        spk_embedding: Optional[np.ndarray] = None,
        hop_tokens: int = 25,
        seed: int = 0,
        max_new_tokens: int = 2048,
        **gen_kw,
    ):
        """Wav chunks while the LM decodes (``streaming.stream_synthesize``
        with hops of `hop_tokens` tokens)."""
        from rwkvtts_torch.infer import streaming

        yield from streaming.stream_synthesize(
            self, text, prompt_text, prompt_speech_tokens=prompt_speech_tokens,
            prompt_mel=prompt_mel, spk_embedding=spk_embedding,
            stream_cfg=streaming.StreamConfig(token_hop_len=hop_tokens), seed=seed,
            max_new_tokens=max_new_tokens, **gen_kw)


def _kernel_route(decode_megakernel: Optional[bool], device: torch.device, bb) -> bool:
    """Whether the LM decodes through the B=1 whole-step kernel: as the
    caller asks, else on a card for a bf16 LM (the kernel's CUDA form takes
    bf16 products only); otherwise through ``rwkv7.decode_step``."""
    bf16 = dm.matmul_dtype(bb) == torch.bfloat16
    if decode_megakernel is None:
        return device.type == "cuda" and bf16
    if decode_megakernel and device.type == "cuda" and not bf16:
        raise ValueError(f"decode_megakernel: the B=1 kernel takes a bf16 LM on a card "
                         f"(the config's dtype is {bb.dtype})")
    return decode_megakernel


def _on_wav(fn, params, cfg, device, wav: np.ndarray) -> np.ndarray:
    """fn(params, cfg, wav[None]) on `device` for one numpy wav -> numpy."""
    wav = torch.from_numpy(np.asarray(wav, np.float32))[None].to(device)
    return fn(params, cfg, wav)[0].cpu().numpy()


def _tree_to(tree, device):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)
