"""Incremental-state streaming CosyVoice synthesis (counterpart of
rwkvtts_tpu/infer/streaming.py; reference cli/model.py:330-446).

Every stage is O(1) a hop:
  * LM: chunked decode with a carried state (``generate.cosy_decode_chunk``
    through the pipeline's decode route: the B=1 whole-step kernel, or the
    model's ``rwkv7.decode_step``); tokens stream out while the flow
    consumes them, and decoding stops at EOS.
  * Flow: a window [prompt | last ctx tokens | hop + lookahead] through
    ``flow.inference_window`` (or, with ``StreamConfig.sfm``, the SFM
    fast decode ``flow.sfm_inference_window``); the noise is indexed by
    absolute frame, so window frames see what the full sequence would at
    those frames.
  * Vocoder: HiFT with an 8-frame mel cache, a source cache and a Hamming
    crossfade (the reference's hift_cache_dict, cli/model.py:355-395).

The host reads each LM chunk's tokens once (one synchronisation a chunk)
and each vocoded chunk's samples; the rest stays on the device. Random
draws come from a noise source (``SessionNoise`` by default, from the
seed), which a caller may replace, e.g. to feed another implementation's
draws.
"""
from __future__ import annotations

import dataclasses
from typing import Generator, Optional, Sequence, Tuple

import numpy as np
import torch

from rwkvtts_torch.codecs import flow as flow_lib
from rwkvtts_torch.codecs import hift as hift_lib
from rwkvtts_torch.data import cosy_collator
from rwkvtts_torch.data.spark_collator import pad_prompts_left
from rwkvtts_torch.infer import generate as gen
from rwkvtts_torch.ops import sampling


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    # token_hop_len = 2 * input_frame_rate (cli/model.py:350): 25 Hz S3-v2
    # tokens, 50-token hops = 2 s of audio a chunk
    token_hop_len: int = 50
    # generated-token context kept in the flow window besides the prompt
    ctx_tokens: int = 100
    mel_cache_len: int = 8  # cli/model.py:355
    n_timesteps: int = 10
    lm_chunk: int = 50  # LM decode steps between host-side EOS checks
    # after the first audio chunk, decode lm_chunk_max steps a chunk
    lm_chunk_max: Optional[int] = None
    # the SFM fast decode in the flow hop (flow.sfm_inference_window), with
    # n_timesteps ~5; needs an sfm_head in the pipeline's flow params
    sfm: bool = False
    # after the first chunk, vocode this many hops in one HiFT call
    vocode_every: int = 1
    # decode LM chunk N+1 before vocoding hop N, once the first audio
    # chunk is out (token-identical; at most one chunk wasted after EOS)
    lm_prefetch: bool = True
    # the flow hop doubles after each emitted hop, capped here (None: fixed)
    hop_max: Optional[int] = None


class SessionNoise:
    """The random draws of one streaming utterance, from `seed`: the LM's
    Gumbel noise (a CPU generator seeded `seed`, so a CPU and a CUDA run
    draw alike), the flow's noise over absolute frames (`seed + 1`) and
    the HiFT source's phase and noise (`seed + 2`), each in call order."""

    def __init__(self, seed: int, device=None):
        self.seed, self.device = seed, device
        self.g_lm = torch.Generator().manual_seed(seed)
        self.flow = None
        self.g_hift = torch.Generator().manual_seed(seed + 2)

    def lm(self, chunk: int, n_steps: int, k: int, vocab: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Noise of LM chunk `chunk` (dispatch order): (nucleus
        (n_steps, 1, k), fallback (n_steps, 1, vocab)), drawn step by step,
        so a step's noise does not depend on how steps fall into chunks."""
        return sampling.ras_noise(self.g_lm, n_steps, 1, k, vocab, self.device)

    def flow_table(self, n_frames: int, channels: int) -> torch.Tensor:
        """(1, >= n_frames, channels) CFM noise over absolute frames."""
        if self.flow is None:
            self.flow = flow_lib.NoiseTable(self.seed + 1, channels, self.device)
        return self.flow(n_frames)

    def hift(self, hop: int, cfg: hift_lib.HiFTConfig, n_samples: int):
        """(phase, noise) of the sine source of vocoder call `hop`."""
        return hift_lib.source_draws(cfg, 1, n_samples, self.g_hift, self.device)


def _flow_hop(fparams, fcfg, noise_table, tokens_win, n_valid: int, prompt_feat,
              prompt_len: int, gen_start: int, new_off: int, slice_len: int, spk,
              n_timesteps: int, sfm: bool = False):
    """One windowed flow hop; returns (1, slice_len * ratio, 80) new mel.
    new_off: window index (in tokens) of the first new token; the slice may
    reach into the padding, and the caller trims it. `sfm`: the SFM fast
    decode, which takes no prompt mel."""
    mask = (torch.arange(tokens_win.shape[1], device=tokens_win.device)[None] < n_valid).float()
    if sfm:
        mel = flow_lib.sfm_inference_window(fparams, fcfg, tokens_win, mask, prompt_len,
                                            gen_start, spk, noise_table, n_timesteps=n_timesteps)
    else:
        mel = flow_lib.inference_window(fparams, fcfg, tokens_win, mask, prompt_feat,
                                        prompt_len, gen_start, spk, noise_table,
                                        n_timesteps=n_timesteps)
    r = fcfg.token_mel_ratio
    start = r * (prompt_len + new_off)
    return mel[:, start:start + r * slice_len]


def _hift_hop(hparams, hcfg, mel, cache_source, phase, noise):
    return hift_lib.inference(hparams, hcfg, mel, cache_source, phase=phase, noise=noise)


class CosyStreamSession:
    """One streaming utterance: feed tokens, iterate wav chunks (numpy).

    Parity: CosyVoice2Model.tts(stream=True) (cli/model.py:406-446)
    without its thread pair: the LM chunk and the flow hop are issued
    back to back on one stream."""

    def __init__(self, pipeline, stream_cfg: StreamConfig, prompt_speech_tokens: Sequence[int],
                 prompt_mel: Optional[np.ndarray], spk_embedding: Optional[np.ndarray], noise):
        """`noise` is the utterance's noise source (``SessionNoise``)."""
        self.pipe = pipeline
        self.scfg = stream_cfg
        self.fcfg, self.hcfg = pipeline.flow_cfg, pipeline.hift_cfg
        if stream_cfg.sfm and "sfm_head" not in pipeline.flow_params:
            # plain CFM at the SFM step count would be degraded audio under
            # the SFM name: refuse
            raise ValueError("StreamConfig.sfm=True but the flow params have no 'sfm_head' "
                             "(an SFM flow checkpoint is required); unset sfm or load an "
                             "SFM-trained flow")
        dev = pipeline.device
        self.noise = noise
        self.prompt_tokens = np.asarray(prompt_speech_tokens, np.int64)
        self.P = P = len(self.prompt_tokens)
        if spk_embedding is None:
            spk_embedding = np.zeros((self.fcfg.spk_embed_dim,), np.float32)
        self.spk = torch.as_tensor(np.asarray(spk_embedding, np.float32)[None], device=dev)
        if prompt_mel is None:
            prompt_mel = np.zeros((self.fcfg.token_mel_ratio * P, self.fcfg.output_size), np.float32)
        self.prompt_mel = torch.as_tensor(np.asarray(prompt_mel, np.float32)[None], device=dev)
        self.la = self.fcfg.pre_lookahead_len
        h = stream_cfg.token_hop_len
        self.hop_cap = max(stream_cfg.hop_max or h, h)
        # one window size a ramp stage: the doubling hops up to hop_cap
        stages = [h]
        while stages[-1] < self.hop_cap:
            stages.append(min(2 * stages[-1], self.hop_cap))
        self._slice_lens = [s + self.la for s in stages]
        self.cur_hop = h
        # vocoder caches (reference hift_cache_dict, cli/model.py:374-395)
        self.scl = stream_cfg.mel_cache_len * self.hcfg.total_upsample
        self.window = torch.from_numpy(np.hamming(2 * self.scl).astype(np.float32)).to(dev)
        self.mel_cache = self.source_cache = self.speech_cache = None
        self.token_offset = 0
        self.hop_idx = 0
        self._mel_accum: list = []

    # -- flow stage -------------------------------------------------------

    def _window_mel(self, tokens: np.ndarray, off: int, n_new: int) -> torch.Tensor:
        """Mel for tokens[off : off + n_new], conditioned on the window."""
        scfg, fcfg = self.scfg, self.fcfg
        end = min(off + n_new + self.la, len(tokens))
        w0 = max(0, off - scfg.ctx_tokens)
        gen_win = tokens[w0:end]
        n_valid = self.P + len(gen_win)
        # the smallest ramp stage that covers n_new sizes the window
        slice_len = next(s for s in self._slice_lens if s >= n_new)
        cap = self.P + scfg.ctx_tokens + slice_len
        buf = np.zeros((1, cap), np.int64)
        buf[0, :self.P] = self.prompt_tokens
        buf[0, self.P:n_valid] = gen_win
        r = fcfg.token_mel_ratio
        table = self.noise.flow_table(r * (cap + w0), fcfg.output_size)
        mel = _flow_hop(self.pipe.flow_params, fcfg, table,
                        torch.from_numpy(buf).to(self.pipe.device), n_valid, self.prompt_mel,
                        self.P, w0, off - w0, slice_len, self.spk, scfg.n_timesteps, scfg.sfm)
        return mel[:, :r * n_new]

    # -- vocoder stage ----------------------------------------------------

    def _vocode(self, new_mel: torch.Tensor, finalize: bool) -> np.ndarray:
        """HiFT with the mel / source caches and the Hamming crossfade
        (cli/model.py:372-404)."""
        hop_frames = self.fcfg.token_mel_ratio * self.scfg.token_hop_len
        n_real = new_mel.shape[1]
        # edge-pad the final partial chunk up to whole hops; the padded tail
        # is trimmed from the wav below. n_real == 0 still flushes the
        # held-back crossfade tail (cli/model.py:437-446)
        pad_to = max(hop_frames, -(-n_real // hop_frames) * hop_frames)
        if finalize and n_real < pad_to:
            edge = new_mel[:, -1:] if n_real > 0 else self.mel_cache[:, -1:]
            new_mel = torch.cat([new_mel, edge.expand(-1, pad_to - n_real, -1)], 1)
        mel_in = new_mel if self.mel_cache is None else torch.cat([self.mel_cache, new_mel], 1)
        up = self.hcfg.total_upsample
        phase, noise = self.noise.hift(self.hop_idx, self.hcfg, mel_in.shape[1] * up)
        wav, source = _hift_hop(self.pipe.hift_params, self.hcfg, mel_in, self.source_cache,
                                phase, noise)
        if self.speech_cache is not None:
            scl = self.scl
            wav = torch.cat([wav[:, :scl] * self.window[:scl] + self.speech_cache * self.window[scl:],
                             wav[:, scl:]], 1)
        if finalize:
            out = wav[0, :(mel_in.shape[1] - (new_mel.shape[1] - n_real)) * up]
        else:
            out = wav[0, :-self.scl]
            self.mel_cache = mel_in[:, -self.scfg.mel_cache_len:]
            self.source_cache = source[:, -self.scl:]
            self.speech_cache = wav[:, -self.scl:]
        self.hop_idx += 1
        return out.cpu().numpy()

    # -- hop driver -------------------------------------------------------

    def emit_ready(self, tokens: np.ndarray, lm_done: bool):
        """Yield wav chunks for every complete hop in `tokens`: the first
        hop is vocoded at once (time to first audio), later ones in groups
        of `vocode_every`."""
        K = max(1, self.scfg.vocode_every)
        while len(tokens) - self.token_offset >= self.cur_hop + self.la:
            hop = self.cur_hop
            mel = self._window_mel(tokens, self.token_offset, hop)
            self.token_offset += hop
            self.cur_hop = min(2 * hop, self.hop_cap)  # ramp
            if self.mel_cache is None and not self._mel_accum:
                yield self._vocode(mel, finalize=False)
            else:
                self._mel_accum.append(mel)
                if len(self._mel_accum) >= K:
                    yield self._vocode(torch.cat(self._mel_accum, 1), finalize=False)
                    self._mel_accum = []
        if lm_done:
            n_rem = len(tokens) - self.token_offset
            mels, self._mel_accum = self._mel_accum, []
            if n_rem > 0:
                mels.append(self._window_mel(tokens, self.token_offset, n_rem))
            self.token_offset = len(tokens)
            if mels:
                yield self._vocode(torch.cat(mels, 1), finalize=True)
            elif self.mel_cache is not None:
                yield self._vocode(self.mel_cache[:, :0], finalize=True)


@torch.inference_mode()
def stream_synthesize(
    pipeline,
    text: str,
    prompt_text: str = "",
    prompt_speech_tokens: Sequence[int] = (),
    prompt_mel: Optional[np.ndarray] = None,
    spk_embedding: Optional[np.ndarray] = None,
    stream_cfg: StreamConfig = StreamConfig(),
    seed: int = 0,
    max_new_tokens: int = 2048,
    top_p: float = 0.8,
    top_k: int = 25,
    noise=None,
) -> Generator[np.ndarray, None, None]:
    """Streaming zero-shot TTS: yields wav chunks (numpy f32) as the LM
    decodes; the first after about hop + lookahead tokens. `noise`
    replaces ``SessionNoise(seed)``."""
    dev = pipeline.device
    noise = noise if noise is not None else SessionNoise(seed, dev)
    sess = CosyStreamSession(pipeline, stream_cfg, prompt_speech_tokens, prompt_mel,
                             spk_embedding, noise)
    text_ids = pipeline.tok.encode(prompt_text) + pipeline.tok.encode(text)
    batch = pad_prompts_left([cosy_collator.build_prompt(text_ids, list(prompt_speech_tokens))])
    # bucket the prompt length to a multiple of 64 (left pad, mask 0), as
    # the JAX package does to bound its compiled prefill programs
    T = batch["tokens"].shape[1]
    batch = {k: torch.from_numpy(np.pad(v, ((0, 0), (-(-T // 64) * 64 - T, 0)))).to(dev)
             for k, v in batch.items()}
    content_len = cosy_collator.content_length(text_ids)
    min_len = int(content_len * 2)
    max_len = min(int(content_len * 20), max_new_tokens)

    lm_cfg, mega = pipeline.lm_cfg, pipeline.lm_mega
    carry = gen.cosy_prefill_carry(pipeline.lm_params, lm_cfg, batch["tokens"], batch["modality"],
                                   batch["attention_mask"], mega_state=mega is not None,
                                   wkv_dtype=pipeline.wkv_dtype)
    eos = lm_cfg.eos_token_id
    n_dispatched = 0

    def dispatch(carry):
        # the first, latency-critical chunk stays lm_chunk; once audio
        # flows, lm_chunk_max steps a chunk
        nonlocal n_dispatched
        n = stream_cfg.lm_chunk
        if stream_cfg.lm_chunk_max and sess.hop_idx > 0:
            n = max(n, stream_cfg.lm_chunk_max)
        draws = noise.lm(n_dispatched, n, min(top_k, lm_cfg.speech_head_size),
                         lm_cfg.speech_head_size)
        n_dispatched += 1
        return gen.cosy_decode_chunk(pipeline.lm_params, lm_cfg, carry, draws, mega=mega,
                                     min_new_tokens=min_len, top_k=top_k, top_p=top_p,
                                     rank_bf16=pipeline.lm_rank_bf16)

    tokens = np.zeros((0,), np.int64)
    n_decoded = 0
    lm_done = False
    pending = dispatch(carry)
    while not lm_done:
        carry, toks, done = pending
        # issue chunk N+1 before reading chunk N, but only once the first
        # audio chunk is out: before it, the device would run the whole
        # next chunk ahead of the first flow hop
        prefetched = stream_cfg.lm_prefetch and sess.hop_idx > 0
        if prefetched:
            pending = dispatch(carry)
        host = torch.cat([toks[0], done.long()]).cpu().numpy()  # one sync a chunk
        chunk, is_done = host[:-1], bool(host[-1])
        n_decoded += len(chunk)
        if is_done:
            if np.any(chunk == eos):
                chunk = chunk[:np.argmax(chunk == eos)]
            lm_done = True
        elif n_decoded >= max_len:
            lm_done = True
        if not lm_done and not prefetched:
            pending = dispatch(carry)
        tokens = np.concatenate([tokens, chunk])
        yield from sess.emit_ready(tokens, lm_done)
