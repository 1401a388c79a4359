"""TTS serving core (counterpart of rwkvtts_tpu/serving/service.py): the
request and response types, the speaker library, ``BatchedTTSService``
(the grouped same-voice dispatcher: queued requests that share a voice
go through one batched ``SparkPipeline.synthesize``; its ``stream``
answers that a Spark pipeline has no streaming path),
``ContinuousTTSService``, which admits every request into a
``ContinuousBatcher`` slot and detokenizes each finished row through the
pipeline's BiCodec codec, and ``CosyTTSService``, which decodes every
Cosy request, streaming or not, through one shared slot pool
(``serving/cosy_pool.CosyStreamHub``).

For Spark one worker thread owns the model and is the only thread that
touches the card; client threads (the HTTP handlers) put a request on a
queue and wait on an event. ``torch.inference_mode`` and the current
CUDA device are thread-local, so the worker sets both itself. For Cosy
the hub's pump thread decodes and each client thread runs its own
stream's flow and HiFT hops.

Without a codec a finished Spark request is answered with an empty wav,
as the JAX service answers.
"""
from __future__ import annotations

import base64
import dataclasses
import io
import logging
import os
import queue
import struct
import threading
import time
import wave
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from rwkvtts_torch.utils import audio_io

log = logging.getLogger("rwkvtts_torch")


@dataclasses.dataclass
class TTSRequest:
    text: str
    speaker: Optional[str] = None
    prompt_text: Optional[str] = None
    prompt_wav: Optional[np.ndarray] = None
    properties: Optional[Dict[str, Any]] = None
    global_tokens: Optional[List[int]] = None  # a designed voice, unsaved
    seed: int = 0
    temperature: float = 1.0
    top_k: int = 50
    top_p: float = 0.95
    # per-request decode cap; clamped to the service's max_new_tokens
    max_new_tokens: Optional[int] = None


@dataclasses.dataclass
class TTSResponse:
    wav: np.ndarray
    sample_rate: int
    error: Optional[str] = None


class SpeakerLibrary:
    """demos/<speaker>/*.wav prompt library; caches codec tokens per speaker."""

    def __init__(self, demo_dir: Optional[str], codec=None, sample_rate: int = 16000):
        self.demo_dir = demo_dir
        self.codec = codec
        self.sample_rate = sample_rate
        self._cache: Dict[str, Dict[str, Any]] = {}

    def speakers(self) -> List[str]:
        """All voices: demo-dir prompt folders plus registered entries."""
        names = set(self._cache)
        if self.demo_dir and os.path.isdir(self.demo_dir):
            names.update(d for d in os.listdir(self.demo_dir)
                         if os.path.isdir(os.path.join(self.demo_dir, d)))
        return sorted(names)

    def register(self, name: str, global_tokens: Sequence[int],
                 semantic_tokens: Sequence[int] = ()):
        self._cache[name] = {"global_tokens": list(global_tokens),
                             "semantic_tokens": list(semantic_tokens)}

    def get(self, name: str) -> Dict[str, Any]:
        if name in self._cache:
            return self._cache[name]
        if not self.demo_dir:
            raise KeyError(name)
        d = os.path.join(self.demo_dir, name)
        wavs = sorted(f for f in os.listdir(d) if f.endswith(".wav"))
        if not wavs:
            raise KeyError(name)
        wav = audio_io.load_wav(os.path.join(d, wavs[0]), self.sample_rate,
                                volume_normalize=True)
        if self.codec is None:
            raise RuntimeError("codec required to tokenize speaker prompts")
        glob, sem = self.codec.tokenize(wav)
        entry = {"global_tokens": glob.reshape(-1).tolist(),
                 "semantic_tokens": sem.reshape(-1).tolist()}
        self._cache[name] = entry
        return entry


def _error(msg: str, sample_rate: int = 16000) -> TTSResponse:
    return TTSResponse(np.zeros(0, np.float32), sample_rate, error=msg)


class BatchedTTSService:
    """A request queue and one worker thread, with ``synthesize`` (the
    blocking client API), ``design_voice``, ``close`` and ``stats``. Its
    own worker is the grouped dispatcher: it takes the first queued
    request, gathers for up to `max_wait_ms` the next ones that share its
    voice (at most `max_batch`), and runs them as one batched
    ``pipeline.synthesize``; a request of another voice goes back on the
    queue for the next round."""

    def __init__(self, pipeline, speakers: Optional[SpeakerLibrary] = None,
                 max_batch: int = 8, max_wait_ms: float = 30.0, max_new_tokens: int = 1024):
        self.pipeline = pipeline
        self.speakers = speakers or SpeakerLibrary(None)
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.max_new_tokens = max_new_tokens
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def synthesize(self, req: TTSRequest, timeout: float = 300.0) -> TTSResponse:
        done = threading.Event()
        box: Dict[str, Any] = {}
        self._q.put((req, done, box))
        if not done.wait(timeout):
            return _error("timeout")
        return box["resp"]

    def stream(self, req: TTSRequest, hop_tokens: int = 50):
        """Streaming synthesis runs through a pipeline's
        ``synthesize_streaming``, which a Spark pipeline lacks: the HTTP
        route answers this NotImplementedError with 501."""
        raise NotImplementedError("pipeline has no streaming path")

    def design_voice(self, properties: Dict[str, Any], name: Optional[str] = None,
                     seed: int = 0) -> List[int]:
        """SPCT properties -> 32 global speaker tokens; with `name`, saved in
        the speaker library for later requests."""
        tokens = self.pipeline.design_voice(properties, seed=seed)
        if name:
            self.speakers.register(name, tokens)
        return tokens

    def close(self):
        self._stop.set()
        self._worker.join(timeout=5)

    def stats(self) -> Dict[str, Any]:
        """The grouped dispatcher reports its queue depth only."""
        return {"mode": "grouped", "queued": self._q.qsize()}

    # -- the grouped dispatcher ----------------------------------------------

    def _voice_key(self, req: TTSRequest):
        if req.speaker:
            return ("spk", req.speaker)
        if req.global_tokens:
            return ("glob", tuple(req.global_tokens))
        if req.properties:
            return ("props", tuple(sorted(req.properties.items())))
        return ("unique", id(req))

    def _run(self):
        dev = getattr(self.pipeline, "device", None)
        if dev is not None and dev.type == "cuda":
            torch.cuda.set_device(dev)
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.perf_counter() + self.max_wait_ms / 1e3
            key0 = self._voice_key(first[0])
            while len(batch) < self.max_batch and time.perf_counter() < deadline:
                try:
                    item = self._q.get(timeout=max(deadline - time.perf_counter(), 0.001))
                except queue.Empty:
                    break
                if self._voice_key(item[0]) != key0:
                    self._q.put(item)  # another voice: the next round
                    break
                batch.append(item)
            self._process(batch)

    def _process(self, batch):
        reqs = [b[0] for b in batch]
        try:
            r0 = reqs[0]
            # the batch decodes to its longest cap, rounded up to whole chunks
            cap = max(min(r.max_new_tokens or self.max_new_tokens, self.max_new_tokens)
                      for r in reqs)
            cap = min(-(-cap // 64) * 64, self.max_new_tokens)
            kw: Dict[str, Any] = {"max_new_tokens": cap, "seed": r0.seed,
                                  "temperature": r0.temperature, "top_k": r0.top_k,
                                  "top_p": r0.top_p}
            if r0.speaker:
                kw["global_tokens"] = self.speakers.get(r0.speaker)["global_tokens"]
            elif r0.global_tokens:
                kw["global_tokens"] = list(r0.global_tokens)
            elif r0.prompt_wav is not None:
                kw["prompt_wav"], kw["prompt_text"] = r0.prompt_wav, r0.prompt_text
            elif r0.properties is not None:
                kw["properties"] = r0.properties
            results = self.pipeline.synthesize([r.text for r in reqs], **kw)
            for (_req, done, box), res in zip(batch, results):
                box["resp"] = TTSResponse(res.wav, res.sample_rate)
                done.set()
        except Exception as e:  # noqa: BLE001 — the service must answer
            log.exception("grouped synthesis failed")
            for _req, done, box in batch:
                box["resp"] = _error(str(e))
                done.set()


def dp_devices(device: torch.device, dp: int):
    """The devices of a dp slot pool: cuda:0 .. cuda:dp-1 for a model on a
    card (more than the cards present is an error), `dp` times the CPU for
    one on the CPU; None for one group."""
    if dp <= 1:
        return None
    if device.type == "cpu":
        return ["cpu"] * dp
    have = torch.cuda.device_count()
    if dp > have:
        raise ValueError(f"dp={dp} slot groups need {dp} CUDA devices; {have} present")
    return [f"cuda:{i}" for i in range(dp)]


class ContinuousTTSService(BatchedTTSService):
    """Every /api/rwkv_tts request is admitted into a ContinuousBatcher
    slot: mixed voices and lengths decode in one pool, since a Spark voice
    lives in the prompt tokens. Per-request temperature and top-p ride in
    the slot carry; top-k is the pool's cap."""

    def __init__(
        self,
        pipeline,  # infer.spark_pipeline.SparkPipeline
        speakers: Optional[SpeakerLibrary] = None,
        n_slots: int = 8,
        chunk: int = 16,
        prompt_cap: int = 128,
        max_new_tokens: int = 1024,
        temperature: float = 1.0,
        top_k: int = 50,
        top_p: float = 0.95,
        seed: int = 0,
        warmup: bool = False,
        warmup_widths=None,  # prompt widths to run at boot (default: prompt_cap)
        dp: int = 1,
        overlap: bool = False,
        megakernel: bool = False,
    ):
        from rwkvtts_torch.serving.continuous import ContinuousBatcher

        self.batcher = ContinuousBatcher(
            pipeline.params, pipeline.cfg, n_slots=n_slots, chunk=chunk,
            prompt_cap=prompt_cap, temperature=temperature, top_k=top_k,
            top_p=top_p, seed=seed, devices=dp_devices(pipeline.params["head"].device, dp),
            overlap=overlap, megakernel=megakernel,
        )
        if warmup:
            self.batcher.warmup(warmup_widths)
        # super() starts the worker thread: the batcher must exist first
        super().__init__(pipeline, speakers, max_new_tokens=max_new_tokens)

    def stats(self) -> Dict[str, Any]:
        st = self.batcher.snapshot_stats()
        chunks = max(1, st["chunks"])
        return {
            "mode": "continuous",
            "n_slots": self.batcher.n_slots,
            "chunk": self.batcher.chunk,
            "queued": self._q.qsize(),
            **{k: round(v, 3) if isinstance(v, float) else v for k, v in st.items()},
            "occupancy": round(st["active_rows"] / (chunks * self.batcher.n_slots), 3),
            "chunk_ms_per_step": round(1e3 * st["chunk_s"] / chunks / self.batcher.chunk, 3),
        }

    # -- request -> prompt --------------------------------------------------

    def _resolve_voice(self, req: TTSRequest):
        """-> (text, global_tokens, prompt_semantics, properties_str)."""
        from rwkvtts_torch.data.properties import properties_string

        text, prompt_sem, props_str = req.text, [], None
        if req.speaker:
            globals_ = self.speakers.get(req.speaker)["global_tokens"]
        elif req.global_tokens:
            globals_ = list(req.global_tokens)
        elif req.prompt_wav is not None:
            if self.pipeline.codec is None:
                raise ValueError("audio tokenizer required for prompt_wav")
            glob, sem = self.pipeline.codec.tokenize(req.prompt_wav)
            globals_ = glob.reshape(-1).tolist()
            if req.prompt_text:
                text = req.prompt_text + text
                prompt_sem = sem.reshape(-1).tolist()
        elif req.properties is not None:
            globals_ = self.pipeline.design_voice(req.properties, seed=req.seed)
            props_str = properties_string(
                req.properties.get("age", "youth-adult"),
                req.properties.get("gender", "female"),
                req.properties.get("emotion", "NEUTRAL"),
                req.properties.get("pitch", "medium_pitch"),
                req.properties.get("speed", "medium"),
            )
        else:
            raise ValueError("need speaker, global_tokens, prompt_wav, or properties")
        return text, globals_, prompt_sem, props_str

    def _admit(self, item, pending) -> None:
        req, done, box = item
        try:
            text, globals_, prompt_sem, props = self._resolve_voice(req)
            pb = self.pipeline._prompt_batch([text], [globals_], [prompt_sem], [props])
            cap = min(req.max_new_tokens or self.max_new_tokens, self.max_new_tokens)
            rid = self.batcher.add_request(pb, cap, temperature=req.temperature,
                                           top_p=req.top_p, seed=req.seed)
            pending[rid] = (req, done, box, globals_)
        except Exception as e:  # noqa: BLE001 — the service must answer
            box["resp"] = _error(str(e))
            done.set()

    def _finish(self, toks, globals_) -> TTSResponse:
        codec = self.pipeline.codec
        sr = getattr(self.pipeline, "sample_rate", 16000)
        if codec is None or not toks:
            return TTSResponse(np.zeros(0, np.float32), sr)
        g = np.asarray(globals_, np.int64)[None, None, :]
        sem = np.asarray(toks, np.int64)[None]
        return TTSResponse(np.asarray(codec.detokenize(g, sem))[0], sr)

    # -- worker -------------------------------------------------------------

    def _run(self):
        cb = self.batcher
        if cb.device.type == "cuda":
            torch.cuda.set_device(cb.device)
        pending: Dict[int, Any] = {}
        with torch.inference_mode():
            while not self._stop.is_set():
                # admit everything queued right now (one batched prefill)
                while True:
                    try:
                        item = self._q.get_nowait()
                    except queue.Empty:
                        break
                    self._admit(item, pending)
                if cb.idle():
                    try:
                        item = self._q.get(timeout=0.1)
                    except queue.Empty:
                        continue
                    self._admit(item, pending)
                    continue  # loop back to drain a burst before stepping
                try:
                    finished = cb.step()
                except Exception as e:  # noqa: BLE001 — the worker must survive
                    # a failed chunk leaves the carry in an unknown state:
                    # answer every request in flight or queued with the
                    # error and start the pool afresh
                    log.exception("decode chunk failed; resetting the slot pool")
                    for req, done, box, _g in pending.values():
                        box["resp"] = _error(str(e))
                        done.set()
                    pending.clear()
                    cb.reset()
                    continue
                for rid, toks in finished:
                    req, done, box, globals_ = pending.pop(rid)
                    try:
                        box["resp"] = self._finish(toks, globals_)
                    except Exception as e:  # noqa: BLE001
                        box["resp"] = _error(str(e))
                    done.set()


class _CosyVoiceNames:
    """SpeakerLibrary-shaped view of a CosyVoiceLibrary, so GET
    /api/speakers lists the stored zero-shot voices."""

    def __init__(self, voices):
        self._voices = voices

    def speakers(self) -> List[str]:
        return self._voices.speakers() if self._voices is not None else []

    def register(self, name, tokens):  # a Spark global-token registration
        raise NotImplementedError(
            "Cosy voices register from wav: CosyVoiceLibrary.register_from_wav")


class CosyTTSService:
    """The HTTP layer's service for a CosyPipeline over one shared slot
    pool (``cosy_pool.CosyStreamHub``): every request, streaming or not,
    decodes through the pool. Duck-compatible with BatchedTTSService for
    the HTTP server: ``synthesize``, ``stream``, ``speakers``, ``stats``,
    ``pipeline``. RAS top-k / top-p are the pool's (set at launch); a
    request's temperature / top-p are ignored, as in the JAX service."""

    def __init__(
        self,
        pipeline,  # infer.cosy_pipeline.CosyPipeline
        voices=None,  # infer.voices.CosyVoiceLibrary
        n_slots: int = 8,
        chunk: int = 16,
        prompt_cap: int = 128,
        max_new_tokens: int = 2048,
        top_k: int = 25,
        top_p: float = 0.8,
        warmup: bool = False,
        warmup_widths=None,
        overlap: bool = False,
        stream_cfg=None,  # the hub-wide StreamConfig (SFM, ctx, vocode_every)
    ):
        from rwkvtts_torch.serving.cosy_pool import CosyStreamHub

        self.pipeline = pipeline
        self.voices = voices
        self.speakers = _CosyVoiceNames(voices)
        self.max_new_tokens = max_new_tokens
        self.hub = CosyStreamHub(pipeline, n_slots=n_slots, chunk=chunk, prompt_cap=prompt_cap,
                                 top_k=top_k, top_p=top_p, warmup=warmup,
                                 warmup_widths=warmup_widths, overlap=overlap,
                                 stream_cfg=stream_cfg)

    def close(self):
        self.hub.close()

    def stats(self) -> Dict[str, Any]:
        b = self.hub.batcher
        return {"mode": "cosy_pool", "n_slots": b.n_slots, "chunk": b.chunk,
                "active": sum(1 for s in b._slots if s.req_id is not None),
                "queued": len(b._queue)}

    def _voice_kw(self, req: TTSRequest) -> Dict[str, Any]:
        if req.prompt_wav is not None:
            return {"prompt_wav": req.prompt_wav, "prompt_text": req.prompt_text or ""}
        if req.speaker:
            if self.voices is None:
                raise ValueError("named speakers need a voice library")
            try:
                v = self.voices.get(req.speaker)
            except KeyError:
                raise ValueError(f"unknown speaker: {req.speaker!r}") from None
            return {"prompt_speech_tokens": v["tokens"], "prompt_mel": v["mel"],
                    "spk_embedding": v["emb"], "prompt_text": req.prompt_text or v.get("text", "")}
        if req.global_tokens or req.properties:
            raise ValueError("the Cosy service takes prompt_wav or a stored speaker voice "
                             "(global_tokens/properties are Spark-voice concepts)")
        return {"prompt_text": req.prompt_text or ""}

    def stream(self, req: TTSRequest, hop_tokens: int = 50, timeout: Optional[float] = None):
        if self.pipeline.flow_cfg is None or self.pipeline.hift_cfg is None:
            raise RuntimeError("cosy serving needs flow.pt + hift.pt for wav output "
                               "(pass --cosy-dir with the CosyVoice2 model files)")
        cap = min(req.max_new_tokens or self.max_new_tokens, self.max_new_tokens)
        yield from self.hub.stream(req.text, hop_tokens=hop_tokens, seed=req.seed,
                                   max_new_tokens=cap, timeout=timeout, **self._voice_kw(req))

    def synthesize(self, req: TTSRequest, timeout: float = 300.0) -> TTSResponse:
        """The stream joined; `timeout` bounds the whole request, and any
        error is answered, never raised."""
        sr = getattr(self.pipeline, "sample_rate", 24000)
        try:
            chunks = list(self.stream(req, timeout=timeout))
            return TTSResponse(np.concatenate(chunks) if chunks else np.zeros(0, np.float32), sr)
        except Exception as e:  # noqa: BLE001 — the service must answer
            return _error(str(e), sr)


def stream_wav_header(sample_rate: int, channels: int = 1) -> bytes:
    """WAV header with an unknown (maximal) data length: players start
    decoding at once and read until the connection closes."""
    bits = 16
    byte_rate = sample_rate * channels * bits // 8
    block_align = channels * bits // 8
    return (b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVE"
            + b"fmt " + struct.pack("<IHHIIHH", 16, 1, channels, sample_rate,
                                    byte_rate, block_align, bits)
            + b"data" + struct.pack("<I", 0xFFFFFFFF))


def pcm16(wav) -> bytes:
    x = np.clip(np.asarray(wav, np.float32), -1.0, 1.0)
    return (x * 32767.0).astype("<i2").tobytes()


def properties_options() -> Dict[str, List[str]]:
    """Dropdown vocabularies for voice design: the SPCT property sets."""
    from rwkvtts_torch.data import properties as props

    return {"age": list(props.AGE_TOKENS), "gender": list(props.GENDER_TOKENS),
            "emotion": list(props.EMOTION_TOKENS), "pitch": list(props.PITCH_TOKENS),
            "speed": list(props.SPEED_TOKENS)}


def decode_audio_b64(b64: str, sample_rate: int = 16000) -> np.ndarray:
    """base64 wav payload -> float32 mono."""
    return audio_io.load_wav_bytes(base64.b64decode(b64), sample_rate)


def mp3_bytes(wav: np.ndarray, sample_rate: int, bitrate_kbps: int = 128) -> bytes:
    """MP3 response bytes (the reference answers in wav or mp3) through the
    ctypes LAME binding; RuntimeError where libmp3lame is absent."""
    from rwkvtts_torch.utils import mp3

    return mp3.encode_mp3(wav, sample_rate, bitrate_kbps=bitrate_kbps)


def wav_bytes(wav: np.ndarray, sample_rate: int) -> bytes:
    """16-bit PCM mono WAV file bytes."""
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm16(wav))
    return buf.getvalue()
