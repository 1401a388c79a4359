"""Slot-pool decoding and concurrent streaming for the Cosy LM (counterpart
of rwkvtts_tpu/serving/cosy_pool.py).

N concurrent streams share one slot pool: ``CosyPoolBatcher`` is the
continuous batcher of serving/continuous.py applied to the CosyVoice LM
(RAS sampling, per-row minimum-length EOS suppression), and
``CosyStreamHub`` feeds each stream's tokens into its own
``infer/streaming.CosyStreamSession`` (the incremental flow / HiFT hops).

A chunk is `chunk` steps of: head product + bias -> EOS masked while a row
has drawn fewer than its minimum -> ``sampling.ras_sample`` with both
draws hashed from (the row's request seed, its own step index n) by
``sampling.ras_row_noise`` -> the EOS latch -> ``cosy.decode_embed`` -> ``rwkv7.decode_step`` (the
WKV step kernel on a card, stepping each layer's state in place). An
admission is one batched ``cosy.prefill`` (the WKV7 forward kernel on a
card) at a power-of-two batch, then row writes into the free slots. A
row's tokens are thereby a function of its request alone, not of what
shares the pool, when it was admitted or where the chunks break.

The queue, the slots, admission, overlap and warmup are
``pool_common.SlotPool``'s, which the Spark pool shares.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Dict, Generator, List, Optional, Sequence

import numpy as np
import torch

from rwkvtts_torch.data import cosy_collator
from rwkvtts_torch.data.spark_collator import pad_prompts_left
from rwkvtts_torch.infer import streaming
from rwkvtts_torch.models import cosy, rwkv7
from rwkvtts_torch.ops import sampling
from rwkvtts_torch.serving import pool_common


class CosyPoolBatcher(pool_common.SlotPool):
    """Slot-pool decoder for the Cosy LM with incremental token delivery:
    ``step()`` returns events (req_id, new tokens, done), the partial tokens
    of every chunk, which is what streaming consumers need.

    `params` is the LM tree: the stacked originals (the prefill reads them)
    and, for the decode step, ``rwkv7.pack_decode_params``'s decode weights
    where present: the fused pair in bf16, int8 or int4, or int8 unfused. The two RAS draws of each row come from
    ``self.noise(seed (B,), n (B,), k, V)``, ``sampling.ras_row_noise``
    (a test may feed other draws through it)."""

    @torch.inference_mode()
    def __init__(
        self,
        params,
        cfg,
        n_slots: int = 8,
        chunk: int = 16,
        prompt_cap: int = 128,
        top_k: int = 25,
        top_p: float = 0.8,
        win_size: int = 10,
        tau_r: float = 0.1,
        seed: int = 0,
        overlap: bool = False,
    ):
        self.cfg = cfg
        bb = cfg.backbone
        self.device = params["head"].device
        self.params = params
        # the decode step on per-layer views, each layer's WKV state stepped
        # in place (the same function as a fresh buffer a step)
        self.bb = dataclasses.replace(bb, decode_wkv_packed=True)
        self.params_l = rwkv7.layer_decode_views(params, bb)
        self._head = params["head"].to(bb.dtype)
        self._bias = params["head_bias"].float() if "head_bias" in params else None
        self.top_k, self.top_p = top_k, top_p
        self.win_size, self.tau_r = win_size, tau_r
        self.seed = seed
        self.noise = sampling.ras_row_noise
        super().__init__(self.device, n_slots, chunk, prompt_cap, overlap)

    def _fresh_carry(self):
        """(h, state, done, recent, n, minlen, seed) of an empty pool."""
        bb, B, dev = self.cfg.backbone, self.n_slots, self.device
        st = rwkv7.pack_decode_state(rwkv7.init_model_state(bb, B, device=dev), bb)
        return (
            torch.zeros(B, bb.hidden_size, dtype=bb.dtype, device=dev),
            st,
            torch.ones(B, dtype=torch.bool, device=dev),  # empty slots count as done
            torch.full((B, self.win_size), -1, dtype=torch.long, device=dev),
            torch.zeros(B, dtype=torch.long, device=dev),
            torch.zeros(B, dtype=torch.long, device=dev),
            torch.full((B,), self.seed, dtype=torch.long, device=dev),
        )

    # -- client API -------------------------------------------------------

    def add_request(self, prompt_batch: Dict[str, np.ndarray], max_new_tokens: int,
                    min_new_tokens: int = 0, seed: Optional[int] = None) -> int:
        """prompt_batch: a B=1 left-padded Cosy prompt ({tokens, modality,
        attention_mask}); EOS is suppressed until `min_new_tokens` are
        drawn. Oversized values are clamped here, so an admission on the
        pool's thread cannot fail on them."""
        return self._enqueue(prompt_batch, max_new_tokens, pool_common.clamp_i32(min_new_tokens),
                             pool_common.clamp_seed(self.seed if seed is None else seed))

    # -- engine -----------------------------------------------------------

    _warm_row = (np.zeros(1, np.int64), np.zeros(1, np.int64))

    def _prefill(self, batch: Dict[str, np.ndarray]):
        t = {k: torch.from_numpy(np.asarray(v, np.int64)).to(self.device)
             for k, v in batch.items()}
        return cosy.prefill(self.params, self.cfg, t["tokens"], t["modality"],
                            t["attention_mask"])

    def _insert(self, hk, stk, slots, take: int, minvec, svec) -> None:
        """Write the first `take` prefilled requests (rows of hk and of the
        stacked prefill state stk) into slots `slots[:take]`: row writes."""
        h, st, done, recent, n, minlen, seed = self._carry
        idx = torch.as_tensor(np.asarray(slots[:take], np.int64), device=self.device)
        rows = slice(0, take)
        h[idx] = hk[rows].to(h.dtype)
        for l, st_l in enumerate(st):
            for k, leaf in st_l.items():
                leaf[idx] = stk[k][l, rows].to(leaf.dtype)
        done[idx] = False
        recent[idx] = -1
        n[idx] = 0
        vecs = torch.as_tensor(np.stack([np.asarray(minvec[:take], np.int64),
                                         np.asarray(svec[:take], np.int64)]), device=self.device)
        minlen[idx], seed[idx] = vecs[0], vecs[1]

    def _chunk(self) -> torch.Tensor:
        """Decode `chunk` steps of the whole pool (rwkvtts_tpu's
        _decode_chunk); returns the tokens (n_slots, chunk) on the device."""
        eos, V = self.cfg.eos_token_id, self.cfg.speech_head_size
        k = min(self.top_k, V)
        h, st, done, recent, n, minlen, seed = self._carry
        toks = torch.empty(self.n_slots, self.chunk, dtype=torch.long, device=self.device)
        for i in range(self.chunk):
            logits = (h @ self._head).float()
            if self._bias is not None:
                logits = logits + self._bias
            logits[:, eos] = torch.where(n < minlen, sampling.NEG_INF, logits[:, eos])
            tok = sampling.ras_sample(logits, recent, top_p=self.top_p, top_k=self.top_k,
                                      win_size=self.win_size, tau_r=self.tau_r,
                                      noise=self.noise(seed, n, k, V))
            tok = torch.where(done, eos, tok)
            done = done | (tok == eos)
            recent = torch.cat([recent[:, 1:], tok[:, None]], 1)
            toks[:, i] = tok
            h, st = rwkv7.decode_step(self.params_l, self.bb,
                                      cosy.decode_embed(self.params, self.cfg, tok), st)
            n = n + 1
        self._carry = (h, st, done, recent, n, minlen, seed)
        return toks

    @torch.inference_mode()
    def cancel(self, rid: int) -> None:
        """Stop decoding a request (its client went away): drop it from the
        queue, free its slot and set the slot's done flag."""
        self._queue = [q for q in self._queue if q[0] != rid]
        self._active.pop(rid, None)
        freed = np.array([s.req_id == rid for s in self._slots])
        if freed.any():
            self._slots = [pool_common._Slot() if f else s for f, s in zip(freed, self._slots)]
            self._mark_done(freed)

    def drain(self) -> Dict[int, List[int]]:
        """Run until every queued request finishes; -> {rid: tokens}."""
        out: Dict[int, List[int]] = {}
        acc: Dict[int, List[int]] = {}
        while not self.idle():
            for rid, new, done in self.step():
                acc.setdefault(rid, []).extend(new.tolist())
                if done:
                    out[rid] = acc.pop(rid)
        return out


class CosyStreamHub:
    """N concurrent streaming utterances over one slot pool.

    Each stream admits its LM prompt into the shared pool and feeds its
    growing token array into its own CosyStreamSession (incremental flow /
    HiFT, with its own noise generators), yielding wav chunks. One pump
    thread advances the pool; the vocoder hops run on the consumer threads,
    so a slow reader does not stall the chunk loop.

    On a card every thread issues to the same default stream, so a chunk's
    host read waits for every hop queued before it: with
    `first_chunk_priority`, streams that already produced audio defer
    their next hop (for at most 0.6 of a hop's audio, 1.5 s at most) while
    an admitted stream still waits for its first chunk. `stream_cfg` is the
    hub-wide StreamConfig (the SFM levers, ctx, vocode_every). The pool
    decodes the pipeline's `lm_params` as they are through
    ``rwkv7.decode_step``: on the launcher's route the fused decode weights
    in bf16, int8 or int4 (or int8 unfused), on the B=1 kernel route the
    unfused originals (the seven-product step)."""

    def __init__(self, pipeline, n_slots: int = 8, chunk: int = 16, prompt_cap: int = 128,
                 top_k: int = 25, top_p: float = 0.8, warmup: bool = False,
                 warmup_widths=None, overlap: bool = False, stream_cfg=None,
                 first_chunk_priority: bool = True):
        self.pipe = pipeline
        self.first_chunk_priority = first_chunk_priority
        self._first_pending: set = set()
        self._first_cv = threading.Condition()
        self.stream_cfg = stream_cfg
        self.batcher = CosyPoolBatcher(pipeline.lm_params, pipeline.lm_cfg, n_slots=n_slots,
                                       chunk=chunk, prompt_cap=prompt_cap, top_k=top_k,
                                       top_p=top_p, overlap=overlap)
        if warmup:
            self.batcher.warmup(warmup_widths)
        self._sinks: Dict[int, "queue.Queue"] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._pump = threading.Thread(target=self._run, daemon=True)
        self._pump.start()

    def close(self) -> None:
        self._stop.set()
        self._wake.set()
        self._pump.join(timeout=5)
        with self._lock:  # unblock any consumer still waiting on its queue
            for q in self._sinks.values():
                q.put((np.zeros((0,), np.int64), True, "hub closed"))

    def _fail_all(self, err: str) -> None:
        """Pool-level failure containment: answer every live stream with
        the error and reset the engine, instead of leaving each consumer
        waiting on its queue forever."""
        with self._lock:
            sinks = dict(self._sinks)
            self.batcher.reset()
        for q in sinks.values():
            q.put((np.zeros((0,), np.int64), True, err))
        with self._first_cv:
            self._first_pending.clear()
            self._first_cv.notify_all()

    def _run(self) -> None:
        dev = self.batcher.device
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        while not self._stop.is_set():
            with self._lock:
                idle = self.batcher.idle()
            if idle:
                self._wake.wait(timeout=0.05)
                self._wake.clear()
                continue
            try:
                with self._lock:
                    events = self.batcher.step()
            except Exception as e:  # noqa: BLE001 — the pump must survive
                self._fail_all(f"pool decode failed: {e}")
                continue
            for rid, new, done in events:
                q = self._sinks.get(rid)
                if q is not None:
                    q.put((new, done, None))

    @torch.inference_mode()
    def stream(
        self,
        text: str,
        prompt_text: str = "",
        prompt_wav: Optional[np.ndarray] = None,
        prompt_speech_tokens: Sequence[int] = (),
        prompt_mel: Optional[np.ndarray] = None,
        spk_embedding: Optional[np.ndarray] = None,
        hop_tokens: Optional[int] = None,
        seed: int = 0,
        max_new_tokens: int = 2048,
        timeout: Optional[float] = None,
        stream_cfg=None,
    ) -> Generator[np.ndarray, None, None]:
        """One streaming utterance (numpy f32 wav chunks); safe to call from
        many threads at once. The LM stage of
        ``streaming.stream_synthesize``, pooled. The StreamConfig is
        `stream_cfg`, else the hub's, else the default; `hop_tokens`, when
        given, sets the hop of whichever applies. `timeout` bounds the whole
        stream (seconds): on expiry the request is cancelled and
        TimeoutError raised. A pool-level decode failure raises
        RuntimeError."""
        pipe = self.pipe
        if prompt_wav is not None:
            prompt_speech_tokens, prompt_mel, spk_embedding = pipe.frontend_zero_shot(prompt_wav)
        scfg = stream_cfg or self.stream_cfg or streaming.StreamConfig()
        if hop_tokens is not None:
            scfg = dataclasses.replace(scfg, token_hop_len=hop_tokens)
        sess = streaming.CosyStreamSession(pipe, scfg, prompt_speech_tokens, prompt_mel,
                                           spk_embedding, streaming.SessionNoise(seed, pipe.device))
        text_ids = pipe.tok.encode(prompt_text) + pipe.tok.encode(text)
        batch = pad_prompts_left([cosy_collator.build_prompt(text_ids, list(prompt_speech_tokens))])
        content_len = cosy_collator.content_length(text_ids)
        min_len = int(content_len * 2)
        max_len = min(int(content_len * 20), max_new_tokens)

        q: "queue.Queue" = queue.Queue()
        with self._lock:
            rid = self.batcher.add_request(batch, max_len, min_new_tokens=min_len, seed=seed)
            self._sinks[rid] = q
        if self.first_chunk_priority:
            with self._first_cv:
                self._first_pending.add(rid)
        self._wake.set()
        tokens = np.zeros((0,), np.int64)
        done = emitted = False
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while True:
                try:
                    new, done, err = q.get(timeout=None if deadline is None
                                           else max(deadline - time.monotonic(), 0.001))
                except queue.Empty:
                    raise TimeoutError(f"stream exceeded {timeout}s") from None
                if err is not None:
                    raise RuntimeError(err)
                if len(new):
                    tokens = np.concatenate([tokens, new])
                if emitted and self.first_chunk_priority:
                    # let pending first chunks take the device first, for at
                    # most a share of this stream's buffered hop audio (25
                    # tokens a second), within the stream's own deadline
                    patience = time.monotonic() + min(1.5, 0.6 * scfg.token_hop_len / 25.0)
                    if deadline is not None:
                        patience = min(patience, deadline)
                    with self._first_cv:
                        while self._first_pending and time.monotonic() < patience:
                            self._first_cv.wait(timeout=0.05)
                for chunk_wav in sess.emit_ready(tokens, lm_done=done):
                    if not emitted:
                        emitted = True
                        with self._first_cv:
                            self._first_pending.discard(rid)
                            self._first_cv.notify_all()
                    yield chunk_wav
                if done:
                    return
        finally:
            self._sinks.pop(rid, None)
            with self._first_cv:
                self._first_pending.discard(rid)
                self._first_cv.notify_all()
            if not done:  # the consumer left mid-stream: free the slot
                with self._lock:
                    self.batcher.cancel(rid)
