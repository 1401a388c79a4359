"""Continuous (in-flight) batching for Spark decode serving (counterpart of
rwkvtts_tpu/serving/continuous.py).

A fixed pool of B decode slots decodes chunk after chunk, and new requests
are swapped into finished slots between chunks. An RWKV request's state is
fixed-size, so admitting one is a row write into each state tensor.

The slot carry is (h, state, done, n, temperature, top_p, seed), all on the
pool's device. A chunk is `chunk` steps of: head product (f32) -> ``sample_rows``
with each row's own temperature / top-p and Gumbel noise hashed from (its
request's seed, its own step index n) -> the EOS latch -> the embedding ->
the backbone step, which is ``rwkv7.decode_step`` (the WKV step kernel,
in place, on a card) or, for the megakernel pool, the B=64 decode step
(``ops/decode_mega_b64``). A row's tokens are thereby a function of its
request alone, not of what shares the pool, when it was admitted or where
the chunks break. The host reads each chunk's tokens once.

Overlap mode dispatches chunk N+1 before reading chunk N's tokens: the
tokens are copied into a pinned host buffer without blocking and a CUDA
event marks the copy's end, so the host's post-processing runs while the
card decodes the next chunk. Its tokens are those of the sequential pool.

PyTorch runs eagerly: nothing is compiled, so ``warmup`` only builds the
kernels and fills the allocator and library caches before traffic. The
dp-sharded pool (a device mesh) is not ported; the pool raises if given
one.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from rwkvtts_torch.models import rwkv7, spark
from rwkvtts_torch.ops import decode_mega_b64 as dmb
from rwkvtts_torch.ops import sampling
from rwkvtts_torch.serving import pool_common


@dataclasses.dataclass
class _Slot:
    req_id: Optional[int] = None
    tokens: Optional[List[int]] = None
    max_new: int = 0


class ContinuousBatcher:
    """Slot-pool decoder for the Spark speech LM.

    Usage:
        cb = ContinuousBatcher(params, cfg, n_slots=8)
        rid = cb.add_request(prompt_batch, max_new_tokens=256)
        while not cb.idle():
            for req_id, toks in cb.step():
                ...  # finished sequences
    """

    @torch.inference_mode()
    def __init__(
        self,
        params,
        cfg,
        n_slots: int = 8,
        chunk: int = 16,
        prompt_cap: int = 128,
        temperature: float = 1.0,
        top_k: int = 1,  # greedy default: deterministic serving
        top_p: float = 1.0,
        seed: int = 0,
        mesh=None,
        overlap: bool = False,
        megakernel: bool = False,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "a dp-sharded slot pool (device mesh) is not ported yet: serve on one card")
        self.cfg = cfg
        bb = cfg.backbone
        self.device = params["head"].device
        self.megakernel = megakernel
        if megakernel:
            # the B=64 step takes exactly 64 rows
            if n_slots != dmb.B:
                raise ValueError(f"megakernel pool requires n_slots={dmb.B}, got {n_slots}")
            self._mega = dmb.pack_mega_b64(params, bb)
        # stacked params for the prefill, per-layer views for the decode
        # step (the mega pool never runs rwkv7.decode_step)
        self.params = params
        self.params_l = None if megakernel else rwkv7.layer_decode_views(params, bb)
        # logits in f32 from the model-dtype h and head: XLA computes the
        # JAX pool's (h @ head).astype(f32) so (the convert folds into the
        # product), and a bf16-rounded logit row would tie far more often
        self._head = params["head"].to(bb.dtype).float()
        self.n_slots = n_slots
        self.chunk = chunk
        self.prompt_cap = prompt_cap
        self.temperature, self.top_k, self.top_p = temperature, top_k, top_p
        self.seed = seed  # default per-request seed
        self._next_id = 0
        # (rid, prompt_batch, max_new, temperature, top_p, seed)
        self._queue: List[Tuple[int, Dict[str, np.ndarray], int, float, float, int]] = []
        self._slots = [_Slot() for _ in range(n_slots)]
        self._carry = self._fresh_carry()
        self.overlap = overlap
        # overlap: two pinned host buffers, one for the chunk being read
        # and one for the chunk in flight
        self._pinned = None
        if overlap and self.device.type == "cuda":
            self._pinned = [torch.empty(n_slots, chunk, dtype=torch.long, pin_memory=True)
                            for _ in range(2)]
        self._flip = 0
        # (tokens handle, owners at dispatch); an owner can go stale when
        # its request finished meanwhile -> resolved through _active
        self._pending: Optional[Tuple[Any, List[Optional[int]]]] = None
        self._active: Dict[int, _Slot] = {}
        # step() time / occupancy breakdown (reset_stats() clears it):
        #   admit_s  host prep + prefill + insert for admissions
        #   chunk_s  decode-chunk dispatch + device + token copy (the
        #            host read bounds it; in overlap mode dispatch only)
        #   host_s   post-processing of finished rows (in overlap mode it
        #            also waits for the previous chunk's tokens)
        #   active_rows / (chunks * n_slots) = slot occupancy
        self.stats = {"admit_s": 0.0, "chunk_s": 0.0, "host_s": 0.0,
                      "chunks": 0, "active_rows": 0, "admitted": 0}
        self._stats_lock = threading.Lock()

    def _fresh_carry(self):
        bb, n, dev = self.cfg.backbone, self.n_slots, self.device
        st = rwkv7.init_model_state(bb, n, device=dev)
        if self.megakernel:
            st = dmb.pack_state(st)
        else:
            st = rwkv7.pack_decode_state(st, bb)
        return (
            torch.zeros(n, bb.hidden_size, dtype=bb.dtype, device=dev),
            st,
            torch.ones(n, dtype=torch.bool, device=dev),  # empty slots count as done
            torch.zeros(n, dtype=torch.long, device=dev),
            torch.full((n,), self.temperature, dtype=torch.float32, device=dev),
            torch.full((n,), self.top_p, dtype=torch.float32, device=dev),
            torch.full((n,), self.seed, dtype=torch.long, device=dev),
        )

    def _prefill(self, batch: Dict[str, np.ndarray]):
        t = {k: torch.from_numpy(np.asarray(v, np.int64)).to(self.device) for k, v in batch.items()}
        return spark.prefill(self.params, self.cfg, t["tokens"], t["modality"],
                             t["attention_mask"])

    def _insert(self, hk, stk, slots, take: int, tvec, pvec, svec) -> None:
        """Write the first `take` prefilled requests (rows of hk and of the
        stacked prefill state stk) into slots `slots[:take]`, with each
        request's temperature / top-p / seed: row writes in place."""
        if take == 0:
            return
        h, st, done, n, temp, topp, seed = self._carry
        idx = torch.as_tensor(np.asarray(slots[:take], np.int64), device=self.device)
        rows = slice(0, take)
        h[idx] = hk[rows].to(h.dtype)
        if self.megakernel:  # stacked (L, 64, ...) leaves
            for k, leaf in st.items():
                leaf[:, idx] = stk[k][:, rows].to(leaf.dtype)
        else:  # per-layer leaves
            for l, st_l in enumerate(st):
                for k, leaf in st_l.items():
                    leaf[idx] = stk[k][l, rows].to(leaf.dtype)
        done[idx] = False
        n[idx] = 0
        params = torch.as_tensor(np.stack([tvec[:take], pvec[:take]]), device=self.device)
        temp[idx], topp[idx] = params[0], params[1]
        seed[idx] = torch.as_tensor(np.asarray(svec[:take], np.int64), device=self.device)

    def _mark_done(self, slot_mask: np.ndarray) -> None:
        """Set the done flag of slots retired by their cap (no EOS drawn),
        so they stop drawing until a new request lands there."""
        h, st, done, n, temp, topp, seed = self._carry
        mask = torch.as_tensor(slot_mask, device=self.device)
        self._carry = (h, st, done | mask, n, temp, topp, seed)

    def _chunk(self) -> torch.Tensor:
        """Decode `chunk` steps of the whole pool; returns the tokens
        (n_slots, chunk) on the device."""
        bb = self.cfg.backbone
        eos = self.cfg.eos_token_id
        h, st, done, n, temp, topp, seed = self._carry
        toks = torch.empty(self.n_slots, self.chunk, dtype=torch.long, device=self.device)
        for i in range(self.chunk):
            logits = h.float() @ self._head
            tok = sampling.sample_rows(logits, temperature=temp, top_k=self.top_k,
                                       top_p=topp, seed=seed, n=n)
            tok = torch.where(done, eos, tok)
            done = done | (tok == eos)
            toks[:, i] = tok
            x = spark.decode_embed(self.params, self.cfg, tok)
            if self.megakernel:
                h, st = dmb.decode_step_mega_b64(self._mega, bb, x, st)
                h = h.to(bb.dtype)
            else:
                h, st = rwkv7.decode_step(self.params_l, bb, x, st)
            n = n + 1
        self._carry = (h, st, done, n, temp, topp, seed)
        return toks

    # -- client API -------------------------------------------------------

    def add_request(self, prompt_batch: Dict[str, np.ndarray], max_new_tokens: int,
                    temperature: Optional[float] = None, top_p: Optional[float] = None,
                    seed: Optional[int] = None) -> int:
        """prompt_batch: a B=1 left-padded batch ({tokens, modality,
        attention_mask}) as spark_collator.pad_prompts_left makes it.
        temperature / top_p / seed default to the pool's; they ride in the
        slot carry, and a (prompt, seed) pair gives the same tokens whatever
        else shares the pool."""
        rid = self._next_id
        self._next_id += 1
        self._queue.append((
            rid, prompt_batch, max_new_tokens,
            self.temperature if temperature is None else float(temperature),
            self.top_p if top_p is None else float(top_p),
            pool_common.clamp_seed(self.seed if seed is None else seed),
        ))
        return rid

    def idle(self) -> bool:
        return (not self._queue and all(s.req_id is None for s in self._slots)
                and self._pending is None)

    @torch.inference_mode()
    def warmup(self, prompt_widths: Optional[List[int]] = None) -> None:
        """Run every program shape once before traffic: the prefill at each
        power-of-two admission size for every width in `prompt_widths`
        (rounded up to the admission buckets; default the prompt cap), an
        insert, a decode chunk and a retire-by-cap flag update. On a card
        this builds the kernels and fills PyTorch's caches, so the first
        request pays for none of it. The engine state is reset after."""
        for width in pool_common.warmup_widths(prompt_widths, self.prompt_cap):
            dummy = {"tokens": np.zeros((1, width), np.int32),
                     "modality": np.zeros((1, width), np.int32),
                     "attention_mask": np.ones((1, width), np.int32)}
            bucket = 1
            while True:
                hk, stk = self._prefill({k: np.repeat(v, bucket, 0) for k, v in dummy.items()})
                self._insert(hk, stk, [0], 1, np.ones(1, np.float32), np.ones(1, np.float32),
                             np.zeros(1, np.int64))
                if bucket >= self.n_slots:
                    break
                bucket *= 2
        self._chunk()
        self._mark_done(np.zeros(self.n_slots, bool))
        self._carry = self._fresh_carry()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- engine -----------------------------------------------------------

    def _admit(self) -> None:
        """Admit as many queued requests as there are free slots with one
        batched prefill, padded to a power-of-two batch (rows beyond the
        admitted ones are inert)."""
        free = [i for i, s in enumerate(self._slots) if s.req_id is None]
        if not free or not self._queue:
            return
        take = min(len(free), len(self._queue))
        reqs = [self._queue.pop(0) for _ in range(take)]
        bucket = 1
        while bucket < take:
            bucket *= 2
        pbs = [pool_common.pad_prompt(b, self.prompt_cap) for _, b, _, _, _, _ in reqs]
        pbs += [pbs[-1]] * (bucket - take)
        tvec = np.array([r[3] for r in reqs], np.float32)
        pvec = np.array([r[4] for r in reqs], np.float32)
        svec = np.array([r[5] for r in reqs], np.int64)
        hk, stk = self._prefill(pool_common.stack_admission(pbs))
        self._insert(hk, stk, free[:take], take, tvec, pvec, svec)
        for j, (rid, _, max_new, _, _, _) in enumerate(reqs):
            rec = _Slot(req_id=rid, tokens=[], max_new=max_new)
            self._slots[free[j]] = rec
            self._active[rid] = rec  # shared record: the slot index may go stale

    def reset_stats(self) -> None:
        with self._stats_lock:
            for k in self.stats:
                self.stats[k] = 0

    def snapshot_stats(self) -> Dict[str, Any]:
        with self._stats_lock:
            return dict(self.stats)

    def _to_host(self, toks: torch.Tensor):
        """Start the copy of a chunk's tokens to the host: into a pinned
        buffer without blocking, with an event marking its end (on a card in
        overlap mode), else at once."""
        if self._pinned is None:
            return toks.cpu().numpy()
        buf = self._pinned[self._flip]
        self._flip ^= 1
        buf.copy_(toks, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return buf, ev

    @staticmethod
    def _from_host(handle) -> np.ndarray:
        if isinstance(handle, np.ndarray):
            return handle
        buf, ev = handle
        ev.synchronize()
        return buf.numpy()

    def _process(self, toks: np.ndarray, owners: List[Optional[int]]
                 ) -> List[Tuple[int, List[int]]]:
        """Host post-processing of one chunk's tokens. `owners` is the slot
        -> request mapping when the chunk was dispatched; in overlap mode an
        owner can be stale (finished on an earlier chunk), and its row is
        then skipped."""
        eos = self.cfg.eos_token_id
        finished = []
        capped = np.zeros(self.n_slots, bool)
        for i, rid in enumerate(owners):
            if rid is None:
                continue
            s = self._active.get(rid)
            if s is None:
                continue  # finished on an earlier chunk; the row is EOS padding
            row = toks[i]
            hit = np.flatnonzero(row == eos)
            take = row[:hit[0]] if hit.size else row
            s.tokens.extend(int(t) for t in take)
            if hit.size or len(s.tokens) >= s.max_new:
                finished.append((rid, s.tokens[:s.max_new]))
                self._active.pop(rid)
                if self._slots[i].req_id == rid:
                    self._slots[i] = _Slot()
                if not hit.size:
                    capped[i] = True  # retired by its cap: the device flag is still False
        if capped.any():
            self._mark_done(capped)
        return finished

    @torch.inference_mode()
    def step(self) -> List[Tuple[int, List[int]]]:
        """Admit waiting requests, decode one chunk, return the finished
        (req_id, tokens) pairs. With overlap the returned requests are those
        the PREVIOUS chunk finished; the chunk just dispatched is read on
        the next call while the card works on it."""
        t0 = time.perf_counter()
        n_q = len(self._queue)
        self._admit()
        t1 = time.perf_counter()
        active = sum(1 for s in self._slots if s.req_id is not None)
        dispatched = False
        if self.overlap:
            pending, self._pending = self._pending, None
            if active:
                handle = self._to_host(self._chunk())
                self._pending = (handle, [s.req_id for s in self._slots])
                dispatched = True
            t2 = time.perf_counter()
            finished = (self._process(self._from_host(pending[0]), pending[1])
                        if pending is not None else [])
        else:
            toks = self._to_host(self._chunk())
            dispatched = True
            t2 = time.perf_counter()
            finished = self._process(toks, [s.req_id for s in self._slots])
        with self._stats_lock:
            self.stats["admitted"] += n_q - len(self._queue)
            self.stats["admit_s"] += t1 - t0
            self.stats["chunk_s"] += t2 - t1
            if dispatched:
                self.stats["chunks"] += 1
                self.stats["active_rows"] += active
            self.stats["host_s"] += time.perf_counter() - t2
        return finished

    def drain(self) -> Dict[int, List[int]]:
        """Run until every queued request finishes."""
        out: Dict[int, List[int]] = {}
        while not self.idle():
            for rid, toks in self.step():
                out[rid] = toks
        return out

    def reset(self) -> None:
        """Drop every queued and running request and start from a fresh
        carry (after a failed chunk)."""
        self._queue.clear()
        self._slots = [_Slot() for _ in self._slots]
        self._active.clear()
        self._pending = None
        with torch.inference_mode():
            self._carry = self._fresh_carry()
