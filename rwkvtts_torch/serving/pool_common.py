"""What the slot-pool engines share: the host-side helpers (a copy of
rwkvtts_tpu/serving/pool_common.py: prompt bucketing, admission batch
stacking, int32-safe request parameters) and ``SlotPool``, the pool
mechanics of serving/continuous.ContinuousBatcher (Spark) and
serving/cosy_pool.CosyPoolBatcher (Cosy)."""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def clamp_seed(seed: int) -> int:
    """Untrusted request seeds are masked to 31 bits, so an oversized seed
    cannot fail an admission on the pool thread; determinism per input
    value is kept."""
    return int(seed) & 0x7FFFFFFF


def clamp_i32(n: int) -> int:
    return max(0, min(int(n), 2**31 - 1))


def round_width(width: int, prompt_cap: int) -> int:
    """The admission pad rule: prompt_cap doubled until it fits. Warmup
    widths round through this, so they are the widths admissions use."""
    cap = prompt_cap
    while cap < width:
        cap *= 2
    return cap


def warmup_widths(widths, prompt_cap: int) -> List[int]:
    """Normalize a user width list to the actual admission buckets."""
    return sorted({round_width(w, prompt_cap) for w in (widths or [prompt_cap])})


def pad_prompt(batch: Dict[str, np.ndarray], prompt_cap: int) -> Dict[str, np.ndarray]:
    """Left-pad a B=1 prompt batch to its admission bucket, in numpy
    (int32), so an admission costs one host-to-device copy."""
    T = batch["tokens"].shape[1]
    cap = round_width(T, prompt_cap)
    pad = cap - T
    return {
        k: np.pad(np.asarray(v, np.int32), ((0, 0), (pad, 0)))
        for k, v in batch.items()
    }


def stack_admission(pbs: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack per-request padded prompts into one admission batch (left-pad
    to the widest bucket present)."""
    cap = max(p["tokens"].shape[1] for p in pbs)
    return {
        k: np.concatenate(
            [np.pad(p[k], ((0, 0), (cap - p[k].shape[1], 0))) for p in pbs],
            axis=0,
        )
        for k in pbs[0]
    }


@dataclasses.dataclass
class _Slot:
    req_id: Optional[int] = None
    tokens: Optional[List[int]] = None
    max_new: int = 0


class SlotPool:
    """A fixed pool of decode slots that decodes chunk after chunk, new
    requests swapped into free slots between chunks. An RWKV request's
    state is fixed-size, so admitting one is a row write into each state
    tensor.

    A queued request is (rid, prompt batch, max_new, *row parameters); an
    admission is one batched prefill at a power-of-two batch (rows beyond
    the admitted ones are inert), then row writes. ``step`` returns the
    events of a chunk, (rid, new tokens, done) for every active request.
    Overlap mode dispatches chunk N+1 before reading chunk N's tokens: on
    a card the tokens go into a pinned host buffer without blocking and a
    CUDA event marks the copy's end, so the host's post-processing runs
    while the card decodes the next chunk; its events come one chunk
    later.

    A subclass sets ``cfg`` (its ``eos_token_id`` ends a row) and what its
    carry needs, calls ``__init__`` and gives:
    ``_fresh_carry`` (h, state, done, ...) of an empty pool, ``_prefill``
    (a stacked numpy batch -> the last hidden and the stacked state),
    ``_insert(hk, stk, slots, take, *row vectors)``, ``_chunk`` (the
    tokens (n_slots, chunk) on the device) and ``_warm_row``, the row
    vectors of warmup's dummy request."""

    _warm_row: Tuple[np.ndarray, ...] = ()

    def __init__(self, device, n_slots: int, chunk: int, prompt_cap: int, overlap: bool):
        self.device = device
        self.n_slots = n_slots
        self.chunk = chunk
        self.prompt_cap = prompt_cap
        self._next_id = 0
        self._queue: List[Tuple[Any, ...]] = []
        self._slots = [_Slot() for _ in range(n_slots)]
        self._carry = self._fresh_carry()
        self.overlap = overlap
        # overlap: two pinned host buffers, one for the chunk being read
        # and one for the chunk in flight
        self._pinned = None
        if overlap and device.type == "cuda":
            self._pinned = [torch.empty(n_slots, chunk, dtype=torch.long, pin_memory=True)
                            for _ in range(2)]
        self._flip = 0
        # (tokens handle, owners at dispatch); an owner can go stale when
        # its request finished or was cancelled meanwhile -> _active
        self._pending: Optional[Tuple[Any, List[Optional[int]]]] = None
        self._active: Dict[int, _Slot] = {}
        # step() time / occupancy breakdown (reset_stats() clears it):
        #   admit_s  host prep + prefill + insert for admissions
        #   chunk_s  decode-chunk dispatch + device + token copy (the
        #            host read bounds it; in overlap mode dispatch only)
        #   host_s   post-processing of the chunk's rows (in overlap mode
        #            it also waits for the previous chunk's tokens)
        #   active_rows / (chunks * n_slots) = slot occupancy
        self.stats = {"admit_s": 0.0, "chunk_s": 0.0, "host_s": 0.0,
                      "chunks": 0, "active_rows": 0, "admitted": 0}
        self._stats_lock = threading.Lock()

    def _enqueue(self, prompt_batch, max_new: int, *row) -> int:
        rid = self._next_id
        self._next_id += 1
        self._queue.append((rid, prompt_batch, max_new, *row))
        return rid

    def idle(self) -> bool:
        return (not self._queue and all(s.req_id is None for s in self._slots)
                and self._pending is None)

    @torch.inference_mode()
    def warmup(self, prompt_widths: Optional[List[int]] = None) -> None:
        """Run every program shape once before traffic: the prefill at each
        power-of-two admission size for every width in `prompt_widths`
        (rounded up to the admission buckets; default the prompt cap), an
        insert, a decode chunk and a retire-by-cap flag update. PyTorch runs
        eagerly, so on a card this builds the kernels and fills PyTorch's
        caches, and the first request pays for none of it. The engine state
        is reset after."""
        for width in warmup_widths(prompt_widths, self.prompt_cap):
            dummy = {"tokens": np.zeros((1, width), np.int32),
                     "modality": np.zeros((1, width), np.int32),
                     "attention_mask": np.ones((1, width), np.int32)}
            bucket = 1
            while True:
                hk, stk = self._prefill({k: np.repeat(v, bucket, 0) for k, v in dummy.items()})
                self._insert(hk, stk, [0], 1, *self._warm_row)
                if bucket >= self.n_slots:
                    break
                bucket *= 2
        self._chunk()
        self._mark_done(np.zeros(self.n_slots, bool))
        self._carry = self._fresh_carry()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _mark_done(self, slot_mask: np.ndarray) -> None:
        """Set the done flag of slots retired on the host (the max cap, a
        cancel), so they stop drawing until a new request lands there."""
        h, st, done, *rest = self._carry
        self._carry = (h, st, done | torch.as_tensor(slot_mask, device=self.device), *rest)

    def _admit(self) -> None:
        """Admit as many queued requests as there are free slots with one
        batched prefill, padded to a power-of-two batch."""
        free = [i for i, s in enumerate(self._slots) if s.req_id is None]
        if not free or not self._queue:
            return
        take = min(len(free), len(self._queue))
        reqs = [self._queue.pop(0) for _ in range(take)]
        # one vector a row parameter, in the dtype of warmup's dummy row
        rows = [np.asarray(v, w.dtype) for v, w in zip(zip(*(r[3:] for r in reqs)),
                                                        self._warm_row)]
        self._admit_rows([pad_prompt(r[1], self.prompt_cap) for r in reqs], free[:take], rows)
        for j, r in enumerate(reqs):
            rec = _Slot(req_id=r[0], tokens=[], max_new=r[2])
            self._slots[free[j]] = rec
            self._active[r[0]] = rec  # shared record: the slot index may go stale

    def _admit_rows(self, pbs: List[Dict[str, np.ndarray]], slots: List[int],
                    rows: List[np.ndarray]) -> None:
        """One batched prefill of the padded prompts `pbs` at a power-of-two
        batch (the rows beyond them are inert), then their row writes into
        `slots` with the row parameters `rows`."""
        take = len(pbs)
        bucket = 1
        while bucket < take:
            bucket *= 2
        hk, stk = self._prefill(stack_admission(pbs + [pbs[-1]] * (bucket - take)))
        self._insert(hk, stk, slots, take, *rows)

    def _to_host(self, toks):
        """Start the copy of a chunk's tokens (a tensor, or one a slot group
        in slot order) to the host: into a pinned buffer without blocking,
        with an event a device marking its end (on a card in overlap mode),
        else at once, one read after every group's chunk was launched."""
        parts = toks if isinstance(toks, list) else [toks]
        if self._pinned is None:
            return np.concatenate([t.cpu().numpy() for t in parts])
        buf = self._pinned[self._flip]
        self._flip ^= 1
        events, row = [], 0
        for t in parts:
            buf[row:row + len(t)].copy_(t, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(t.device))
            events.append(ev)
            row += len(t)
        return buf, events

    @staticmethod
    def _from_host(handle) -> np.ndarray:
        if isinstance(handle, np.ndarray):
            return handle
        buf, events = handle
        for ev in events:
            ev.synchronize()
        return buf.numpy()

    def _process(self, toks: np.ndarray, owners: List[Optional[int]]
                 ) -> List[Tuple[int, np.ndarray, bool]]:
        """One chunk's tokens -> (rid, new tokens, done) events. `owners` is
        the slot -> request map at dispatch; in overlap mode an owner can be
        stale (finished or cancelled off an earlier chunk), and its row,
        EOS padding, is skipped."""
        eos = self.cfg.eos_token_id
        events: List[Tuple[int, np.ndarray, bool]] = []
        capped = np.zeros(self.n_slots, bool)
        for i, rid in enumerate(owners):
            if rid is None:
                continue
            s = self._active.get(rid)
            if s is None:
                continue
            row = toks[i]
            hit = np.flatnonzero(row == eos)
            new = (row[:hit[0]] if hit.size else row)[:s.max_new - len(s.tokens)]
            s.tokens.extend(int(t) for t in new)
            done = bool(hit.size) or len(s.tokens) >= s.max_new
            events.append((rid, new.astype(np.int64), done))
            if done:
                self._active.pop(rid)
                if self._slots[i].req_id == rid:
                    self._slots[i] = _Slot()
                if not hit.size:
                    capped[i] = True  # retired by its cap: the device flag is still False
        if capped.any():
            self._mark_done(capped)
        return events

    @torch.inference_mode()
    def step(self):
        """Admit waiting requests, decode one chunk, return its events
        (``_process``'s). With overlap they are the PREVIOUS chunk's: the
        chunk just dispatched is read on the next call while the card works
        on it."""
        t0 = time.perf_counter()
        n_q = len(self._queue)
        self._admit()
        t1 = time.perf_counter()
        owners = [s.req_id for s in self._slots]
        active = sum(r is not None for r in owners)
        if self.overlap:
            pending, self._pending = self._pending, None
            if active:
                self._pending = (self._to_host(self._chunk()), owners)
            t2 = time.perf_counter()
            events = (self._process(self._from_host(pending[0]), pending[1])
                      if pending is not None else [])
        else:
            toks = self._to_host(self._chunk()) if active else None
            t2 = time.perf_counter()
            events = self._process(toks, owners) if active else []
        with self._stats_lock:
            self.stats["admitted"] += n_q - len(self._queue)
            self.stats["admit_s"] += t1 - t0
            self.stats["chunk_s"] += t2 - t1
            if active:
                self.stats["chunks"] += 1
                self.stats["active_rows"] += active
            self.stats["host_s"] += time.perf_counter() - t2
        return events

    def reset_stats(self) -> None:
        with self._stats_lock:
            for k in self.stats:
                self.stats[k] = 0

    def snapshot_stats(self) -> Dict[str, Any]:
        with self._stats_lock:
            return dict(self.stats)

    def reset(self) -> None:
        """Drop every queued and running request and start from a fresh
        carry (after a failed chunk)."""
        self._queue.clear()
        self._slots = [_Slot() for _ in self._slots]
        self._active.clear()
        self._pending = None
        with torch.inference_mode():
            self._carry = self._fresh_carry()
