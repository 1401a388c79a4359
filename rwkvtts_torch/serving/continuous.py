"""Continuous (in-flight) batching for Spark decode serving (counterpart of
rwkvtts_tpu/serving/continuous.py).

The slot carry is (h, state, done, n, temperature, top_p, seed), all on the
pool's device. A chunk is `chunk` steps of: head product (f32) -> ``sample_rows``
with each row's own temperature / top-p and Gumbel noise hashed from (its
request's seed, its own step index n) -> the EOS latch -> the embedding ->
the backbone step, which is ``rwkv7.decode_step`` (the WKV step kernel,
in place, on a card) or, for the megakernel pool, the B=64 decode step
(``ops/decode_mega_b64``). A row's tokens are thereby a function of its
request alone, not of what shares the pool, when it was admitted or where
the chunks break. The host reads each chunk's tokens once.

The queue, the slots, admission, overlap (chunk N+1 dispatched before
chunk N's tokens are read, with the sequential pool's tokens) and warmup
are ``pool_common.SlotPool``'s, which the Cosy pool shares.

``devices=[...]`` (the JAX pool's dp mesh) splits the slots into
len(devices) groups of consecutive slots, each a single-device pool on its
device with its own copy of the parameters (a device may repeat). A chunk
launches every group's steps before the one host read of the tokens; an
admission prefills on the group of each freed slot. One host thread issues
the groups' steps in turn: the eager step is bound by the host, so N groups
on N cards take about N times one group's host time a step (a thread a
group was slower still: scripts/probe_dp_threads.py). The slot indices stay
global and a row's draws are hashed from its request alone, so the tokens
are the one-group pool's. Unlike JAX, whose GSPMD-sharded carry would
gather a per-device kernel's state, each group keeps the in-place step
kernel (the same math). The B=64 megakernel pool is single-device.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from rwkvtts_torch.models import rwkv7, spark
from rwkvtts_torch.ops import decode_mega_b64 as dmb
from rwkvtts_torch.ops import sampling
from rwkvtts_torch.serving import pool_common


class ContinuousBatcher(pool_common.SlotPool):
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
        devices=None,
        overlap: bool = False,
        megakernel: bool = False,
    ):
        self.cfg = cfg
        bb = cfg.backbone
        self._groups = None
        if devices is not None and len(devices) > 1:
            if megakernel:
                raise ValueError("the megakernel pool is single-device (the B=64 step takes "
                                 "64 rows on one card): drop the dp groups or --mega")
            if n_slots % len(devices):
                raise ValueError(f"n_slots={n_slots} not divisible by dp={len(devices)}")
            per = n_slots // len(devices)
            self._groups = [
                ContinuousBatcher(rwkv7.tree_map(lambda t, d=torch.device(d): t.to(d), params),
                                  cfg, n_slots=per, chunk=chunk, prompt_cap=prompt_cap,
                                  temperature=temperature, top_k=top_k, top_p=top_p, seed=seed)
                for d in devices]
            self.device = self._groups[0].device
            self.megakernel = False
            self.params = self._groups[0].params
            self.temperature, self.top_k, self.top_p = temperature, top_k, top_p
            self.seed = seed
            super().__init__(self.device, n_slots, chunk, prompt_cap, overlap)
            return
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
        self.temperature, self.top_k, self.top_p = temperature, top_k, top_p
        self.seed = seed  # default per-request seed
        super().__init__(self.device, n_slots, chunk, prompt_cap, overlap)

    # -- the dp groups: each a single-device pool over its slots ----------

    def _admit_rows(self, pbs, slots, rows) -> None:
        if self._groups is None:
            return super()._admit_rows(pbs, slots, rows)
        per = self.n_slots // len(self._groups)
        for g, group in enumerate(self._groups):
            idx = [j for j, slot in enumerate(slots) if slot // per == g]
            if idx:
                group._admit_rows([pbs[j] for j in idx], [slots[j] % per for j in idx],
                                  [r[idx] for r in rows])

    def _mark_done(self, slot_mask: np.ndarray) -> None:
        if self._groups is None:
            return super()._mark_done(slot_mask)
        for g, part in zip(self._groups, np.split(np.asarray(slot_mask), len(self._groups))):
            g._mark_done(part)

    def warmup(self, prompt_widths: Optional[List[int]] = None) -> None:
        if self._groups is None:
            return super().warmup(prompt_widths)
        for g in self._groups:
            g.warmup(prompt_widths)

    def _fresh_carry(self):
        if self._groups is not None:
            for g in self._groups:
                g._carry = g._fresh_carry()
            return None
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

    def _chunk(self):
        """Decode `chunk` steps of the whole pool; returns the tokens
        (n_slots, chunk) on the device (with dp groups, one such tensor a
        group on its device, every group's chunk launched)."""
        if self._groups is not None:
            return [g._chunk() for g in self._groups]
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
        return self._enqueue(prompt_batch, max_new_tokens,
                             self.temperature if temperature is None else float(temperature),
                             self.top_p if top_p is None else float(top_p),
                             pool_common.clamp_seed(self.seed if seed is None else seed))

    _warm_row = (np.ones(1, np.float32), np.ones(1, np.float32), np.zeros(1, np.int64))

    def _process(self, toks: np.ndarray, owners: List[Optional[int]]
                 ) -> List[Tuple[int, List[int]]]:
        """The chunk's finished (req_id, tokens) pairs, from its events."""
        recs = {rid: self._active.get(rid) for rid in owners if rid is not None}
        return [(rid, recs[rid].tokens) for rid, _, done in super()._process(toks, owners)
                if done]

    def drain(self) -> Dict[int, List[int]]:
        """Run until every queued request finishes."""
        out: Dict[int, List[int]] = {}
        while not self.idle():
            for rid, toks in self.step():
                out[rid] = toks
        return out
