"""The Cosy slot pool and stream hub (rwkvtts_torch/serving/cosy_pool.py),
port vs JAX package, on the CPU: JAX's ras_sample_rows against the port's
per-row RAS (ras_sample fed JAX's per-row Gumbel draws),
the pool's greedy tokens against the JAX CosyPoolBatcher's (the RAS
fallback fed JAX's per-row draws) and against each request's solo
cosy_generate given the pool's own draws, the pool's contracts (purity,
bounds, incremental events, cancel, the cap flag, overlap, warmup), the
hub (concurrent streams, failure containment, timeout, seeds, the hop of a
per-call StreamConfig) and nn.f32 across threads. LM 64 x 2 (head 16), f32,
one set of weights through the bridge; the tiny flow / HiFT of
tests/test_cosy_pool.py."""
import dataclasses
import functools
import os
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkvtts_tpu.data import cosy_collator as jcoll
from rwkvtts_tpu.data.spark_collator import pad_prompts_left as jpad
from rwkvtts_tpu.models import cosy as jcosy
from rwkvtts_tpu.ops import sampling as jsampling
from rwkvtts_tpu.serving import cosy_pool as jpool
from rwkvtts_torch import bridge
from rwkvtts_torch.codecs import conformer, flow, hift, nn
from rwkvtts_torch.data import cosy_collator
from rwkvtts_torch.data.spark_collator import pad_prompts_left
from rwkvtts_torch.infer import generate as tgen
from rwkvtts_torch.infer import streaming
from rwkvtts_torch.infer.cosy_pipeline import CosyPipeline
from rwkvtts_torch.models import cosy, rwkv7
from rwkvtts_torch.ops import sampling
from rwkvtts_torch.serving import cosy_pool

torch.set_num_threads(2)

EOS, V = 6561, 6562
TEXTS = ("hello", "wxyz", "abc")
# the tiny flow / HiFT of tests/test_cosy_pool.py:120-155
ENC = dict(input_size=24, output_size=24, attention_heads=2, linear_units=48, num_blocks=1,
           num_up_blocks=1)
EST = dict(in_channels=16 * 4, out_channels=16, channels=(16,), n_blocks=1, num_mid_blocks=1,
           num_heads=2, attention_head_dim=8, static_chunk_size=2)
FLOW = dict(input_size=24, output_size=16, spk_embed_dim=12, vocab_size=6562, n_timesteps=2)
HIFT = dict(in_channels=16, base_channels=32, nb_harmonics=2, upsample_rates=(4, 3),
            upsample_kernel_sizes=(8, 7), istft_n_fft=16, istft_hop_len=4,
            resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 2),),
            source_resblock_kernel_sizes=(7, 7),
            source_resblock_dilation_sizes=((1, 2), (1, 2)), f0_cond_channels=16)


class FakeTok:
    def encode(self, text):
        return [ord(c) % 200 + 1 for c in text][:8]


def _prompt(text, coll=cosy_collator, pad=pad_prompts_left):
    return pad([coll.build_prompt(FakeTok().encode(text), [])])


@functools.partial(jax.jit, static_argnums=(2, 3))
def _jax_row_draws(seeds, steps, k, vocab):
    """The JAX pool's two RAS draws of each row: its key fold_in(key(seed),
    n) split into the nucleus and the fallback draw."""
    def one(s, i):
        k1, k2 = jax.random.split(jax.random.fold_in(jax.random.key(s, impl="threefry2x32"), i))
        return jax.random.gumbel(k1, (k,), jnp.float32), jax.random.gumbel(k2, (vocab,),
                                                                            jnp.float32)
    return jax.vmap(one)(seeds, steps)


def jax_noise(seed, n, k, vocab):
    """``ras_row_noise``'s interface over the JAX pool's draws."""
    a, b = _jax_row_draws(jnp.asarray(seed.numpy(), jnp.int32),
                          jnp.asarray(n.numpy(), jnp.int32), k, vocab)
    return torch.from_numpy(np.array(a)), torch.from_numpy(np.array(b))


# ---------------------------------------------------------------------------
# ras_sample_rows
# ---------------------------------------------------------------------------


def _check_ras_sample_rows(top_k, top_p):
    """Per-row keys, JAX's Gumbel draws fed to the port: JAX's tokens, with
    the fallback not taken and taken (every row's window then holds its
    nucleus draw, >= win_size * tau_r repeats, so the full-vocabulary draw
    is taken)."""
    for fallback in (False, True):
        _ras_rows_vs_jax(top_k, top_p, fallback)
    # the hashed draws: two salts, a function of (seed, n) only
    a, b = sampling.ras_row_noise(torch.tensor([5, 5]), torch.tensor([2, 2]), 25, 300)
    assert a.shape == (2, 25) and b.shape == (2, 300)
    assert torch.equal(a[0], a[1]) and not torch.equal(a[0], b[0, :25])


def _ras_rows_vs_jax(top_k, top_p, fallback):
    rng = np.random.default_rng(top_k)
    Bn, Vs = 5, 300
    logits = (rng.permutation(Vs * Bn).reshape(Bn, Vs) / 40.0 - 15.0).astype(np.float32)
    seeds, steps = np.arange(Bn, dtype=np.int32) + 3, np.arange(Bn, dtype=np.int32) * 2
    keys = jax.vmap(lambda s, i: jax.random.key_data(
        jax.random.fold_in(jax.random.key(s, impl="threefry2x32"), i)))(seeds, steps)
    nucleus, full = _jax_row_draws(seeds, steps, min(top_k, Vs), Vs)
    x = torch.from_numpy(logits)
    recent = torch.full((Bn, 10), -1, dtype=torch.long)
    if fallback:  # the nucleus draw of each row, once in its window
        first = sampling.ras_sample(x, recent, top_k=top_k, top_p=top_p,
                                    noise=(torch.from_numpy(np.array(nucleus)),
                                           torch.full((Bn, Vs), -1e4)))
        recent[:, 3] = first
    want = jax.jit(jsampling.ras_sample_rows, static_argnames=("top_k", "top_p"))(
        keys, jnp.asarray(logits), jnp.asarray(recent.numpy()), top_k=top_k, top_p=top_p)
    got = sampling.ras_sample(x, recent, top_k=top_k, top_p=top_p,
                              noise=(torch.from_numpy(np.array(nucleus)),
                                     torch.from_numpy(np.array(full))))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if fallback:
        np.testing.assert_array_equal(got.numpy(), np.argmax(logits + np.array(full), -1))


# ---------------------------------------------------------------------------
# the pool
# ---------------------------------------------------------------------------


def _numpy_lm(tree, seed):
    """The init tree with numpy noise from `seed` on every leaf (matrices at
    1/sqrt(fan-in), vectors at 0.1): the zero-initialised projections
    (output, FFN value, lora inputs) come alive, so a row's tokens depend
    on its prompt and its state."""
    rng = np.random.default_rng(seed)

    def leaf(x):
        if isinstance(x, dict):
            return {k: leaf(v) for k, v in x.items()}
        scale = 1.0 / np.sqrt(x.shape[-2]) if x.ndim >= 2 and x.shape[-2] > 2 else 0.1
        return (x + scale * rng.standard_normal(x.shape)).astype(np.float32)

    return leaf(tree)


@pytest.fixture(scope="module")
def lm():
    """LM 64 x 2 (head 16) f32 from a numpy seed: the JAX config and tree,
    the port's config and decode tree; the head x 10 (no near-ties)."""
    kw = dict(hidden_size=64, num_layers=2, head_size=16, gate_lora=16)
    tcfg = cosy.default_config(dtype=torch.float32, **kw)
    jcfg = jcosy.default_config(dtype=jnp.float32, wkv_chunk=16, remat=False, **kw)
    tree = _numpy_lm(bridge.params_to_numpy(cosy.init_params(torch.Generator().manual_seed(0),
                                                             tcfg)), 0)
    tree["head"] = 10.0 * tree["head"]
    tparams = rwkv7.pack_decode_params(bridge.params_from_numpy(tree), tcfg.backbone)
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, tparams


def _pool(lm, noise=None, **kw):
    _, _, tcfg, tparams = lm
    cb = cosy_pool.CosyPoolBatcher(tparams, tcfg, **{"n_slots": 2, "chunk": 4,
                                                    "prompt_cap": 32, **kw})
    cb.noise = noise or cb.noise
    return cb


def _run(cb, reqs):
    """reqs: (text, max_new, min_new, seed) -> tokens of each, in order."""
    rids = [cb.add_request(_prompt(t), mx, min_new_tokens=mn, seed=s) for t, mx, mn, s in reqs]
    out = cb.drain()
    return [out[r] for r in rids]


# the first two fill both slots and end at their cap in the first chunk; the
# next two are admitted together into the freed slots
REQS = [("hello", 4, 4, 7), ("wxyz", 4, 4, 1), ("abc", 12, 2, 2), ("xyz", 10, 6, 3)]


def _check_pool_greedy(lm):
    """Top-k 1, 4 requests over 2 slots, 4-step chunks (two admitted into
    slots freed by others): the JAX CosyPoolBatcher's tokens, its fallback draws
    fed to the port; and each request's solo cosy_generate fed the draws
    the pool gives its rows (ras_row_noise of its seed and step)."""
    jcfg, jtree, tcfg, tparams = lm
    jcb = jpool.CosyPoolBatcher(jtree, jcfg, n_slots=2, chunk=4, prompt_cap=32, top_k=1)
    rids = [jcb.add_request(_prompt(t, jcoll, jpad), mx, min_new_tokens=mn, seed=s)
            for t, mx, mn, s in REQS]
    jout = jcb.drain()
    want = [jout[r] for r in rids]
    assert _run(_pool(lm, top_k=1, noise=jax_noise), REQS) == want
    pooled = _run(_pool(lm, top_k=1), REQS)
    assert [len(t) for t in pooled] == [len(t) for t in want]
    for (text, mx, mn, seed), toks in zip(REQS, pooled):
        steps = torch.arange(mx)
        draws = sampling.ras_row_noise(torch.full((mx,), seed), steps, 1, V)
        pb = {k: torch.from_numpy(v).long() for k, v in _prompt(text).items()}
        solo, n = tgen.cosy_generate(tparams, tcfg, pb["tokens"], pb["modality"],
                                     pb["attention_mask"], max_new_tokens=mx, min_new_tokens=mn,
                                     top_k=1, noise=(draws[0][:, None], draws[1][:, None]))
        assert solo[0, :int(n[0])].tolist() == toks


def _check_purity(lm):
    """A (prompt, seed) gives the same sampled tokens (top-k 25 / top-p 0.8)
    alone and in a mixed pool."""
    alone = _run(_pool(lm), [("hello", 12, 2, 7)])[0]
    crowd = _run(_pool(lm), [("wxyz", 9, 1, 1), ("hello", 12, 2, 7), ("abc", 12, 2, 2)])
    assert crowd[1] == alone and len(crowd) == 3


def _check_bounds_events_and_cancel(lm):
    """min_new suppresses EOS below the bound, max_new caps the length, a
    row retired by its cap (no EOS yet) has its device done flag set;
    events carry partial tokens (concatenated: drain()'s sequence, done
    once); cancel frees the slot for a queued request."""
    _bounds_and_cap_flag(lm)
    _incremental_events(lm)
    _cancel_frees_the_slot(lm)


def _bounds_and_cap_flag(lm):
    cb = _pool(lm)
    ra = cb.add_request(_prompt("aaaa"), 10, min_new_tokens=6, seed=0)
    rb = cb.add_request(_prompt("bbbb"), 3, min_new_tokens=3, seed=1)
    acc = {ra: [], rb: []}
    first = cb.step()
    for r, new, _ in first:
        acc[r].extend(new.tolist())
    assert [d for r, _, d in first if r == rb] == [True] and len(acc[rb]) == 3
    assert cb._slots[1].req_id is None and bool(cb._carry[2][1])
    while not cb.idle():
        for r, new, _ in cb.step():
            acc[r].extend(new.tolist())
    assert 6 <= len(acc[ra]) <= 10 and EOS not in acc[ra] + acc[rb]


def _incremental_events(lm):
    cb = _pool(lm, n_slots=1)
    rid = cb.add_request(_prompt("hello"), 10, min_new_tokens=2, seed=7)
    acc, dones = [], 0
    while not cb.idle():
        for r, new, done in cb.step():
            assert r == rid and new.dtype == np.int64
            acc.extend(new.tolist())
            dones += int(done)
    assert dones == 1 and acc == _run(_pool(lm, n_slots=1), [("hello", 10, 2, 7)])[0]


def _cancel_frees_the_slot(lm):
    cb = _pool(lm, n_slots=1)
    ra = cb.add_request(_prompt("aaaa"), 1000, min_new_tokens=900, seed=0)
    rb = cb.add_request(_prompt("bbbb"), 8, seed=1)  # waits in the queue
    cb.step()
    cb.cancel(ra)
    assert bool(cb._carry[2][0])
    out = cb.drain()
    assert ra not in out and rb in out and cb.idle()


def _check_overlap_and_warmup(lm):
    """Overlap (chunk N+1 dispatched before chunk N is read) and a warmed-up
    pool give the sequential, cold pool's tokens."""
    reqs = [(t, 10, 2, i) for i, t in enumerate(TEXTS)]
    base = _run(_pool(lm), reqs)
    assert _run(_pool(lm, overlap=True), reqs) == base
    cb = _pool(lm)
    cb.warmup(prompt_widths=[32, 64])
    assert _run(cb, reqs) == base


# ---------------------------------------------------------------------------
# the hub
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pipe(lm):
    _, _, tcfg, tparams = lm
    fcfg = flow.FlowConfig(encoder=conformer.UpsampleConformerConfig(**ENC),
                           estimator=flow.EstimatorConfig(**EST), **FLOW)
    hcfg = hift.HiFTConfig(**HIFT)
    g = torch.Generator().manual_seed(1)
    return CosyPipeline(tcfg, tparams, FakeTok(), fcfg, flow.init_params(g, fcfg), hcfg,
                        hift.init_params(g, hcfg), device="cpu")


SCFG = streaming.StreamConfig(token_hop_len=4, ctx_tokens=4, mel_cache_len=2, n_timesteps=2)


def _hub(pipe, **kw):
    return cosy_pool.CosyStreamHub(pipe, **{"n_slots": 2, "chunk": 4, "prompt_cap": 32,
                                            "stream_cfg": SCFG, **kw})


def _collect(hub, text, seed, max_new_tokens=12, **kw):
    chunks = list(hub.stream(text, seed=seed, max_new_tokens=max_new_tokens, **kw))
    assert chunks and all(np.isfinite(c).all() for c in chunks)
    return chunks


def _check_hub_concurrent(pipe):
    """Two streams running at once through one hub give exactly the wav
    each gives streamed alone."""
    solo = {}
    for name, text, seed in (("a", "hello", 7), ("b", "wxyz", 3)):
        hub = _hub(pipe)
        try:
            solo[name] = np.concatenate(_collect(hub, text, seed))
        finally:
            hub.close()
    hub, results = _hub(pipe), {}

    def worker(name, text, seed):
        results[name] = np.concatenate(_collect(hub, text, seed))

    try:
        ts = [threading.Thread(target=worker, args=a) for a in (("a", "hello", 7),
                                                               ("b", "wxyz", 3))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=300)
        with hub._first_cv:
            assert not hub._first_pending
    finally:
        hub.close()
    for name in solo:
        np.testing.assert_allclose(results[name], solo[name], rtol=1e-5, atol=1e-6)


def _check_hub_failures(pipe):
    """A decode failure on the pump thread reaches the stream as a
    RuntimeError (not a hang) and the reset pool serves the next one; the
    whole-stream timeout cancels the request and raises; a consumer that
    leaves after its first chunk frees its slot and the first-chunk set; a
    seed of 2**31 + 7 is clamped at admission and the stream completes."""
    _pump_failure_surfaces_and_recovers(pipe)
    _timeout_abandon_and_oversized_seed(pipe)


def _pump_failure_surfaces_and_recovers(pipe):
    hub = _hub(pipe)
    try:
        armed, orig = {"on": True}, hub.batcher.step

        def flaky_step():
            if armed.pop("on", False):
                raise RuntimeError("injected device fault")
            return orig()

        hub.batcher.step = flaky_step
        with pytest.raises(RuntimeError, match="injected device fault"):
            list(hub.stream("hello", seed=7, max_new_tokens=12))
        assert hub.batcher.idle()
        _collect(hub, "hello", 7)
    finally:
        hub.close()


def _timeout_abandon_and_oversized_seed(pipe):
    hub = _hub(pipe, n_slots=1)
    try:
        gen = hub.stream("hello world", seed=4, max_new_tokens=24)
        assert np.isfinite(next(gen)).all()
        gen.close()
        with hub._lock:
            assert hub.batcher.idle()
        with hub._first_cv:
            assert not hub._first_pending
        orig = hub.batcher.step

        def slow_step():
            time.sleep(0.3)
            return orig()

        hub.batcher.step = slow_step
        with pytest.raises(TimeoutError):
            list(hub.stream("hello", seed=1, max_new_tokens=12, timeout=0.2))
        hub.batcher.step = orig
        deadline = time.monotonic() + 30
        while not hub.batcher.idle() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert hub.batcher.idle()  # the timed-out request was cancelled
        _collect(hub, "hello", 2**31 + 7)
    finally:
        hub.close()


def _check_hub_per_call_hop(pipe):
    """hop_tokens sets the hop of whichever StreamConfig applies, a
    per-call one too (the JAX hub drops it there): first chunk hop * 96 -
    the crossfade tail, later ones hop * 96 samples."""
    hub = _hub(pipe)
    per_call = dataclasses.replace(SCFG, token_hop_len=8)
    try:
        up = pipe.hift_cfg.total_upsample * pipe.flow_cfg.token_mel_ratio  # samples a token
        tail = SCFG.mel_cache_len * pipe.hift_cfg.total_upsample
        # 8 content tokens: 16-24 new tokens
        kw = dict(max_new_tokens=24, stream_cfg=per_call)
        chunks = _collect(hub, "hello world", 5, hop_tokens=3, **kw)
        assert len(chunks[0]) == 3 * up - tail and len(chunks) >= 5
        assert all(len(c) == 3 * up for c in chunks[1:-1])
        chunks = _collect(hub, "hello world", 5, **kw)
        assert len(chunks[0]) == 8 * up - tail
    finally:
        hub.close()


# ---------------------------------------------------------------------------
# nn.f32 across threads
# ---------------------------------------------------------------------------


def _check_f32_threads():
    """Overlapping nn.f32 blocks on two threads: TF32 stays off inside
    every block until the last one closes, then the flags come back; then
    short blocks on twice as many threads as cores, switching every
    microsecond: never on inside a block, restored after the last."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    a_in, b_in, a_out = threading.Event(), threading.Event(), threading.Event()
    seen = []

    def a():
        with nn.f32():
            a_in.set()
            b_in.wait(5)
        a_out.set()

    def b():
        a_in.wait(5)
        with nn.f32():
            b_in.set()
            a_out.wait(5)  # the other block has closed: still off here
            seen.append((torch.backends.cudnn.allow_tf32,
                         torch.backends.cuda.matmul.allow_tf32))
    def stress():  # many short blocks on more threads than cores
        for _ in range(200):
            with nn.f32():
                if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
                    seen.append("on inside a block")

    switch = sys.getswitchinterval()
    try:
        ts = [threading.Thread(target=f) for f in (a, b)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(10)
        assert seen == [(False, False)] and not any(t.is_alive() for t in ts)
        sys.setswitchinterval(1e-6)
        ts = [threading.Thread(target=stress) for _ in range(2 * (os.cpu_count() or 4))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        assert seen == [(False, False)] and not any(t.is_alive() for t in ts)
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
        assert nn._f32_depth == 0
    finally:
        sys.setswitchinterval(switch)
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


# ---------------------------------------------------------------------------
# The tests. Two of them, each a sequence of the checks above: a file's
# number of tests sets where xdist's load-by-file scheduler queues it, and
# two keeps this file behind the long few-test files of the suite, in the
# slack of the other workers.
# ---------------------------------------------------------------------------


def test_ras_sample_rows_and_the_pool_match_jax(lm):
    """JAX's ras_sample_rows against the port's RAS given its draws (top-k
    25 / top-p 0.8 and greedy, the fallback taken and not); the pool's
    greedy tokens against the JAX pool and solo generation; purity;
    bounds, the cap flag, events and cancel; overlap and warmup."""
    for top_k, top_p in ((25, 0.8), (1, 1.0)):
        _check_ras_sample_rows(top_k, top_p)
    _check_pool_greedy(lm)
    _check_purity(lm)
    _check_bounds_events_and_cancel(lm)
    _check_overlap_and_warmup(lm)


def test_hub_streams_and_threads(pipe):
    """The hub: concurrent streams = each alone; a pump failure, the
    timeout, a consumer that leaves, an oversized seed; a per-call
    StreamConfig's hop; then nn.f32 across threads."""
    _check_hub_concurrent(pipe)
    _check_hub_failures(pipe)
    _check_hub_per_call_hop(pipe)
    _check_f32_threads()
