"""The port's Spark serving path against the JAX package's: per-row
sampling (ops/sampling.sample_rows) fed JAX's Gumbel noise, the slot pool
(serving/continuous.py) against the JAX pool and isolated greedy
generation, the pool's own contracts (overlap, slot reuse, the cap flag,
per-request seeds, the B=64 pool's insert), the service and its HTTP
server, and the launcher with the checkpoint converters both ways."""
import concurrent.futures as cf
import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkvtts_tpu.convert import export_hf as jexport
from rwkvtts_tpu.convert import rwkv7_ckpt as jckpt
from rwkvtts_tpu.convert import speech_init as jinit
from rwkvtts_tpu.data import spark_collator as jcoll
from rwkvtts_tpu.infer import generate as jgen
from rwkvtts_tpu.models import spark as jspark
from rwkvtts_tpu.ops import sampling as jsampling
from rwkvtts_tpu.serving import continuous as jcont
from rwkvtts_tpu.serving import launch as jlaunch
from rwkvtts_tpu.serving import service as jsvc
from rwkvtts_torch import bridge
from rwkvtts_torch.convert import export_hf as texport
from rwkvtts_torch.data import spark_collator as tcoll
from rwkvtts_torch.infer.spark_pipeline import SparkPipeline
from rwkvtts_torch.models import rwkv7 as trwkv7
from rwkvtts_torch.models import spark as tspark
from rwkvtts_torch.ops import decode_mega_b64 as dmb
from rwkvtts_torch.ops import sampling as tsampling
from rwkvtts_torch.serving import continuous as tcont
from rwkvtts_torch.serving import http_server, launch
from rwkvtts_torch.serving import service as tsvc

torch.set_num_threads(2)

# JAX's init as one compiled program (op by op it compiles each random op)
_jinit = jax.jit(jspark.init_params, static_argnums=1)


class FakeTok:
    def encode(self, text):
        return [ord(c) % 200 + 1 for c in text][:12]


# ---------------------------------------------------------------------------
# sample_rows
# ---------------------------------------------------------------------------


def _jax_keys(seeds, steps):
    return jax.vmap(lambda s, i: jax.random.key_data(
        jax.random.fold_in(jax.random.key(s, impl="threefry2x32"), i)))(
            jnp.asarray(seeds, jnp.int32), jnp.asarray(steps, jnp.int32))


@pytest.mark.parametrize("top_k", [0, 1, 20])
def test_sample_rows_matches_jax_given_its_noise(top_k):
    rng = np.random.default_rng(top_k)
    Bn, V = 6, 300
    # distinct logits: no ties for top_k to order differently
    logits = (rng.permutation(V * Bn).reshape(Bn, V) / 50.0 - 15.0).astype(np.float32)
    temp = np.array([1.0, 0.7, 2.0, 1.0, 1e-3, 1.3], np.float32)
    top_p = np.array([0.95, 0.0, 1.0, 0.5, 0.9, 0.8], np.float32)
    keys = _jax_keys(np.arange(Bn) + 11, np.arange(Bn) * 3)
    k = top_k if 0 < top_k < V else V
    noise = jax.vmap(lambda kk: jax.random.gumbel(
        jax.random.wrap_key_data(kk, impl="threefry2x32"), (k,)))(keys)
    want = jsampling.sample_rows(keys, jnp.asarray(logits), temperature=jnp.asarray(temp),
                                 top_k=top_k, top_p=jnp.asarray(top_p))
    got = tsampling.sample_rows(torch.from_numpy(logits), temperature=torch.from_numpy(temp),
                                top_k=top_k, top_p=torch.from_numpy(top_p),
                                noise=torch.from_numpy(np.array(noise)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[1] == int(np.argmax(logits[1]))  # top_p = 0 is greedy


def test_row_noise_is_a_function_of_seed_and_step():
    seed = torch.tensor([5, 9, 5, 5])
    n = torch.tensor([3, 3, 3, 4])
    g = tsampling.row_noise(seed, n, 64)
    torch.testing.assert_close(g[0], g[2], rtol=0, atol=0)  # same (seed, n): same noise
    assert not torch.equal(g[0], g[1]) and not torch.equal(g[0], g[3])
    # a row's noise does not depend on the other rows of the batch
    torch.testing.assert_close(tsampling.row_noise(seed[:1], n[:1], 64)[0], g[0], rtol=0, atol=0)
    logits = torch.randn(4, 100, generator=torch.Generator().manual_seed(0))
    kw = dict(temperature=torch.ones(4), top_k=64, top_p=torch.full((4,), 0.9))
    torch.testing.assert_close(tsampling.sample_rows(logits, seed=seed, n=n, **kw),
                               tsampling.sample_rows(logits, noise=g, **kw))


# ---------------------------------------------------------------------------
# the slot pool
# ---------------------------------------------------------------------------


def _prompt(text, tok=FakeTok()):
    return tcoll.pad_prompts_left([tcoll.build_prompt(tok.encode(text), [1, 2, 3, 4])])


@pytest.fixture(scope="module")
def model():
    """A 64 x 2 Spark model (head 16), f32: JAX config and params, the
    port's config and params (the same numbers)."""
    jcfg = jspark.default_config(hidden_size=64, num_layers=2, head_size=16, gate_lora=16,
                                 dtype=jnp.float32, wkv_chunk=16, remat=False, dropout=0.0)
    jparams = _jinit(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, tparams


def _tcfg(packed):
    return tspark.default_config(hidden_size=64, num_layers=2, head_size=16, gate_lora=16,
                                 dtype=torch.float32, decode_wkv_packed=packed)


def _pool(tparams, packed=True, **kw):
    cfg = _tcfg(packed)
    return tcont.ContinuousBatcher(trwkv7.pack_decode_params(tparams, cfg.backbone), cfg,
                                   **{"n_slots": 2, "chunk": 4, "prompt_cap": 32, **kw})


@pytest.fixture(scope="module")
def greedy_reference(model):
    """5 requests: the JAX pool's greedy tokens (2 slots, 4-step chunks),
    and each request's isolated greedy generation."""
    jcfg, jparams, _ = model
    texts = [f"request number {i}" for i in range(5)]
    pool = jcont.ContinuousBatcher(jparams, jcfg, n_slots=2, chunk=4, prompt_cap=32, top_k=1)
    rids = [pool.add_request(jcoll.pad_prompts_left(
        [jcoll.build_prompt(FakeTok().encode(t), [1, 2, 3, 4])]), 12) for t in texts]
    out = pool.drain()
    isolated = []
    for t in texts:
        pb = _prompt(t)
        toks, lengths = jgen.spark_generate(
            jparams, jcfg, *(jnp.asarray(pb[k]) for k in ("tokens", "modality", "attention_mask")),
            jax.random.PRNGKey(9), max_new_tokens=12, top_k=1, top_p=1.0)
        isolated.append(np.asarray(toks)[0, :int(np.asarray(lengths)[0])].tolist()[:12])
    return texts, [out[r] for r in rids], isolated


@pytest.mark.parametrize("packed,overlap", [(True, False), (False, False), (True, True)])
def test_pool_greedy_matches_jax_pool_and_isolated(model, greedy_reference, packed, overlap):
    _, _, tparams = model
    texts, jax_pool, isolated = greedy_reference
    assert jax_pool == isolated
    cb = _pool(tparams, packed, top_k=1, overlap=overlap)
    rids = [cb.add_request(_prompt(t), 12) for t in texts]
    out = cb.drain()
    assert [out[r] for r in rids] == jax_pool


def test_overlap_matches_sequential(model):
    _, _, tparams = model
    texts = [f"overlap request {i}" for i in range(6)]

    def run(overlap):
        cb = _pool(tparams, top_k=8, top_p=0.9, overlap=overlap)
        rids = [cb.add_request(_prompt(t), 6 + i, seed=100 + i, temperature=1.0 + 0.1 * i)
                for i, t in enumerate(texts)]
        out = cb.drain()
        assert cb.idle()
        return [out[r] for r in rids]

    assert run(True) == run(False)


def test_freed_slots_are_reused(model):
    _, _, tparams = model
    cb = _pool(tparams, n_slots=1, top_k=1)
    a = cb.add_request(_prompt("one"), 6)
    b = cb.add_request(_prompt("two"), 6)
    out = cb.drain()
    assert set(out) == {a, b} and all(0 < len(v) <= 6 for v in out.values())
    assert cb.idle()
    st = cb.snapshot_stats()
    assert st["admitted"] == 2 and st["chunks"] >= 2
    assert 0 < st["active_rows"] <= st["chunks"] * cb.n_slots and st["chunk_s"] > 0
    cb.reset_stats()
    assert cb.stats["chunks"] == 0


def test_capped_request_sets_done_flag(model):
    _, _, tparams = model
    cb = _pool(tparams, top_k=1)
    rid = cb.add_request(_prompt("cap me"), 4)  # the random model draws no EOS in 4
    out = {}
    while not cb.idle():
        out.update(cb.step())
    assert len(out[rid]) == 4
    assert bool(cb._carry[2].all()), "a slot retired by its cap left done=False"


def test_seed_gives_same_tokens_under_different_pool_mixes(model):
    _, _, tparams = model
    target = _prompt("the reproducible request")

    def run(n_slots, chunk, others, seed=123):
        cb = _pool(tparams, n_slots=n_slots, chunk=chunk, top_k=0)
        for i in range(others):
            cb.add_request(_prompt(f"decoy {i}"), 10, seed=7 + i)
        rid = cb.add_request(target, 10, seed=seed)
        return cb.drain()[rid]

    alone = run(2, 4, 0)
    assert run(3, 5, 4) == alone
    assert run(2, 4, 0, seed=124) != alone


def test_warmup_leaves_the_pool_unchanged(model):
    _, _, tparams = model

    def run(warm):
        cb = _pool(tparams, top_k=1)
        if warm:
            cb.warmup(prompt_widths=[32, 64])
        long_row = tcoll.build_prompt([i % 150 + 1 for i in range(40)], [1, 2, 3, 4])
        rids = [cb.add_request(_prompt(t), 8) for t in ("aa", "bb", "cc")]
        rids.append(cb.add_request(tcoll.pad_prompts_left([long_row]), 8))
        out = cb.drain()
        return [out[r] for r in rids]

    assert run(True) == run(False)


def test_pool_refuses_a_mesh(model):
    """The pool takes no JAX mesh: its dp form is slot groups on devices
    (test_torch_dp_pool.py), which refuse slots they do not divide."""
    _, _, tparams = model
    with pytest.raises(TypeError, match="mesh"):
        _pool(tparams, mesh=object())
    with pytest.raises(ValueError, match="not divisible"):
        _pool(tparams, devices=["cpu"] * 3)


def test_mega_insert_matches_full_pack_on_the_plain_step():
    """The B=64 pool's insert (row writes into the natural-layout bf16
    state, slots in shuffled order) gives the state the whole-batch pack
    gives, and the plain B=64 step then gives the same hidden."""
    cfg = tspark.default_config(hidden_size=128, num_layers=2, dtype=torch.float32)
    g = torch.Generator().manual_seed(3)
    params = tspark.init_params(g, cfg)
    cb = tcont.ContinuousBatcher(params, cfg, n_slots=64, chunk=2, megakernel=True)
    raw = {"att_x": torch.randn(2, 64, 128, generator=g),
           "wkv": 0.3 * torch.randn(2, 64, 2, 64, 64, generator=g),
           "ffn_x": torch.randn(2, 64, 128, generator=g)}
    hk = torch.randn(64, 128, generator=g)
    order = np.random.default_rng(0).permutation(64)
    x = torch.randn(64, 128, generator=g)
    with torch.inference_mode():  # the pool's carry lives in inference mode
        cb._insert(hk[order], {k: v[:, order] for k, v in raw.items()}, order.tolist(), 64,
                   np.ones(64, np.float32), np.ones(64, np.float32), np.zeros(64, np.int64))
        h, st, done = cb._carry[:3]
        torch.testing.assert_close(h, hk, rtol=0, atol=0)
        assert not bool(done.any())
        full = dmb.pack_state(raw)
        for k in full:
            torch.testing.assert_close(st[k], full[k], rtol=0, atol=0)
        h1, _ = dmb.decode_step_mega_b64(cb._mega, cfg.backbone, x, st)
        h2, _ = dmb.decode_step_mega_b64(cb._mega, cfg.backbone, x, full)
    torch.testing.assert_close(h1, h2, rtol=0, atol=0)


def test_mega_pool_matches_mega_generate():
    """The B=64 pool's greedy tokens for 64 prompts equal
    spark_generate_mega_b64's on the same prompts."""
    from rwkvtts_torch.infer.generate import spark_generate_mega_b64
    from rwkvtts_torch.serving import pool_common

    cfg = tspark.default_config(hidden_size=128, num_layers=2, dtype=torch.float32)
    params = tspark.init_params(torch.Generator().manual_seed(0), cfg)
    pbs = [_prompt(f"mega pool request {i}") for i in range(64)]
    stacked = pool_common.stack_admission([pool_common.pad_prompt(b, 32) for b in pbs])
    mega = dmb.pack_mega_b64(params, cfg.backbone)
    toks, lengths = spark_generate_mega_b64(
        params, mega, cfg, *(torch.from_numpy(stacked[k]).long()
                             for k in ("tokens", "modality", "attention_mask")),
        max_new_tokens=6, top_k=1, top_p=1.0, noise=torch.zeros(6, 64, 8193))
    want = {i: toks[i, :min(int(lengths[i]), 6)].tolist() for i in range(64)}
    cb = tcont.ContinuousBatcher(params, cfg, n_slots=64, chunk=3, prompt_cap=32, top_k=1,
                                 megakernel=True)
    rids = {cb.add_request(pbs[i], 6): i for i in range(64)}
    got = {rids[r]: v for r, v in cb.drain().items()}
    assert got == want


# ---------------------------------------------------------------------------
# service and HTTP
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def service(model):
    _, _, tparams = model
    pipe = SparkPipeline(_tcfg(True), tparams, FakeTok())
    tts = tsvc.ContinuousTTSService(pipe, n_slots=3, chunk=4, max_new_tokens=16, top_k=1)
    yield tts
    tts.close()


def test_service_answers_concurrent_mixed_voices(service):
    reqs = [tsvc.TTSRequest(text=f"voice {i}", global_tokens=[i + j for j in range(32)],
                            max_new_tokens=4 + i, seed=i) for i in range(8)]
    with cf.ThreadPoolExecutor(8) as ex:
        res = list(ex.map(service.synthesize, reqs))
    assert all(r.error is None and r.wav.size == 0 for r in res)
    st = service.stats()
    assert st["mode"] == "continuous" and st["admitted"] >= 8 and 0 < st["occupancy"] <= 1
    # a properties request is answered through voice design (no codec here:
    # an empty wav, as for the others)
    r = service.synthesize(tsvc.TTSRequest(text="x", properties={"gender": "male"},
                                           max_new_tokens=4))
    assert r.error is None and r.wav.size == 0


def _http(port, path, body=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=None if body is None else json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.headers["Content-Type"], resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def test_http_endpoints(service):
    server, port = http_server.start_background(service)
    try:
        assert json.loads(_http(port, "/health")[2]) == {"status": "ok"}
        assert json.loads(_http(port, "/api/stats")[2])["mode"] == "continuous"
        assert json.loads(_http(port, "/api/speakers")[2]) == {"speakers": []}
        assert "NEUTRAL" in json.loads(_http(port, "/api/properties")[2])["emotion"]
        code, ctype, body = _http(port, "/api/rwkv_tts",
                                  {"text": "hello", "global_tokens": [5] * 32,
                                   "max_new_tokens": 6})
        assert (code, ctype) == (200, "audio/wav") and body[:4] == b"RIFF"
        assert _http(port, "/api/rwkv_tts", {"text": "no voice"})[0] == 400
        # voice design answers 32 global tokens; the instruct endpoint a wav
        code, _, msg = _http(port, "/api/voice_design", {"properties": {}})
        designed = json.loads(msg)["global_tokens"]
        assert code == 200 and len(designed) == 32 and all(0 <= t < 4096 for t in designed)
        assert _http(port, "/api/voice_design", {"name": "no properties"})[0] == 400
        code, ctype, body = _http(port, "/api/rwkv_tts_instruct",
                                  {"text": "x", "properties": {"gender": "male"},
                                   "max_new_tokens": 4})
        assert (code, ctype) == (200, "audio/wav") and body[:4] == b"RIFF"
        # a Spark pipeline has no streaming path; the studio page is served
        code, _, msg = _http(port, "/api/rwkv_tts_stream", {"text": "x"})
        assert code == 501 and b"no streaming pipeline" in msg
        code, ctype, _ = _http(port, "/")
        assert code == 200 and ctype.startswith("text/html")
        assert _http(port, "/nowhere")[0] == 404
    finally:
        server.shutdown()
        server.server_close()


# ---------------------------------------------------------------------------
# launcher and checkpoints
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """A 32 x 2 Spark checkpoint written by the JAX package's exporter; its
    head scaled so greedy gaps stand far above bf16 rounding (both
    launchers serve in bf16, and two bf16 implementations round apart)."""
    pytest.importorskip("safetensors")
    cfg = jspark.default_config(hidden_size=32, num_layers=2, head_size=8, gate_lora=8,
                                dtype=jnp.float32, wkv_chunk=16, remat=False)
    params = _jinit(jax.random.PRNGKey(0), cfg)
    params = {**params, "head": 10.0 * params["head"]}
    d = tmp_path_factory.mktemp("jax_ckpt")
    return f"{jexport.save_pretrained(params, cfg, str(d), kind='spark')}/model.safetensors"


@pytest.fixture
def fake_tokenizers(monkeypatch):
    monkeypatch.setattr("rwkvtts_tpu.utils.tokenizer.get_world_tokenizer",
                        lambda n_spct=0: FakeTok())
    monkeypatch.setattr("rwkvtts_torch.utils.tokenizer.get_world_tokenizer",
                        lambda n_spct=0: FakeTok())


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def test_jax_checkpoint_loads_to_equal_params(jax_ckpt, fake_tokenizers):
    jpipe = jlaunch.build_pipeline(jax_ckpt)
    tpipe = launch.build_pipeline(jax_ckpt, device="cpu")
    jp, tp = _flat(jpipe.params), _flat(tpipe.params)
    assert set(jp) == set(tp)
    for k, v in tp.items():
        assert v.dtype == (torch.bfloat16 if v.dim() >= 2 else torch.float32), k
        np.testing.assert_array_equal(bridge.to_numpy(v), np.asarray(jp[k], np.float32),
                                      err_msg=k)
    assert tpipe.cfg.backbone.decode_wkv_packed and not tpipe.cfg.backbone.decode_state_bf16


def test_launcher_serves_the_jax_launchers_greedy_tokens(jax_ckpt, fake_tokenizers):
    """Booted on the CPU, the port's launcher answers a request with the
    tokens the JAX launcher's service gives (greedy)."""
    def tokens_of(build_pipeline, build_service, svc, **kw):
        tts = build_service(build_pipeline(jax_ckpt, **kw), n_slots=2, chunk=8,
                            max_new_tokens=12, top_k=1, warmup=False)
        got = []
        finish = tts._finish
        tts._finish = lambda toks, g: (got.append(list(toks)), finish(toks, g))[1]
        try:
            resp = tts.synthesize(svc.TTSRequest(text="boot", global_tokens=[1] * 32,
                                                 max_new_tokens=10), timeout=600)
        finally:
            tts.close()
        assert resp.error is None
        return got

    want = tokens_of(jlaunch.build_pipeline, jlaunch.build_service, jsvc)
    got = tokens_of(launch.build_pipeline, launch.build_service, tsvc, device="cpu")
    assert got == want and len(got[0]) == 10


def test_port_export_reads_back_through_jax(tmp_path):
    cfg = tspark.default_config(hidden_size=32, num_layers=2, head_size=8, gate_lora=8,
                                dtype=torch.float32)
    params = tspark.init_params(torch.Generator().manual_seed(1), cfg)
    path = f"{texport.save_pretrained(params, cfg, str(tmp_path))}/model.safetensors"
    sd = jckpt.load_torch_or_safetensors(path)
    jcfg = jspark.default_config(hidden_size=32, num_layers=2, head_size=8, gate_lora=8)
    back = _flat(jinit.spark_from_pretrained_sd(sd, jcfg))
    want = _flat(bridge.params_to_numpy(params))
    # layer 0 has no v-lora in the checkpoint format: both loaders zero it
    for k in ("v0", "v1", "v2"):
        want[f"blocks/att/{k}"][0] = 0.0
    assert set(back) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(back[k]), v, err_msg=k)
    from safetensors.numpy import load_file

    assert set(load_file(path)) == set(sd)


@pytest.mark.parametrize("naming,stacked_x", [("fla", False), ("fla", True),
                                              ("blinkdl", False), ("blinkdl", True)])
def test_checkpoint_readers_match_jax(naming, stacked_x):
    """The port's fla-HF and BlinkDL readers (and the v1 stacked
    token-shift migration) give the JAX readers' trees."""
    from rwkvtts_torch.convert import rwkv7_ckpt as tckpt

    jcfg = jspark.default_config(hidden_size=32, num_layers=2, head_size=8, gate_lora=8)
    params = jax.tree.map(np.asarray, _jinit(jax.random.PRNGKey(2), jcfg))
    if naming == "fla":
        sd = jexport.spark_to_fla(params, jcfg)
        prefix = "model.layers.{}.attn"
    else:
        sd = jckpt.rwkv7_to_blinkdl(params, jcfg.backbone)
        prefix = "blocks.{}.att"
    if stacked_x:  # the v1 layout: the six deltas stacked as x_x
        for i in range(2):
            a = prefix.format(i)
            sd[f"{a}.x_x"] = np.stack([sd.pop(f"{a}.x_{c}").reshape(-1) for c in "rwkvag"])
    load = "fla_to_rwkv7" if naming == "fla" else "blinkdl_to_rwkv7"
    want = _flat(getattr(jckpt, load)(dict(sd), jcfg.backbone))
    got = _flat(getattr(tckpt, load)(dict(sd), tspark.default_config(
        hidden_size=32, num_layers=2, head_size=8, gate_lora=8).backbone))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
    assert tckpt.infer_config_kwargs(sd) == jckpt.infer_config_kwargs(sd)


@pytest.mark.parametrize("flags", [["--mega", "--int8"], ["--family", "cosy", "--mega"],
                                   ["--grouped", "--mega"], ["--mega", "--int4"], ["--dp", "2"]])
def test_launcher_refuses_what_it_cannot_serve(flags):
    with pytest.raises(SystemExit):
        launch.main(["--ckpt", "unused.safetensors", *flags])


def test_launcher_without_a_card_raises(jax_ckpt):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.build_pipeline(jax_ckpt)


class _Resolved(Exception):
    """Stops a launcher's main once it has handed its sampling on."""


def _jax_launcher_sampling(monkeypatch, flags):
    """(top_k, top_p) that the JAX launcher's main resolves from `flags` and
    hands to its service, with the model loading stubbed out."""
    from rwkvtts_tpu.serving import service as jservice

    got = {}

    def capture(*args, **kwargs):
        got.update(top_k=kwargs["top_k"], top_p=kwargs["top_p"])
        raise _Resolved

    monkeypatch.setattr(jlaunch, "build_pipeline", lambda *a, **k: None)
    monkeypatch.setattr(jlaunch, "build_cosy_pipeline", lambda *a, **k: None)
    monkeypatch.setattr(jlaunch, "build_service", capture)
    monkeypatch.setattr(jservice, "CosyTTSService", capture)
    with pytest.raises(_Resolved):
        jlaunch.main(["--ckpt", "unused.safetensors", *flags])
    return got["top_k"], got["top_p"]


@pytest.mark.parametrize("family", ["spark", "cosy"])
@pytest.mark.parametrize("given", [[], ["--top-k", "7", "--top-p", "0.5"], ["--top-p", "0.6"]])
def test_launchers_resolve_the_same_sampling(monkeypatch, family, given):
    """Both launchers' parsers resolve top-k / top-p per family (spark 50 /
    0.95, cosy 25 / 0.8) unless the flags give them; the port's main hands
    them on to its service."""
    flags = ["--family", family, *given]
    want = _jax_launcher_sampling(monkeypatch, flags)
    args = launch._parser().parse_args(["--ckpt", "unused.safetensors", *flags])
    assert launch.sampling_defaults(args.family, args.top_k, args.top_p) == want
    got = {}

    def capture(*a, **kw):
        got.update(top_k=kw["top_k"], top_p=kw["top_p"])
        raise _Resolved

    monkeypatch.setattr(launch, "build_pipeline", lambda *a, **k: None)
    monkeypatch.setattr(launch, "build_cosy_pipeline", lambda *a, **k: None)
    monkeypatch.setattr(launch, "build_service", capture)
    monkeypatch.setattr(tsvc, "CosyTTSService", capture)
    with pytest.raises(_Resolved):
        launch.main(["--ckpt", "unused.safetensors", *flags])
    assert (got["top_k"], got["top_p"]) == want
