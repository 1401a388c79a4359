"""The Spark text->wav route, port vs JAX package, on the CPU: early-exit
and global-token generation fed the JAX package's Gumbel noise,
``SparkPipeline.synthesize`` / ``design_voice`` end to end through a
BiCodec codec on the same LM and codec weights, the grouped same-voice
service, the HTTP voice-design and instruct endpoints answering with
audio, and the launcher's --codec-dir and --grouped."""
import concurrent.futures as cf
import dataclasses
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import golden_configs as gc
from rwkvtts_tpu.codecs import bicodec as jb
from rwkvtts_tpu.codecs import spark_tokenizer as jst
from rwkvtts_tpu.infer import generate as jgen
from rwkvtts_tpu.infer.spark_pipeline import SparkPipeline as JPipeline
from rwkvtts_tpu.models import spark as jspark
from rwkvtts_torch import bridge
from rwkvtts_torch.codecs import spark_tokenizer as tst
from rwkvtts_torch.convert import export_hf as texport
from rwkvtts_torch.infer import generate as tgen
from rwkvtts_torch.infer.spark_pipeline import SparkPipeline
from rwkvtts_torch.models import spark as tspark
from rwkvtts_torch.serving import http_server, launch
from rwkvtts_torch.serving import service as tsvc
from test_torch_bicodec import _both, port_config, write_model_dir

torch.set_num_threads(2)

V = 8193


class FakeTok:
    def encode(self, text):
        return [ord(c) % 200 + 1 for c in text][:12]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


@pytest.fixture(scope="module")
def lm():
    """A 64 x 2 Spark LM (head 16), f32: the JAX config and parameters and
    the port's (the same numbers); the head scaled so greedy gaps stand
    well above rounding."""
    jcfg = jspark.default_config(hidden_size=64, num_layers=2, head_size=16, gate_lora=16,
                                 dtype=jnp.float32, wkv_chunk=16, remat=False, dropout=0.0)
    tcfg = tspark.default_config(hidden_size=64, num_layers=2, head_size=16, gate_lora=16,
                                 dtype=torch.float32)
    p = jax.tree.map(np.asarray, jax.jit(lambda k: jspark.init_params(k, jcfg))(
        jax.random.PRNGKey(0)))
    p["head"] = 10.0 * p["head"]
    return jcfg, tcfg, p, bridge.params_from_numpy(p)


def _prompt(B, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 4000, (B, 12)).astype(np.int32)
    modality = np.full((B, 12), jspark.MOD_TEXT, np.int32)
    modality[:, -1], tokens[:, -1] = jspark.MOD_TAG, jspark.TAG_START_TTS
    mask = np.ones((B, 12), np.int32)
    mask[0, :4], modality[0, :4], tokens[0, :4] = 0, jspark.MOD_PAD, 0
    return tokens, modality, mask


def chunk_noise(seed, max_new, chunk_len, B, width):
    """The Gumbel noise of the JAX early-exit loop's draws, step by step:
    a split of the key a chunk, then a key a step."""
    key, out, n = jax.random.PRNGKey(seed), [], 0
    while n < max_new:
        key, sub = jax.random.split(key)
        cl = min(chunk_len, max_new - n)
        out += [jax.random.gumbel(k, (B, width)) for k in jax.random.split(sub, cl)]
        n += cl
    return torch.from_numpy(np.stack([np.asarray(x) for x in out]))


def global_noise(seed, num, B, width):
    keys = jax.random.split(jax.random.PRNGKey(seed), num)
    return torch.from_numpy(np.stack([np.asarray(jax.random.gumbel(k, (B, width)))
                                      for k in keys]))


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_early_exit_generation_matches_jax(lm, mode):
    """B=3, chunks of 4. Greedy: the EOS logit lifted far above the rest (a
    constant EOS column against a final norm with a positive bias: the
    normed part sums to zero), so every row draws EOS as soon as
    min_new_tokens (5) lets it; tokens and lengths equal and the loop
    stops after two chunks. Top-k 50 / top-p 0.95 fed JAX's noise: >= 98%
    of the tokens equal."""
    jcfg, tcfg, p, tp = lm
    if mode == "greedy":
        p = {**p, "head": p["head"].copy(), "ln_out_scale": np.ones(64, np.float32),
             "ln_out_bias": np.full(64, 0.1, np.float32)}
        p["head"][:, -1] = 1000.0 * np.abs(p["head"]).max()
        tp = bridge.params_from_numpy(p)
        kw, max_new = {"top_k": 1, "top_p": 1.0, "min_new_tokens": 5}, 16
    else:
        kw, max_new = {"top_k": 50, "top_p": 0.95}, 8
    prompt = _prompt(3, 1)
    want, want_len = jgen.spark_generate_early_exit(
        jax.tree.map(jnp.asarray, p), jcfg, *(jnp.asarray(x) for x in prompt),
        jax.random.PRNGKey(7), max_new_tokens=max_new, chunk_len=4, **kw)
    width = 50 if mode == "sampled" else V
    chunks = []
    chunk = tgen.spark_decode_chunk

    def counted(*a, **k):
        chunks.append(k["chunk_len"])
        return chunk(*a, **k)

    tgen.spark_decode_chunk = counted
    try:
        got, got_len = tgen.spark_generate_early_exit(
            tp, tcfg, *(torch.from_numpy(x) for x in prompt), max_new_tokens=max_new,
            chunk_len=4, noise=chunk_noise(7, max_new, 4, 3, width), **kw)
    finally:
        tgen.spark_decode_chunk = chunk
    want, want_len = np.asarray(want), np.asarray(want_len)
    if mode == "greedy":
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got_len.numpy(), want_len)
        assert list(want_len) == [5, 5, 5] and chunks == [4, 4]
    else:
        assert float((got.numpy() == want).mean()) >= 0.98


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_global_generate_matches_jax(lm, mode):
    """The voice designer's 32 draws, restricted to [0, 4096): greedy equal,
    sampled (JAX's noise) >= 98% equal."""
    jcfg, tcfg, p, tp = lm
    kw = {"top_k": 1, "top_p": 1.0} if mode == "greedy" else {"top_k": 50, "top_p": 0.95}
    prompt = _prompt(2, 2)
    want, _ = jgen.spark_global_generate(jax.tree.map(jnp.asarray, p), jcfg,
                                         *(jnp.asarray(x) for x in prompt),
                                         jax.random.PRNGKey(3), num_tokens=32, **kw)
    noise = global_noise(3, 32, 2, 50 if mode == "sampled" else V)
    got, lengths = tgen.spark_global_generate(tp, tcfg, *(torch.from_numpy(x) for x in prompt),
                                              num_tokens=32, noise=noise, **kw)
    want = np.asarray(want)
    assert got.shape == (2, 32) and (lengths == 32).all() and int(got.max()) < 4096
    if mode == "greedy":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        assert float((got.numpy() == want).mean()) >= 0.98


# ---------------------------------------------------------------------------
# the pipeline with a codec
# ---------------------------------------------------------------------------


def codec_config():
    """The golden's reduced BiCodec, with the LM's 8192-code semantic space
    and a 32-token speaker code."""
    c = gc.bicodec_config()
    return dataclasses.replace(c, quantizer_codebook_size=8192,
                               speaker=dataclasses.replace(c.speaker, token_num=32))


def features(wav):
    """A stand-in frontend shared by both packages: 12 features a 320-sample
    frame (the wav2vec2 frontend has its own test)."""
    n = wav.shape[-1] // 320
    frames = wav[..., :n * 320].reshape(*wav.shape[:-1], n, 320)
    proj = np.random.default_rng(5).standard_normal((320, 12)).astype(np.float32)
    return np.tanh(frames @ proj).astype(np.float32)


@pytest.fixture(scope="module")
def pipelines(lm):
    """The JAX and the port's SparkPipeline on the same LM and codec weights."""
    jcfg, tcfg, p, tp = lm
    ccfg = codec_config()
    cj, ct = _both(lambda k: jb.init_params(k, ccfg), seed=4)
    jcodec = jst.SparkAudioTokenizer(ccfg, cj, wav2vec2=lambda w: jnp.asarray(features(w)))
    tcodec = tst.SparkAudioTokenizer(port_config(ccfg), ct,
                                     wav2vec2=lambda w: torch.from_numpy(features(w)))
    jpipe = JPipeline(jcfg, jax.tree.map(jnp.asarray, p), FakeTok(), audio_tokenizer=jcodec)
    tpipe = SparkPipeline(tcfg, tp, FakeTok(), audio_tokenizer=tcodec)
    return jpipe, tpipe


PROPS = {"gender": "male", "age": "middle-aged", "emotion": "HAPPY"}


@pytest.mark.parametrize("voice", ["global_tokens", "properties", "prompt_wav"])
def test_synthesize_matches_jax(pipelines, voice):
    """Greedy synthesis of two texts, 8 new tokens: the semantic tokens
    equal and each wav within 1e-4 relative of the JAX pipeline's (tokens
    x 32 samples at this codec's hop). With properties the voice is
    designed first (top-k 50 / top-p 0.95, seed 0, JAX's noise fed in):
    the 32 global tokens equal."""
    jpipe, tpipe = pipelines
    texts = ["hello there", "a second text"]
    kw = {"max_new_tokens": 8, "top_k": 1, "top_p": 1.0}
    if voice == "global_tokens":
        kw["global_tokens"] = list(range(100, 132))
    elif voice == "properties":
        kw["properties"] = PROPS
    else:
        kw.update(prompt_wav=np.random.default_rng(6).uniform(-0.5, 0.5, 4000)
                  .astype(np.float32), prompt_text="prompt words")
    want = jpipe.synthesize(texts, **kw)
    design = global_noise(0, 32, 1, 50) if voice == "properties" else None
    got = tpipe.synthesize(texts, design_noise=design, **kw)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.global_tokens, w.global_tokens)
        np.testing.assert_array_equal(g.semantic_tokens, np.asarray(w.semantic_tokens))
        assert g.wav.shape == w.wav.shape == (32 * len(w.semantic_tokens),)
        assert _rel(g.wav, w.wav) <= 1e-4
    if voice == "properties":
        assert got[0].global_tokens.tolist() == tpipe.design_voice(PROPS, noise=design)


def _http(port, path, body=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=None if body is None else json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, resp.headers["Content-Type"], resp.read()


def _wav_samples(body: bytes) -> int:
    assert body[:4] == b"RIFF"
    return (len(body) - 44) // 2


def test_grouped_service_and_http_answer_with_audio(pipelines):
    """The grouped dispatcher batches three same-voice requests into one
    synthesize and answers each with the pipeline's own wav; over HTTP,
    /api/voice_design designs and saves a voice, /api/rwkv_tts speaks
    with the saved name and /api/rwkv_tts_instruct with properties, each
    with audio."""
    _, tpipe = pipelines
    tts = tsvc.BatchedTTSService(tpipe, max_new_tokens=8, max_wait_ms=200)
    server, port = http_server.start_background(tts)
    try:
        voice = list(range(200, 232))
        reqs = [tsvc.TTSRequest(text=f"grouped {i}", global_tokens=voice, top_k=1, top_p=1.0)
                for i in range(3)]
        with cf.ThreadPoolExecutor(3) as ex:
            res = list(ex.map(tts.synthesize, reqs))
        want = tpipe.synthesize([r.text for r in reqs], global_tokens=voice, max_new_tokens=8,
                                top_k=1, top_p=1.0)
        for r, w in zip(res, want):
            assert r.error is None and r.wav.size == 32 * len(w.semantic_tokens) > 0
            assert _rel(r.wav, w.wav) <= 1e-5
        assert tts.stats() == {"mode": "grouped", "queued": 0}

        code, _, body = _http(port, "/api/voice_design", {"properties": PROPS, "name": "v1"})
        designed = json.loads(body)
        assert code == 200 and designed["name"] == "v1"
        assert len(designed["global_tokens"]) == 32
        assert all(0 <= t < 4096 for t in designed["global_tokens"])
        code, _, body = _http(port, "/api/voice_design",
                              {"properties": {}, "name": "v2", "global_tokens": voice})
        assert json.loads(body)["global_tokens"] == voice
        assert json.loads(_http(port, "/api/speakers")[2]) == {"speakers": ["v1", "v2"]}
        for path, body in (("/api/rwkv_tts", {"text": "saved", "speaker": "v1",
                                              "top_k": 1, "top_p": 1.0}),
                           ("/api/rwkv_tts_instruct", {"text": "instruct", "properties": PROPS,
                                                       "top_k": 1, "top_p": 1.0})):
            code, ctype, wav = _http(port, path, body)
            assert (code, ctype) == (200, "audio/wav") and _wav_samples(wav) > 0, path
            assert _wav_samples(wav) % 32 == 0, path
    finally:
        server.shutdown()
        server.server_close()
        tts.close()


def test_continuous_service_answers_with_audio(pipelines):
    """The slot pool with the codec attached: each answer's wav has exactly
    tokens x hop samples and equals the codec's detokenize of the tokens."""
    _, tpipe = pipelines
    tts = tsvc.ContinuousTTSService(tpipe, n_slots=2, chunk=4, max_new_tokens=8, top_k=1)
    toks = []
    finish = tts._finish
    tts._finish = lambda t, g: (toks.append(list(t)), finish(t, g))[1]
    try:
        resp = tts.synthesize(tsvc.TTSRequest(text="pool", global_tokens=[7] * 32,
                                              max_new_tokens=6))
    finally:
        tts.close()
    assert resp.error is None and len(toks[0]) == 6 and resp.wav.shape == (6 * 32,)
    want = tpipe.codec.detokenize(np.full((1, 1, 32), 7), np.asarray(toks))[0]
    np.testing.assert_array_equal(resp.wav, want)


@pytest.fixture
def fake_tokenizer(monkeypatch):
    monkeypatch.setattr("rwkvtts_torch.utils.tokenizer.get_world_tokenizer",
                        lambda n_spct=0: FakeTok())


def test_launcher_codec_dir_and_grouped(tmp_path, monkeypatch, fake_tokenizer):
    """launch --codec-dir builds the codec from a model directory, and
    --grouped serves it through the grouped dispatcher."""
    from rwkvtts_torch.utils import fixtures

    cfg = tspark.default_config(hidden_size=32, num_layers=2, head_size=8, gate_lora=8,
                                dtype=torch.float32)
    params = tspark.init_params(torch.Generator().manual_seed(1), cfg)
    ckpt = f"{texport.save_pretrained(params, cfg, str(tmp_path / 'lm'))}/model.safetensors"
    sd, io = fixtures.load_golden(f"{gc.GOLDEN_DIR}/bicodec.npz")
    codec_dir = write_model_dir(tmp_path / "codec", sd, gc.bicodec_config())

    pipe = launch.build_pipeline(ckpt, codec_dir=str(codec_dir), device="cpu")
    assert isinstance(pipe.codec, tst.SparkAudioTokenizer) and pipe.codec.wav2vec2 is None
    np.testing.assert_allclose(pipe.codec.detokenize(io["global_tokens"], io["semantic"]),
                               io["wav"][:, 0], atol=2e-3)
    served = {}
    monkeypatch.setattr(http_server, "serve", lambda tts, host, port: served.update(tts=tts))
    launch.main(["--ckpt", ckpt, "--codec-dir", str(codec_dir), "--grouped", "--device", "cpu",
                 "--no-warmup"])
    tts = served["tts"]
    try:
        assert type(tts) is tsvc.BatchedTTSService and tts.pipeline.codec is not None
        assert tts.speakers.codec is tts.pipeline.codec
        assert tts.pipeline.params["head"].dtype == torch.bfloat16
    finally:
        tts.close()
