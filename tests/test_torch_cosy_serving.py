"""The Cosy server, port vs JAX package, on the CPU: CosyTTSService's
synthesize and stream over one slot pool, the HTTP routes it opens (the
chunked streaming WAV, stored voices, the studio page, mp3), the Spark
service's stream route (501), the voice library read back across the two
packages, and the launcher's cosy branch against the JAX launcher on a
checkpoint the JAX exporter wrote. LM 64 x 2 and the tiny flow / HiFT of
tests/test_torch_cosy_pool.py."""
import json
import socket
import types

import numpy as np
import pytest
import torch

from rwkvtts_tpu.convert import export_hf as jexport
from rwkvtts_tpu.infer import voices as jvoices
from rwkvtts_tpu.serving import http_server as jhttp
from rwkvtts_tpu.serving import launch as jlaunch
from rwkvtts_torch.infer import voices
from rwkvtts_torch.serving import http_server, launch
from rwkvtts_torch.serving import service as svc
from rwkvtts_torch.utils import mp3

from test_torch_cosy_pool import SCFG, FakeTok, _prompt, jax_noise, lm, pipe  # noqa: F401

torch.set_num_threads(2)

SAMPLES_A_TOKEN = 96  # 2 mel frames x the tiny HiFT's 48 samples


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    """A voice library written by the JAX class: one stored voice."""
    d = tmp_path_factory.mktemp("voices")
    rng = np.random.default_rng(3)
    jvoices.CosyVoiceLibrary(str(d)).register(
        "alice", [5, 17, 200, 6000], rng.standard_normal((8, 16)).astype(np.float32),
        rng.standard_normal(12).astype(np.float32), prompt_text="hi")
    return str(d)


@pytest.fixture(scope="module")
def service(pipe, library):
    tts = svc.CosyTTSService(pipe, voices=voices.CosyVoiceLibrary(library), n_slots=2, chunk=4,
                             prompt_cap=32, max_new_tokens=12, stream_cfg=SCFG)
    yield tts
    tts.close()


def _check_synthesize(service):
    """synthesize = the stream's chunks joined (same seed, same draws),
    tokens x 96 finite samples; errors are answered, not raised."""
    req = svc.TTSRequest(text="hello", speaker="alice", seed=3)
    resp = service.synthesize(req)
    assert resp.error is None and resp.sample_rate == 24000
    np.testing.assert_array_equal(resp.wav, np.concatenate(list(service.stream(req))))
    hops = list(service.stream(req, hop_tokens=4))  # the same tokens in 4-token hops
    assert len(hops) >= 3 and sum(map(len, hops)) == len(resp.wav)
    assert len(resp.wav) % SAMPLES_A_TOKEN == 0 and 10 * SAMPLES_A_TOKEN <= len(resp.wav)
    assert np.isfinite(resp.wav).all()
    assert "unknown speaker" in service.synthesize(svc.TTSRequest(text="x", speaker="bob")).error
    assert "Spark" in service.synthesize(svc.TTSRequest(text="x", global_tokens=[1])).error
    st = service.stats()
    assert st["mode"] == "cosy_pool" and st["n_slots"] == 2 and st["active"] == 0


def _post_raw(port, path, body):
    """POST over a raw socket: (status line, headers, raw body bytes up to
    and including the terminating 0-chunk)."""
    data = json.dumps(body).encode()
    with socket.create_connection(("127.0.0.1", port), timeout=120) as s:
        s.sendall(f"POST {path} HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\n"
                  f"Content-Length: {len(data)}\r\n\r\n".encode() + data)
        buf = b""
        while not buf.endswith(b"\r\n0\r\n\r\n"):
            got = s.recv(65536)
            assert got, "connection closed before the 0-chunk"
            buf += got
    head, raw = buf.split(b"\r\n\r\n", 1)
    return head.decode().split("\r\n")[0], head.decode().lower(), raw


def _dechunk(raw):
    out = []
    while True:
        size, raw = raw.split(b"\r\n", 1)
        n = int(size, 16)
        if n == 0:
            assert raw == b"\r\n"
            return out
        out.append(raw[:n])
        assert raw[n:n + 2] == b"\r\n"
        raw = raw[n + 2:]


def _http(port, path, body=None):
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=None if body is None else json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.headers["Content-Type"], resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def _check_http(service):
    """The chunked streaming WAV (a RIFF header of open length, PCM16 of
    the stream's samples, the 0-chunk), the stored voices, the studio
    page, an mp3 answer (MPEG frames) and a wav one."""
    server, port = http_server.start_background(service)
    try:
        status, head, raw = _post_raw(port, "/api/rwkv_tts_stream",
                                      {"text": "hello", "speaker": "alice", "seed": 3,
                                       "hop_tokens": 4})
        assert "200" in status and "transfer-encoding: chunked" in head
        parts = _dechunk(raw)
        assert parts[0] == svc.stream_wav_header(24000) and parts[0][:4] == b"RIFF"
        want = list(service.stream(svc.TTSRequest(text="hello", speaker="alice", seed=3),
                                   hop_tokens=4))
        assert parts[1:] == [svc.pcm16(w) for w in want] and len(parts) >= 4
        assert json.loads(_http(port, "/api/speakers")[2]) == {"speakers": ["alice"]}
        code, ctype, page = _http(port, "/")
        assert code == 200 and ctype.startswith("text/html") and b"RWKV TTS Studio" in page
        assert _http(port, "/demo")[2] == page
        body = {"text": "hello", "speaker": "alice", "seed": 3}
        code, ctype, wav = _http(port, "/api/rwkv_tts", body)
        assert (code, ctype) == (200, "audio/wav") and wav[:4] == b"RIFF"
        assert mp3.available()  # the system's libmp3lame.so.0
        code, ctype, data = _http(port, "/api/rwkv_tts", {**body, "audio_format": "mp3"})
        assert (code, ctype) == (200, "audio/mpeg") and data[0] == 0xFF and data[1] & 0xE0 == 0xE0
        assert _http(port, "/api/rwkv_tts_stream", {"text": "x", "speaker": "bob"})[0] == 400
    finally:
        server.shutdown()
        server.server_close()


def _check_spark_stream_501():
    """A pipeline without synthesize_streaming (a Spark one): stream raises
    NotImplementedError and the route answers 501."""
    tts = svc.BatchedTTSService(types.SimpleNamespace(sample_rate=16000))
    server, port = http_server.start_background(tts)
    try:
        with pytest.raises(NotImplementedError):
            next(tts.stream(svc.TTSRequest(text="x")))
        code, _, msg = _http(port, "/api/rwkv_tts_stream", {"text": "x"})
        assert code == 501 and b"no streaming pipeline" in msg
    finally:
        server.shutdown()
        server.server_close()
        tts.close()


def _check_voice_library(tmp_path, pipe, library):
    """A library written by either class reads back equal in the other;
    register_from_wav(s) stores what frontend_zero_shot gives (and the
    mean x-vector of several clips)."""
    theirs, ours = jvoices.CosyVoiceLibrary(library), voices.CosyVoiceLibrary(library)
    for k in ("tokens", "mel", "emb"):
        np.testing.assert_array_equal(ours.get("alice")[k], theirs.get("alice")[k])
        assert ours.get("alice")[k].dtype == theirs.get("alice")[k].dtype
    assert ours.get("alice")["text"] == "hi" and ours.speakers() == ["alice"]
    fe = types.SimpleNamespace(**vars(pipe))
    fe.sample_rate = 16000  # the prompt mel at the clips' rate: no resampling
    fe.speech_tokenizer_fn = lambda w: np.arange(len(w) // 640) % 6561
    fe.spk_embed_fn = lambda w: np.full(12, float(np.abs(w).mean()), np.float32)
    fe.frontend_zero_shot = lambda w, sr=16000: type(pipe).frontend_zero_shot(fe, w, sr)
    clips = [np.sin(np.arange(16000) / (5 + i)).astype(np.float32) * (i + 1) for i in range(2)]
    lib = voices.CosyVoiceLibrary(str(tmp_path))
    lib.register_from_wav(fe, "one", clips[0], prompt_text="a")
    lib.register_from_wavs(fe, "two", clips, prompt_text="b")
    back = jvoices.CosyVoiceLibrary(str(tmp_path))
    t, m, e = fe.frontend_zero_shot(clips[0])
    np.testing.assert_array_equal(back.get("one")["tokens"], t)
    np.testing.assert_array_equal(back.get("one")["mel"], m)
    np.testing.assert_array_equal(back.get("one")["emb"], e)
    np.testing.assert_allclose(back.get("two")["emb"],
                               np.mean([fe.spk_embed_fn(c) for c in clips], 0), rtol=1e-6)
    assert back.speakers() == ["one", "two"] and back.get("two")["text"] == "b"


def test_cosy_service_http_and_voices(service, tmp_path, pipe, library):
    """CosyTTSService's synthesize and stream; its HTTP routes; the Spark
    service's stream route; the voice library across the packages (one
    test, so that xdist's load-by-file scheduler queues this file behind
    the long few-test files)."""
    _check_synthesize(service)
    _check_http(service)
    _check_spark_stream_501()
    _check_voice_library(tmp_path, pipe, library)


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory, lm):
    """The 64 x 2 Cosy LM (head x 10: both launchers serve in bf16, and the
    greedy gaps stand far above its rounding) as a checkpoint written by the
    JAX package's exporter."""
    jcfg, jtree, _, _ = lm
    d = tmp_path_factory.mktemp("cosy_ckpt")
    return f"{jexport.save_pretrained(jtree, jcfg, str(d), kind='cosy')}/model.safetensors"


def _served(main, http_mod, monkeypatch, argv):
    """The service a launcher's main builds, its HTTP serve stubbed out."""
    box = {}
    monkeypatch.setattr(http_mod, "serve", lambda tts, *a, **k: box.update(tts=tts))
    main(argv)
    return box["tts"]


def _pool_tokens(hub, text, seed):
    """Greedy tokens of one request through the service's hub (its pump
    thread), without the flow."""
    import queue

    q = queue.Queue()
    with hub._lock:
        rid = hub.batcher.add_request(_prompt(text), 12, min_new_tokens=4, seed=seed)
        hub._sinks[rid] = q
    hub._wake.set()
    out, done = [], False
    while not done:
        new, done, err = q.get(timeout=300)
        assert err is None
        out += list(np.asarray(new))
    return out


def test_launcher_serves_the_jax_launchers_greedy_tokens(jax_ckpt, monkeypatch, tmp_path):
    """launch.main --family cosy --device cpu and the JAX launcher's main on
    one checkpoint: the services' pools give the same greedy tokens (the
    port's RAS fallback fed the JAX pool's draws); --sfm without an SFM
    flow is refused at boot."""
    monkeypatch.setattr("rwkvtts_tpu.utils.tokenizer.get_world_tokenizer",
                        lambda n_spct=0: FakeTok())
    monkeypatch.setattr("rwkvtts_torch.utils.tokenizer.get_world_tokenizer",
                        lambda n_spct=0: FakeTok())
    argv = ["--family", "cosy", "--ckpt", jax_ckpt, "--n-slots", "2", "--chunk", "4",
            "--top-k", "1", "--no-warmup", "--voices-dir", str(tmp_path)]
    theirs = _served(jlaunch.main, jhttp, monkeypatch, argv)
    ours = _served(launch.main, http_server, monkeypatch, argv + ["--device", "cpu"])
    try:
        assert isinstance(ours, svc.CosyTTSService) and ours.hub.batcher.top_k == 1
        assert ours.hub.batcher.device.type == "cpu" and ours.voices is not None
        ours.hub.batcher.noise = jax_noise
        want = _pool_tokens(theirs.hub, "hello", 7)
        assert _pool_tokens(ours.hub, "hello", 7) == want and 4 <= len(want) <= 12
    finally:
        theirs.close()
        ours.close()
    with pytest.raises(SystemExit, match="sfm"):
        launch.main(argv + ["--device", "cpu", "--sfm"])
