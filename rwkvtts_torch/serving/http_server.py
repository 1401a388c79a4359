"""HTTP TTS service on the stdlib ThreadingHTTPServer (counterpart of
rwkvtts_tpu/serving/http_server.py).

Ported endpoints:
  POST /api/rwkv_tts   {text, speaker? | global_tokens:[int]* | audio (b64
                       wav) + prompt_text?, seed?, temperature?, top_p?,
                       max_new_tokens?} -> audio/wav
  POST /api/rwkv_tts_instruct  {text, properties: {age, gender, emotion,
                       pitch, speed}, seed?, ...} -> audio/wav (a voice
                       designed from the properties)
  POST /api/voice_design {properties, name?, seed?, global_tokens?} ->
                       {"global_tokens": [32 ids], "name"}; with name and
                       global_tokens it saves that designed voice as is
  GET  /api/speakers   -> {"speakers": [...]}
  GET  /api/properties -> the SPCT dropdown vocabularies
  GET  /api/stats      -> engine counters (occupancy, chunk / admit / host
                       seconds, chunk ms a step, queue)
  GET  /health
The others answer 501 with what is not ported yet: the streaming
endpoint, the studio page, mp3 output. Handler threads only queue
requests and wait; the service's worker thread alone runs the model
(voice design runs on the handler's thread, as in the JAX server).
"""
from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict

from rwkvtts_torch.serving import service as svc

log = logging.getLogger("rwkvtts_torch.serving")

_NOT_PORTED = {
    "/api/rwkv_tts_stream": "the streaming endpoint is not ported yet",
    "/": "the voice-design studio page is not ported yet",
    "/demo": "the voice-design studio page is not ported yet",
}


def _make_handler(tts: svc.BatchedTTSService):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            log.info("%s " + fmt, self.client_address[0], *args)

        def _json(self, code: int, obj: Dict[str, Any]):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/api/speakers":
                self._json(200, {"speakers": tts.speakers.speakers()})
            elif self.path == "/api/properties":
                self._json(200, svc.properties_options())
            elif self.path == "/health":
                self._json(200, {"status": "ok"})
            elif self.path == "/api/stats":
                self._json(200, tts.stats())
            elif self.path in _NOT_PORTED:
                self._json(501, {"error": _NOT_PORTED[self.path]})
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            try:
                payload = json.loads(self.rfile.read(n) or b"{}")
            except json.JSONDecodeError:
                return self._json(400, {"error": "bad json"})
            if self.path in _NOT_PORTED:
                return self._json(501, {"error": _NOT_PORTED[self.path]})
            if self.path == "/api/voice_design":
                return self._voice_design(payload)
            if self.path not in ("/api/rwkv_tts", "/api/rwkv_tts_instruct"):
                return self._json(404, {"error": "not found"})
            if str(payload.get("audio_format", "wav")).lower() != "wav":
                return self._json(501, {"error": "only wav output is ported (no mp3 encoder)"})
            text = payload.get("text")
            if not text:
                return self._json(400, {"error": "missing text"})
            try:
                req = svc.TTSRequest(
                    text=text,
                    seed=int(payload.get("seed", 0)),
                    temperature=float(payload.get("temperature", 1.0)),
                    top_k=int(payload.get("top_k", 50)),
                    top_p=float(payload.get("top_p", 0.95)),
                    max_new_tokens=(int(payload["max_new_tokens"])
                                    if payload.get("max_new_tokens") else None),
                )
                if self.path == "/api/rwkv_tts_instruct":
                    req.properties = payload.get("properties", {})
                elif payload.get("speaker"):
                    req.speaker = payload["speaker"]
                elif payload.get("global_tokens"):
                    req.global_tokens = [int(t) for t in payload["global_tokens"]]
                elif payload.get("audio"):
                    req.prompt_wav = svc.decode_audio_b64(payload["audio"])
                    req.prompt_text = payload.get("prompt_text")
                else:
                    return self._json(400, {"error": "need speaker, audio, or global_tokens"})
            except (TypeError, ValueError) as e:
                return self._json(400, {"error": str(e)})
            resp = tts.synthesize(req)
            if resp.error:
                return self._json(500, {"error": resp.error})
            body = svc.wav_bytes(resp.wav, resp.sample_rate)
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _voice_design(self, payload):
            properties = payload.get("properties")
            if not isinstance(properties, dict):
                return self._json(400, {"error": "missing properties"})
            name = payload.get("name")
            try:
                if name and payload.get("global_tokens"):
                    # save a voice designed earlier, as it is
                    tokens = [int(t) for t in payload["global_tokens"]]
                    tts.speakers.register(name, tokens)
                else:
                    tokens = tts.design_voice(properties, name=name,
                                              seed=int(payload.get("seed", 0)))
            except Exception as e:  # noqa: BLE001 — the server must answer
                log.exception("voice design failed")
                return self._json(500, {"error": str(e)})
            return self._json(200, {"global_tokens": tokens, "name": name})

    return Handler


def serve(tts: svc.BatchedTTSService, host: str = "0.0.0.0", port: int = 8000):
    server = ThreadingHTTPServer((host, port), _make_handler(tts))
    log.info("TTS service on %s:%d", host, port)
    server.serve_forever()


def start_background(tts: svc.BatchedTTSService, host="127.0.0.1", port=0):
    """Start the server on a daemon thread; returns (server, port)."""
    server = ThreadingHTTPServer((host, port), _make_handler(tts))
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return server, server.server_address[1]
