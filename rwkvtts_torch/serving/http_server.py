"""HTTP TTS service on the stdlib ThreadingHTTPServer (counterpart of
rwkvtts_tpu/serving/http_server.py).

Endpoints:
  POST /api/rwkv_tts   {text, speaker? | global_tokens:[int]* | audio (b64
                       wav) + prompt_text?, seed?, temperature?, top_p?,
                       max_new_tokens?, audio_format? wav | mp3} -> audio/wav
                       or audio/mpeg (mp3 through the system's libmp3lame;
                       501 where it is absent)
  POST /api/rwkv_tts_instruct  {text, properties: {age, gender, emotion,
                       pitch, speed}, seed?, ...} -> audio/wav (a voice
                       designed from the properties)
  POST /api/rwkv_tts_stream  {text, speaker? | audio (b64 wav), prompt_text?,
                       seed?, hop_tokens?} -> a chunked WAV: a header of open
                       length, then PCM16 chunks as they decode, always ended
                       by the 0-chunk (501 for a service without streaming)
  POST /api/voice_design {properties, name?, seed?, global_tokens?} ->
                       {"global_tokens": [32 ids], "name"}; with name and
                       global_tokens it saves that designed voice as is
  GET  /api/speakers   -> {"speakers": [...]}
  GET  /api/properties -> the SPCT dropdown vocabularies
  GET  /api/stats      -> engine counters (occupancy, chunk / admit / host
                       seconds, chunk ms a step, queue)
  GET  /, /demo        -> the voice-design studio page
  GET  /health
Handler threads queue requests and wait; the Spark service's worker thread
alone runs the model (voice design runs on the handler's thread, as in the
JAX server). A stream runs its flow and HiFT hops on its handler's thread.
"""
from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict

import numpy as np

from rwkvtts_torch.serving import service as svc

log = logging.getLogger("rwkvtts_torch.serving")

# The built-in voice-design studio (a web form for the reference's desktop
# GUI, gradio/tts_gui_simple.py: SPCT property controls -> design a voice ->
# save it as a named speaker -> synthesize; zero-shot prompt upload); a
# copy of the JAX server's page.
DEMO_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>RWKV TTS Studio (GPU)</title>
<style>
body{font-family:system-ui;max-width:880px;margin:32px auto;padding:0 16px;color:#222}
textarea{width:100%;height:90px;font-size:15px;box-sizing:border-box}
select,button,input[type=text],input[type=number]{font-size:14px;padding:5px 10px;margin:4px 4px 4px 0}
fieldset{border:1px solid #ccc;border-radius:6px;margin:12px 0;padding:10px}
legend{font-weight:600}
button.primary{background:#2563eb;color:#fff;border:none;border-radius:5px;padding:8px 18px;cursor:pointer}
button.primary:disabled{background:#9ca3af}
#status{color:#666;margin-left:8px}
#tokens{font-family:ui-monospace,monospace;font-size:12px;color:#444;word-break:break-all;background:#f5f5f5;padding:6px;border-radius:4px;min-height:1em}
#langinfo{color:#888;font-size:13px}
#history div{margin:6px 0}
.row{display:flex;gap:16px;flex-wrap:wrap}
.col{flex:1;min-width:320px}
</style></head><body>
<h2>RWKV TTS Studio — GPU service</h2>
<textarea id="text" placeholder="Text to speak…">今天天气不错。</textarea>
<div id="langinfo"></div>
<div class="row"><div class="col">
<fieldset><legend>Voice</legend>
<label>Speaker <select id="speaker"><option value="">(use properties / designed voice)</option></select></label>
<div id="propctl"></div>
</fieldset>
<fieldset><legend>Voice designer</legend>
<p style="margin:4px 0;color:#666">Design 32 global speaker tokens from the
properties above, audition, then save under a name.</p>
<button onclick="design()">Design voice</button>
<input type="text" id="voicename" placeholder="speaker name">
<button onclick="saveVoice()">Save as speaker</button>
<div id="tokens"></div>
</fieldset>
<fieldset><legend>Zero-shot prompt</legend>
<input type="file" id="promptwav" accept=".wav">
<input type="text" id="prompttext" placeholder="prompt transcript (optional)">
</fieldset>
</div><div class="col">
<fieldset><legend>Generation</legend>
<label>temperature <input type="number" id="temperature" value="1.0" step="0.05" style="width:70px"></label>
<label>top_k <input type="number" id="top_k" value="50" style="width:60px"></label>
<label>top_p <input type="number" id="top_p" value="0.95" step="0.01" style="width:70px"></label>
<label>seed <input type="number" id="seed" value="0" style="width:70px"></label>
</fieldset>
<button class="primary" id="speakbtn" onclick="speak()">Speak</button><span id="status"></span>
<audio id="player" controls style="width:100%;margin-top:12px"></audio>
<fieldset><legend>History</legend><div id="history"></div></fieldset>
</div></div>
<script>
let designedTokens=null;
const $=id=>document.getElementById(id);
fetch('/api/speakers').then(r=>r.json()).then(d=>{
  for(const name of d.speakers){const o=document.createElement('option');o.value=name;o.textContent=name;$('speaker').appendChild(o);}
});
fetch('/api/properties').then(r=>r.json()).then(d=>{
  const ctl=$('propctl');
  for(const k of ['age','gender','emotion','pitch','speed']){
    const lab=document.createElement('label');lab.textContent=k+' ';
    const sel=document.createElement('select');sel.id='prop_'+k;
    for(const v of d[k]){const o=document.createElement('option');o.value=v;o.textContent=v;sel.appendChild(o);}
    const def={age:'youth-adult',gender:'female',emotion:'NEUTRAL',pitch:'medium_pitch',speed:'medium'}[k];
    if(def)sel.value=def;
    lab.appendChild(sel);ctl.appendChild(lab);
  }
});
$('text').addEventListener('input',()=>{
  const t=$('text').value;
  const zh=(t.match(/[\\u4e00-\\u9fff]/g)||[]).length;
  const lang=zh>t.length/4?'zh':'en';
  $('langinfo').textContent='detected language: '+lang+' · '+t.length+' chars';
});
function props(){return{age:$('prop_age').value,gender:$('prop_gender').value,
  emotion:$('prop_emotion').value,pitch:$('prop_pitch').value,speed:$('prop_speed').value};}
async function design(){
  $('status').textContent='designing voice…';
  const r=await fetch('/api/voice_design',{method:'POST',headers:{'Content-Type':'application/json'},
    body:JSON.stringify({properties:props(),seed:+$('seed').value})});
  if(!r.ok){$('status').textContent='error: '+(await r.text());return;}
  const d=await r.json();designedTokens=d.global_tokens;
  $('tokens').textContent=designedTokens.join(' ');
  $('status').textContent='voice designed ('+designedTokens.length+' tokens)';
}
async function saveVoice(){
  const name=$('voicename').value.trim();
  if(!name||!designedTokens){$('status').textContent='design a voice and enter a name first';return;}
  const r=await fetch('/api/voice_design',{method:'POST',headers:{'Content-Type':'application/json'},
    body:JSON.stringify({properties:props(),name:name,global_tokens:designedTokens})});
  if(!r.ok){$('status').textContent='error: '+(await r.text());return;}
  const o=document.createElement('option');o.value=name;o.textContent=name;$('speaker').appendChild(o);
  $('speaker').value=name;$('status').textContent='saved speaker "'+name+'"';
}
async function speak(){
  $('speakbtn').disabled=true;$('status').textContent='synthesizing…';
  const t0=performance.now();
  const text=$('text').value;
  const gen={seed:+$('seed').value,temperature:+$('temperature').value,
    top_k:+$('top_k').value,top_p:+$('top_p').value};
  let url='/api/rwkv_tts', body={text,...gen};
  const speaker=$('speaker').value, f=$('promptwav').files[0];
  if(speaker){body.speaker=speaker;}
  else if(f){body.audio=await fileB64(f);body.prompt_text=$('prompttext').value;}
  else if(designedTokens){body.global_tokens=designedTokens;}
  else{url='/api/rwkv_tts_instruct';body.properties=props();}
  try{
    const r=await fetch(url,{method:'POST',headers:{'Content-Type':'application/json'},body:JSON.stringify(body)});
    if(!r.ok){$('status').textContent='error: '+(await r.text());return;}
    const blob=await r.blob();
    const src=URL.createObjectURL(blob);
    $('player').src=src;$('player').play();
    const dt=((performance.now()-t0)/1000).toFixed(2);
    $('status').textContent='done in '+dt+'s';
    const h=document.createElement('div');
    const a=document.createElement('a');a.href=src;a.download='tts.wav';a.textContent='⬇';
    h.appendChild(document.createTextNode((speaker||'designed')+': '+text.slice(0,48)+' ('+dt+'s) '));
    h.appendChild(a);$('history').prepend(h);
  } finally {$('speakbtn').disabled=false;}
}
function fileB64(f){return new Promise((res,rej)=>{const rd=new FileReader();
  rd.onload=()=>res(rd.result.split(',')[1]);rd.onerror=rej;rd.readAsDataURL(f);});}
</script></body></html>
"""


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

        def _audio(self, wav: np.ndarray, sr: int, audio_format: str):
            """The answer's audio in the request's audio_format: wav, or
            mp3 (501 where no mp3 encoder is present)."""
            if audio_format.lower() == "mp3":
                try:
                    body, ctype = svc.mp3_bytes(wav, sr), "audio/mpeg"
                except RuntimeError as e:
                    return self._json(501, {"error": str(e)})
            else:
                body, ctype = svc.wav_bytes(wav, sr), "audio/wav"
            self.send_response(200)
            self.send_header("Content-Type", ctype)
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
            elif self.path in ("/", "/demo"):
                body = DEMO_PAGE.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            try:
                payload = json.loads(self.rfile.read(n) or b"{}")
            except json.JSONDecodeError:
                return self._json(400, {"error": "bad json"})
            if self.path == "/api/voice_design":
                return self._voice_design(payload)
            if self.path == "/api/rwkv_tts_stream":
                return self._stream(payload)
            if self.path not in ("/api/rwkv_tts", "/api/rwkv_tts_instruct"):
                return self._json(404, {"error": "not found"})
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
            self._audio(resp.wav, resp.sample_rate, str(payload.get("audio_format", "wav")))

        def _stream(self, payload):
            text = payload.get("text")
            if not text:
                return self._json(400, {"error": "missing text"})
            try:
                req = svc.TTSRequest(
                    text=text, seed=int(payload.get("seed", 0)),
                    prompt_text=payload.get("prompt_text"), speaker=payload.get("speaker"),
                    temperature=float(payload.get("temperature", 1.0)),
                    top_k=int(payload.get("top_k", 25)), top_p=float(payload.get("top_p", 0.8)))
                if payload.get("audio"):
                    req.prompt_wav = svc.decode_audio_b64(payload["audio"])
                gen = tts.stream(req, hop_tokens=int(payload.get("hop_tokens", 50)))
                first = next(gen, None)
            except NotImplementedError:
                return self._json(501, {"error": "no streaming pipeline"})
            except ValueError as e:
                return self._json(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — the server must answer
                log.exception("stream failed before its first chunk")
                return self._json(500, {"error": str(e)})
            # a chunked WAV: a header of open length, then PCM16 chunks as
            # the LM and the flow produce them
            sr = getattr(tts.pipeline, "sample_rate", 24000)
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def chunk(b: bytes):
                self.wfile.write(f"{len(b):x}\r\n".encode() + b + b"\r\n")

            # after the headers a failure can no longer be an HTTP error:
            # always end with the 0-chunk, so a keep-alive client does not
            # wait for its timeout
            try:
                chunk(svc.stream_wav_header(sr))
                if first is not None:
                    chunk(svc.pcm16(first))
                for wav in gen:
                    chunk(svc.pcm16(wav))
            finally:
                try:
                    self.wfile.write(b"0\r\n\r\n")
                except OSError:
                    self.close_connection = True

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
