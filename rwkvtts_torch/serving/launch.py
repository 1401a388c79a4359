"""Serving launcher: checkpoint -> pipeline -> service -> HTTP (counterpart
of rwkvtts_tpu/serving/launch.py).

The Spark family (the default) loads an RWKV7ForSpeech checkpoint (HF safetensors, torch .pt, BlinkDL
.pth through convert/rwkv7_ckpt), casts the matrices to bf16, packs the
decode weights, loads the BiCodec codec of a Spark-TTS model directory
(``--codec-dir``: BiCodec/ and wav2vec2-large-xlsr-53/) and serves
/api/rwkv_tts, /api/rwkv_tts_instruct and /api/voice_design from the
continuous batcher on the card (``--grouped``: the same-voice grouping
dispatcher; ``--device cpu`` runs the plain versions instead):

    python -m rwkvtts_torch.serving.launch --ckpt model.safetensors \
        --codec-dir Spark-TTS-0.5B --port 8000

Defaults are the JAX launcher's: 96 slots, 32-step chunks, fused decode
projections, the in-place WKV step with an f32 carry, top-k 50 / top-p
0.95. Without --codec-dir the answers carry no audio.

``--family cosy`` loads an RWKV7CosyLM checkpoint and the CosyVoice2 files
of ``--cosy-dir`` (flow.pt, hift.pt, speech_tokenizer_v2.onnx,
campplus.onnx; a missing file is logged and what it serves is left out)
and serves every request, streaming (/api/rwkv_tts_stream) or not,
through one shared Cosy slot pool (serving/cosy_pool.py), RAS top-k 25 /
top-p 0.8; ``--voices-dir`` holds stored zero-shot voices
(infer/voices.py); ``--sfm --flow-timesteps N --stream-ctx N
--vocode-every K`` set the streaming hops' flow and vocoder levers for
every stream:

    python -m rwkvtts_torch.serving.launch --family cosy --ckpt cosy_lm.safetensors \
        --cosy-dir CosyVoice2-0.5B --voices-dir voices --n-slots 8 --chunk 16

``--int8`` / ``--int4`` store the decode weights (the fused projections,
the output and the FFN matrices) as per-channel int8 / group-wise int4
(``rwkv7.pack_decode_params``) for either family; the pools decode them
through ``rwkv7.decode_step``. ``--mega`` streams its own int8 pack and
refuses both.

``--dp N`` splits the Spark slot pool into N groups, one a card
(cuda:0 .. cuda:N-1, each with its own copy of the weights;
serving/continuous.py); more than the cards present, ``--mega``, the
grouped dispatcher and the Cosy family refuse it. One host thread issues
every group's steps and the eager pool step is bound by the host, so N
groups do not raise tok/s until the step is captured (PERF.md).
"""
from __future__ import annotations

import argparse
import logging
from typing import Optional, Tuple

import torch

log = logging.getLogger("rwkvtts_torch")


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device 'cpu' (--device cpu) to serve "
                           "on the CPU's plain path")
    return dev


def build_pipeline(ckpt: str, codec_dir: Optional[str] = None, packed_wkv: bool = True,
                   int8: bool = False, int4: bool = False, state_bf16: bool = False,
                   fuse_projections: bool = True, device="cuda"):
    """Checkpoint -> SparkPipeline on `device`: every parameter with two or
    more dimensions in bf16, the rest as stored (f32)."""
    from rwkvtts_torch import bridge
    from rwkvtts_torch.convert import rwkv7_ckpt, speech_init
    from rwkvtts_torch.infer.spark_pipeline import SparkPipeline
    from rwkvtts_torch.models import rwkv7, spark
    from rwkvtts_torch.utils import tokenizer

    dev = _device(device)
    sd = rwkv7_ckpt.load_torch_or_safetensors(ckpt)
    kw = rwkv7_ckpt.infer_config_kwargs(sd)
    cfg = spark.default_config(
        hidden_size=kw["hidden_size"], num_layers=kw["num_layers"],
        head_size=kw["head_size"], decode_wkv_packed=packed_wkv,
        decode_state_bf16=state_bf16,
    )
    params = bridge.params_from_numpy(speech_init.spark_from_pretrained_sd(sd, cfg), dev)
    del sd
    params = rwkv7.tree_map(lambda t: t.to(torch.bfloat16) if t.dim() >= 2 else t, params)
    codec = None
    if codec_dir:
        from rwkvtts_torch.codecs.spark_tokenizer import SparkAudioTokenizer

        codec = SparkAudioTokenizer.from_pretrained(codec_dir, device=dev)
    tok = tokenizer.get_world_tokenizer(n_spct=48)
    return SparkPipeline(cfg, params, tok, audio_tokenizer=codec, quantize_int8=int8,
                         quantize_int4=int4, fuse_projections=fuse_projections)


def build_service(pipeline, demo_dir: Optional[str] = None, continuous: bool = True,
                  n_slots: int = 96, chunk: int = 32, max_new_tokens: int = 1024,
                  top_k: int = 50, top_p: float = 0.95, temperature: float = 1.0,
                  warmup: bool = True, warmup_widths=None, dp: int = 1,
                  overlap: bool = False, megakernel: bool = False):
    from rwkvtts_torch.serving import service as svc

    speakers = svc.SpeakerLibrary(demo_dir, codec=pipeline.codec)
    if not continuous:
        return svc.BatchedTTSService(pipeline, speakers, max_new_tokens=max_new_tokens)
    return svc.ContinuousTTSService(
        pipeline, speakers, n_slots=n_slots, chunk=chunk, max_new_tokens=max_new_tokens,
        top_k=top_k, top_p=top_p, temperature=temperature, warmup=warmup,
        warmup_widths=warmup_widths, dp=dp, overlap=overlap, megakernel=megakernel,
    )


_COSY_FILES = ("flow.pt", "hift.pt", "speech_tokenizer_v2.onnx", "campplus.onnx")


def cosy_pipeline(cfg, params, device="cuda", int8: bool = False, int4: bool = False,
                  **codecs):
    """The server's CosyPipeline of a Cosy LM's parameter tree on `device`:
    every parameter with two or more dimensions in bf16, the rest as
    given; the LM decodes through ``rwkv7.decode_step`` on the fused decode
    weights, in bf16 or as int8 / int4, the slot pool's route (no B=1
    kernel pack). `codecs` are CosyPipeline's flow / HiFT / S3 / CAM++
    keywords."""
    from rwkvtts_torch.infer.cosy_pipeline import CosyPipeline
    from rwkvtts_torch.models import rwkv7
    from rwkvtts_torch.utils import tokenizer

    dev = _device(device)
    params = rwkv7.tree_map(lambda t: t.to(dev, torch.bfloat16 if t.dim() >= 2 else t.dtype),
                            params)
    return CosyPipeline(cfg, params, tokenizer.get_world_tokenizer(), quantize_int8=int8,
                        quantize_int4=int4, decode_megakernel=False, device=dev, **codecs)


def build_cosy_pipeline(ckpt: str, cosy_dir: Optional[str] = None, int8: bool = False,
                        int4: bool = False, device="cuda"):
    """RWKV7CosyLM weights + a CosyVoice2 model directory (the reference's
    pretrained_models layout) -> ``cosy_pipeline`` on `device`, its decode
    weights in int8 / int4 where asked. A missing
    codec file is logged and its part left out: the LM still serves,
    zero-shot from a wav needs the two ONNX files, wav output the flow and
    HiFT."""
    import os

    from rwkvtts_torch import bridge
    from rwkvtts_torch.codecs import campplus as cp
    from rwkvtts_torch.codecs import cosy_import
    from rwkvtts_torch.codecs import flow as flow_lib
    from rwkvtts_torch.codecs import hift as hift_lib
    from rwkvtts_torch.codecs import s3_tokenizer as s3
    from rwkvtts_torch.convert import rwkv7_ckpt, speech_init
    from rwkvtts_torch.models import cosy

    dev = _device(device)
    sd = rwkv7_ckpt.load_torch_or_safetensors(ckpt)
    kw = rwkv7_ckpt.infer_config_kwargs(sd)
    cfg = cosy.default_config(hidden_size=kw["hidden_size"], num_layers=kw["num_layers"],
                              head_size=kw["head_size"])
    params = bridge.params_from_numpy(speech_init.cosy_from_pretrained_sd(sd, cfg), dev)
    del sd
    pk = {}
    if cosy_dir:
        path = lambda n: os.path.join(cosy_dir, n)
        if os.path.exists(path("flow.pt")):
            # an SFM checkpoint's head is read too (sfm_head.*)
            fcfg = flow_lib.FlowConfig(sfm=True)
            pk.update(flow_cfg=fcfg, flow_params=cosy_import.load_flow(path("flow.pt"), fcfg, dev))
        if os.path.exists(path("hift.pt")):
            hcfg = hift_lib.HiFTConfig()
            pk.update(hift_cfg=hcfg, hift_params=cosy_import.load_hift(path("hift.pt"), hcfg, dev))
        if os.path.exists(path("speech_tokenizer_v2.onnx")):
            s3_cfg = s3.S3TokenizerConfig()
            pk.update(s3_cfg=s3_cfg,
                      s3_params=s3.s3_from_onnx(path("speech_tokenizer_v2.onnx"), s3_cfg, dev))
        if os.path.exists(path("campplus.onnx")):
            cam_cfg = cp.CampplusConfig()
            pk.update(campplus_cfg=cam_cfg,
                      campplus_params=cp.load_campplus_onnx(path("campplus.onnx"), cam_cfg, dev))
        missing = [n for n in _COSY_FILES if not os.path.exists(path(n))]
        if missing:
            log.warning("cosy dir %s misses %s: serving without what they give", cosy_dir,
                        missing)
    return cosy_pipeline(cfg, params, dev, int8=int8, int4=int4, **pk)


def stream_config(sfm: bool = False, flow_timesteps: Optional[int] = None,
                  stream_ctx: Optional[int] = None, vocode_every: int = 1):
    """The hub-wide StreamConfig of the four streaming levers, or None when
    none is set (every stream then takes the defaults)."""
    from rwkvtts_torch.infer import streaming

    if not sfm and flow_timesteps is None and stream_ctx is None and vocode_every == 1:
        return None
    kw = {"sfm": sfm, "vocode_every": vocode_every}
    if flow_timesteps is not None:
        kw["n_timesteps"] = flow_timesteps
    if stream_ctx is not None:
        kw["ctx_tokens"] = stream_ctx
    return streaming.StreamConfig(**kw)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ckpt", required=True, help="RWKV7ForSpeech weights")
    ap.add_argument("--family", default="spark", choices=["spark", "cosy"],
                    help="spark: BiCodec voice-in-prompt serving (default); cosy: CosyVoice2 "
                         "zero-shot serving, every request through one streaming slot pool")
    ap.add_argument("--cosy-dir", default=None,
                    help="CosyVoice2 model dir (flow.pt / hift.pt / speech_tokenizer_v2.onnx / "
                         "campplus.onnx)")
    ap.add_argument("--voices-dir", default=None,
                    help="stored zero-shot voice library dir (cosy family)")
    ap.add_argument("--codec-dir", default=None, help="Spark-TTS model dir (BiCodec)")
    ap.add_argument("--demo-dir", default=None, help="demos/<speaker>/*.wav library")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--n-slots", type=int, default=96)
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--no-packed-wkv", action="store_true",
                    help="a fresh WKV state buffer every step instead of the in-place step")
    ap.add_argument("--mega", action="store_true",
                    help="B=64 whole-step decode pool (int8 weight stream of its own, "
                         "bf16 state; forces 64 slots)")
    ap.add_argument("--int8", action="store_true", help="int8 decode weights")
    ap.add_argument("--int4", action="store_true",
                    help="int4 decode weights (group-wise, 64 input rows a scale)")
    ap.add_argument("--state-bf16", action="store_true", help="bf16 WKV state carry")
    ap.add_argument("--max-new-tokens", type=int, default=1024)
    # resolved per family by sampling_defaults when not given
    ap.add_argument("--top-k", type=int, default=None)
    ap.add_argument("--top-p", type=float, default=None)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--grouped", action="store_true",
                    help="same-voice grouping dispatcher instead of the slot pool")
    ap.add_argument("--dp", type=int, default=1,
                    help="slot pool in dp groups, one a card (n-slots must divide); the "
                         "eager step is host-bound, so more groups do not raise tok/s yet")
    ap.add_argument("--overlap", action="store_true",
                    help="dispatch chunk N+1 before reading chunk N's tokens")
    ap.add_argument("--no-warmup", action="store_true")
    ap.add_argument("--warmup-widths", default=None,
                    help="comma-separated prompt widths to run at boot (default: prompt cap)")
    ap.add_argument("--sfm", action="store_true",
                    help="(cosy) SFM fast flow decode in the streaming hops; needs an sfm_head "
                         "in flow.pt")
    ap.add_argument("--flow-timesteps", type=int, default=None,
                    help="(cosy) ODE steps a streaming flow hop (default 10; ~5 with --sfm)")
    ap.add_argument("--stream-ctx", type=int, default=None,
                    help="(cosy) generated-token context in the flow window")
    ap.add_argument("--vocode-every", type=int, default=1,
                    help="(cosy) hops a HiFT call after the first chunk")
    return ap


# the sampling each family ships with (the JAX launcher's): Spark top-k 50 /
# top-p 0.95, Cosy's RAS top-k 25 / top-p 0.8
_SAMPLING = {"spark": (50, 0.95), "cosy": (25, 0.8)}


def sampling_defaults(family: str, top_k: Optional[int] = None,
                      top_p: Optional[float] = None) -> Tuple[int, float]:
    """top-k and top-p for a family: the flags where given, else the
    family's own."""
    k, p = _SAMPLING[family]
    return (k if top_k is None else top_k, p if top_p is None else top_p)


def _widths(arg: Optional[str]):
    return [int(w) for w in arg.split(",")] if arg else None


def main_cosy(args, top_k: int, top_p: float):
    """The cosy branch of main: the pipeline, the voice library, the
    streaming levers, CosyTTSService over one slot pool, HTTP."""
    if args.mega:
        raise SystemExit("--mega is a spark-family pool (64 slots); the cosy hub runs its "
                         "own slot pool: drop --mega")
    logging.basicConfig(level=logging.INFO)
    from rwkvtts_torch.serving import http_server
    from rwkvtts_torch.serving import service as svc

    pipeline = build_cosy_pipeline(args.ckpt, args.cosy_dir, int8=args.int8, int4=args.int4,
                                   device=args.device)
    if args.sfm and (pipeline.flow_params is None or "sfm_head" not in pipeline.flow_params):
        raise SystemExit("--sfm needs an SFM flow: flow.pt in --cosy-dir has no sfm_head")
    voices = None
    if args.voices_dir:
        from rwkvtts_torch.infer.voices import CosyVoiceLibrary

        voices = CosyVoiceLibrary(args.voices_dir)
    tts = svc.CosyTTSService(
        pipeline, voices=voices, n_slots=args.n_slots, chunk=args.chunk,
        max_new_tokens=args.max_new_tokens, top_k=top_k, top_p=top_p,
        warmup=not args.no_warmup, warmup_widths=_widths(args.warmup_widths),
        overlap=args.overlap,
        stream_cfg=stream_config(args.sfm, args.flow_timesteps, args.stream_ctx,
                                 args.vocode_every))
    http_server.serve(tts, args.host, args.port)


def main(argv=None):
    args = _parser().parse_args(argv)
    top_k, top_p = sampling_defaults(args.family, args.top_k, args.top_p)
    if args.dp > 1:
        if args.family == "cosy" or args.grouped or args.mega:
            raise SystemExit("--dp splits the Spark slot pool: not with --family cosy, "
                             "--grouped or --mega (single-device)")
        have = torch.cuda.device_count() if torch.device(args.device).type == "cuda" else 0
        if args.device != "cpu" and args.dp > have:
            raise SystemExit(f"--dp {args.dp}: {have} CUDA devices present")
        if args.n_slots % args.dp:
            raise SystemExit(f"--dp {args.dp}: --n-slots {args.n_slots} must divide by it")
    if args.int8 and args.int4:
        raise SystemExit("--int8 and --int4 are exclusive: drop one of them")
    if args.family == "cosy":
        return main_cosy(args, top_k, top_p)
    if args.grouped and args.mega:
        raise SystemExit("--grouped decodes through the pipeline, not the B=64 pool: "
                         "drop --mega")
    if args.mega and (args.int8 or args.int4):
        raise SystemExit("--mega streams its own int8 weights; --int8 / --int4 (the fused "
                         "projections' int8 / int4 forms) do not apply: drop one of them")
    logging.basicConfig(level=logging.INFO)
    n_slots, packed = args.n_slots, not args.no_packed_wkv
    if args.mega:
        packed = False  # the mega pool never runs rwkv7.decode_step
        if n_slots != 64:
            log.info("--mega: n_slots %d -> 64 (the B=64 decode step)", n_slots)
            n_slots = 64
    pipeline = build_pipeline(
        args.ckpt, args.codec_dir, packed_wkv=packed, int8=args.int8, int4=args.int4,
        state_bf16=args.state_bf16, fuse_projections=not args.mega, device=args.device,
    )
    tts = build_service(
        pipeline, args.demo_dir, continuous=not args.grouped, n_slots=n_slots, chunk=args.chunk,
        max_new_tokens=args.max_new_tokens, top_k=top_k, top_p=top_p,
        temperature=args.temperature, warmup=not args.no_warmup,
        warmup_widths=_widths(args.warmup_widths), dp=args.dp, overlap=args.overlap,
        megakernel=args.mega,
    )
    from rwkvtts_torch.serving import http_server

    http_server.serve(tts, args.host, args.port)


if __name__ == "__main__":
    main()
