"""Serving launcher: checkpoint -> pipeline -> ContinuousTTSService -> HTTP
(counterpart of rwkvtts_tpu/serving/launch.py, the Spark family).

Loads an RWKV7ForSpeech checkpoint (HF safetensors, torch .pt, BlinkDL
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
0.95. Without --codec-dir the answers carry no audio. Not ported yet:
int4, --family cosy and --dp.
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


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ckpt", required=True, help="RWKV7ForSpeech weights")
    ap.add_argument("--family", default="spark", choices=["spark", "cosy"])
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
    ap.add_argument("--int4", action="store_true", help="int4 decode weights (not ported)")
    ap.add_argument("--state-bf16", action="store_true", help="bf16 WKV state carry")
    ap.add_argument("--max-new-tokens", type=int, default=1024)
    # resolved per family by sampling_defaults when not given
    ap.add_argument("--top-k", type=int, default=None)
    ap.add_argument("--top-p", type=float, default=None)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--grouped", action="store_true",
                    help="same-voice grouping dispatcher instead of the slot pool")
    ap.add_argument("--dp", type=int, default=1, help="slot pool over dp devices (not ported)")
    ap.add_argument("--overlap", action="store_true",
                    help="dispatch chunk N+1 before reading chunk N's tokens")
    ap.add_argument("--no-warmup", action="store_true")
    ap.add_argument("--warmup-widths", default=None,
                    help="comma-separated prompt widths to run at boot (default: prompt cap)")
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


def main(argv=None):
    args = _parser().parse_args(argv)
    top_k, top_p = sampling_defaults(args.family, args.top_k, args.top_p)
    if args.family == "cosy":
        raise SystemExit("--family cosy waits for serving/cosy_pool.py, which is not ported yet")
    if args.grouped and args.mega:
        raise SystemExit("--grouped decodes through the pipeline, not the B=64 pool: "
                         "drop --mega")
    if args.dp > 1:
        raise SystemExit("--dp: a slot pool over several devices is not ported yet")
    if args.int4:
        raise SystemExit("--int4: int4 decode weights are not ported yet")
    if args.mega and args.int8:
        raise SystemExit("--mega streams its own int8 weights; --int8 (the fused "
                         "projections' int8 form) does not apply: drop one of them")
    logging.basicConfig(level=logging.INFO)
    n_slots, packed = args.n_slots, not args.no_packed_wkv
    if args.mega:
        packed = False  # the mega pool never runs rwkv7.decode_step
        if n_slots != 64:
            log.info("--mega: n_slots %d -> 64 (the B=64 decode step)", n_slots)
            n_slots = 64
    pipeline = build_pipeline(
        args.ckpt, args.codec_dir, packed_wkv=packed, int8=args.int8,
        state_bf16=args.state_bf16, fuse_projections=not args.mega, device=args.device,
    )
    tts = build_service(
        pipeline, args.demo_dir, continuous=not args.grouped, n_slots=n_slots, chunk=args.chunk,
        max_new_tokens=args.max_new_tokens, top_k=top_k, top_p=top_p,
        temperature=args.temperature, warmup=not args.no_warmup,
        warmup_widths=([int(w) for w in args.warmup_widths.split(",")]
                       if args.warmup_widths else None),
        overlap=args.overlap, megakernel=args.mega,
    )
    from rwkvtts_torch.serving import http_server

    http_server.serve(tts, args.host, args.port)


if __name__ == "__main__":
    main()
