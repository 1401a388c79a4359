"""Interactive TTS console over a SparkPipeline (counterpart of
rwkvtts_tpu/serving/interactive_cli.py; the reference's desktop-GUI /
interactive-CLI flows, gradio/tts_gui_simple.py and
test_respark/tts_using_webrwkv_osx.py).

Commands:
    /voice design            pick SPCT properties, draw 32 global tokens
    /voice clone <wav> [txt] tokenize a reference clip (with its text, a
                             zero-shot prompt; without, its global tokens)
    /voice save <name>       keep the current voice under a name
    /voice use <name>        make a kept voice the current one
    /seed N, /save-dir DIR, /quit
    anything else            synthesize it and write a wav

    python -m rwkvtts_torch.serving.interactive_cli --ckpt model.safetensors \\
        --codec-dir Spark-TTS-0.5B [--device cpu] [--save-dir tts_out]

The pipeline comes from ``launch.build_pipeline`` on the CUDA device, or
on the CPU's plain path with ``--device cpu``.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Any, Dict, List, Optional


def _ask(prompt: str, options: List[str]) -> str:
    """One property: an answer among `options`, else the first option."""
    print(f"{prompt} {options} [default {options[0]}]")
    ans = input("> ").strip()
    return ans if ans in options else options[0]


def repl(pipeline, save_dir: str = "tts_out") -> None:
    """The blocking console loop over a SparkPipeline (its ``synthesize``,
    ``design_voice`` and ``codec``), reading stdin until /quit or EOF. Each
    synthesized line is written as tts_NNNN.wav in the save directory."""
    from rwkvtts_torch.serving.service import properties_options
    from rwkvtts_torch.utils import audio_io

    os.makedirs(save_dir, exist_ok=True)
    voices: Dict[str, Dict[str, Any]] = {}
    current: Optional[Dict[str, Any]] = None
    seed, n_written = 0, 0
    print("rwkvtts_torch interactive console: /voice design | /voice clone <wav> | /quit")
    while True:
        try:
            line = input("tts> ").strip()
        except EOFError:
            break
        if not line:
            continue
        if line == "/quit":
            break
        if line.startswith("/seed "):
            seed = int(line.split()[1])
        elif line.startswith("/save-dir "):
            save_dir = line.split(None, 1)[1]
            os.makedirs(save_dir, exist_ok=True)
        elif line == "/voice design":
            props = {k: _ask(k, v) for k, v in properties_options().items()}
            current = {"global_tokens": pipeline.design_voice(props, seed=seed)}
            print(f"designed voice: 32 global tokens {current['global_tokens'][:8]}...")
        elif line.startswith("/voice clone "):
            parts = line.split(None, 3)
            wav = audio_io.load_wav(parts[2], 16000, volume_normalize=True)
            glob, _ = pipeline.codec.tokenize(wav)
            current = {"global_tokens": glob.reshape(-1).tolist(), "prompt_wav": wav,
                       "prompt_text": parts[3] if len(parts) > 3 else None}
            print("cloned voice from", parts[2])
        elif line.startswith("/voice save "):
            if current is None:
                print("no voice selected: /voice design or /voice clone first")
            else:
                voices[line.split()[2]] = current
                print("saved")
        elif line.startswith("/voice use "):
            current = voices.get(line.split()[2], current)
            print("ok" if line.split()[2] in voices else "unknown voice")
        elif line.startswith("/"):
            print(f"unknown command {line.split()[0]}")
        elif current is None:
            print("no voice selected: /voice design or /voice clone first")
        else:
            t0 = time.perf_counter()
            if current.get("prompt_text"):
                res = pipeline.synthesize(line, prompt_wav=current["prompt_wav"],
                                          prompt_text=current["prompt_text"], seed=seed)
            else:
                res = pipeline.synthesize(line, global_tokens=current["global_tokens"], seed=seed)
            path = os.path.join(save_dir, f"tts_{n_written:04d}.wav")
            n_written += 1
            audio_io.save_wav(path, res.wav, res.sample_rate)
            print(f"{path}  ({len(res.wav) / res.sample_rate:.2f} s audio, "
                  f"{time.perf_counter() - t0:.2f} s wall, {res.tokens_per_s:.0f} tok/s)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ckpt", required=True, help="RWKV7ForSpeech weights")
    ap.add_argument("--codec-dir", required=True, help="Spark-TTS model dir (BiCodec)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--save-dir", default="tts_out")
    args = ap.parse_args(argv)
    from rwkvtts_torch.serving import launch

    repl(launch.build_pipeline(args.ckpt, args.codec_dir, device=args.device), args.save_dir)


if __name__ == "__main__":
    main()
