"""End-to-end WER ranking demonstration (counterpart of
rwkvtts_tpu/eval/ranking_demo.py): the seed-eval loop tells a trained TTS
system from an untrained one.

No trained BiCodec or Whisper weights are in the repository, so an
absolute WER on real speech cannot be measured. What the reference's eval
is for (its eval/run_wer.py:21-28 ranks trained systems) can be shown: the
whole synthesize -> wav -> transcribe -> WER path is sound and monotone,
a model that learned the corpus scoring a far lower WER than an untrained
control through the same harness.

Every stage is the port's own component, at a tiny size:
  * a deterministic invertible codec (the "sine codec": each semantic token
    is one 20 ms sine frame, tokenize = the rfft argmax) stands in for
    BiCodec, so the tokens survive a wav round trip on disk;
  * the Spark LM (models/spark.py) is trained text -> semantic tokens with
    the port's collator, train step and AdamW, and synthesizes through
    ``generate.spark_generate`` at top-k 1 (the WKV7 forward kernel in the
    prefill, the WKV step kernel in each decode step on a card);
  * the discrete ASR (models/asr.py, variant "discrete") is trained
    wav tokens -> text and transcribes through
    ``seed_tts.evaluate_wer``'s transcription backend;
  * the WER is ``seed_tts.corpus_wer``.
Training runs the fused WKV7 kernel pair on a card, in f32.

Both models are hidden 128 x 2 layers at head size 64, the ASR's audio
adapter 2 layers too (the port's WKV kernels take head size 64 only; the
JAX demo's are 64 x 2 at head size 16, with a 6-layer adapter). It runs on
the card unless ``device="cpu"`` is given (the JAX demo pins itself to the
CPU):

    python -m rwkvtts_torch.eval.ranking_demo [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rwkvtts_torch.data import asr_collator, spark_collator
from rwkvtts_torch.eval import seed_tts
from rwkvtts_torch.infer import generate as gen
from rwkvtts_torch.models import asr as asr_model
from rwkvtts_torch.models import spark
from rwkvtts_torch.parallel import train_step as ts
from rwkvtts_torch.train import optimizer as opt_lib
from rwkvtts_torch.utils import audio_io

SR = 16000
FRAME = 320  # 20 ms -> 50 Hz rfft bins: token t <-> bin (t + BIN0)
BIN0 = 6  # lowest token frequency = 300 Hz
N_CODES = 64
HIDDEN, LAYERS, HEAD = 128, 2, 64


# ---------------------------------------------------------------------------
# Sine codec: deterministic, invertible, survives wav files on disk


def sine_detokenize(tokens: Sequence[int]) -> np.ndarray:
    """tokens -> wav: one pure-tone 20 ms frame a token."""
    n = np.arange(FRAME)
    out = [0.5 * np.sin(2 * np.pi * (BIN0 + int(t)) * 50.0 * n / SR) for t in tokens]
    return np.concatenate(out).astype(np.float32) if out else np.zeros(0, np.float32)


def sine_tokenize(wav: np.ndarray) -> List[int]:
    """wav -> tokens: the rfft argmax of each frame (exact for the codec's
    output)."""
    toks = []
    for i in range(len(wav) // FRAME):
        spec = np.abs(np.fft.rfft(wav[i * FRAME:(i + 1) * FRAME]))
        toks.append(int(np.argmax(spec)) - BIN0)
    return [t for t in toks if 0 <= t < N_CODES]


class CharTok:
    """A reversible character tokenizer, so the ASR's tokens decode to
    text."""

    def encode(self, text: str) -> List[int]:
        return [min(ord(c), 126) + 1 for c in text]

    def decode(self, ids: Sequence[int]) -> str:
        return "".join(chr(i - 1) for i in ids if i > 1)


# ---------------------------------------------------------------------------
# Synthetic corpus: 16 words, each a fixed triple of codec tokens


WORDS = ("cat dog sun moon tree fish bird star rain snow wind fire "
         "rock leaf wave cloud").split()


def word_token_table(seed: int = 7) -> Dict[str, List[int]]:
    rng = np.random.default_rng(seed)
    triples: List[Tuple[int, ...]] = []
    seen = set()
    while len(triples) < len(WORDS):
        t = tuple(rng.integers(0, N_CODES, 3).tolist())
        if t not in seen:
            seen.add(t)
            triples.append(t)
    return {w: list(t) for w, t in zip(WORDS, triples)}


def build_corpus(n_sentences: int = 16, words_per: int = 4, seed: int = 11):
    table = word_token_table()
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n_sentences):
        ws = [WORDS[i] for i in rng.integers(0, len(WORDS), words_per)]
        rows.append({"text": " ".join(ws), "semantic_tokens": [t for w in ws for t in table[w]],
                     "global_tokens": [1, 2, 3, 4]})
    return rows


# ---------------------------------------------------------------------------
# TTS: the Spark LM trained on the corpus


def spark_cfg() -> spark.SparkTTSConfig:
    return spark.default_config(hidden_size=HIDDEN, num_layers=LAYERS, head_size=HEAD,
                                gate_lora=16, dtype=torch.float32, dropout=0.0,
                                wkv_fuse_prep=True)


def tts_batch(rows, device) -> Dict[str, torch.Tensor]:
    """The rows through the plain Spark collator, padded to 64."""
    cfg = spark_cfg()
    b = spark_collator.collate_plain(rows, CharTok(), cfg.eos_token_id, pad_to=64)
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


def _train(cfg, params, batch, loss_fn, steps: int):
    """`steps` AdamW steps (peak LR 3e-3 after 10 warm-up steps, 3e-4 at
    the end) on one batch. Returns (params, per-step losses)."""
    opt = opt_lib.AdamW(params, total_steps=steps, peak_lr=3e-3, final_lr=3e-4,
                        warmup_steps=10)
    state = ts.init_train_state(params, opt)
    step = ts.make_train_step(cfg, opt, loss_fn)
    losses = []
    for _ in range(steps):
        state, m = step(state, batch, None)
        losses.append(m["loss"])
    return state.params, torch.stack(losses).tolist()


def train_tts(rows, steps: int = 400, seed: int = 0, device="cuda", params=None):
    """(cfg, trained params, per-step losses); fresh weights from `seed`
    unless `params` is given."""
    cfg = spark_cfg()
    if params is None:
        params = spark.init_params(torch.Generator(device=device).manual_seed(seed), cfg)
    params, losses = _train(cfg, params, tts_batch(rows, device), ts.spark_loss_fn, steps)
    return cfg, params, losses


def tts_synthesize(params, cfg, text: str, out_path: str, max_tokens: int = 20):
    """text -> semantic tokens at top-k 1 (``spark_generate``) ->
    sine-codec wav file. Returns the tokens."""
    tok = CharTok()
    pb = spark_collator.pad_prompts_left([spark_collator.build_prompt(tok.encode(text),
                                                                       [1, 2, 3, 4])])
    dev = params["head"].device
    toks, lengths = gen.spark_generate(
        params, cfg, *(torch.from_numpy(pb[k]).to(dev)
                       for k in ("tokens", "modality", "attention_mask")),
        max_new_tokens=max_tokens, top_k=1, top_p=1.0, temperature=1.0,
        generator=torch.Generator(device=dev).manual_seed(0))
    n = int(lengths[0])
    sem = [int(t) % N_CODES for t in toks[0, :n].tolist()]
    audio_io.save_wav(out_path, sine_detokenize(sem), SR)
    return sem


# ---------------------------------------------------------------------------
# ASR: the discrete-variant model trained wav tokens -> text


def asr_cfg() -> asr_model.ASRConfig:
    return asr_model.default_config(hidden_size=HIDDEN, num_layers=LAYERS, adapter_layers=LAYERS,
                                    head_size=HEAD, gate_lora=16, variant="discrete",
                                    dtype=torch.float32, wkv_fuse_prep=True)


def asr_batch(rows, tok: CharTok, pad_audio: int = 16, pad_label: int = 32):
    """The discrete variant's numpy batch: each row's semantic tokens
    through a real wav round trip, and its text as char labels + EOS."""
    B = len(rows)
    audio = np.zeros((B, pad_audio), np.int64)
    amask = np.zeros((B, pad_audio), np.int32)
    labels = np.full((B, pad_label), -100, np.int64)
    lmask = np.zeros((B, pad_label), np.int32)
    for i, r in enumerate(rows):
        ids = sine_tokenize(sine_detokenize(r["semantic_tokens"]))
        audio[i, :len(ids)] = ids
        amask[i, :len(ids)] = 1
        lab = tok.encode(r["text"]) + [asr_collator.EOS_ID]
        labels[i, :len(lab)] = lab
        lmask[i, :len(lab)] = 1
    instr = np.asarray(tok.encode(asr_collator.INSTRUCTIONS["en"]), np.int64)
    hints = np.asarray(tok.encode(asr_collator.HINTS), np.int64)
    return {"audio_ids": audio, "audio_mask": amask,
            "text_ids": np.tile(instr[None], (B, 1)),
            "text_mask": np.ones((B, len(instr)), np.int32),
            "hints_ids": np.tile(hints[None], (B, 1)),
            "hints_mask": np.ones((B, len(hints)), np.int32),
            "labels": labels, "labels_mask": lmask}


def train_asr(rows, steps: int = 400, seed: int = 5, device="cuda", params=None):
    """(cfg, trained params, per-step losses); fresh weights from `seed`
    unless `params` is given."""
    cfg = asr_cfg()
    if params is None:
        params = asr_model.init_params(torch.Generator(device=device).manual_seed(seed), cfg)
    batch = {k: torch.from_numpy(v).to(device) for k, v in asr_batch(rows, CharTok()).items()}
    params, losses = _train(cfg, params, batch, ts.asr_loss_fn, steps)
    return cfg, params, losses


def make_transcribe_fn(asr_params, cfg):
    """A wav path -> text backend on the trained ASR: sine-tokenize the wav,
    transcribe greedily, 32 steps."""
    tok, dev = CharTok(), asr_params["llm"]["head"].device

    def fn(wav_path: str) -> str:
        ids = sine_tokenize(audio_io.load_wav(wav_path, SR)) or [0]
        batch = {k: torch.from_numpy(v).to(dev) for k, v in
                 asr_batch([{"text": "", "semantic_tokens": ids}], tok,
                           pad_audio=max(16, len(ids))).items()
                 if k not in ("labels", "labels_mask")}
        toks, lengths = asr_model.transcribe(asr_params, cfg, batch, max_new_tokens=32)
        return tok.decode(toks[0, :int(lengths[0])].tolist())

    return fn


# ---------------------------------------------------------------------------
# The ranking experiment


def run(
    n_sentences: int = 12,
    tts_steps: int = 400,
    asr_steps: int = 400,
    out_dir: Optional[str] = None,
    verbose: bool = True,
    device="cuda",
) -> Dict[str, float]:
    """Train TTS and ASR on the corpus, then the WER of the trained TTS
    and of an untrained control through the same seed-eval path. Returns
    both WERs, both final losses and the wall seconds."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("ranking_demo: no CUDA device; pass device='cpu'")
    t0 = time.perf_counter()
    rows = build_corpus(n_sentences)
    tts_cfg, tts_params, tts_losses = train_tts(rows, steps=tts_steps, device=device)
    a_cfg, asr_params, asr_losses = train_asr(rows, steps=asr_steps, device=device)
    control = spark.init_params(torch.Generator(device=device).manual_seed(99), tts_cfg)
    transcribe = make_transcribe_fn(asr_params, a_cfg)
    out_dir = out_dir or tempfile.mkdtemp(prefix="wer_ranking_")
    os.makedirs(out_dir, exist_ok=True)
    results = {"tts_loss": tts_losses[-1], "asr_loss": asr_losses[-1]}
    for name, params in (("trained", tts_params), ("untrained", control)):
        pairs = []
        for i, r in enumerate(rows):
            path = os.path.join(out_dir, f"{name}_{i}.wav")
            tts_synthesize(params, tts_cfg, r["text"], path,
                           max_tokens=len(r["semantic_tokens"]) + 6)
            pairs.append((path, r["text"]))
        res = seed_tts.evaluate_wer(pairs, "en", transcribe)
        results[name] = res["wer"]
        if verbose:
            print(f"WER({name}) = {res['wer']:.3f}  (S {res['substitutions']:.3f} "
                  f"D {res['deletions']:.3f} I {res['insertions']:.3f}, "
                  f"N={res['n_ref_tokens']})")
    results["seconds"] = time.perf_counter() - t0
    if verbose:
        gap = results["untrained"] - results["trained"]
        print(f"tts final loss {results['tts_loss']:.4f} | asr final loss "
              f"{results['asr_loss']:.4f} | {results['seconds']:.1f} s")
        print(f"ranking gap: {gap:.3f} ({'MONOTONE' if gap > 0.3 else 'NOT SEPARATED'})")
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--sentences", type=int, default=12)
    p.add_argument("--tts-steps", type=int, default=400)
    p.add_argument("--asr-steps", type=int, default=400)
    args = p.parse_args(argv)
    return run(args.sentences, args.tts_steps, args.asr_steps, device=args.device)


if __name__ == "__main__":
    main()
