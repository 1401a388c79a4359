"""Long-form text, phoneme-marked training and the seed-tts eval, port vs
JAX package, on the CPU:

  * the Spark properties collator with phoneme marking (the same batches
    from the same random.Random, padded and packed, over two batches) and
    the train CLI's --mark-phonemes-prob (a dry run; its collator's batches
    equal the JAX CLI's from a fresh module-level Random(0));
  * CosyPipeline.synthesize_long against the JAX pipeline's on the tiny
    pipelines of tests/test_torch_cosy_pipeline.py, the JAX draws fed to the
    port as tests/test_torch_cosy_zero_shot.py feeds them;
  * spark_generate / greedy_spark_generate against JAX's, greedy and on
    JAX's Gumbel noise;
  * every seed_tts function (generate_testset on the tiny pipelines,
    whisper_transcribe_fn on a tiny saved Whisper model) and every sim
    function (fixed embeddings, a tiny CAM++ on shared weights);
  * the ranking demo's codec, corpus and batches, and its first training
    steps' losses at the port's configs against the JAX package's loss
    functions (spark.forward / asr.forward) on the same weights.

Tolerances: token ids, strings, batches and WER numbers exact; wavs
within 1e-3 of their largest sample; speaker embeddings within 1e-4 of
their largest value and cosines within 1e-4; training losses within 1e-5
relative."""
import concurrent.futures
import dataclasses
import json
import os
import random
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkvtts_tpu.codecs import campplus as jcp
from rwkvtts_tpu.codecs import flow as jflow
from rwkvtts_tpu.codecs import hift as jhift
from rwkvtts_tpu.data import spark_collator as jsc
from rwkvtts_tpu.data import text_frontend as jtf
from rwkvtts_tpu.eval import ranking_demo as jrd
from rwkvtts_tpu.eval import seed_tts as jseed
from rwkvtts_tpu.eval import sim as jsim
from rwkvtts_tpu.infer import generate as jgen
from rwkvtts_tpu.models import asr as jasr
from rwkvtts_tpu.models import spark as jspark
from rwkvtts_tpu.train import cli as jcli
from rwkvtts_tpu.train import trainer as jtrainer
from rwkvtts_tpu.utils import tokenizer as jtok
from rwkvtts_torch import bridge
from rwkvtts_torch.codecs import campplus as cp
from rwkvtts_torch.data import spark_collator
from rwkvtts_torch.eval import ranking_demo, seed_tts, sim
from rwkvtts_torch.infer import generate as tgen
from rwkvtts_torch.models import rwkv7, spark
from rwkvtts_torch.parallel import train_step as ts
from rwkvtts_torch.train import cli
from rwkvtts_torch.utils import audio_io, fixtures
from rwkvtts_torch.utils.tokenizer import get_world_tokenizer

from test_torch_cosy_pipeline import CAM_SMALL, FakeTok, _clip, _numpy_params, pipes  # noqa: F401
from test_torch_cosy_zero_shot import _feed_jax_noise, _jax_flow, _jax_hift
from test_torch_spark_generate import _prompt

torch.set_num_threads(2)

# words of the native pronunciation tables: en exception words, zh characters
EN_WORDS = ["the", "world", "people", "water", "music", "station", "quick", "friend"]
ZH_WORDS = ["中国", "人工智能", "语音", "世界", "今天", "天气", "朋友", "学习"]


def _marked_rows(n, seed):
    """Spark properties rows whose texts mix zh and en words of the native
    tables, some mostly zh and some mostly en."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        zh = [ZH_WORDS[j] for j in rng.integers(0, len(ZH_WORDS), 3 + i % 3)]
        en = [EN_WORDS[j] for j in rng.integers(0, len(EN_WORDS), 1 + 2 * (i % 2))]
        text = "".join(zh) + " " + " ".join(en) if i % 2 else " ".join(en) + " " + "".join(zh)
        rows.append({"text": text, "global_tokens": rng.integers(0, 4096, 32).tolist(),
                     "semantic_tokens": rng.integers(0, 8192, 20 + i).tolist(),
                     "age": "youth-adult", "gender": ("female", "male")[i % 2],
                     "emotion": "NEUTRAL", "pitch": float(rng.uniform(100, 260)),
                     "speed": float(rng.uniform(2, 6))})
    return rows


def _equal_batches(a, b, what):
    assert a.keys() == b.keys(), what
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=f"{what} {k}")


@pytest.mark.parametrize("packed", [False, True])
def test_marked_collator_matches_jax(packed):
    """Two batches from one random.Random(3) a side: the same arrays and
    the same draws left in the generator; some texts marked and some not;
    the strict refusal of a character outside the pinyin table, and the
    port's refusal without a generator."""
    jt, tt_ = jtok.get_world_tokenizer(n_spct=64), get_world_tokenizer(n_spct=64)
    rows = _marked_rows(6, 1)
    kw = dict(eos_id=8192, pad_to=1024 if packed else 192, packed=packed, mark_phonemes_prob=0.5)
    rt, rj = random.Random(3), random.Random(3)
    for call in range(2):
        got = spark_collator.collate_with_properties(rows, tt_, rng=rt, **kw)
        _equal_batches(got, jsc.collate_with_properties(rows, jt, rng=rj, **kw), f"batch {call}")
    assert rt.random() == rj.random()
    plain = spark_collator.collate_with_properties(rows, tt_, **dict(kw, mark_phonemes_prob=0.0))
    assert (got["attention_mask"].sum() > plain["attention_mask"].sum())
    assert not np.array_equal(got["tokens"], plain["tokens"]) if packed else True
    bad = [dict(rows[0], text="齉齉齉")]
    for collate, tok in ((spark_collator.collate_with_properties, tt_),
                         (jsc.collate_with_properties, jt)):
        with pytest.raises(RuntimeError, match="outside the native pinyin"):
            collate(bad, tok, rng=random.Random(0), **dict(kw, mark_phonemes_prob=1.0))
    with pytest.raises(ValueError, match="random.Random"):
        spark_collator.collate_with_properties(rows, tt_, **kw)


def test_cli_marks_phonemes(tmp_path, monkeypatch):
    """train.cli --task spark_properties --mark-phonemes-prob 0.5 --dry-run
    on the CPU; its collator's first two batches from --seed 0 equal the
    JAX CLI's from a fresh module-level Random(0) and the host's
    collate_with_properties(rng=random.Random(0)); another task refuses
    the flag."""
    rows = _marked_rows(4, 2)
    path = tmp_path / "rows.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    seen = []
    real = spark_collator.collate_with_properties
    monkeypatch.setattr(spark_collator, "collate_with_properties",
                        lambda rs, *a, **k: seen.append((rs, k)) or real(rs, *a, **k))
    args = ["--data", str(path), "--device", "cpu", "--dry-run", "--hidden", "64", "--layers",
            "1", "--no-bf16", "--batch-size", "2", "--pad-to", "192", "--seed", "0",
            "--run-dir", str(tmp_path / "run"), "--mark-phonemes-prob", "0.5"]
    tr = cli.main(["--task", "spark_properties"] + args)
    assert tr.state.step == 1 and len(seen) == 1
    first_rows, kw = seen[0]
    assert kw["mark_phonemes_prob"] == 0.5
    monkeypatch.setattr(spark_collator, "collate_with_properties", real)
    want = real(first_rows, get_world_tokenizer(n_spct=64), 8192, pad_to=192,
                mark_phonemes_prob=0.5, rng=random.Random(0))
    ns = SimpleNamespace(pad_to=192, packed=False, seed=0, mark_phonemes_prob=0.5)
    ours = cli.build_collate("spark_properties", ns, spark.default_config(hidden_size=64,
                                                                            num_layers=1))
    monkeypatch.setattr(jsc, "_DEFAULT_RNG", random.Random(0))
    theirs = jcli.build_collate("spark_properties", ns,
                                jspark.default_config(hidden_size=64, num_layers=1))
    _equal_batches(ours(first_rows), want, "the CLI's first batch vs the host's")
    _equal_batches(want, theirs(first_rows), "the first batch vs JAX's CLI")
    _equal_batches(ours(rows[2:]), theirs(rows[2:]), "the second batch vs JAX's CLI")
    with pytest.raises(SystemExit):
        cli.main(["--task", "spark"] + args)


def test_synthesize_long_matches_jax(pipes, monkeypatch):
    """A three-sentence text with a number, token_max_n 6 (FakeTok's ids,
    at most 8 a call): JAX's normalized text splits into the same two
    chunks, each synthesized with seed + i: JAX's tokens, its wav within
    1e-3. The port's synthesize_long from the prompt wav runs the frontend
    once and equals the one from the frontend's features, and equals its
    chunks' synthesize calls concatenated."""
    _feed_jax_noise(monkeypatch)
    monkeypatch.setattr(jflow, "inference", _jax_flow)
    monkeypatch.setattr(jhift, "inference", _jax_hift)
    tpipe = pipes["decode_step"]
    clip = _clip(11, 1.2, 16000)
    feats = dict(zip(("prompt_speech_tokens", "prompt_mel", "spk_embedding"),
                     tpipe.frontend_zero_shot(clip)))
    text = "hello there friend. we go at 10 now. ok then."
    kw = dict(prompt_text="a prompt here", seed=5, token_max_n=6, max_new_tokens=12)
    want = pipes["jax"].synthesize_long(text, **feats, **kw)
    got = tpipe.synthesize_long(text, **feats, **kw)
    chunks = jtf.split_paragraph(jtf.basic_normalize(text), FakeTok().encode, token_max_n=6)
    assert got.chunks == chunks == ["hello there friend.", " we go at ten now. ok then."]
    np.testing.assert_array_equal(got.speech_tokens, np.asarray(want.speech_tokens))
    assert got.chunk_tokens == [12, 12] and got.wav.shape == want.wav.shape == (24 * 96,)
    assert np.abs(got.wav - want.wav).max() <= 1e-3 * np.abs(want.wav).max()

    calls = []
    real = tpipe.frontend_zero_shot
    monkeypatch.setattr(tpipe, "frontend_zero_shot", lambda w: calls.append(1) or real(w))
    from_wav = tpipe.synthesize_long(text, prompt_wav=clip, **kw)
    assert len(calls) == 1
    np.testing.assert_array_equal(from_wav.speech_tokens, got.speech_tokens)
    np.testing.assert_array_equal(from_wav.wav, got.wav)
    parts = [tpipe.synthesize(c, kw["prompt_text"], None, seed=5 + i, max_new_tokens=12,
                              **feats) for i, c in enumerate(chunks)]
    np.testing.assert_array_equal(np.concatenate([p.wav for p in parts]), got.wav)


_FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
# JAX's spark_generate, compiled at XLA -O0 (the package jits it at the default level)
_JAX_SPARK_GENERATE = jax.jit(jgen.spark_generate.__wrapped__, compiler_options=_FAST,
                              static_argnames=("cfg", "max_new_tokens", "top_k", "top_p",
                                               "temperature", "eos_id", "min_new_tokens"))


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_spark_generate_matches_jax(mode, monkeypatch):
    """Spark 128 x 2 f32, B = 3 left-padded, 8 new tokens, EOS masked for 2
    steps: greedy_spark_generate against JAX's (the model's tree), and
    spark_generate at top-k 50 / top-p 0.95 on JAX's Gumbel noise (the
    decode-packed tree): the same tokens and lengths, some rows ending
    early."""
    tcfg = spark.default_config(hidden_size=128, num_layers=2, dtype=torch.float32)
    jcfg = jspark.default_config(hidden_size=128, num_layers=2, dtype=jnp.float32, remat=False)
    npp = bridge.params_to_numpy(spark.init_params(torch.Generator().manual_seed(4), tcfg))
    npp["head"] = 10.0 * npp["head"]
    npp["head"][:, tcfg.eos_token_id] *= 4.0  # some rows end early
    tokens, modality, mask = _prompt(3, 16, seed=6)
    jargs = [jax.tree.map(jnp.asarray, npp), jcfg] + [jnp.asarray(a) for a in
                                                      (tokens, modality, mask)]
    targs = [torch.from_numpy(a).long() for a in (tokens, modality, mask)]
    n_new, tp = 8, bridge.params_from_numpy(npp)
    monkeypatch.setattr(jgen, "spark_generate", _JAX_SPARK_GENERATE)  # greedy's too
    if mode == "greedy":
        want, want_len = jgen.greedy_spark_generate(*jargs, max_new_tokens=n_new,
                                                    min_new_tokens=2)
        got, got_len = tgen.greedy_spark_generate(tp, tcfg, *targs, max_new_tokens=n_new,
                                                  min_new_tokens=2)
    else:
        key = jax.random.PRNGKey(9)
        want, want_len = jgen.spark_generate(*jargs[:5], key, max_new_tokens=n_new,
                                             min_new_tokens=2, top_k=50, top_p=0.95)
        noise = np.stack([np.asarray(jax.random.gumbel(k, (3, 50), jnp.float32))
                          for k in jax.random.split(key, n_new)])
        got, got_len = tgen.spark_generate(rwkv7.pack_decode_params(tp, tcfg.backbone), tcfg,
                                           *targs, max_new_tokens=n_new, min_new_tokens=2,
                                           top_k=50, top_p=0.95, noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert (got_len.numpy() >= 2).all() and (got_len.numpy() < n_new).any()


def _texts(seed, n):
    """Pairs of zh / en texts with punctuation, the second a noisy copy of
    the first (substituted, dropped and added tokens)."""
    rng = np.random.default_rng(seed)
    zh, en = list("今天天气很好我们一起去公园散步吧"), "the cat sat on a mat don't stop now".split()
    punct = list("，。！？、：；“”,.!?'\"-") + ["  "]
    out = []
    for i in range(n):
        lang = ("zh", "en")[i % 2]
        vocab = zh if lang == "zh" else en
        ref = [vocab[j] for j in rng.integers(0, len(vocab), rng.integers(0, 12))]
        hyp = [w for w in ref if rng.random() > 0.2]
        for _ in range(rng.integers(0, 3)):
            hyp.insert(int(rng.integers(0, len(hyp) + 1)), vocab[int(rng.integers(0, len(vocab)))])
        join = lambda ws: ("" if lang == "zh" else " ").join(
            w + (punct[int(rng.integers(0, len(punct)))] if rng.random() < 0.3 else "") for w in ws)
        out.append((lang, join(ref), join(hyp).upper() if rng.random() < 0.2 else join(hyp)))
    return out


def test_seed_tts_text_functions_match_jax(tmp_path):
    """normalize_text, edit_ops, wer, corpus_wer, read_meta_lst and
    evaluate_wer on 200 text pairs; equal results (exact)."""
    pairs = _texts(0, 200)
    for lang, ref, hyp in pairs:
        assert seed_tts.normalize_text(ref, lang) == jseed.normalize_text(ref, lang)
        r, h = seed_tts.normalize_text(ref, lang), seed_tts.normalize_text(hyp, lang)
        assert seed_tts.edit_ops(r, h) == jseed.edit_ops(r, h)
        assert dataclasses.asdict(seed_tts.wer(ref, hyp, lang)) == \
            dataclasses.asdict(jseed.wer(ref, hyp, lang))
    for lang in ("zh", "en"):
        sub = [(r, h) for la, r, h in pairs if la == lang]
        assert dataclasses.asdict(seed_tts.corpus_wer(sub, lang)) == \
            dataclasses.asdict(jseed.corpus_wer(sub, lang))
        fake = {f"w{i}.wav": h for i, (_, h) in enumerate(sub)}
        wavs = [(f"w{i}.wav", r) for i, (r, _) in enumerate(sub)]
        assert seed_tts.evaluate_wer(wavs, lang, fake.get) == jseed.evaluate_wer(wavs, lang,
                                                                                fake.get)
    with pytest.raises(NotImplementedError):
        seed_tts.normalize_text("x", "fr")
    meta = tmp_path / "meta.lst"
    meta.write_text("id1|提示文本|prompt-wavs/a.wav|目标文本\n\nid2|p|w.wav|t\n")
    assert [dataclasses.astuple(r) for r in seed_tts.read_meta_lst(str(meta))] == \
        [dataclasses.astuple(r) for r in jseed.read_meta_lst(str(meta))]


def test_generate_testset_matches_jax(pipes, monkeypatch, tmp_path):
    """A zh/meta.lst of two rows with 1.2 s prompt wavs through both tiny
    pipelines (the port fed the JAX draws): the same (id, path) list
    relative to each output directory and each wav within 1e-3 of JAX's
    largest sample."""
    _feed_jax_noise(monkeypatch)
    monkeypatch.setattr(jflow, "inference", _jax_flow)
    monkeypatch.setattr(jhift, "inference", _jax_hift)
    d = tmp_path / "eval" / "zh"
    (d / "prompt-wavs").mkdir(parents=True)
    for i in range(2):
        audio_io.save_wav(str(d / "prompt-wavs" / f"p{i}.wav"), _clip(20 + i, 1.2, 16000), 16000)
    (d / "meta.lst").write_text("u0|a prompt here|prompt-wavs/p0.wav|hello there friend\n"
                                "u1|another prompt|prompt-wavs/p1.wav|good day to you all\n")
    kw = dict(max_new_tokens=12, seed=5)
    want = jseed.generate_testset(pipes["jax"], str(tmp_path / "eval"), "zh",
                                  str(tmp_path / "jax"), **kw)
    got = seed_tts.generate_testset(pipes["decode_step"], str(tmp_path / "eval"), "zh",
                                    str(tmp_path / "port"), **kw)
    rel = lambda res, root: [(u, os.path.relpath(p, root)) for u, p in res]
    assert rel(got, tmp_path / "port") == rel(want, tmp_path / "jax") == [
        ("u0", "zh/u0.wav"), ("u1", "zh/u1.wav")]
    for (_, g), (_, w) in zip(got, want):
        g, w = audio_io.load_wav(g, 24000), audio_io.load_wav(w, 24000)
        assert g.shape == w.shape and np.abs(g - w).max() <= 1e-3 * np.abs(w).max()


def test_transcription_backends_match_jax(tmp_path, monkeypatch):
    """whisper_transcribe_fn on a tiny saved Whisper model (config,
    vocabulary and weights written here) on the CPU: JAX's text for two
    wavs, also through default_transcribe_fn('en'); default_transcribe_fn
    hands zh to the own ASR backend and raises without a backend, as
    JAX's does."""
    monkeypatch.setenv("USE_TF", "0")  # no TensorFlow import under transformers (seconds)
    d = fixtures.write_tiny_whisper(str(tmp_path / "whisper"))
    wavs = []
    for i in range(2):
        wavs.append(str(tmp_path / f"{i}.wav"))
        audio_io.save_wav(wavs[-1], 0.1 * _clip(30 + i, 1.0, 16000), 16000)
    ours = seed_tts.whisper_transcribe_fn(d, "en", device="cpu")
    theirs = jseed.whisper_transcribe_fn(d, "en")
    texts = [ours(w) for w in wavs]
    assert texts == [theirs(w) for w in wavs] and all(isinstance(t, str) for t in texts)
    default = seed_tts.default_transcribe_fn("en", whisper_dir=d, device="cpu")
    assert [default(w) for w in wavs] == texts
    seen = {}
    monkeypatch.setattr(seed_tts, "asr_transcribe_fn",
                        lambda *a, **k: seen.update(args=a, kw=k) or "asr backend")
    assert seed_tts.default_transcribe_fn("zh", asr_params="P", asr_cfg="C",
                                          tokenizer="T") == "asr backend"
    assert seen == {"args": ("P", "C", "T"), "kw": {"lang": "zh"}}
    for mod in (seed_tts, jseed):
        with pytest.raises(ValueError, match="no transcription backend"):
            mod.default_transcribe_fn("zh", whisper_dir=d)


def test_sim_matches_jax(monkeypatch):
    """cosine_sim, evaluate_sim and discriminability on fixed embeddings
    (equal results); campplus_embed_fn on a tiny CAM++ with shared weights
    (embeddings within 1e-4 of the largest value), and the SIM numbers it
    gives within 1e-4."""
    rng = np.random.default_rng(0)
    embs = rng.standard_normal((8, 16)) + 2.0  # a shared direction, as x-vectors have
    wavs = [np.full(4, i, np.float32) for i in range(8)]
    fixed = lambda w: embs[int(w[0])]
    for a, b in ((embs[0], embs[1]), ([1, 0], [0, 1]), ([0, 0], [1, 1]), ([1, 1], [-1, -1])):
        assert sim.cosine_sim(a, b) == jsim.cosine_sim(a, b)
    pairs = [(wavs[i], wavs[i + 1]) for i in range(0, 8, 2)]
    assert dataclasses.asdict(sim.evaluate_sim(pairs, fixed)) == \
        dataclasses.asdict(jsim.evaluate_sim(pairs, fixed))
    assert dataclasses.asdict(sim.evaluate_sim([], fixed)) == \
        dataclasses.asdict(jsim.evaluate_sim([], fixed))
    same, diff = pairs[:2], [(wavs[0], wavs[5]), (wavs[2], wavs[7])]
    assert sim.discriminability(same, diff, fixed) == jsim.discriminability(same, diff, fixed)

    jcfg = jcp.CampplusConfig(**CAM_SMALL)
    npp = _numpy_params(jax.eval_shape(lambda k: jcp.init_params(k, jcfg),
                                       jax.random.PRNGKey(0)), 3)
    monkeypatch.setattr(jcp, "embed_wav", jax.jit(jcp.embed_wav, static_argnums=1))
    theirs = jsim.campplus_embed_fn(npp, jcfg)
    ours = sim.campplus_embed_fn(bridge.codec_params_from_numpy(npp), cp.CampplusConfig(**CAM_SMALL))
    clips = [_clip(40 + i, 1.0, 16000) for i in range(3)]
    for c in clips:
        g, w = ours(c), np.asarray(theirs(c))
        assert g.shape == w.shape == (24,) and np.abs(g - w).max() <= 1e-4 * np.abs(w).max()
    pairs = [(clips[0], clips[1]), (clips[1], clips[2]), (clips[0], clips[0])]
    g, w = sim.evaluate_sim(pairs, ours), jsim.evaluate_sim(pairs, theirs)
    np.testing.assert_allclose(g.per_utt + g.per_utt_centered,
                               w.per_utt + w.per_utt_centered, rtol=0, atol=1e-4)
    assert g.per_utt[2] == pytest.approx(1.0, abs=1e-6)


def test_ranking_demo_pieces_match_jax():
    """The sine codec (its wav and tokens), the char tokenizer, the word
    table, the corpus, the TTS batch and the ASR batch: equal to JAX's."""
    toks = [0, 5, 63, 17, 17, 42]
    np.testing.assert_array_equal(ranking_demo.sine_detokenize(toks), jrd.sine_detokenize(toks))
    wav = ranking_demo.sine_detokenize(toks)
    assert ranking_demo.sine_tokenize(wav) == jrd.sine_tokenize(wav) == toks
    noisy = wav + 0.3 * np.random.default_rng(0).standard_normal(wav.shape).astype(np.float32)
    assert ranking_demo.sine_tokenize(noisy) == jrd.sine_tokenize(noisy)
    text = "cat dog ~ 你"
    assert ranking_demo.CharTok().encode(text) == jrd.CharTok().encode(text)
    ids = list(range(0, 130))
    assert ranking_demo.CharTok().decode(ids) == jrd.CharTok().decode(ids)
    assert ranking_demo.word_token_table() == jrd.word_token_table()
    rows = ranking_demo.build_corpus(8)
    assert rows == jrd.build_corpus(8)
    cfg = ranking_demo.spark_cfg()
    want = jsc.collate_plain(rows, jrd.CharTok(), cfg.eos_token_id, pad_to=64)
    _equal_batches({k: v.numpy() for k, v in ranking_demo.tts_batch(rows, "cpu").items()}, want,
                   "tts batch")
    for kw in ({}, dict(pad_audio=20, pad_label=40)):
        _equal_batches(ranking_demo.asr_batch(rows, ranking_demo.CharTok(), **kw),
                       jrd._asr_batch(rows, jrd.CharTok(), **kw), f"asr batch {kw}")


@pytest.fixture(scope="module")
def demo_losses():
    """JAX's loss functions (the JAX trainer's spark / asr loss) at the
    port demo's configs (128 x 2, head size 64, gate lora 16) on the demo's
    batches of 4 sentences, each traced once and compiled at XLA -O0, the
    two compiles on threads."""
    rows = ranking_demo.build_corpus(4)
    kw = dict(hidden_size=128, num_layers=2, head_size=64, gate_lora=16, dtype=jnp.float32,
              wkv_chunk=16, remat=False)
    jobs = {
        "tts": (jspark.default_config(dropout=0.0, **kw), jspark.init_params,
                jtrainer.LOSS_FNS["spark"],
                jsc.collate_plain(rows, jrd.CharTok(), 8192, pad_to=64)),
        "asr": (jasr.default_config(variant="discrete", adapter_layers=2, **kw), jasr.init_params,
                jtrainer.LOSS_FNS["asr"], jrd._asr_batch(rows, jrd.CharTok())),
    }

    def lower(cfg, init, loss_fn, batch):
        shapes = jax.eval_shape(lambda k: init(k, cfg), jax.random.PRNGKey(0))
        fn = jax.jit(lambda p, b: loss_fn(p, cfg, b, None)[0])
        return fn.lower(shapes, {k: jnp.asarray(v) for k, v in batch.items()})

    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        futures = {k: ex.submit(lambda lo: lo.compile(compiler_options=_FAST), lower(*job))
                   for k, job in jobs.items()}
        return {k: (f.result(), jobs[k][3]) for k, f in futures.items()}


@pytest.mark.parametrize("kind", ["tts", "asr"])
def test_ranking_demo_training_matches_jax(kind, demo_losses, monkeypatch):
    """Three of the demo's train steps (the port's train_tts / train_asr on
    4 sentences): each step's loss equals JAX's loss function (the JAX
    trainer's spark / asr loss: spark.forward / asr.forward) at the weights
    that step started from, within 1e-5 relative; the loss falls."""
    rows = ranking_demo.build_corpus(4)
    snapshots = []
    make = ts.make_train_step

    def spying_make(cfg, opt, loss_fn):
        step = make(cfg, opt, loss_fn)

        def spied(state, batch, g):
            snapshots.append(bridge.params_to_numpy(rwkv7.tree_map(torch.clone, state.params)))
            return step(state, batch, g)

        return spied

    monkeypatch.setattr(ts, "make_train_step", spying_make)
    train = ranking_demo.train_tts if kind == "tts" else ranking_demo.train_asr
    _, _, losses = train(rows, steps=3, device="cpu")
    program, batch = demo_losses[kind]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    assert len(snapshots) == len(losses) == 3
    for got, params in zip(losses, snapshots):
        want = float(program(jax.tree.map(jnp.asarray, params), jb))
        assert abs(got - want) <= 1e-5 * abs(want), (kind, got, want)
    assert losses[2] < losses[0]
