"""Tokens and training from raw audio, port vs JAX package on the CPU: the
offline extractors (``extract_spark_tokens`` with BiCodec, XY_Tokenizer,
Higgs, S3 rows) and ``run_sharded`` over tar shards, the inline
tokenization's batches for each Spark task (both train CLIs' choice of
collator over tars), ``train.cli --data-format webdataset --codec-dir``
on a tiny model directory and its refusals, the BiCodec state-dict
exporter and model-directory writer, and the deployment exporters
(``rwkv7_to_blinkdl``, ``spark_to_flat``, ``cast_fp32_to_bf16``) with a
flat model's logits against the Spark model's semantic logits.

Small configs: the golden BiCodec (tests/goldens/bicodec.npz) behind a
tiny random wav2vec2 whose features both packages share, XY_Tokenizer at
tests/test_torch_xy_codecs.py's small widths with 80 mels (the JAX
extractor's mel), a small Higgs; the JAX references compiled whole
(``jax.jit``). Codes, ids, rows and exported arrays are compared exactly;
the flat model's logits at 1e-6 of the largest."""
import dataclasses
import functools
import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import golden_configs as gc
from rwkvtts_tpu.codecs import bicodec as jb
from rwkvtts_tpu.codecs import higgs as jhiggs
from rwkvtts_tpu.codecs import spark_tokenizer as jst
from rwkvtts_tpu.codecs import torch_import as jti
from rwkvtts_tpu.codecs import xy_tokenizer as jxt
from rwkvtts_tpu.convert import rwkv7_ckpt as jck
from rwkvtts_tpu.convert import speech_init as jinit
from rwkvtts_tpu.data import extract as jextract
from rwkvtts_tpu.data import inline_spark as jinline
from rwkvtts_tpu.data import spark_collator as jsc
from rwkvtts_tpu.data import webdataset as jwds
from rwkvtts_tpu.models import spark as jspark
from rwkvtts_tpu.train import cli as jcli
from rwkvtts_tpu.utils import tokenizer as jtok
from rwkvtts_torch import bridge
from rwkvtts_torch.codecs import bicodec as tb
from rwkvtts_torch.codecs import higgs, s3_tokenizer
from rwkvtts_torch.codecs import spark_tokenizer as tst
from rwkvtts_torch.codecs import torch_import as tti
from rwkvtts_torch.codecs import xy_tokenizer as xt
from rwkvtts_torch.convert import rwkv7_ckpt, speech_init
from rwkvtts_torch.data import corpus_tools, extract, inline_spark, spark_collator
from rwkvtts_torch.data import webdataset as wds
from rwkvtts_torch.models import rwkv7, spark
from rwkvtts_torch.train import cli
from rwkvtts_torch.utils.tokenizer import get_world_tokenizer

torch.set_num_threads(2)

TEXTS = ("今天的天气非常好。", "The quick brown fox jumps over the lazy dog.",
         "人工智能正在改变世界。", "请在下午三点之前把报告发给我。", "We expect 125 people to attend.")
XY_TINY = dict(n_mels=80, d_model=32, enc_layers=1, heads=2, ffn_dim=64, adapter_layers=1,
               nq=8, codebook_size=16, codebook_dim=8, rvq_dim=16, quantizer_io_dim=32 * 4,
               dec_layers=1, vocos_dim=32, vocos_intermediate_dim=64, vocos_layers=1,
               vocos_n_fft=64, vocos_hop=16)
HIGGS_TINY = dict(d_model=8, latent_dim=16, semantic_dim=16, nq=8, codebook_size=16,
                  strides=(2, 2, 2), decoder_channels=16)


def corpus(n: int, seed: int = 0, sr: int = 16000):
    """n seeded samples of 0.3 or 0.5 s (a tone and noise; two lengths, so
    the JAX references compile twice) with texts and the five speaker
    properties."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        t = np.arange(int(rng.choice([3 * sr // 10, sr // 2]))) / sr
        wav = (0.3 * np.sin(2 * np.pi * rng.uniform(120, 400) * t)
               + 0.05 * rng.standard_normal(len(t))).astype(np.float32)
        out.append({"__key__": f"utt{i:04d}", "audio": wav, "text": TEXTS[i % len(TEXTS)],
                    "age": ("youth-adult", "child")[i % 2], "gender": ("female", "male")[i % 2],
                    "emotion": ("HAPPY", "NEUTRAL")[i % 2], "pitch": float(rng.uniform(100, 260)),
                    "speed": float(rng.uniform(2, 6))})
    return out


def _port_cfg(jcfg):
    """A JAX BiCodec config (or part) -> the port's, field for field."""
    kw = {f.name: (_port_cfg(getattr(jcfg, f.name))
                   if dataclasses.is_dataclass(getattr(jcfg, f.name)) else getattr(jcfg, f.name))
          for f in dataclasses.fields(jcfg)}
    return getattr(tb, type(jcfg).__name__)(**kw)


def _tiny_wav2vec2():
    from transformers import Wav2Vec2Config

    return Wav2Vec2Config(hidden_size=12, num_hidden_layers=16, num_attention_heads=2,
                          intermediate_size=24, conv_dim=(8,) * 7,
                          num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=2,
                          feat_extract_norm="layer", do_stable_layer_norm=True,
                          conv_bias=True)


@pytest.fixture(scope="module")
def codecs(tmp_path_factory):
    """The golden BiCodec in both packages behind one tiny wav2vec2 (the
    JAX tokenizer gets the port frontend's features), the port's written
    to a model directory, and 4 shards of 3 samples."""
    from rwkvtts_torch.utils import fixtures

    sd, _ = fixtures.load_golden(os.path.join(os.path.dirname(__file__), "goldens",
                                              "bicodec.npz"))
    jcfg = gc.bicodec_config()
    pcfg = _port_cfg(jcfg)
    front = tst.Wav2Vec2Frontend.from_config(_tiny_wav2vec2(), seed=3, device="cpu")
    port = tst.SparkAudioTokenizer(pcfg, tti.bicodec_from_state_dict(sd, pcfg, "cpu"), front)
    jparams = jax.tree.map(jnp.asarray, jti.bicodec_from_state_dict(sd, jcfg))
    jax_ = jst.SparkAudioTokenizer(jcfg, jparams,
                                   wav2vec2=lambda w: jnp.asarray(front(w).numpy()))
    root = tmp_path_factory.mktemp("extract")
    model_dir = port.save_pretrained(root / "Spark-TTS")
    shards = corpus_tools.write_shards(corpus(12), str(root / "shards"), samples_per_shard=3)
    return SimpleNamespace(port=port, jax=jax_, dir=str(model_dir), shards=shards, root=root,
                           pcfg=pcfg)


def test_model_dir_round_trip(codecs):
    """bicodec_to_state_dict then bicodec_from_state_dict gives the tree
    back; save_pretrained's directory reads back through from_pretrained
    (config, every weight, the frontend) and through the JAX package's
    config reader."""
    back = tst.SparkAudioTokenizer.from_pretrained(codecs.dir, device="cpu")
    assert back.cfg == codecs.pcfg
    assert _port_cfg(jst.bicodec_config_from_yaml(
        os.path.join(codecs.dir, "BiCodec", "config.yaml"))) == codecs.pcfg
    flat = lambda t: dict(_leaves(t))
    a, b = flat(back.params), flat(codecs.port.params)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    sd = tti.bicodec_to_state_dict(codecs.port.params)
    assert flat(tti.bicodec_from_state_dict(sd, codecs.pcfg, "cpu")).keys() == b.keys()
    wav = corpus(1, seed=9)[0]["audio"]
    g1, s1 = back.tokenize(wav)
    g2, s2 = codecs.port.tokenize(wav)
    np.testing.assert_array_equal(g1, g2)
    np.testing.assert_array_equal(s1, s2)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _props(s):
    return {k: s[k] for k in ("gender", "pitch")}


def test_extract_spark_tokens_and_run_sharded_match_jax(codecs, tmp_path):
    """extract_spark_tokens over a shard with a properties function, and
    run_sharded with one worker over the 4 shards (SparkTarWorker reading
    the model directory; the JAX side a worker function over its own
    reader), give the JAX package's rows byte for byte."""
    samples = list(wds.iter_tar_samples(codecs.shards[0]))
    a, b = str(tmp_path / "p.jsonl"), str(tmp_path / "j.jsonl")
    assert extract.extract_spark_tokens(samples, codecs.port, a, _props) == 3
    assert jextract.extract_spark_tokens(list(jwds.iter_tar_samples(codecs.shards[0])),
                                         codecs.jax, b, _props) == 3
    assert open(a).read() == open(b).read()
    row = json.loads(open(a).readline())
    assert len(row["global_tokens"]) == 4 and row["gender"] == "female"

    worker = extract.SparkTarWorker(codecs.dir, device="cpu", properties=("gender", "pitch"))
    n = extract.run_sharded(codecs.shards, worker, str(tmp_path / "port"))
    jn = jextract.run_sharded(
        codecs.shards, lambda s, o: jextract.extract_spark_tokens(
            jwds.iter_tar_samples(s), codecs.jax, o, _props), str(tmp_path / "jax"))
    assert n == jn == 12
    for p in codecs.shards:
        name = os.path.basename(p) + ".jsonl"
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def _jax_tree(init, cfg, seed):
    """A JAX codec tree of `init`'s shapes (nothing compiled) from a numpy
    seed (tests/test_torch_xy_codecs.py's recipe)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = jax.tree_util.keystr(path), leaf.shape
        if "codebook" in name:
            return rng.standard_normal(shape).astype(np.float32)
        if len(shape) >= 2:
            bound = 1.0 / np.sqrt(np.prod(shape[:-1]))
            return rng.uniform(-bound, bound, shape).astype(np.float32)
        base = 1.0 if name.endswith(("['g']", "['alpha']")) else 0.0
        return (base + rng.uniform(-0.1, 0.1, shape)).astype(np.float32)

    shapes = jax.eval_shape(lambda k: init(k, cfg), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _hubert_stub(hop: int):
    """A shared semantic teacher: each hop of samples projected to 16 dims."""
    proj = np.random.default_rng(5).standard_normal((hop, 16)).astype(np.float32)

    def fn(wavs):
        B, T = wavs.shape
        return wavs[:, : T // hop * hop].reshape(B, T // hop, hop) @ proj

    return fn


def test_extract_xy_higgs_and_cosy_match_jax(codecs, tmp_path, monkeypatch):
    """extract_xy_tokens (batches of 3 padded to 0.75 s), extract_higgs_tokens
    (batches of 2 padded to 0.5 s, a shared teacher) and extract_cosy_tokens
    (the port's S3 at a small width on both sides) give the JAX package's
    rows: codes equal, cut to each row's length."""
    samples = [s for p in codecs.shards[:2] for s in wds.iter_tar_samples(p)]
    monkeypatch.setattr(jxt, "whisper_log_mel", jax.jit(
        jxt.whisper_log_mel, static_argnames=("sample_rate", "n_fft", "hop", "n_mels")))
    monkeypatch.setattr(jxt, "encode", jax.jit(jxt.encode, static_argnums=1))
    monkeypatch.setattr(jhiggs, "encode", jax.jit(jhiggs.encode, static_argnums=1))

    jcfg, tcfg = jxt.XYTokenizerConfig(**XY_TINY), xt.XYTokenizerConfig(**XY_TINY)
    jp = _jax_tree(jxt.init_params, jcfg, 9)
    tp = bridge.xy_tokenizer_params_from_numpy(jax.tree.map(np.asarray, jp))
    a, b = str(tmp_path / "xy_p.jsonl"), str(tmp_path / "xy_j.jsonl")
    assert extract.extract_xy_tokens(samples, tcfg, tp, a, batch_size=3, max_seconds=0.75) == 6
    jextract.extract_xy_tokens(samples, jcfg, jp, b, batch_size=3, max_seconds=0.75)
    assert open(a).read() == open(b).read()
    rows = [json.loads(line) for line in open(a)]
    assert [len(r["audio_tokens"][0]) for r in rows] == [
        max(min(len(s["audio"]), 12000) // 1280, 1) for s in samples]

    jcfg, tcfg = jhiggs.HiggsConfig(**HIGGS_TINY), higgs.HiggsConfig(**HIGGS_TINY)
    jp = _jax_tree(jhiggs.init_params, jcfg, 11)
    tp = bridge.higgs_params_from_numpy(jax.tree.map(np.asarray, jp))
    teacher = _hubert_stub(tcfg.hop_length)
    a, b = str(tmp_path / "h_p.jsonl"), str(tmp_path / "h_j.jsonl")
    assert extract.extract_higgs_tokens(samples, tcfg, tp, teacher, a, batch_size=2,
                                        max_seconds=0.5) == 6
    jextract.extract_higgs_tokens(samples, jcfg, jp, teacher, b, batch_size=2, max_seconds=0.5)
    assert open(a).read() == open(b).read()

    s3cfg = s3_tokenizer.S3TokenizerConfig(n_mels=16, d_model=32, layers=2, heads=2,
                                           ffn_dim=64, fsq_dim=8)
    s3p = s3_tokenizer.init_params(torch.Generator().manual_seed(2), s3cfg)
    s3fn = lambda w: s3_tokenizer.tokenize(s3p, s3cfg, torch.from_numpy(w[None]))[0].tolist()
    upper = lambda t: t.upper()
    a, b = str(tmp_path / "c_p.jsonl"), str(tmp_path / "c_j.jsonl")
    assert extract.extract_cosy_tokens(samples, s3fn, a, upper) == 6
    jextract.extract_cosy_tokens(samples, s3fn, b, upper)
    assert open(a).read() == open(b).read()
    assert len(json.loads(open(a).readline())["tts_speech_tokens"]) > 0


class StubCodec:
    """A codec both packages' inline collates share: tokens that follow
    from the audio."""

    def tokenize(self, wav):
        glob = (np.abs(wav[:32]) * 1e4).astype(np.int64) % 4096
        sem = (np.abs(wav[::320]) * 1e4).astype(np.int64) % 8192
        return glob[None, None], sem[None]


TASKS = {"spark": "collate_plain", "spark_properties": "collate_with_properties",
         "spark_global": "collate_global_tokens"}


@pytest.mark.parametrize("task", sorted(TASKS))
def test_inline_collate_matches_jax(codecs, task):
    """inline_collate over rows of the tars, the task's collator
    and tokenizer (64 SPCT tokens where the task has properties), with one
    stub codec: the port's batch = the JAX package's, array for array."""
    rows = wds.MultipleWebDataset(codecs.shards, seed=4).samples[:5]
    n_spct = 0 if task == "spark" else 64
    got = inline_spark.inline_collate(functools.partial(
        getattr(spark_collator, TASKS[task]), tokenizer=get_world_tokenizer(n_spct=n_spct),
        eos_id=8192, pad_to=256), StubCodec())(rows)
    want = jinline.make_inline_spark_collate(
        StubCodec(), jtok.get_world_tokenizer(n_spct=n_spct), 8192, pad_to=256,
        collate_fn=getattr(jsc, TASKS[task]))(rows)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    tokenized = inline_spark.tokenize_rows(rows, StubCodec())
    assert tokenized[0]["semantic_tokens"] == StubCodec().tokenize(rows[0]["audio"])[1][0].tolist()
    assert inline_spark.tokenize_rows(tokenized, None) == tokenized  # already tokens


class _Captured(Exception):
    pass


def _capture(monkeypatch, module):
    """Make `module`'s JsonlDataset stop the CLI with its (rows, collate)."""
    def fake(rows, collate, *a, **k):
        raise _Captured(rows, collate)

    monkeypatch.setattr(module.jsonl_dataset, "JsonlDataset", fake)


def _cli_args(task, codecs, tmp_path):
    return ["--task", task, "--data-format", "webdataset",
            "--data", os.path.join(os.path.dirname(codecs.shards[0]), "*.tar"),
            "--codec-dir", codecs.dir, "--hidden", "64", "--layers", "1", "--pad-to", "256",
            "--run-dir", str(tmp_path / task), "--seed", "2", "--max-rows", "10"]


@pytest.mark.parametrize("task", ["spark", "spark_properties"])
def test_cli_inline_route_matches_jax_cli(codecs, tmp_path, monkeypatch, task):
    """Both CLIs over the tars with --codec-dir (the codec a stub, the model
    left unbuilt): the same 10 rows in the same order. For spark the
    collated batches are equal; for spark_properties the port's is the
    properties collator's, while the JAX CLI's is the plain one, without
    the SPCT tokens (a fault of the JAX CLI: it drops the task's collator)."""
    _capture(monkeypatch, cli)
    _capture(monkeypatch, jcli)
    monkeypatch.setattr(cli, "inline_codec", lambda d, dev: StubCodec())
    monkeypatch.setattr(jst.SparkAudioTokenizer, "from_pretrained",
                        classmethod(lambda cls, d: StubCodec()))
    jcfg = jspark.default_config(hidden_size=64, num_layers=1, dtype=jnp.float32)
    monkeypatch.setattr(jcli, "build_model", lambda task, args: (jcfg, None))
    args = _cli_args(task, codecs, tmp_path)
    with pytest.raises(_Captured) as port:
        cli.main(args + ["--device", "cpu"])
    with pytest.raises(_Captured) as jax_:
        jcli.main(args)
    (rows, collate), (jrows, jcollate) = port.value.args, jax_.value.args
    assert [r["__key__"] for r in rows] == [r["__key__"] for r in jrows] and len(rows) == 10
    got, want = collate(rows[:4]), jcollate(jrows[:4])
    tok = get_world_tokenizer(n_spct=0 if task == "spark" else 64)
    own = getattr(spark_collator, TASKS[task])(inline_spark.tokenize_rows(rows[:4], StubCodec()),
                                               tok, 8192, pad_to=256)
    for k in own:
        np.testing.assert_array_equal(got[k], own[k], err_msg=k)
    same = got.keys() == want.keys() and all(np.array_equal(got[k], want[k]) for k in want)
    assert same == (task == "spark")
    if task == "spark_properties":
        assert got["tokens"].shape[0] == 8 and want["tokens"].shape[0] == 4


def test_cli_webdataset_dry_run_and_refusals(codecs, tmp_path, monkeypatch):
    """train.cli --device cpu --data-format webdataset --codec-dir <the tiny
    model dir> --dry-run runs a step on inline tokens; --codec-dir with a
    task without an inline codec or with jsonl data, and --wandb-project
    without wandb installed, are refused."""
    args = _cli_args("spark", codecs, tmp_path) + ["--device", "cpu", "--dry-run",
                                                   "--batch-size", "2", "--no-bf16"]
    tr = cli.main(args)
    assert tr.state.step == 1
    for bad in (["--task", "cosy"], ["--data-format", "jsonl"]):
        with pytest.raises(SystemExit):
            cli.main(args + bad)
    monkeypatch.setitem(__import__("sys").modules, "wandb", None)
    with pytest.raises(RuntimeError, match="wandb"):
        cli.main(args + ["--wandb-project", "p", "--run-name", "r"])


def _spark_params(C=64, L=2):
    cfg = spark.default_config(hidden_size=C, num_layers=L, dtype=torch.float32, head_size=16)
    jcfg = jspark.default_config(hidden_size=C, num_layers=L, dtype=jnp.float32, head_size=16)
    return cfg, jcfg, spark.init_params(torch.Generator().manual_seed(6), cfg)


def test_exporters_match_jax_and_flat_logits(tmp_path):
    """rwkv7_to_blinkdl and spark_to_flat give the JAX package's arrays
    exactly; the flat model (blinkdl_to_rwkv7 of the export) on
    flat_ids_from_parts' ids gives the Spark model's semantic logits
    within 1e-6 of their largest, and zeros beyond them; cast_fp32_to_bf16
    casts what the JAX one casts."""
    cfg, jcfg, params = _spark_params()
    npp = bridge.params_to_numpy(params)
    for got, want in ((rwkv7_ckpt.rwkv7_to_blinkdl(params, cfg.backbone),
                       jck.rwkv7_to_blinkdl(npp, jcfg.backbone)),
                      (speech_init.spark_to_flat(params, cfg), jinit.spark_to_flat(npp, jcfg))):
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (speech_init.FLAT_TAG_BASE, speech_init.FLAT_GLOBAL_BASE,
            speech_init.FLAT_TEXT_BASE) == (jinit.FLAT_TAG_BASE, jinit.FLAT_GLOBAL_BASE,
                                            jinit.FLAT_TEXT_BASE)

    flat = speech_init.spark_to_flat(params, cfg)
    fcfg = dataclasses.replace(cfg.backbone, vocab_size=flat["emb.weight"].shape[0])
    fparams = bridge.params_from_numpy(rwkv7_ckpt.blinkdl_to_rwkv7(flat, fcfg))
    rng = np.random.default_rng(7)
    text = get_world_tokenizer().encode("今天的天气非常好。hello")
    glob, sem = rng.integers(0, 4096, 32).tolist(), rng.integers(0, 8192, 40).tolist()
    batch = spark_collator.collate_plain([{"text": "今天的天气非常好。hello",
                                           "global_tokens": glob, "semantic_tokens": sem}],
                                         get_world_tokenizer(), 8192)
    tokens, modality = torch.from_numpy(batch["tokens"]), torch.from_numpy(batch["modality"])
    t_ids, g_ids, s_ids = speech_init.flat_ids_from_parts(text, glob, sem)
    assert (t_ids, g_ids, s_ids) == jinit.flat_ids_from_parts(text, glob, sem)
    tag = speech_init.FLAT_TAG_BASE
    ids = ([tag + spark.TAG_START_TTS] + t_ids + [tag + spark.TAG_GLOBAL] + g_ids
           + [tag + spark.TAG_SEMANTIC] + s_ids)
    n = len(ids)
    assert tokens.shape[1] >= n
    with torch.no_grad():
        want = spark.forward(params, cfg, tokens[:, :n], modality[:, :n]) @ params["head"]
        got = rwkv7.forward(fparams, fcfg, input_ids=torch.tensor([ids])) @ fparams["head"]
    V = cfg.semantic_vocab_size
    assert float((got[..., :V] - want).abs().max()) <= 1e-6 * float(want.abs().max())
    assert float(got[..., V:].abs().max()) == 0.0

    src = str(tmp_path / "model.pth")
    torch.save({k: torch.from_numpy(v) for k, v in flat.items()} | {"step": torch.tensor(3)}, src)
    n_port = rwkv7_ckpt.cast_fp32_to_bf16(src, str(tmp_path / "p.pth"))
    n_jax = jck.cast_fp32_to_bf16(src, str(tmp_path / "j.pth"))
    assert n_port == n_jax == len(flat)
    a = torch.load(str(tmp_path / "p.pth"), weights_only=True)
    b = torch.load(str(tmp_path / "j.pth"), weights_only=True)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert a["emb.weight"].dtype == torch.bfloat16 and a["step"].dtype == torch.int64
