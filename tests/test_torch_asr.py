"""The ASR family, port vs JAX package, on the CPU: ``right_align_pack``
(overflow included), the Whisper encoder with a mask and its HF importer
(on a tiny transformers ``WhisperEncoder``), both ASR variants' loss and
every gradient against ``jax.value_and_grad`` with the encoder frozen,
``transcribe`` greedy and sampled on JAX's Gumbel draws, the collator, the
ASR export / loader, and ``asr_transcribe_fn`` on a wav file.

The configs are tests/test_asr.py's (hidden 32, head 8, 2 LLM layers, 1
adapter layer, a 1-layer Whisper of width 32), f32. The weights are JAX's
``init_params`` with the matrices it leaves at zero filled from a numpy
seed, carried to the port by ``bridge.asr_params_from_numpy``. Tolerances:
forward values 1e-5 relative, gradients 1e-4 relative to each leaf's
largest, tokens exact."""
import concurrent.futures
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkvtts_tpu.convert import export_hf as jexport
from rwkvtts_tpu.convert import speech_init as jinit
from rwkvtts_tpu.data import asr_collator as jcoll
from rwkvtts_tpu.eval import seed_tts as jseed
from rwkvtts_tpu.models import asr as jasr
from rwkvtts_tpu.models import whisper as jwhisper
from rwkvtts_tpu.ops import packing as jpacking
from rwkvtts_torch import bridge
from rwkvtts_torch.convert import export_hf, speech_init
from rwkvtts_torch.data import asr_collator
from rwkvtts_torch.eval import seed_tts
from rwkvtts_torch.models import asr, rwkv7, whisper
from rwkvtts_torch.ops.packing import right_align_pack
from rwkvtts_torch.utils import audio_io

torch.set_num_threads(2)

RTOL, GRAD_RTOL = 1e-5, 1e-4
MINI_WHISPER = dict(n_mels=8, d_model=32, layers=1, heads=2, ffn_dim=64)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _leaves(tree, prefix=""):
    """(path, leaf) over a tree of dicts and lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _configs(variant, n_mels=8):
    kw = dict(hidden_size=32, num_layers=2, adapter_layers=1, audio_vocab=16, variant=variant,
              head_size=8, gate_lora=8)
    jcfg = jasr.default_config(dtype=jnp.float32, wkv_chunk=4, remat=False, **kw)
    tcfg = asr.default_config(dtype=torch.float32, **kw)
    if variant == "whisper":
        wkw = dict(MINI_WHISPER, n_mels=n_mels)
        jcfg = dataclasses.replace(jcfg, whisper=jwhisper.WhisperEncoderConfig(**wkw))
        tcfg = dataclasses.replace(tcfg, whisper=whisper.WhisperEncoderConfig(**wkw))
    return jcfg, tcfg


def _weights(jcfg, seed):
    """JAX's init tree (names and shapes from jax.eval_shape; XLA would
    compile the init for seconds), its values drawn with numpy from
    `seed`: norm scales 1 + U(-0.1, 0.1), matrices U within
    1/sqrt(fan_in), the other vectors U(-0.1, 0.1). Returns (JAX tree,
    port tree through bridge.asr_params_from_numpy)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        if jax.tree_util.keystr(path).endswith(("scale']", "['g']")):
            return (1 + rng.uniform(-0.1, 0.1, leaf.shape)).astype(np.float32)
        bound = 1 / np.sqrt(leaf.shape[-2]) if len(leaf.shape) >= 2 else 0.1
        return rng.uniform(-bound, bound, leaf.shape).astype(np.float32)

    shapes = jax.eval_shape(lambda k: jasr.init_params(k, jcfg), jax.random.PRNGKey(0))
    npp = jax.tree_util.tree_map_with_path(fill, shapes)
    return jax.tree.map(jnp.asarray, npp), bridge.asr_params_from_numpy(npp)


def _batch(variant, B=3, seed=0):
    """Instruction, audio, hints and answer segments, padded on both sides,
    one row's audio shorter than the others'."""
    rng = np.random.default_rng(seed)
    b = {"text_ids": rng.integers(1, 100, (B, 4)),
         "text_mask": np.array([[0, 1, 1, 1], [1, 1, 1, 1], [1, 1, 1, 0]], np.int32)[:B],
         "hints_ids": rng.integers(1, 100, (B, 2)),
         "hints_mask": np.ones((B, 2), np.int32),
         "labels": rng.integers(1, 100, (B, 5)),
         "labels_mask": np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1], [1, 1, 0, 0, 0]],
                                 np.int32)[:B]}
    if variant == "whisper":
        b["mel"] = rng.standard_normal((B, 16, 8)).astype(np.float32)
        b["mel_mask"] = np.ones((B, 16), np.int32)
        b["mel_mask"][0, 12:] = 0
    else:
        b["audio_ids"] = rng.integers(0, 16, (B, 6))
        b["audio_mask"] = np.array([[0, 0, 1, 1, 1, 1], [1, 1, 1, 1, 1, 1], [1, 1, 1, 1, 0, 0]],
                                   np.int32)[:B]
    b["labels"] = np.where(b["labels_mask"] > 0, b["labels"], -100)
    return b


@functools.lru_cache(maxsize=None)
def _jax_loss_grad(jcfg):
    return jax.jit(jax.value_and_grad(lambda p, b: jasr.forward(p, jcfg, b)[0]))


# JAX's transcribe compiled once a config and setting (cfg, max_new_tokens,
# temperature, top_k, top_p static); eager, it dispatches op by op for seconds
_jax_transcribe = jax.jit(jasr.transcribe, static_argnums=(1, 3, 4, 5, 6))
# XLA's backend at -O0: the same programs, compiled in about two thirds of the time
_FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _compiled(jobs, options=_FAST):
    """{name: (jitted function, its arguments[, keyword arguments])} ->
    {name: the compiled program, called with the non-static arguments}:
    traced here one after another, compiled with XLA's `options` (-O0 by
    default) on threads (XLA compiles outside the GIL)."""
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
        futures = {k: ex.submit(lambda lo: lo.compile(compiler_options=options),
                                job[0].lower(*job[1], **(job[2] if len(job) > 2 else {})))
                   for k, job in jobs.items()}
        return {k: f.result() for k, f in futures.items()}


def test_pack_whisper_and_hf_import(monkeypatch):
    """Named checks: right_align_pack = JAX's (three segments with labels,
    then an overflow: more valid positions than T_total) and differentiable;
    whisper.apply with a mask within 1e-5 of JAX's, its padded outputs
    zero; from_hf_state_dict on a tiny transformers WhisperEncoder = JAX's
    importer through the bridge, and the imported encoder = the HF module's
    forward within 1e-5."""
    rng = np.random.default_rng(0)
    B, C = 3, 4
    segs = [(rng.standard_normal((B, L, C)).astype(np.float32),
             (rng.random((B, L)) < 0.7).astype(np.int32),
             rng.integers(0, 50, (B, L)) if k == 2 else None)
            for k, L in enumerate((3, 4, 5))]
    for T_total in (12, 5):  # 5: rows with more valid positions than that overflow
        want = jpacking.right_align_pack(
            [(jnp.asarray(e), jnp.asarray(m), None if lab is None else jnp.asarray(lab))
             for e, m, lab in segs], T_total)
        x = torch.tensor(segs[0][0], requires_grad=True)
        got = right_align_pack(
            [(x if k == 0 else torch.tensor(e), torch.tensor(m),
              None if lab is None else torch.tensor(lab)) for k, (e, m, lab) in enumerate(segs)],
            T_total)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.detach().numpy(), np.asarray(w))
        assert got[1].dtype == torch.int32 and got[2].dtype == torch.long
        got[0].sum().backward()  # each valid, kept position of segment 0 once
        np.testing.assert_array_equal(
            x.grad.numpy(), np.asarray(jax.grad(lambda e: jpacking.right_align_pack(
                [(e, jnp.asarray(segs[0][1]), None)] + [
                    (jnp.asarray(s[0]), jnp.asarray(s[1]), None) for s in segs[1:]],
                T_total)[0].sum())(jnp.asarray(segs[0][0]))))

    jcfg = jwhisper.WhisperEncoderConfig(**MINI_WHISPER)
    tcfg = whisper.WhisperEncoderConfig(**MINI_WHISPER)
    # JAX's init and apply as compiled programs (op by op, each primitive
    # would compile on its own)
    jp = jax.tree.map(np.asarray, jax.jit(jwhisper.init_params, static_argnums=1)(
        jax.random.PRNGKey(1), jcfg))
    japply = jax.jit(jwhisper.apply, static_argnums=1, compiler_options=_FAST)
    tp = bridge.codec_params_from_numpy(jp)
    mel = rng.standard_normal((2, 20, 8)).astype(np.float32)
    mask = np.ones((2, 20), np.int32)
    mask[1, 12:] = 0
    got = whisper.apply(tp, tcfg, torch.from_numpy(mel), torch.from_numpy(mask))
    want = np.asarray(japply(jax.tree.map(jnp.asarray, jp), jcfg, jnp.asarray(mel),
                             jnp.asarray(mask)))
    assert got.shape == (2, 10, 32) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= RTOL
    assert not got[1, 6:].any()
    # bf16 weights: the encoder still computes in f32 (JAX's promotion)
    got16 = whisper.apply(rwkv7.tree_map(lambda t: t.to(torch.bfloat16), tp), tcfg,
                          torch.from_numpy(mel), torch.from_numpy(mask))
    want16 = japply(jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), jp), jcfg,
                    jnp.asarray(mel), jnp.asarray(mask))
    assert got16.dtype == torch.float32 and want16.dtype == jnp.float32
    assert _rel(got16.numpy(), np.asarray(want16)) <= RTOL

    monkeypatch.setenv("USE_TF", "0")  # no TensorFlow import under transformers (seconds)
    from transformers import WhisperConfig
    from transformers.models.whisper.modeling_whisper import WhisperEncoder

    torch.manual_seed(0)
    hf = WhisperEncoder(WhisperConfig(d_model=32, encoder_layers=1, encoder_attention_heads=2,
                                      encoder_ffn_dim=64, num_mel_bins=8,
                                      max_source_positions=10)).eval()
    with torch.no_grad():
        hf.embed_positions.weight.normal_()
    sd = {f"model.encoder.{k}": v.numpy() for k, v in hf.state_dict().items()}
    wcfg = whisper.WhisperEncoderConfig(**MINI_WHISPER, max_positions=10)
    imported = whisper.from_hf_state_dict(sd, wcfg)
    ref = bridge.codec_params_from_numpy(jwhisper.from_hf_state_dict(
        sd, jwhisper.WhisperEncoderConfig(**MINI_WHISPER, max_positions=10)))
    got_leaves, ref_leaves = dict(_leaves(imported)), dict(_leaves(ref))
    assert got_leaves.keys() == ref_leaves.keys() and "layers/0/k/b" not in got_leaves
    for k, v in got_leaves.items():
        np.testing.assert_array_equal(v.numpy(), ref_leaves[k].numpy(), err_msg=k)
    feats = torch.randn(2, 8, 20, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        want = hf(feats).last_hidden_state
    assert _rel(whisper.apply(imported, wcfg, feats.transpose(1, 2)), want) <= RTOL


def test_asr_forward_grads_and_transcribe():
    """Named checks, both variants: the loss and every gradient vs
    jax.value_and_grad (the Whisper tower frozen: no gradient on either
    side); transcribe (the audio embedding is the variants' only
    difference, which the loss holds): greedy on the discrete variant
    (tokens and lengths exact; without the audio mask as with an all-ones
    one), and sampled on
    the whisper variant at temperature 1, top-k 8, top-p 0.9 on JAX's
    Gumbel draws (tokens and lengths exact)."""
    n, key = 6, jax.random.PRNGKey(7)
    setups, jobs = {}, {}
    for variant, seed in (("whisper", 3), ("discrete", 4)):
        jcfg, tcfg = _configs(variant)
        jp, tp = _weights(jcfg, seed)
        batch = _batch(variant)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jt = {k: v for k, v in jb.items() if not k.startswith("label")}
        setups[variant] = (jcfg, tcfg, jp, tp, batch, jb, jt)
        jobs[variant, "loss"] = (_jax_loss_grad(jcfg), (jp, jb))
        sampling = (jp, jcfg, jt, n, 0.0, 0, 0.0) if variant == "discrete" else (
            jp, jcfg, jt, n, 1.0, 8, 0.9, key)
        jobs[variant, "transcribe"] = (_jax_transcribe, sampling)
    programs = _compiled(jobs)
    for variant in ("whisper", "discrete"):
        jcfg, tcfg, jp, tp, batch, jb, jt = setups[variant]
        tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}

        loss_j, grads_j = programs[variant, "loss"](jp, jb)
        leaves = rwkv7.tree_map(lambda t: t.clone().requires_grad_(), tp)
        loss_t, n_t = asr.forward(leaves, tcfg, tb)
        loss_t.backward()
        assert int(n_t) == int(batch["labels_mask"].sum())
        assert abs(loss_t.item() - float(loss_j)) <= RTOL * abs(float(loss_j)), variant
        gj = dict(_leaves(bridge.asr_params_from_numpy(jax.tree.map(np.asarray, grads_j))))
        for path, t in _leaves(leaves):
            want = gj[path].numpy()
            if path.startswith("whisper/"):
                assert t.grad is None and not want.any(), path
                continue
            # unused leaves (a 1-layer adapter's v-lora) get None, JAX's zeros
            g = np.zeros(want.shape, np.float32) if t.grad is None else t.grad.numpy()
            err = np.abs(g - want).max()
            assert err <= GRAD_RTOL * max(np.abs(want).max(), 1e-6), (variant, path, err)

        tt = {k: v for k, v in tb.items() if not k.startswith("label")}
        if variant == "discrete":
            toks_j, len_j = programs[variant, "transcribe"](jp, jt)
            toks_t, len_t = asr.transcribe(tp, tcfg, tt, max_new_tokens=n)
            np.testing.assert_array_equal(toks_t.numpy(), np.asarray(toks_j))
            np.testing.assert_array_equal(len_t.numpy(), np.asarray(len_j))
            # no audio mask = every audio position valid
            ones = dict(tt, audio_mask=torch.ones_like(tt["audio_mask"]))
            no_mask = {k: v for k, v in tt.items() if k != "audio_mask"}
            np.testing.assert_array_equal(asr.transcribe(tp, tcfg, no_mask, max_new_tokens=n)[0],
                                          asr.transcribe(tp, tcfg, ones, max_new_tokens=n)[0])
        else:
            toks_j, len_j = programs[variant, "transcribe"](jp, jt, key)
            noise = np.stack([np.asarray(jax.random.gumbel(k, (3, 8), jnp.float32))
                              for k in jax.random.split(key, n)])
            toks_t, len_t = asr.transcribe(tp, tcfg, tt, max_new_tokens=n, temperature=1.0,
                                           top_k=8, top_p=0.9, noise=torch.from_numpy(noise))
            np.testing.assert_array_equal(toks_t.numpy(), np.asarray(toks_j))
            np.testing.assert_array_equal(len_t.numpy(), np.asarray(len_j))


class StubTokenizer:
    def encode(self, text):
        return [1 + ord(c) % 97 for c in text]

    def decode(self, ids):
        return "".join(chr(ord("a") + i % 26) for i in ids)


def test_asr_collator_converters_and_transcribe_fn(tmp_path, monkeypatch):
    """Named checks: the collator = JAX's on a wav file and a float list
    (mel within 1e-5, the rest exact), and at 16 mels through `n_mels`;
    the ASR export = JAX's, loaded back by both loaders equal, and
    save_pretrained's kind "asr"; asr_transcribe_fn on a wav in tmp_path =
    JAX's text at the JAX collator's 80 mels; with a 16-mel encoder JAX's
    fails at conv1 (it collates at 80 mels) and the port's transcribes."""
    rng = np.random.default_rng(5)
    wav = (0.3 * rng.standard_normal(8000)).astype(np.float32)
    path = str(tmp_path / "a.wav")
    audio_io.save_wav(path, wav, 16000)
    rows = [{"audio": path, "text": "hello", "language": "en"},
            {"audio": (0.2 * rng.standard_normal(5000)).tolist(), "text": "你好", "language": "zh"}]
    tok = StubTokenizer()
    got = asr_collator.collate(rows, tok, pad_frames_to=64)
    want = jcoll.collate(rows, tok, pad_frames_to=64)
    assert got.keys() == want.keys()
    for k in got:
        if k == "mel":
            assert got[k].shape == (2, 64, 80) and _rel(got[k], want[k]) <= RTOL
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert asr_collator.collate(rows, tok, n_mels=16)["mel"].shape == (2, 50, 16)

    jcfg, tcfg = _configs("whisper", n_mels=80)
    jp, tp = _weights(jcfg, seed=6)
    sd = export_hf.asr_to_fla(tp, tcfg)
    want_sd = jexport.asr_to_fla(jp, jcfg)
    assert sd.keys() == want_sd.keys() and not any(k.startswith("whisper") for k in sd)
    for k in sd:
        np.testing.assert_array_equal(sd[k], np.asarray(want_sd[k]), err_msg=k)
    back = speech_init.asr_from_pretrained_sd(sd, tcfg)
    jback = jinit.asr_from_pretrained_sd(sd, jcfg)
    ref = dict(_leaves(bridge.params_to_numpy({k: v for k, v in tp.items() if k != "whisper"})))
    assert dict(_leaves(back)).keys() == ref.keys() == dict(_leaves(jback)).keys()
    for k, v in _leaves(back):
        np.testing.assert_array_equal(v, dict(_leaves(jback))[k], err_msg=k)
        # layer 0's v-lora is unused and not exported: the loaders fill it
        unused = k.split("/")[-1] in ("v0", "v1", "v2")
        np.testing.assert_array_equal(v[1:] if unused else v, ref[k][1:] if unused else ref[k],
                                      err_msg=k)
    _, dcfg = _configs("discrete")
    dsd = export_hf.asr_to_fla(asr.init_params(torch.Generator().manual_seed(0), dcfg), dcfg)
    assert "audio_lm.model.embeddings.weight" in dsd and "projector1.weight" not in dsd
    assert "audio_lm.lm_head.weight" not in dsd
    out = export_hf.save_pretrained(tp, tcfg, str(tmp_path / "asr"), kind="asr")
    assert (tmp_path / "asr" / "model.safetensors").exists() and out.endswith("asr")

    monkeypatch.setattr(jasr, "transcribe", _jax_transcribe)  # the same function, compiled
    text = seed_tts.asr_transcribe_fn(tp, tcfg, tok, lang="en", max_new_tokens=5)(path)
    assert text == jseed.asr_transcribe_fn(jp, jcfg, tok, lang="en", max_new_tokens=5)(path)

    jcfg16, tcfg16 = _configs("whisper", n_mels=16)
    jp16, tp16 = _weights(jcfg16, seed=6)
    with pytest.raises(ValueError, match="80 // 1 != 16"):  # conv1 gets 80 mels
        jseed.asr_transcribe_fn(jp16, jcfg16, tok, max_new_tokens=2)(path)
    assert isinstance(seed_tts.asr_transcribe_fn(tp16, tcfg16, tok, max_new_tokens=2)(path), str)
