"""Every training task of the train CLI, port vs JAX package, on the CPU:
the collators (properties, global tokens, Cosy on one numpy generator, the
S2S toggle), each task's loss adapter (``trainer.LOSS_FNS``) with its loss,
n_valid and every gradient against ``jax.value_and_grad`` of the JAX
adapter, the low-memory optimizers against optax over three steps, the
frozen Whisper encoder (JAX's step decays it; the port's leaves it
bit-identical), and ``train.cli.main`` for each task, ``--warm-start`` and
the refusals. The SFM flow's collator and losses are
tests/test_torch_flow_train.py's.

Models are LM 128 x 2 (head 64) in f32 with JAX's init tree filled from a
numpy seed (``jax.eval_shape``: nothing compiled for the init), carried to
the port through the bridge. Tolerances: loss 1e-4 relative, gradients
1e-4 relative to each leaf's largest (exactly zero where JAX's is zero),
n_valid and collated arrays exact, optimizer parameters 1e-6."""
import concurrent.futures
import dataclasses
import json
import random
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rwkvtts_tpu.convert import speech_init as jinit
from rwkvtts_tpu.data import cosy_collator as jcc
from rwkvtts_tpu.data import spark_collator as jsc
from rwkvtts_tpu.models import asr as jasr
from rwkvtts_tpu.models import cosy as jcosy
from rwkvtts_tpu.models import s2s as js2s
from rwkvtts_tpu.models import spark as jspark
from rwkvtts_tpu.models import tts_two_tower as jtt
from rwkvtts_tpu.models import whisper as jwhisper
from rwkvtts_tpu.models import xy as jxy
from rwkvtts_tpu.train import cli as jcli
from rwkvtts_tpu.train import optimizer as jopt
from rwkvtts_tpu.train import trainer as jtrainer
from rwkvtts_tpu.utils import tokenizer as jtok
from rwkvtts_torch import bridge
from rwkvtts_torch.convert import export_hf
from rwkvtts_torch.data import cosy_collator, s2s_collator, spark_collator, xy_collator
from rwkvtts_torch.infer.xy_pipeline import xy_text_tokenizer
from rwkvtts_torch.models import asr, cosy, rwkv7, s2s, spark, whisper, xy
from rwkvtts_torch.models import tts_two_tower as tt
from rwkvtts_torch.train import cli
from rwkvtts_torch.train import optimizer as topt
from rwkvtts_torch.train import trainer
from rwkvtts_torch.utils.tokenizer import get_world_tokenizer

torch.set_num_threads(2)

C, L = 128, 2
MINI_WHISPER = dict(n_mels=8, d_model=32, layers=1, heads=2, ffn_dim=64)
# XLA's backend at -O0: the same program, compiled in about two thirds of the time
_FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _weights(init, jcfg, seed, to_port=bridge.params_from_numpy):
    """`init`'s tree (names and shapes from jax.eval_shape), values drawn
    with numpy from `seed`: norm scales 1 + U(-0.1, 0.1), matrices U within
    1/sqrt(fan_in), other vectors U(-0.1, 0.1). Returns (numpy tree, port
    tree through `to_port`)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        if jax.tree_util.keystr(path).endswith(("scale']", "['g']")):
            return (1 + rng.uniform(-0.1, 0.1, leaf.shape)).astype(np.float32)
        bound = 1 / np.sqrt(leaf.shape[-2]) if len(leaf.shape) >= 2 else 0.1
        return rng.uniform(-bound, bound, leaf.shape).astype(np.float32)

    shapes = jax.eval_shape(lambda k: init(k, jcfg), jax.random.PRNGKey(0))
    npp = jax.tree_util.tree_map_with_path(fill, shapes)
    return npp, to_port(npp)


def _jax_results(cases, ex):
    """jax.value_and_grad of the JAX trainer's adapter for each case's task,
    with the batch's static '_'-metadata merged in as Trainer._step_for
    does; one program for cases that share task, config, metadata and
    shapes. The programs are traced one after another here, and compiled
    and run on `ex`'s threads (XLA compiles and runs outside the GIL), so
    the caller goes on meanwhile. Returns a future a case of JAX's
    (loss, n_valid, gradients as numpy in JAX's tree)."""
    def key(case):
        task, jcfg, _, _, _, batch = case[:6]
        meta = tuple(sorted((k, v) for k, v in batch.items() if k.startswith("_")))
        shapes = tuple((k, np.shape(v)) for k, v in batch.items() if not k.startswith("_"))
        return task, jcfg, meta, shapes

    def lower(case):
        task, jcfg, _, npp, _, batch = case[:6]
        meta = dict(key(case)[2])

        def loss(p, b):
            return jtrainer.LOSS_FNS[task](p, jcfg, dict(b, **meta), None)

        fn = jax.jit(jax.value_and_grad(loss, has_aux=True))
        return fn.lower(jax.tree.map(jnp.asarray, npp), _jax_batch(batch))

    def run(case):
        npp, batch = case[3], case[5]
        (loss, n), grads = programs[key(case)].result()(jax.tree.map(jnp.asarray, npp),
                                                         _jax_batch(batch))
        return float(loss), int(n), jax.tree.map(np.asarray, grads)

    firsts = {key(c): c for c in reversed(cases)}
    # trace here, compile there: each compile runs while the next traces; the
    # runs queue behind every compile
    programs = {k: ex.submit(lambda lo: lo.compile(compiler_options=_FAST), lower(c))
                for k, c in firsts.items()}
    return [ex.submit(run, c) for c in cases]


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items() if not k.startswith("_")}


def _port_loss_grads(task, tcfg, tp, batch):
    flat = topt.flatten(tp)
    leaves = {p: t.clone().requires_grad_() for p, t in flat.items()}
    tb = {k: v if k.startswith("_") else torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    loss, n = trainer.LOSS_FNS[task](topt.unflatten(leaves, like=tp), tcfg, tb, None)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss.item(), int(n), {p: None if g is None else g.numpy()
                                 for p, g in zip(leaves, grads)}


def _check_task(jax_result, port_result, task, jcfg, tcfg, npp, tp, batch,
                to_port=bridge.params_from_numpy):
    """JAX's (loss, n_valid, gradients) against the port's
    (``_port_loss_grads``): loss within 1e-4, n_valid exact, every gradient
    within 1e-4 of the leaf's largest (a leaf the port leaves without
    gradient: JAX's is zero). Returns JAX's gradients, numpy, in JAX's
    tree."""
    loss_j, n_j, grads_j = jax_result
    loss_t, n_t, grads_t = port_result
    assert n_t == n_j, task
    assert abs(loss_t - loss_j) <= 1e-4 * abs(loss_j), (task, loss_t, loss_j)
    want = topt.flatten(bridge.params_to_numpy(to_port(grads_j)))
    assert want.keys() == grads_t.keys(), task
    for path, g in grads_t.items():
        w = want[path]
        if g is None or not np.abs(w).max():
            assert not np.abs(w).max() and (g is None or not np.abs(g).max()), (task, path)
        else:
            assert _rel(g, w) <= 1e-4, (task, path, _rel(g, w))
    return grads_j


def _task_rows(task, seed=0, n=4):
    """jsonl rows of `task`'s collator, a few tokens each."""
    rng = np.random.default_rng(seed)
    ages = ["child", "teenager", "youth-adult", "middle-aged", "elderly"]
    rows = []
    for i in range(n):
        text = f"row {i} says hello 你好 {int(rng.integers(0, 1000))}"
        if task.startswith("spark") or task == "tts_two_tower":
            r = {"text": text, "global_tokens": rng.integers(0, 4096, 32).tolist(),
                 "semantic_tokens": rng.integers(0, 8192, 20 + 3 * i).tolist(),
                 "age": ages[i % 5], "gender": ("female", "male")[i % 2],
                 "emotion": ("HAPPY", "NEUTRAL", "SAD")[i % 3],
                 "pitch": float(rng.uniform(100, 260)), "speed": float(rng.uniform(2, 6))}
        elif task == "cosy":
            r = {"text": text, "prompt_text": f"prompt {i}",
                 "tts_speech_tokens": rng.integers(0, 6561, 20 + i).tolist(),
                 "llm_prompt_speech_token": rng.integers(0, 6561, 6 + i).tolist()}
        elif task == "xy":
            r = {"text": text, "audio_tokens": rng.integers(0, 1000, (8, 10 + i)).tolist()}
        elif task == "asr":
            r = {"text": text, "language": ("en", "zh")[i % 2],
                 "audio": (0.1 * rng.standard_normal(8000 + 1600 * i)).tolist()}
        elif task == "s2s":
            r = {"text": text, "audio_tokens": rng.integers(0, 8192, 20 + i).tolist()}
        else:  # sfm_flow
            n_tok = 10 + i
            r = {"speech_token": rng.integers(0, 6561, n_tok).tolist(),
                 "speech_feat": rng.standard_normal((2 * n_tok, 80)).tolist(),
                 "embedding": rng.standard_normal(192).tolist()}
        rows.append(r)
    return rows


def _assert_batches_equal(a, b, what):
    assert a.keys() == b.keys(), what
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=f"{what} {k}")


def test_collators_match_jax():
    """Named checks: the properties and global-token collators padded and
    packed, equal to JAX's array for array (the SPCT tokenizer); the
    properties collator's phoneme marking on one random.Random a side
    (tests/test_torch_long_eval.py holds it further); Cosy's collator on the
    same numpy generator as JAX's over eight batches, dropping and keeping
    the prompts, padded and packed; the CLI's S2S toggle starts on an
    audio batch and alternates as JAX's does."""
    jt, tt_ = jtok.get_world_tokenizer(n_spct=64), get_world_tokenizer(n_spct=64)
    rows = _task_rows("spark_properties", 1, 3)
    for name in ("collate_with_properties", "collate_global_tokens"):
        for packed, pad_to in ((False, 160), (True, 512)):
            kw = dict(eos_id=8192, pad_to=pad_to, packed=packed)
            _assert_batches_equal(getattr(spark_collator, name)(rows, tt_, **kw),
                                  getattr(jsc, name)(rows, jt, **kw), f"{name} packed={packed}")
    rt, rj = random.Random(5), random.Random(5)
    kw = dict(eos_id=8192, pad_to=192, mark_phonemes_prob=0.5)
    _assert_batches_equal(spark_collator.collate_with_properties(rows, tt_, rng=rt, **kw),
                          jsc.collate_with_properties(rows, jt, rng=rj, **kw), "marked")
    assert rt.random() == rj.random()

    rows = _task_rows("cosy", 2, 3)
    jw, tw = jtok.get_world_tokenizer(), get_world_tokenizer()
    drops = set()
    for seed in range(8):
        packed = bool(seed % 2)
        kw = dict(eos_id=6561, drop_prompt_audio_rate=0.5, pad_to=192 if packed else 64,
                  packed=packed)
        got = cosy_collator.collate(rows, tw, rng=np.random.default_rng(seed), **kw)
        _assert_batches_equal(got, jcc.collate(rows, jw, rng=np.random.default_rng(seed), **kw),
                              f"cosy seed {seed}")
        drops.add(int(got["attention_mask"].sum()))
    assert len(drops) >= 2  # some batches dropped their prompts, some kept them
    s = cosy_collator.make_sample([5, 6], [7, 8, 9], 6561)
    assert s.labels == [-100, -100, -100, 7, 8, 9, 6561] and s.modality == [2, 1, 1, 2, 3, 3, 3]

    args = SimpleNamespace(pad_to=None, seed=0)
    rows = _task_rows("s2s", 3, 2)
    j_toggle = jcli.build_collate("s2s", args, js2s.default_config(hidden_size=C, num_layers=L))
    t_toggle = cli.build_collate("s2s", args, s2s.default_config(hidden_size=C, num_layers=L))
    for call in range(3):
        a, b = t_toggle(rows), j_toggle(rows)
        assert a["_is_text"] is b["_is_text"] is bool(call % 2)
        _assert_batches_equal(a, b, f"s2s batch {call}")


def _asr_configs(variant):
    kw = dict(hidden_size=C, num_layers=L, adapter_layers=1, audio_vocab=64, variant=variant)
    jcfg = jasr.default_config(dtype=jnp.float32, remat=False, **kw)
    tcfg = asr.default_config(dtype=torch.float32, wkv_fuse_prep=True, **kw)
    if variant == "whisper":
        jcfg = dataclasses.replace(jcfg, whisper=jwhisper.WhisperEncoderConfig(**MINI_WHISPER))
        tcfg = dataclasses.replace(tcfg, whisper=whisper.WhisperEncoderConfig(**MINI_WHISPER))
    return jcfg, tcfg


def _asr_batch(variant, seed):
    """Instruction, audio, hints and answer padded on either side; the
    whisper variant's mel 30 frames (a ragged last WKV chunk in the
    adapter), one row's audio shorter."""
    rng = np.random.default_rng(seed)
    B = 3
    b = {"text_ids": rng.integers(1, 100, (B, 4)),
         "text_mask": np.array([[0, 1, 1, 1], [1, 1, 1, 1], [1, 1, 1, 0]], np.int32),
         "hints_ids": rng.integers(1, 100, (B, 2)), "hints_mask": np.ones((B, 2), np.int32),
         "labels_mask": np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1], [1, 1, 0, 0, 0]], np.int32)}
    b["labels"] = np.where(b["labels_mask"] > 0, rng.integers(1, 100, (B, 5)), -100)
    if variant == "whisper":
        b["mel"] = rng.standard_normal((B, 30, 8)).astype(np.float32)
        b["mel_mask"] = np.ones((B, 30), np.int32)
        b["mel_mask"][0, 22:] = 0
    else:
        b["audio_ids"] = rng.integers(0, 64, (B, 6))
        b["audio_mask"] = np.array([[0, 0, 1, 1, 1, 1], [1] * 6, [1, 1, 1, 1, 0, 0]], np.int32)
    return b


def test_task_losses_and_grads_match_jax():
    """Named checks, one a task through trainer.LOSS_FNS against the JAX
    trainer's adapter: spark_properties (fused prep) and spark_global
    (unfused) on their collators' batches; cosy packed, label smoothing
    0.1, length-normalised, the head's bias; xy; both ASR variants (the
    Whisper tower frozen: no gradient on either side); the two-tower model;
    S2S on the text and the audio head through `_is_text`. Then the JAX
    package's step on the ASR gradients: optax decays every Whisper matrix
    by lr * wd * w although its gradient is zero."""
    cases = []  # (task, JAX config, port config, JAX weights, port weights, batch[, to_port])
    jspc = jspark.default_config(hidden_size=C, num_layers=L, dtype=jnp.float32, dropout=0.0,
                                 remat=False)
    npp, tp = _weights(jspark.init_params, jspc, 10)
    for task, fuse, n_rows in (("spark_properties", True, 2), ("spark_global", False, 4)):
        tcfg = spark.default_config(hidden_size=C, num_layers=L, dtype=torch.float32,
                                    dropout=0.0, wkv_fuse_prep=fuse)
        collate = cli.build_collate(task, SimpleNamespace(pad_to=128, packed=False), tcfg)
        cases.append((task, jspc, tcfg, npp, tp, collate(_task_rows(task, 11, n_rows))))

    jcfg = dataclasses.replace(jcosy.default_config(hidden_size=C, num_layers=L,
                                                    dtype=jnp.float32, remat=False),
                               lsm_weight=0.1)
    tcfg = dataclasses.replace(cosy.default_config(hidden_size=C, num_layers=L,
                                                   dtype=torch.float32, wkv_fuse_prep=True),
                               lsm_weight=0.1)
    batch = cosy_collator.collate(_task_rows("cosy", 13, 3), get_world_tokenizer(), 6561,
                                  rng=np.random.default_rng(0), drop_prompt_audio_rate=0.5,
                                  pad_to=192, packed=True)
    assert batch["resets"].sum() == 3
    cases.append(("cosy", jcfg, tcfg) + _weights(jcosy.init_params, jcfg, 12) + (batch,))

    jcfg = jxy.default_config(hidden_size=C, num_layers=L, dtype=jnp.float32, remat=False)
    tcfg = xy.default_config(hidden_size=C, num_layers=L, dtype=torch.float32, wkv_fuse_prep=True)
    batch = xy_collator.collate(_task_rows("xy", 15, 2), xy_text_tokenizer(), pad_to=64)
    cases.append(("xy", jcfg, tcfg) + _weights(jxy.init_params, jcfg, 14) + (batch,))

    for variant, seed in (("whisper", 16), ("discrete", 17)):
        jcfg, tcfg = _asr_configs(variant)
        weights = _weights(jasr.init_params, jcfg, seed, bridge.asr_params_from_numpy)
        cases.append(("asr", jcfg, tcfg) + weights
                     + (_asr_batch(variant, seed), bridge.asr_params_from_numpy))

    jcfg = jtt.default_config(text_hidden=C, text_layers=L, audio_hidden=C, audio_layers=L,
                              dtype=jnp.float32, remat=False)
    tcfg = tt.default_config(text_hidden=C, text_layers=L, audio_hidden=C, audio_layers=L,
                             dtype=torch.float32, wkv_fuse_prep=True)
    batch = s2s_collator.collate_two_tower(_task_rows("tts_two_tower", 19, 3),
                                           get_world_tokenizer(), pad_audio_to=80)
    cases.append(("tts_two_tower", jcfg, tcfg) + _weights(jtt.init_params, jcfg, 18) + (batch,))

    jcfg = js2s.default_config(hidden_size=C, num_layers=L, dtype=jnp.float32, remat=False)
    tcfg = s2s.default_config(hidden_size=C, num_layers=L, dtype=torch.float32,
                              wkv_fuse_prep=True)
    npp, tp = _weights(js2s.init_params, jcfg, 20)
    for is_text in (True, False):
        batch = s2s_collator.collate_s2s(_task_rows("s2s", 21, 3), get_world_tokenizer(),
                                         is_text=is_text, pad_to=48)
        cases.append(("s2s", jcfg, tcfg, npp, tp, batch))

    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        jax_results = _jax_results(cases, ex)
        # the port's side meanwhile, on this thread
        port_results = [_port_loss_grads(case[0], case[2], case[4], case[5]) for case in cases]
        grads = [_check_task(r.result(), p, *case)
                 for r, p, case in zip(jax_results, port_results, cases)]
    for case, g in zip(cases, grads):
        if case[0] == "s2s":
            used, unused = ("head", "audio_head") if case[5]["_is_text"] else ("audio_head", "head")
            assert np.abs(g[used]).max() > 0 and not np.abs(g[unused]).max()
        if case[0] == "asr" and case[1].variant == "whisper":
            asr_case = case[3], g

    # the JAX step on the ASR gradients: clip, the three AdamW groups, the
    # update (make_train_step's tx.update + apply_updates), at the peak LR
    npp, grads = asr_case
    assert all(not np.abs(g).max() for g in jax.tree.leaves(grads["whisper"]))
    lr, wd = 1e-3, 0.1
    tx = jopt.build_optimizer(npp, peak_lr=lr, warmup_steps=0, weight_decay=wd)
    jp = jax.tree.map(jnp.asarray, npp)
    upd, _ = jax.jit(tx.update)(jax.tree.map(jnp.asarray, grads), tx.init(jp), jp)
    new = jax.tree.map(np.asarray, optax.apply_updates(jp, upd))
    for name in ("conv1", "conv2"):
        w = npp["whisper"][name]["w"]
        np.testing.assert_allclose(new["whisper"][name]["w"], w * (1 - lr * wd), rtol=1e-6)
        assert np.abs(new["whisper"][name]["w"] - w).max() > 0


def _optax_state(opt_state):
    """{key: {path: array}} of a build_optimizer state: the moments of the
    three groups' scale transform (optax's MaskedNode marks a leaf outside
    a group), and their one count."""
    out, counts = {}, set()
    for masked in opt_state[1].inner_states.values():
        inner = masked.inner_state[0]
        counts.add(int(inner.count))
        for key in inner._fields:
            if key == "count":
                continue
            for path, leaf in jax.tree_util.tree_leaves_with_path(getattr(inner, key)):
                if hasattr(leaf, "shape"):
                    out.setdefault(key, {})["/".join(str(p.key) for p in path)] = leaf
    return out, counts.pop()


def test_low_memory_optimizers_frozen_encoder_and_cli(tmp_path):
    """Named checks: mu_bf16 and adafactor against optax over three steps
    (clipped, not clipped, clipped) on the Spark 128 x 2 tree, whose
    stacked (2, 128, 128) block matrices and embeddings are factored:
    parameters within 1e-6 (mu_bf16: but at the rare elements, <= 0.1 %,
    whose stored bf16 moment rounded a step or two the other way, there
    within lr x 2^-6 a step), the state's keys, shapes and dtypes as optax's;
    the frozen Whisper encoder bit-identical after two Trainer steps and
    outside the optimizer state; train.cli.main --dry-run for each of the
    nine tasks at tiny width (with both low-memory modes once); a
    --warm-start dry run = JAX's spark_from_text on the same checkpoint;
    --mark-phonemes-prob refused outside spark_properties."""
    jspc = jspark.default_config(hidden_size=C, num_layers=L, dtype=jnp.float32)
    npp, _ = _weights(jspark.init_params, jspc, 30)
    kw = dict(peak_lr=1e-3, final_lr=1e-4, warmup_steps=1, total_steps=4, weight_decay=0.1,
              grad_clip=1.0)
    for mode in ("mu_bf16", "adafactor"):
        tx = jopt.build_optimizer(npp, low_memory=mode, **kw)
        update = jax.jit(lambda g, s, p: (lambda u, s2: (optax.apply_updates(p, u), s2))(
            *tx.update(g, s, p)), compiler_options=_FAST)
        jp = jax.tree.map(jnp.asarray, npp)
        js = jax.jit(tx.init)(jp)  # one program (op by op, each leaf's zeros would compile)
        tp = bridge.params_from_numpy(npp)
        opt = topt.AdamW(tp, low_memory=mode, **kw)
        ts_ = opt.init(tp)
        rng = np.random.default_rng(31)
        flipped = {}  # mu_bf16: elements whose stored moment rounded the other way
        for step, scale in enumerate((1.0, 1e-3, 0.05), 1):
            grads = jax.tree.map(
                lambda p: (scale * rng.standard_normal(p.shape)).astype(np.float32), npp)
            jp, js = update(jax.tree.map(jnp.asarray, grads), js, jp)
            tg = {p: torch.from_numpy(g) for p, g in topt.flatten(grads).items()}
            opt.step(tp, tg, ts_, torch.tensor(True), topt.global_norm(tg.values()))
            want, got = topt.flatten(jax.tree.map(np.asarray, jp)), topt.flatten(tp)
            if mode == "mu_bf16":
                # the clip's global norm sums in another order, so an f32
                # moment may differ in its last bits (more where the moment's
                # two terms cancel) and its bf16 copy then round a bf16 step
                # the other way; such an element's update differs by at most
                # 2^-6 of lr a step from then on
                for path, m in _optax_state(js)[0]["mu"].items():
                    m, t = np.asarray(m, np.float32), ts_["mu"][path].float().numpy()
                    off = m != t
                    # within one bf16 step at the leaf's largest moment
                    assert np.abs(m - t).max() <= 2 ** -7 * np.abs(m).max(), path
                    flipped[path] = flipped.get(path, False) | off
                    assert flipped[path].mean() <= 1e-3, (path, flipped[path].mean())
            for path in want:
                g, w = got[path].numpy(), want[path]
                if mode == "mu_bf16" and flipped[path].any():
                    off = flipped[path]
                    assert np.abs(g - w)[off].max() <= step * kw["peak_lr"] * 2 ** -6, path
                    g, w = g[~off], w[~off]
                np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7, err_msg=f"{mode} {path}")
        if mode == "mu_bf16":
            print("mu_bf16: moments a bf16 step or two apart:",
                  {p: int(f.sum()) for p, f in flipped.items() if f.any()})
        state, count = _optax_state(js)
        assert count == int(ts_["count"]) == 3
        assert state.keys() == set(ts_) - {"count"}, mode
        for key, leaves in state.items():
            assert leaves.keys() == ts_[key].keys()
            for path, leaf in leaves.items():
                t = ts_[key][path]
                assert tuple(t.shape) == leaf.shape and str(t.dtype)[6:] == str(leaf.dtype), \
                    (mode, key, path)
        if mode == "adafactor":
            assert ts_["v_row"]["blocks/att/receptance"].shape == (2, 128)
            assert ts_["v"]["blocks/att/receptance"].shape == (1,)

    # the frozen encoder: two Trainer steps move the rest, never Whisper
    _, tcfg = _asr_configs("whisper")
    _, tp = _weights(jasr.init_params, _asr_configs("whisper")[0], 32,
                     bridge.asr_params_from_numpy)
    before = {p: t.clone() for p, t in topt.flatten(tp).items()}
    tcfg_run = trainer.TrainerConfig(run_dir=str(tmp_path / "asr"), warmup_steps=0,
                                     weight_decay=0.1, save_steps=0)
    tr = trainer.Trainer(tcfg, tp, trainer.LOSS_FNS["asr"], tcfg_run, "cpu")
    for seed in (33, 34):
        tr.state, m = tr.step_fn(tr.state, tr.to_device(_asr_batch("whisper", seed)), None)
        assert int(m["skipped"]) == 0
    after = topt.flatten(tr.state.params)
    assert not any(p.startswith("whisper/") for p in tr.state.opt_state["mu"])
    for path, t in before.items():
        if path.startswith("whisper/"):
            assert torch.equal(after[path], t), path
    # the trained leaves moved (a 1-layer adapter's v-lora has no gradient and no decay)
    assert all(not torch.equal(after[p], before[p]) for p in tr.optimizer.labels
               if tr.optimizer.labels[p] == "decay")

    # the CLI, each task
    for task in sorted(trainer.LOSS_FNS):
        path = tmp_path / f"{task}.jsonl"
        path.write_text("\n".join(json.dumps(r) for r in _task_rows(task, 40)) + "\n")
        args = ["--task", task, "--data", str(path), "--device", "cpu", "--dry-run",
                "--layers", "1", "--batch-size", "2", "--run-dir", str(tmp_path / task),
                "--hidden", "192" if task == "asr" else "64",  # Whisper's 12 heads
                "--pad-to", "16" if task == "sfm_flow" else "128"]
        if task != "spark":
            args.append("--no-bf16")
        extra = {"spark": ["--low-memory-opt", "adafactor"],
                 "cosy": ["--low-memory-opt", "mu_bf16"]}.get(task, [])
        tr = cli.main(args + extra)
        assert tr.state.step == 1 and tr.optimizer.low_memory == (extra or [None, None])[1]

    # --warm-start from a text RWKV-7 written here: at step 0 the LR is 0,
    # so the dry run's parameters are the warm start's
    tbb = rwkv7.RWKV7Config(vocab_size=65536, hidden_size=64, num_layers=1,
                            dtype=torch.float32)
    sd = export_hf.rwkv7_to_fla(rwkv7.init_params(torch.Generator().manual_seed(41), tbb), tbb)
    export_hf.save_safetensors(sd, str(tmp_path / "text.safetensors"))
    args = ["--task", "spark", "--data", str(tmp_path / "spark.jsonl"), "--device", "cpu",
            "--dry-run", "--hidden", "64", "--layers", "1", "--batch-size", "2",
            "--pad-to", "128", "--no-bf16", "--run-dir", str(tmp_path / "warm")]
    tr = cli.main(args + ["--warm-start", str(tmp_path / "text.safetensors")])
    _, fresh = cli.build_model("spark", SimpleNamespace(
        hidden=64, layers=1, head_size=64, bf16=False, no_wkv_fuse_prep=False, seed=0),
        torch.device("cpu"))
    jcfg = jspark.default_config(hidden_size=64, num_layers=1, dtype=jnp.float32)
    want = topt.flatten(jinit.spark_from_text(sd, bridge.params_to_numpy(fresh), jcfg))
    got = topt.flatten(tr.state.params)
    assert want.keys() == got.keys()
    for path, w in want.items():
        np.testing.assert_array_equal(got[path].numpy(), np.asarray(w), err_msg=path)
    np.testing.assert_array_equal(got["text_embedder"].numpy(), sd["model.embeddings.weight"])

    with pytest.raises(SystemExit):
        cli.main(args + ["--mark-phonemes-prob", "0.3"])
