"""The training slice of the port vs the JAX package, on the CPU: the fused
linear CE, the optimizer groups and AdamW, the Spark loss and every
gradient end to end (fused prep on and off, padded and packed), the
non-finite skip, checkpoints and resume, the data and tokenizer copies,
and the train CLI."""
import filecmp
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rwkvtts_tpu.data import jsonl_dataset as jds
from rwkvtts_tpu.data import spark_collator as jsc
from rwkvtts_tpu.models import spark as jspark
from rwkvtts_tpu.ops import loss as jloss
from rwkvtts_tpu.parallel.train_step import spark_loss_fn as jspark_loss_fn
from rwkvtts_tpu.train import optimizer as jopt
from rwkvtts_tpu.utils import tokenizer as jtokenizer
from rwkvtts_torch import bridge
from rwkvtts_torch.data import jsonl_dataset as tds
from rwkvtts_torch.data import spark_collator as tsc
from rwkvtts_torch.models import spark as tspark
from rwkvtts_torch.ops import loss as tloss
from rwkvtts_torch.parallel import train_step as tts
from rwkvtts_torch.train import checkpoint as tckpt
from rwkvtts_torch.train import cli as tcli
from rwkvtts_torch.train import optimizer as topt
from rwkvtts_torch.train import trainer as ttrainer
from rwkvtts_torch.utils import tokenizer as ttokenizer

from test_torch_asr import _compiled

torch.set_num_threads(2)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _flat(tree):
    """{path: numpy} of a JAX (numpy) or port (tensor) parameter tree."""
    if any(torch.is_tensor(v) for v in topt.flatten(tree).values()):
        tree = bridge.params_to_numpy(tree)
    return {p: np.asarray(v) for p, v in topt.flatten(tree).items()}


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shift,l2_wrap,smoothing,normalize_length", [
    (True, 0.0, 0.0, True), (True, 1e-4, 0.0, True), (False, 0.0, 0.1, True),
    (True, 1e-4, 0.1, False)])
def test_fused_linear_ce_matches_jax(shift, l2_wrap, smoothing, normalize_length):
    """Loss, n_valid and the gradients w.r.t. hidden and the head, chunked
    with a ragged last chunk, within 1e-5 of the JAX loss."""
    rng = np.random.default_rng(0)
    B, T, C, V = 3, 11, 16, 37
    h = rng.standard_normal((B, T, C)).astype(np.float32)
    w = rng.standard_normal((C, V)).astype(np.float32)
    labels = rng.integers(0, V, (B, T)).astype(np.int32)
    labels[rng.random((B, T)) < 0.3] = -100
    kw = dict(shift=shift, l2_wrap=l2_wrap, smoothing=smoothing,
              normalize_length=normalize_length, chunk=7)
    (lj, nj), gj = jax.value_and_grad(
        lambda h_, w_: jloss.fused_linear_cross_entropy(h_, w_, jnp.asarray(labels), **kw),
        argnums=(0, 1), has_aux=True)(jnp.asarray(h), jnp.asarray(w))
    ht, wt = torch.tensor(h, requires_grad=True), torch.tensor(w, requires_grad=True)
    lt, nt = tloss.fused_linear_cross_entropy(ht, wt, torch.from_numpy(labels), **kw)
    gt = torch.autograd.grad(lt, (ht, wt))
    assert int(nt) == int(nj)
    assert abs(lt.item() - float(lj)) <= 1e-5 * abs(float(lj))
    for a, b in zip(gt, gj):
        assert _rel(a.numpy(), b) <= 1e-5


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((4, 9, 50)).astype(np.float32)
    labels = rng.integers(0, 50, (4, 9))
    labels[0, :3] = -100
    lj, nj = jloss.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    lt, nt = tloss.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    assert int(nt) == int(nj) and abs(float(lt) - float(lj)) <= 1e-6


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------


# JAX's init as one compiled program (op by op it compiles each random op)
_jinit = jax.jit(jspark.init_params, static_argnums=1)


def _tiny_spark_params(seed=0, hidden=64, layers=2):
    jcfg = jspark.default_config(hidden_size=hidden, num_layers=layers, dtype=jnp.float32)
    return jax.tree.map(np.asarray, _jinit(jax.random.PRNGKey(seed), jcfg))


def test_group_labels_match_jax():
    params = _tiny_spark_params()
    want = _flat(jax.tree.map(lambda s: np.asarray(s == "decay") * 1 + np.asarray(s == "lr2x") * 2,
                              jopt.group_labels(params)))
    got = topt.group_labels(bridge.params_from_numpy(params))
    code = {"nodecay": 0, "decay": 1, "lr2x": 2}
    assert got.keys() == want.keys()
    assert {p: code[g] for p, g in got.items()} == {p: int(v) for p, v in want.items()}
    assert got["blocks/att/w0"] == "lr2x" and got["blocks/att/w1"] == "nodecay"
    assert got["blocks/att/receptance"] == "decay" and got["text_embedder"] == "decay"


def test_adamw_matches_optax_over_three_steps():
    """Given identical gradients, three updates of build_optimizer (clip,
    warmup then cosine, three groups) and of the port's AdamW give the
    same parameters and Adam moments, within 1e-6."""
    params = _tiny_spark_params(1)
    kw = dict(peak_lr=1e-3, final_lr=1e-4, warmup_steps=1, total_steps=4,
              weight_decay=0.1, grad_clip=1.0)
    tx = jopt.build_optimizer(params, **kw)
    jp = jax.tree.map(jnp.asarray, params)
    js = tx.init(jp)
    update = jax.jit(lambda g, s, p: (lambda u, s2: (optax.apply_updates(p, u), s2))(
        *tx.update(g, s, p)))  # one compiled update, not one program an op
    tp = bridge.params_from_numpy(params)
    opt = topt.AdamW(tp, **kw)
    ts_ = opt.init(tp)
    rng = np.random.default_rng(2)
    for scale in (1.0, 1e-3, 0.05):  # clipped, not clipped, clipped
        grads = jax.tree.map(lambda p: (scale * rng.standard_normal(p.shape)).astype(np.float32),
                             params)
        jp, js = update(jax.tree.map(jnp.asarray, grads), js, jp)
        tg = {p: torch.from_numpy(g) for p, g in _flat(grads).items()}
        opt.step(tp, tg, ts_, torch.tensor(True), topt.global_norm(tg.values()))
        want, got = _flat(jax.tree.map(np.asarray, jp)), _flat(tp)
        for path in want:
            np.testing.assert_allclose(got[path], want[path], rtol=1e-6, atol=1e-7,
                                       err_msg=path)
    moved = bridge.adam_state_from_optax(js)
    assert int(moved["count"]) == int(ts_["count"]) == 3
    for key in ("mu", "nu"):
        assert moved[key].keys() == ts_[key].keys()
        for path, t in ts_[key].items():
            assert _rel(t.numpy(), moved[key][path].numpy()) <= 1e-6, f"{key} {path}"


# ---------------------------------------------------------------------------
# The Spark loss and every gradient, port vs JAX
# ---------------------------------------------------------------------------


def _rows(seed, n, n_sem=40):
    rng = np.random.default_rng(seed)
    return [{"text": f"row {i} says héllo 你好 {rng.integers(0, 1000)}",
             "global_tokens": rng.integers(0, 4096, 32).tolist(),
             "semantic_tokens": rng.integers(0, 8192, n_sem + 3 * i).tolist()}
            for i in range(n)]


def _randomize(params, rng):
    """Make the zero-initialised lora-in, output and FFN value matrices
    nonzero (as chip_smoke.randomize does), so every gradient is exercised."""
    att, ffn = params["blocks"]["att"], params["blocks"]["ffn"]
    for tree, name in [(att, n) for n in ("w1", "a1", "v1", "g1", "output")] + [(ffn, "value")]:
        shape = tree[name].shape
        tree[name] = (rng.standard_normal(shape) * shape[-2] ** -0.5).astype(np.float32)


@pytest.fixture(scope="module")
def spark_slice():
    """Hidden 128 x 2 layers, f32, dropout 0: JAX weights (zero matrices
    randomised), a padded and a packed batch, and JAX's loss and gradients
    (jax.value_and_grad of spark_loss_fn) for each."""
    jcfg = jspark.default_config(hidden_size=128, num_layers=2, dtype=jnp.float32,
                                 dropout=0.0)
    params = jax.tree.map(np.array, _jinit(jax.random.PRNGKey(4), jcfg))
    _randomize(params, np.random.default_rng(5))
    collate = functools.partial(tsc.collate_plain, tokenizer=ttokenizer.get_world_tokenizer(),
                                eos_id=8192)
    rows = _rows(6, 2)
    batches = {"padded": collate(rows, pad_to=128), "packed": collate(rows, pad_to=192,
                                                                     packed=True)}
    jp = jax.tree.map(jnp.asarray, params)
    grad_fn = jax.jit(jax.value_and_grad(lambda p, b: jspark_loss_fn(p, jcfg, b, None),
                                         has_aux=True))
    jbs = {name: {k: jnp.asarray(v) for k, v in batch.items()} for name, batch in batches.items()}
    programs = _compiled({name: (grad_fn, (jp, jb)) for name, jb in jbs.items()})
    ref = {}
    for name, jb in jbs.items():
        (loss, n), grads = programs[name](jp, jb)
        ref[name] = (float(loss), int(n), _flat(jax.tree.map(np.asarray, grads)))
    return params, batches, ref


@pytest.mark.parametrize("layout", ["padded", "packed"])
@pytest.mark.parametrize("fuse", [True, False])
def test_spark_loss_and_grads_match_jax(spark_slice, layout, fuse):
    """Loss and the gradient of every parameter within 1e-4 of JAX's, with
    the port's wkv_fuse_prep on and off (rematerialised blocks)."""
    params, batches, ref = spark_slice
    loss_j, n_j, grads_j = ref[layout]
    cfg = tspark.default_config(hidden_size=128, num_layers=2, dtype=torch.float32,
                                dropout=0.0, wkv_fuse_prep=fuse)
    flat = {p: torch.from_numpy(np.array(v)).requires_grad_()
            for p, v in _flat(params).items()}
    tree = topt.unflatten(flat)
    batch = {k: torch.as_tensor(v) for k, v in batches[layout].items()}
    loss, n = tts.spark_loss_fn(tree, cfg, batch, None)
    grads = torch.autograd.grad(loss, list(flat.values()))
    assert int(n) == n_j
    assert abs(loss.item() - loss_j) <= 1e-4 * abs(loss_j)
    assert flat.keys() == grads_j.keys()
    for (path, _), g in zip(flat.items(), grads):
        want = grads_j[path]
        if np.abs(want).max() == 0:
            assert np.abs(g.numpy()).max() <= 1e-8, path
        else:
            assert _rel(g.numpy(), want) <= 1e-4, path


# ---------------------------------------------------------------------------
# The train step, checkpoints, resume
# ---------------------------------------------------------------------------


def _tiny_setup(seed=0):
    cfg = tspark.default_config(hidden_size=64, num_layers=2, dtype=torch.float32,
                                dropout=0.0, wkv_fuse_prep=True)
    params = tspark.init_params(torch.Generator().manual_seed(seed), cfg)
    collate = functools.partial(tsc.collate_plain, tokenizer=ttokenizer.get_world_tokenizer(),
                                eos_id=8192, pad_to=128)
    return cfg, params, collate


def test_nonfinite_step_changes_nothing_but_the_step():
    cfg, params, collate = _tiny_setup()
    opt = topt.AdamW(params, warmup_steps=0)
    state = tts.init_train_state(params, opt)
    batch = {k: torch.as_tensor(v) for k, v in collate(_rows(7, 2)).items()}
    step = tts.make_train_step(cfg, opt)
    state, m = step(state, batch, None)
    assert int(m["skipped"]) == 0 and int(state.opt_state["count"]) == 1
    before = {p: t.clone() for p, t in _flat_tensors(state).items()}

    def nan_loss(*args):
        loss, n = tts.spark_loss_fn(*args)
        return loss * float("nan"), n

    state, m = tts.make_train_step(cfg, opt, nan_loss)(state, batch, None)
    assert int(m["skipped"]) == 1 and not np.isfinite(float(m["loss"]))
    assert state.step == 2 and int(state.opt_state["count"]) == 1
    after = _flat_tensors(state)
    assert before.keys() == after.keys()
    for path, t in before.items():
        assert torch.equal(t, after[path]), path


def _flat_tensors(state):
    out = {f"params/{p}": t for p, t in topt.flatten(state.params).items()}
    for key in ("mu", "nu"):
        out.update({f"{key}/{p}": t for p, t in state.opt_state[key].items()})
    out["count"] = state.opt_state["count"]
    return out


class _Rows:
    """A JsonlDataset that asks the trainer to stop after `stop_after`
    batches (as the preemption signal handler does)."""

    def __init__(self, ds, trainer=None, stop_after=None):
        self.ds, self.trainer, self.stop_after = ds, trainer, stop_after
        self.calls = []

    def epoch(self, epoch, start_batch=0):
        self.calls.append((epoch, start_batch))
        for i, batch in enumerate(self.ds.epoch(epoch, start_batch), start=start_batch):
            if self.stop_after is not None and i + 1 == self.stop_after:
                self.trainer._preempted = True
            yield batch


def test_checkpoint_rotation_and_resume(tmp_path):
    """Saves keep the newest two step directories; a preempted run resumes
    at its data position (epoch, next batch) with the saved state."""
    cfg, params, collate = _tiny_setup(1)
    rows = _rows(8, 8)
    tcfg = ttrainer.TrainerConfig(run_dir=str(tmp_path), save_steps=1, log_every=1,
                                  warmup_steps=0)
    tr = ttrainer.Trainer(cfg, params, ttrainer.LOSS_FNS["spark"], tcfg, "cpu")
    data = _Rows(tds.JsonlDataset(rows, collate, 2), tr, stop_after=3)
    tr.fit(data)  # 3 of 4 batches, then the preemption checkpoint
    ckpt = tmp_path / "ckpt"
    assert sorted(os.listdir(ckpt)) == ["step_2", "step_3"]
    assert json.loads((ckpt / "step_3" / "meta.json").read_text()) == {"epoch": 0, "batch": 3}
    saved = {p: t.clone() for p, t in _flat_tensors(tr.state).items()}

    _, params2, _ = _tiny_setup(2)  # other weights: the resume must replace them
    tr2 = ttrainer.Trainer(cfg, params2, ttrainer.LOSS_FNS["spark"], tcfg, "cpu")
    assert tr2.maybe_resume()
    assert (tr2.start_epoch, tr2.start_batch, tr2.state.step) == (0, 3, 3)
    for path, t in _flat_tensors(tr2.state).items():
        assert torch.equal(t, saved[path]), path
    data2 = _Rows(tds.JsonlDataset(rows, collate, 2))
    tr2.fit(data2)
    assert data2.calls == [(0, 3)] and tr2.state.step == 4
    assert sorted(os.listdir(ckpt)) == ["step_3", "step_4"]
    state, meta = tckpt.restore(str(ckpt), tr2.state)
    assert meta == {"epoch": 1, "batch": 0} and state.step == 4
    recs = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2, 3, 4]
    assert all(np.isfinite(r["loss"]) for r in recs)


# ---------------------------------------------------------------------------
# Data and tokenizer copies
# ---------------------------------------------------------------------------


def test_vocabulary_copy_is_byte_identical():
    assert filecmp.cmp(jtokenizer.VOCAB_FILE, ttokenizer.VOCAB_FILE, shallow=False)


def test_tokenizer_matches_jax():
    texts = ["Hello, world!", "你好，世界。 RWKV-7 speaks 3 languages: こんにちは",
             "SPCT_3 then SPCT_12 mid-text SPCT_63", "", "tabs\tand\nnewlines  "]
    for n_spct in (0, 64):
        jt, tt = jtokenizer.get_world_tokenizer(n_spct), ttokenizer.get_world_tokenizer(n_spct)
        assert tt.vocab_size == jt.vocab_size
        for text in texts:
            ids = tt.encode(text)
            assert ids == jt.encode(text), text
            assert tt.decode(ids) == text


@pytest.mark.parametrize("packed", [False, True])
def test_collator_and_dataset_match_jax(packed):
    """Epoch order, the token budget, the start-batch resume and every
    collated array equal to the JAX package's on the same rows."""
    rows = _rows(9, 10)
    kw = dict(eos_id=8192, pad_to=512 if packed else 128, packed=packed)
    jc = functools.partial(jsc.collate_plain, tokenizer=jtokenizer.get_world_tokenizer(), **kw)
    tc = functools.partial(tsc.collate_plain, tokenizer=ttokenizer.get_world_tokenizer(), **kw)
    for max_tokens, start in ((None, 0), (90, 2)):
        jb = list(jds.JsonlDataset(rows, jc, 3, seed=4, max_tokens=max_tokens).epoch(1, start))
        tb = list(tds.JsonlDataset(rows, tc, 3, seed=4, max_tokens=max_tokens).epoch(1, start))
        assert len(tb) == len(jb) == 3 - start
        for a, b in zip(tb, jb):
            assert a.keys() == b.keys()
            for key in a:
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_jsonl_rows_match_jax(tmp_path):
    for i in range(2):
        (tmp_path / f"part{i}.jsonl").write_text(
            "\n".join(json.dumps(r) for r in _rows(10 + i, 5)) + "\n\n")
    pat = [str(tmp_path / "*.jsonl")]
    for shard, shards, max_rows in ((0, 1, None), (1, 3, None), (0, 2, 3)):
        assert (tds.load_jsonl_rows(pat, shard, shards, max_rows)
                == jds.load_jsonl_rows(pat, shard, shards, max_rows))


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def _cli_data(tmp_path):
    path = tmp_path / "rows.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in _rows(11, 4)) + "\n")
    return ["--task", "spark", "--data", str(path), "--hidden", "64", "--layers", "2",
            "--batch-size", "2", "--pad-to", "128"]


def test_cli_dry_run_and_fit_on_cpu(tmp_path):
    """--device cpu: a dry run takes one step; a fit takes the two steps of
    one epoch, logs both and saves its checkpoint; without the fused prep
    too."""
    base = _cli_data(tmp_path)
    tr = tcli.main(base + ["--device", "cpu", "--dry-run", "--run-dir", str(tmp_path / "dry")])
    assert tr.state.step == 1
    run = tmp_path / "fit"
    tr = tcli.main(base + ["--device", "cpu", "--run-dir", str(run), "--log-every", "1",
                           "--no-wkv-fuse-prep"])
    assert tr.state.step == 2 and not tr.model_cfg.backbone.wkv_fuse_prep
    recs = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2]
    assert abs(recs[0]["loss"] - np.log(8193)) < 0.5
    assert os.listdir(run / "ckpt") == ["step_2"]


def test_cli_refuses_to_fall_back_to_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(_cli_data(tmp_path) + ["--dry-run", "--run-dir", str(tmp_path / "run")])
