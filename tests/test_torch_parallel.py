"""The port's multi-rank training on the CPU against the JAX package: the
mesh's sharding rules (parallel/mesh.py) against JAX's, the dp x fsdp train
step (parallel/train_step.py on a mesh) against JAX's single-device step,
the global loss denominators with ranks of unequal valid labels (the Cosy
and ASR losses), the low-memory optimizers and checkpoints under fsdp, and
the CLI's --mesh. The ranks are gloo processes spawned through
parallel/dryrun (a file store in tmp_path for the rendezvous); the JAX
references run here, in the parent."""
import concurrent.futures
import dataclasses
import functools
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from rwkvtts_tpu.models import asr as jasr
from rwkvtts_tpu.models import cosy as jcosy
from rwkvtts_tpu.models import spark as jspark
from rwkvtts_tpu.parallel import mesh as jmesh
from rwkvtts_tpu.parallel import train_step as jts
from rwkvtts_tpu.train import optimizer as jopt
from rwkvtts_torch import bridge
from rwkvtts_torch.data import cosy_collator
from rwkvtts_torch.models import cosy
from rwkvtts_torch.models import spark as tspark
from rwkvtts_torch.parallel import dryrun
from rwkvtts_torch.parallel import mesh as tmesh
from rwkvtts_torch.parallel import train_step as tts
from rwkvtts_torch.train import checkpoint as tckpt
from rwkvtts_torch.train import cli as tcli
from rwkvtts_torch.train import optimizer as topt
from rwkvtts_torch.utils.tokenizer import get_world_tokenizer

from test_torch_train_tasks import (_asr_configs, _jax_results, _optax_state, _rel, _task_rows,
                                    _weights)

torch.set_num_threads(2)

B1 = 0.9  # AdamW's b1: after one step mu = (1 - b1) g


@functools.lru_cache(maxsize=None)
def spark_setup(spans=1, chunk=16, hidden=64):
    """tests/test_parallel.py's configs and batches: Spark 64 x 2 (or
    `hidden` wide), head 16, f32, dropout 0; B x T = 8 x 32, or with spans
    4 x 64 with resets inside a span and at a span boundary. Returns (JAX
    config, port config, numpy weights of JAX's init, numpy batch)."""
    base = jspark.default_config(hidden_size=hidden, num_layers=2, head_size=16, gate_lora=32,
                                 dtype=jnp.float32, remat=False, wkv_chunk=chunk, dropout=0.0)
    jcfg = dataclasses.replace(base, backbone=dataclasses.replace(base.backbone,
                                                                  wkv_spans=spans))
    tcfg = tspark.default_config(hidden_size=hidden, num_layers=2, head_size=16, gate_lora=32,
                                 dtype=torch.float32, dropout=0.0, wkv_spans=spans)
    params = jax.tree.map(np.asarray, jax.jit(jspark.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg))
    B, T = (8, 32) if spans == 1 else (4, 64)
    k = jax.random.PRNGKey(1)
    batch = {
        "tokens": jax.random.randint(k, (B, T), 0, 1000),
        "modality": jnp.full((B, T), jspark.MOD_SEMANTIC, jnp.int32),
        "labels": jnp.where(jnp.arange(T)[None, :] > 2,
                            jax.random.randint(k, (B, T), 0, 8000), -100),
        "attention_mask": jnp.ones((B, T), jnp.int32),
    }
    if spans > 1:
        batch["resets"] = (jnp.arange(T)[None, :] % 32 == 16) & jnp.ones((B, 1), bool)
    return jcfg, tcfg, params, {k: np.asarray(v) for k, v in batch.items()}


OPT = dict(total_steps=10, grad_clip=None, warmup_steps=0)


def jax_step(jcfg, params, batch, steps=1, **opt):
    """JAX's single-device step(s) (make_train_step, build_optimizer with
    OPT and `opt`): (metrics of the last step, numpy params, the optimizer
    state after each step as {key: {path: numpy}}: mu and nu, or
    adafactor's v_row, v_col and v)."""
    tx = jopt.build_optimizer(params, **{**OPT, **opt})
    state = jts.init_train_state(jax.tree.map(jnp.asarray, params), tx)
    step = jts.make_train_step(jcfg, tx, donate=False)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    states = []
    for _ in range(steps):
        state, m = step(state, jb, jax.random.PRNGKey(9))
        # build_optimizer without a clip: the multi_transform alone
        moments, _ = _optax_state((None, state.opt_state))
        states.append({k: {p: np.asarray(t) for p, t in v.items()}
                       for k, v in moments.items()})
    return {k: float(v) for k, v in m.items()}, _flat(state.params), states


def _flat(tree):
    return {p: np.asarray(v) for p, v in topt.flatten(jax.tree.map(np.asarray, tree)).items()}


def run_mesh(tmp_path, mesh, cfg, params, batch, task="spark", **spec):
    """The port's step on `mesh`, gloo ranks spawned here; rank 0's result."""
    flat = {p: np.asarray(v) for p, v in topt.flatten(params).items()}
    tmp_path.mkdir(parents=True, exist_ok=True)
    out = str(tmp_path / "out")
    spec = {**dict(cfg=cfg, task=task, params=flat, batch=batch, mesh=mesh, device="cpu",
                   backend="gloo", init_method=f"file://{tmp_path}/store", optimizer=OPT,
                   timeout=60), **spec}
    return dryrun.spawn(int(np.prod(list(mesh.values()))), spec, out)


def check_against_jax(res, jm, jparams, jstate, loss_rtol=1e-4):
    """The mesh run's loss, grad norm, post-step parameters (rtol 2e-4,
    atol 2e-6, leaf by leaf) and first moments against JAX's."""
    jmu = jstate["mu"]
    m = res["metrics"][-1]
    assert m["skipped"] == 0 and m["tokens"] == jm["tokens"]
    np.testing.assert_allclose(m["loss"], jm["loss"], rtol=loss_rtol)
    np.testing.assert_allclose(m["grad_norm"], jm["grad_norm"], rtol=1e-3)
    assert res["params"].keys() == jparams.keys()
    for p, want in jparams.items():
        np.testing.assert_allclose(res["params"][p].numpy(), want, rtol=2e-4, atol=2e-6,
                                   err_msg=p)
    for p, want in jmu.items():
        got = res["opt_state"]["mu"][p].numpy()
        if np.abs(want).max() == 0:
            assert np.abs(got).max() <= 1e-12, p
        else:
            assert _rel(got, want) <= 1e-3, (p, _rel(got, want))


# ---------------------------------------------------------------------------
# The mesh and its rules
# ---------------------------------------------------------------------------


def test_param_specs_match_jax():
    """spec_for_path and the fitted param_specs equal JAX's on the tiny
    Spark tree at {dp 2, fsdp 2, tp 2} and on the 1.5B tree's shapes
    (jax.eval_shape); the layout shards the fsdp dimension of the
    trainable leaves only; tp and a mesh smaller than the world refuse."""
    sizes = {"dp": 2, "fsdp": 2, "tp": 2}
    _, _, small, _ = spark_setup()
    big = jax.eval_shape(lambda k: jspark.init_params(k, jspark.default_config(
        hidden_size=2048, num_layers=24)), jax.random.PRNGKey(0))
    for tree in (small, big):
        want = topt.flatten(jax.tree.map(tuple, jmesh.param_specs(tree, sizes),
                                         is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
        meta = jax.tree.map(lambda l: torch.empty(l.shape, device="meta"), tree)
        got = topt.flatten(tmesh.param_specs(meta, sizes))
        assert got == {p: tuple(v) for p, v in want.items()}
        for p in got:
            assert tmesh.spec_for_path(p) == tuple(jmesh.spec_for_path(p)), p
    # the vocabulary that no mesh divides stays replicated, as in JAX
    flat = topt.flatten(tmesh.param_specs(
        jax.tree.map(lambda l: torch.empty(l.shape, device="meta"), big), sizes))
    assert flat["head"] == (None, None) and flat["blocks/att/receptance"] == (None, "fsdp", "tp")
    assert tmesh.fsdp_dim(flat["blocks/att/output"]) == 2
    assert tmesh.fsdp_dim(flat["text_embedder"]) == 0 and tmesh.fsdp_dim(flat["ln0_scale"]) is None
    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        tmesh.make_mesh(tp=2)
    with pytest.raises(RuntimeError, match="not initialised"):
        tmesh.make_mesh(dp=2)


def test_dp_fsdp_step_and_checkpoint_match_jax(tmp_path):
    """dp=2 x fsdp=2 over 4 gloo ranks: loss, grad norm, post-step
    parameters and moments against JAX's single-device step; the fsdp
    shards are the leaves' halves along their spec's dimension; every rank
    launches the same steps. The checkpoint the mesh wrote restores in one
    process to the gathered tensors, bit for bit."""
    jcfg, tcfg, params, batch = spark_setup()
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        ranks = ex.submit(run_mesh, tmp_path, {"dp": 2, "fsdp": 2}, tcfg, params, batch,
                          save=str(tmp_path / "ckpt"))
        jm, jparams, jstates = jax_step(jcfg, params, batch)
        res = ranks.result()
    check_against_jax(res, jm, jparams, jstates[-1])
    assert res["layout"]["blocks/att/key"] == 1 and res["layout"]["blocks/att/output"] == 2
    assert res["layout"]["head"] is None and res["layout"]["blocks/att/x_r"] is None
    assert len(res["ranks"]) == 4

    like = tts.init_train_state(bridge.params_from_numpy(params),
                                topt.AdamW(bridge.params_from_numpy(params), **OPT))
    state, _ = tckpt.restore(str(tmp_path / "ckpt"), like)
    assert state.step == 1 and int(state.opt_state["count"]) == 1
    for p, t in topt.flatten(state.params).items():
        assert torch.equal(t, res["params"][p]), p
    for key in ("mu", "nu"):
        for p, t in state.opt_state[key].items():
            assert torch.equal(t, res["opt_state"][key][p]), (key, p)


# ---------------------------------------------------------------------------
# Denominators: ranks with unequal numbers of valid labels
# ---------------------------------------------------------------------------


def _asr_batch4(seed):
    """The discrete ASR variant's batch at 4 rows: the first two (rank 0's
    under dp=2) answer one label each, the last two five."""
    rng = np.random.default_rng(seed)
    B = 4
    b = {"text_ids": rng.integers(1, 100, (B, 4)), "text_mask": np.ones((B, 4), np.int32),
         "hints_ids": rng.integers(1, 100, (B, 2)), "hints_mask": np.ones((B, 2), np.int32),
         "labels_mask": np.array([[1, 0, 0, 0, 0]] * 2 + [[1] * 5] * 2, np.int32),
         "audio_ids": rng.integers(0, 64, (B, 6)),
         "audio_mask": np.array([[0, 0, 1, 1, 1, 1], [1] * 6, [1, 1, 1, 1, 0, 0], [1] * 6],
                                np.int32)}
    b["text_mask"][0, 0] = 0
    b["labels"] = np.where(b["labels_mask"] > 0, rng.integers(1, 100, (B, 5)), -100)
    return b


def test_global_denominators_with_unequal_ranks(tmp_path):
    """dp=2 where rank 0 holds far fewer valid labels than rank 1: the
    Cosy loss divided by the global B (length_normalized_loss off, label
    smoothing 0.1) and the ASR loss with its L2Wrap over the global B T,
    each one step on the mesh against JAX's loss, token count and every
    gradient (the first moment over 1 - b1), within 1e-4."""
    cases = []
    jcfg = dataclasses.replace(jcosy.default_config(hidden_size=128, num_layers=2,
                                                    dtype=jnp.float32, remat=False),
                               lsm_weight=0.1, length_normalized_loss=False)
    tcfg = dataclasses.replace(cosy.default_config(hidden_size=128, num_layers=2,
                                                   dtype=torch.float32),
                               lsm_weight=0.1, length_normalized_loss=False)
    rows = _task_rows("cosy", 13, 4)
    for r in rows[:2]:
        r["tts_speech_tokens"] = r["tts_speech_tokens"][:3]
    batch = cosy_collator.collate(rows, get_world_tokenizer(), 6561,
                                  rng=np.random.default_rng(0), drop_prompt_audio_rate=0.0,
                                  pad_to=96, packed=False)
    cases.append(("cosy", jcfg, tcfg) + _weights(jcosy.init_params, jcfg, 12) + (batch,))
    jcfg, tcfg = _asr_configs("discrete")
    cases.append(("asr", jcfg, tcfg)
                 + _weights(jasr.init_params, jcfg, 17, bridge.asr_params_from_numpy)
                 + (_asr_batch4(17),))
    valid = lambda b: [int((b["labels"][i] != -100).sum()) for i in range(4)]
    assert valid(cases[0][5])[:2] != valid(cases[0][5])[2:]
    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        runs = [ex.submit(run_mesh, tmp_path / c[0], {"dp": 2}, c[2], c[4], c[5], task=c[0])
                for c in cases]
        refs = _jax_results(cases, ex)
        for i, (task, _, tcfg, _, tp, batch) in enumerate(cases):
            res = runs[i].result()
            loss_j, n_j, grads_j = refs[i].result()
            m = res["metrics"][0]
            assert m["tokens"] == n_j, task
            assert abs(m["loss"] - loss_j) <= 1e-4 * abs(loss_j), (task, m["loss"], loss_j)
            to_port = bridge.asr_params_from_numpy if task == "asr" else bridge.params_from_numpy
            want = topt.flatten(bridge.params_to_numpy(to_port(grads_j)))
            mu = res["opt_state"]["mu"]
            assert mu.keys() <= want.keys()
            for p, g in mu.items():
                w = want[p]
                if not np.abs(w).max():
                    assert not np.abs(g.numpy()).max(), (task, p)
                else:
                    assert _rel(g.numpy() / (1 - B1), w) <= 1e-4, (task, p)
            frozen = [p for p in want if p not in mu]
            assert all(p.startswith("whisper/") for p in frozen), frozen


# ---------------------------------------------------------------------------
# The low-memory optimizers and resume under fsdp
# ---------------------------------------------------------------------------


def _port_step_saved(cfg, params, batch, low_memory, save):
    """The port's one-process step from `params`, its state saved; the
    state."""
    p = bridge.params_from_numpy(params)
    opt = topt.AdamW(p, **OPT, peak_lr=1e-3, low_memory=low_memory)
    state, m = tts.make_train_step(cfg, opt)(tts.init_train_state(p, opt),
                                             {k: torch.from_numpy(v) for k, v in batch.items()},
                                             None)
    assert int(m["skipped"]) == 0
    tckpt.save(save, state)
    return state


@pytest.mark.parametrize("low_memory", ["mu_bf16", "adafactor"])
def test_low_memory_optimizers_and_resume_under_fsdp(tmp_path, low_memory):
    """fsdp=2: the port's one-process checkpoint after one step resumes on
    the mesh, whose second step (the bf16 first moment; adafactor's
    factored rows and columns all-reduced or gathered over fsdp, its
    factors cut to each shard) is held against two JAX single-device steps
    in the same low_memory mode: loss (rtol 1e-4), grad norm (1e-3),
    parameters (rtol 2e-4 / atol 2e-6, leaf by leaf), the state's keys,
    shapes and dtypes as optax's, f32 moments (adafactor's v_row / v_col /
    v, Adam's nu) within 1e-4 and the bf16 mu within one bf16 step of the
    leaf's largest moment. As in the one-device optax check
    (test_torch_train_tasks), the gradients sum in another order, so a
    stored bf16 moment may round a bf16 step the other way (at <= 0.1 % of
    the tree's elements over the two steps); such an element's parameter
    is held within lr x 2^-6 a step. At width 128 adafactor factors the
    block matrices and the text embedding (a second-largest dimension of
    at least 128), each sharded along one of its factored dimensions."""
    jcfg, tcfg, params, batch = spark_setup(hidden=128)
    lr = 1e-3
    opt = dict(peak_lr=lr, low_memory=low_memory)
    one = _port_step_saved(tcfg, params, batch, low_memory, str(tmp_path / "one"))
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        ranks = ex.submit(run_mesh, tmp_path, {"fsdp": 2}, tcfg, params, batch,
                          restore=str(tmp_path / "one"), optimizer=dict(OPT, **opt))
        jm, jparams, jstates = jax_step(jcfg, params, batch, steps=2, **opt)
        res = ranks.result()
    m = res["metrics"][0]
    assert m["skipped"] == 0 and m["tokens"] == jm["tokens"]
    np.testing.assert_allclose(m["loss"], jm["loss"], rtol=1e-4)
    np.testing.assert_allclose(m["grad_norm"], jm["grad_norm"], rtol=1e-3)
    assert int(res["opt_state"]["count"]) == 2
    jstate = jstates[-1]
    assert set(jstate) == set(res["opt_state"]) - {"count"}
    flipped = {}  # mu_bf16: elements whose stored moment rounded the other way
    for key, leaves in jstate.items():
        assert leaves.keys() == res["opt_state"][key].keys(), key
        for p, want in leaves.items():
            got = res["opt_state"][key][p]
            assert tuple(got.shape) == want.shape and str(got.dtype)[6:] == str(want.dtype), \
                (key, p)
            got, want = got.float().numpy(), want.astype(np.float32)
            if key == "mu" and low_memory == "mu_bf16":
                assert np.abs(got - want).max() <= 2 ** -7 * np.abs(want).max(), (key, p)
                before = one.opt_state["mu"][p].float().numpy()
                flipped[p] = (got != want) | (before != jstates[0]["mu"][p].astype(np.float32))
            else:
                assert _rel(got, want) <= 1e-4, (key, p, _rel(got, want))
    if flipped:
        share = sum(f.sum() for f in flipped.values()) / sum(f.size for f in flipped.values())
        print(f"mu_bf16: {share:.2e} of the moments a bf16 step apart")
        assert share <= 1e-3, share
    assert res["params"].keys() == jparams.keys()
    for p, want in jparams.items():
        got = res["params"][p].numpy()
        off = flipped.get(p, np.zeros(want.shape, bool))
        if off.any():
            assert np.abs(got - want)[off].max() <= 2 * lr * 2 ** -6, p
            got, want = got[~off], want[~off]
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-6, err_msg=p)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def test_cli_mesh_flags_and_a_two_rank_dry_run(tmp_path, monkeypatch):
    """--mesh parsing and its refusals (an unknown axis, tp, spans that sp
    does not divide, --pad-to or a batch the mesh does not divide,
    --multihost outside torchrun), and under torchrun without --mesh (every
    rank on dp) a batch dp does not divide and --max-tokens-k; a --codec-dir
    batch that dp x fsdp does not divide raises; then two gloo ranks run the CLI's dry
    run at --mesh fsdp=2 on jsonl: the global batch's tokens are the
    one-process dry run's and its loss theirs but for the dropout masks,
    which each rank draws from its own generator; each rank holds half of
    each sharded leaf."""
    assert tcli.parse_mesh("dp=2,fsdp=2") == {"dp": 2, "fsdp": 2}
    # --codec-dir on a mesh: the rank's rows of the global batch alone are
    # collated (and tokenized)
    part = tcli.rank_rows(list, SimpleNamespace(rows=2, row_part=1))
    assert part([1, 2, 3, 4]) == [3, 4]
    with pytest.raises(ValueError, match="not divisible"):
        part([1, 2, 3])
    for bad in ("dp=2,xp=2", "dp=0", "fsdp=two"):
        with pytest.raises(ValueError):
            tcli.parse_mesh(bad)
    path = tmp_path / "rows.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in _task_rows("spark", 3, 4)) + "\n")
    base = ["--task", "spark", "--data", str(path), "--hidden", "64", "--layers", "1",
            "--batch-size", "4", "--pad-to", "128", "--device", "cpu", "--dry-run", "--no-bf16"]
    refused = [["--mesh", "dp=2,xp=2"], ["--mesh", "tp=2"], ["--mesh", "sp=2", "--wkv-spans", "3"],
               ["--mesh", "sp=3"], ["--mesh", "dp=3"], ["--mesh", "sp=2", "--task", "cosy"],
               ["--multihost"], ["--mesh", "dp=2"]]
    for flags in refused:
        with pytest.raises(SystemExit):
            tcli.main(base + flags + ["--run-dir", str(tmp_path / "r")])
    with monkeypatch.context() as env:  # torchrun's two ranks, refused before they join
        env.setenv("WORLD_SIZE", "2")
        for flags in (["--batch-size", "3"], ["--max-tokens-k", "1"]):
            with pytest.raises(SystemExit):
                tcli.main(base + flags + ["--run-dir", str(tmp_path / "r")])
    one = tcli.main(base + ["--run-dir", str(tmp_path / "one")])
    argv = base + ["--mesh", "fsdp=2", "--run-dir", str(tmp_path / "two")]
    mp.spawn(dryrun.cli_rank, args=(2, argv, str(tmp_path), f"file://{tmp_path}/store"),
             nprocs=2, join=True)
    ranks = [json.loads((tmp_path / f"cli_rank{r}.json").read_text()) for r in range(2)]
    for r in ranks:
        assert r["step"] == 1 and r["mesh"]["fsdp"] == 2
        # the same global batch; Spark's input dropout (0.02) draws per rank
        np.testing.assert_allclose(r["metrics"]["loss"], one.dry_run_metrics["loss"], rtol=1e-3)
        assert r["metrics"]["tokens"] == one.dry_run_metrics["tokens"]
        full = {p: list(t.shape) for p, t in topt.flatten(one.state.params).items()}
        assert r["shapes"]["blocks/att/key"][1] * 2 == full["blocks/att/key"][1]
        assert r["shapes"]["head"] == full["head"]
