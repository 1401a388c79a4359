"""The SFM flow's training slice, port vs JAX package, on the CPU: the SFM
collator (precomputed mel and mel from audio), ``flow.cfm_loss`` and
``flow.sfm_loss`` fed the draws of JAX's ``jax.random.split(key, 3)``
(loss, the SFM terms, every gradient), and the ``sfm_flow`` task's adapter
(``trainer.LOSS_FNS``): its tokens, and its loss = ``sfm_loss`` on the
trainer's generator.

A tiny flow (the Cosy pool tests' widths: conformer 24 wide, estimator 16
channels, 16 mel bins) with an SFM head, f32, one set of weights from a
numpy seed through ``bridge.codec_params_from_numpy``. Tolerances: mel 1e-5,
losses 1e-4 relative (f32 and f64), gradients in f64 1e-4 relative to each
leaf's largest (exactly zero where JAX's is zero; 1e-9 of the largest
gradient for a leaf whose gradient is zero but for rounding), other
collated arrays exact."""
import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rwkvtts_tpu.codecs import conformer as jconformer
from rwkvtts_tpu.codecs import flow as jflow
from rwkvtts_tpu.data import sfm_collator as jsfc
from rwkvtts_tpu.train import trainer as jtrainer
from rwkvtts_torch import bridge
from rwkvtts_torch.codecs import conformer, flow
from rwkvtts_torch.data import sfm_collator
from rwkvtts_torch.train import optimizer as topt
from rwkvtts_torch.train import trainer

torch.set_num_threads(2)

ENC = dict(input_size=24, output_size=24, attention_heads=2, linear_units=48, num_blocks=1,
           num_up_blocks=1)
EST = dict(in_channels=16 * 4, out_channels=16, channels=(16,), n_blocks=1, num_mid_blocks=1,
           num_heads=2, attention_head_dim=8, static_chunk_size=2)
FLOW = dict(input_size=24, output_size=16, spk_embed_dim=12, vocab_size=6562, n_timesteps=2)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _flow():
    """(JAX config, port config, JAX tree as numpy, port tree): weights at
    1/sqrt(fan-in), gains near 1, vectors small, from a numpy seed."""
    jcfg = jflow.FlowConfig(encoder=jconformer.UpsampleConformerConfig(**ENC),
                            estimator=jflow.EstimatorConfig(**EST), sfm=True, **FLOW)
    tcfg = flow.FlowConfig(encoder=conformer.UpsampleConformerConfig(**ENC),
                           estimator=flow.EstimatorConfig(**EST), sfm=True, **FLOW)
    rng = np.random.default_rng(50)

    def leaf(path, sd):
        x = rng.standard_normal(sd.shape)
        if getattr(path[-1], "key", "") in ("g", "var"):
            x = 1.0 + 0.1 * np.abs(x)
        elif sd.ndim == 1:
            x = 0.1 * x
        else:
            x = x / np.sqrt(max(1, int(np.prod(sd.shape[:-1]))))
        return x.astype(np.float32)

    shapes = jax.eval_shape(lambda k: jflow.init_params(k, jcfg), jax.random.PRNGKey(0))
    npp = jax.tree_util.tree_map_with_path(leaf, shapes)
    return jcfg, tcfg, npp, bridge.codec_params_from_numpy(npp)


def _batch(seed, B=3, Tt=8):
    """tokens / token_mask (B, Tt), the mel x1 (B, 2 Tt, 16) with its mask,
    one row shorter, x-vectors (B, 12)."""
    rng = np.random.default_rng(seed)
    n_valid = np.array([Tt, Tt - 3, Tt - 1])[:B]
    tmask = (np.arange(Tt)[None] < n_valid[:, None]).astype(np.float32)
    fmask = np.repeat(tmask, 2, 1)
    return {"tokens": rng.integers(0, 6561, (B, Tt)), "token_mask": tmask,
            "feat": (rng.standard_normal((B, 2 * Tt, 16)) * fmask[..., None]).astype(np.float32),
            "feat_mask": fmask, "embedding": rng.standard_normal((B, 12)).astype(np.float32)}


def _port_grads(fn, tp):
    """fn(tree) -> (loss, aux); the loss, aux and {path: grad or None}."""
    leaves = {p: t.clone().requires_grad_() for p, t in topt.flatten(tp).items()}
    loss, aux = fn(topt.unflatten(leaves, like=tp))
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss, aux, dict(zip(leaves, grads))


def _check_grads(got, want_tree, what):
    """Every gradient within 1e-4 of its leaf's largest, or, for a leaf
    whose gradient is zero but for rounding (the attention key biases:
    softmax ignores a shift of all scores), within 1e-9 of the tree's
    largest gradient."""
    want = topt.flatten(bridge.params_to_numpy(bridge.codec_params_from_numpy(want_tree)))
    assert got.keys() == want.keys(), what
    top = max(np.abs(w).max() for w in want.values())
    for path, g in got.items():
        w = want[path]
        if g is None or not np.abs(w).max():
            assert not np.abs(w).max() and (g is None or not g.abs().max()), (what, path)
        else:
            err = np.abs(g.numpy() - w).max()
            assert err <= 1e-4 * max(np.abs(w).max(), 1e-5 * top), (what, path, err, top)


def test_sfm_collator_matches_jax():
    """Rows with a precomputed mel and rows with 24 kHz audio (the port's
    log_mel_hifigan), a long row cut at pad_tokens_to, a short x-vector:
    tokens, masks and embeddings equal to JAX's, the mel within 1e-5."""
    rng = np.random.default_rng(51)
    rows = [{"speech_token": rng.integers(0, 6561, 12).tolist(),
             "speech_feat": rng.standard_normal((24, 80)).tolist(),
             "embedding": rng.standard_normal(192).tolist()},
            {"speech_token": rng.integers(0, 6561, 9).tolist(),
             "audio": (0.1 * rng.standard_normal(480 * 20)).tolist()},
            {"speech_token": rng.integers(0, 6561, 30).tolist(),
             "audio": (0.1 * rng.standard_normal(480 * 50)).tolist(),
             "embedding": rng.standard_normal(200).tolist()}]
    for pad in (None, 16):
        got = sfm_collator.collate(rows, pad_tokens_to=pad)
        want = jsfc.collate(rows, pad_tokens_to=pad)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            if k == "feat":
                np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5)
            else:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["feat_mask"][1].sum() == 18 and got["feat"][1, 18:].max() == 0


def _losses(jp, tp, jcfg, tcfg, b, dtype, seeds, grads=True):
    """For each seed: cfm_loss on the estimator and sfm_loss on the flow,
    JAX's on its key and the port's fed the same draws, in `dtype` on both
    sides (float64 under jax.enable_x64), with the gradients (JAX's
    value_and_grad, the port's autograd) or without. Yields (what, seed,
    JAX (loss, aux[, grads]), port (loss, aux[, grads]), the CFG keep
    mask)."""
    B, T = b["feat"].shape[:2]
    cast = lambda a: np.asarray(a, dtype) if np.asarray(a).dtype.kind == "f" else np.asarray(a)
    rng = np.random.default_rng(53)
    mu, cond, spks = (cast(rng.standard_normal(s)) for s in ((B, T, 16), (B, T, 16), (B, 16)))
    jb = {k: jnp.asarray(cast(v)) for k, v in b.items()}
    tb = {k: torch.from_numpy(cast(v)) for k, v in b.items()}
    jp = jax.tree.map(lambda a: jnp.asarray(cast(a)), jp)
    tp = topt.unflatten({p: t.to(getattr(torch, np.dtype(dtype).name))
                         for p, t in topt.flatten(tp).items()}, like=tp)
    args = ("tokens", "token_mask", "feat", "feat_mask", "embedding")
    with_grad = (lambda f: jax.value_and_grad(f, has_aux=True)) if grads else (
        lambda f: lambda *a: (f(*a), None))
    cfm_grad = jax.jit(with_grad(
        lambda p, key: jflow.cfm_loss(p, jcfg.estimator, jcfg.cfm, key, jb["feat"],
                                      jb["feat_mask"], jnp.asarray(mu), jnp.asarray(spks),
                                      jnp.asarray(cond))))
    sfm_grad = jax.jit(with_grad(
        lambda p, key: jflow.sfm_loss(p, jcfg, key, *(jb[k] for k in args))))
    # traced here, the two compiled at once on threads (XLA compiles outside the GIL)
    key0 = jax.random.PRNGKey(seeds[0])
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        cfm_grad, sfm_grad = [f.result() for f in [
            ex.submit(lo.compile) for lo in (cfm_grad.lower(jp["estimator"], key0),
                                              sfm_grad.lower(jp, key0))]]
    port_fn = _port_grads if grads else lambda fn, tree: (*fn(tree), None)
    as_t = lambda a: torch.from_numpy(np.array(a))
    for seed in seeds:
        key = jax.random.PRNGKey(seed)
        k1, k2, k3 = jax.random.split(key, 3)
        keep = np.asarray(jax.random.uniform(k3, (B,))) > jcfg.cfm.training_cfg_rate
        (loss, y), grads = cfm_grad(jp["estimator"], key)
        port = port_fn(lambda p: flow.cfm_loss(
            p, tcfg.estimator, tcfg.cfm, tb["feat"], tb["feat_mask"], as_t(mu), as_t(spks),
            as_t(cond), t=as_t(jax.random.uniform(k1, (B, 1, 1))),
            z=as_t(jax.random.normal(k2, b["feat"].shape)), keep=as_t(keep)), tp["estimator"])
        yield "cfm", seed, (loss, y, grads), port, keep
        (loss, terms), grads = sfm_grad(jp, key)
        port = port_fn(lambda p: flow.sfm_loss(
            p, tcfg, *(tb[k] for k in args), x0=as_t(jax.random.normal(k1, b["feat"].shape)),
            t_u=as_t(jax.random.uniform(k2, (B, 1, 1))), keep=as_t(keep)), tp)
        yield "sfm", seed, (loss, terms, grads), port, keep


def test_cfm_and_sfm_losses_match_jax():
    """Named checks: cfm_loss on the estimator alone (cosine t, CFG drop at
    the training rate 0.2) and sfm_loss on the whole SFM flow, each fed
    JAX's draws, with and without the CFG drop hitting a row: in f32 the
    loss (and the five SFM terms) within 1e-4; in f64 also every gradient
    within 1e-4. (In f32 the estimator's time embedding, sin(1000 t), turns
    one-ulp differences of t into ~1e-4 of its gradients, on either side.)
    Then the sfm_flow adapter: tokens = the valid mel frames, loss =
    sfm_loss on the same generator."""
    jcfg, tcfg, npp, tp = _flow()
    assert jcfg.cfm.t_scheduler == "cosine"
    assert flow.TRAINING_CFG_RATE == jcfg.cfm.training_cfg_rate
    b = _batch(52)
    dropped = set()
    for j, t, keep in ((j, t, keep) for what, seed, j, t, keep in
                       _losses(npp, tp, jcfg, tcfg, b, np.float32, (1, 2, 8), grads=False)):
        dropped.add(bool((~keep).any()))
        assert _rel(t[0].item(), float(j[0])) <= 1e-4
        if isinstance(j[1], dict):
            assert t[1].keys() == j[1].keys()
            for name, v in t[1].items():
                assert _rel(v.item(), float(j[1][name])) <= 1e-4, name
        else:
            assert _rel(t[1].detach().numpy(), np.asarray(j[1])) <= 1e-5
    assert dropped == {True, False}
    dropped = set()
    with jax.enable_x64(True):
        for what, seed, j, t, keep in _losses(npp, tp, jcfg, tcfg, b, np.float64, (1, 3)):
            dropped.add(bool((~keep).any()))
            assert _rel(t[0].item(), float(j[0])) <= 1e-4, (what, seed)
            _check_grads(t[2], jax.tree.map(np.asarray, j[2]), f"{what} {seed}")
    assert dropped == {True, False}

    jp = jax.tree.map(jnp.asarray, npp)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    # the JAX adapter is sfm_loss on the rng it is given; the port's on its
    # generator (the JAX adapter as one compiled program: op by op, each of its
    # primitives would compile on its own)
    adapter = jax.jit(lambda p, batch, key: jtrainer.LOSS_FNS["sfm_flow"](p, jcfg, batch, key))
    total_j, n_j = adapter(jp, b, jax.random.PRNGKey(1))
    assert np.isfinite(float(total_j))
    loss, n = trainer.LOSS_FNS["sfm_flow"](tp, tcfg, tb, torch.Generator().manual_seed(3))
    want, _ = flow.sfm_loss(tp, tcfg, *(tb[k] for k in ("tokens", "token_mask", "feat",
                                                        "feat_mask", "embedding")),
                            generator=torch.Generator().manual_seed(3))
    assert int(n) == int(n_j) == int(b["feat_mask"].sum()) and n.dtype == torch.int32
    assert loss.item() == want.item() and np.isfinite(loss.item())
