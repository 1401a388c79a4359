"""The training remat policies, the non-causal flow estimator and the
memorized decode, on the CPU: gradients of a tiny RWKV-7 under every
``remat_policy`` (and with remat off) against JAX's, and how often the WKV forward runs (L times under "wkv", 2 L under the
full replay); the non-causal estimator (GroupNorm(8) blocks, padding-1
convolutions) and a CFM solve on it against JAX's, and its importer
against JAX's on a synthetic state dict; and tests/test_convergence.py's
four memorized-decode cases against the port, trained once: greedy decode
reproduces the memorized tokens with fp, int8, int4 (group 16) weights and
a bf16 state carry."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from rwkvtts_tpu.codecs import cosy_import as jimport
from rwkvtts_tpu.codecs import flow as jflow
from rwkvtts_tpu.models import rwkv7 as jrwkv7
from test_torch_quant import O0
from rwkvtts_torch import bridge
from rwkvtts_torch.codecs import cosy_import, flow
from rwkvtts_torch.codecs import torch_import as ti
from rwkvtts_torch.data import spark_collator
from rwkvtts_torch.infer import generate as gen
from rwkvtts_torch.models import rwkv7, spark
from rwkvtts_torch.ops import wkv7 as wkv7_ops
from rwkvtts_torch.ops import wkv7_cuda
from rwkvtts_torch.parallel import train_step as ts
from rwkvtts_torch.train import optimizer as opt_lib

torch.set_num_threads(2)

C, L, HS, B, T = 64, 2, 16, 2, 20


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


class _CountProducts(TorchDispatchMode):
    """Counts the aten matrix products run under it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def model():
    """An RWKV-7 C x L (head HS) f32 as numpy, loras nonzero, with its
    inputs (embeddings, a pad mask, resets) and a fixed projection of the
    output: the loss is sum(forward(x) * proj)."""
    cfg = rwkv7.RWKV7Config(vocab_size=0, hidden_size=C, num_layers=L, head_size=HS,
                            gate_lora=16, dtype=torch.float32)
    params = bridge.params_to_numpy(rwkv7.init_params(torch.Generator().manual_seed(0), cfg))
    rng = np.random.default_rng(1)
    att, ffn = params["blocks"]["att"], params["blocks"]["ffn"]
    for tree, name in [(att, n) for n in ("w1", "a1", "v1", "g1", "output")] + [(ffn, "value")]:
        tree[name] = (0.3 * rng.standard_normal(tree[name].shape)).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    mask[1, :4] = 0
    resets = np.zeros((B, T), bool)
    resets[0, 9] = True
    inputs = {"x": rng.standard_normal((B, T, C)).astype(np.float32), "mask": mask,
              "resets": resets, "proj": rng.standard_normal((B, T, C)).astype(np.float32)}
    return params, inputs


@pytest.fixture(scope="module")
def jax_grads(model):
    """JAX's gradient of the loss (numpy, by path) at its default full
    replay. It stands for every policy and both prep settings: a JAX remat
    policy picks what the replay keeps, not the gradient; on the CPU JAX's
    "wkv" names (its Pallas path) do not occur, so every JAX policy replays
    the same program, and its wkv_fuse_prep takes effect only on a TPU."""
    params, inp = model
    cfg = jrwkv7.RWKV7Config(vocab_size=0, hidden_size=C, num_layers=L, head_size=HS,
                             gate_lora=16, dtype=jnp.float32, wkv_chunk=4)

    def loss(p, x, mask, resets, proj):
        h = jrwkv7.forward(p, cfg, inputs_embeds=x, attention_mask=mask, resets=resets)
        return jnp.sum(h * proj)

    grads = O0(jax.grad(loss))(jax.tree.map(jnp.asarray, params),
                                    *(jnp.asarray(inp[k]) for k in ("x", "mask", "resets",
                                                                    "proj")))
    return opt_lib.flatten(bridge.params_to_numpy(grads))


# (remat policy, "off" = cfg.remat False; the fused prep)
POLICIES = [(None, False), ("wkv", False), ("wkv", True), ("dots", False),
            ("dots_no_batch", False), ("off", False)]


@pytest.mark.parametrize("policy,fuse", POLICIES)
def test_remat_policy_gradients_match_jax(model, jax_grads, monkeypatch, policy, fuse):
    """Every gradient within 1e-5 of JAX's (relative to its leaf's
    largest); the WKV forward runs L times under
    "wkv" and with remat off, 2 L under the full replay and "dots"; "dots"
    replays without the forward's matrix products (fewer aten mm in the
    backward than the full replay's)."""
    params, inp = model
    cfg = rwkv7.RWKV7Config(vocab_size=0, hidden_size=C, num_layers=L, head_size=HS,
                            gate_lora=16, dtype=torch.float32, wkv_fuse_prep=fuse,
                            remat=policy != "off",
                            remat_policy=None if policy == "off" else policy)
    calls = []
    owner, name = (wkv7_cuda, "wkv7_fused") if fuse else (wkv7_ops, "wkv7")
    plain = getattr(owner, name)
    monkeypatch.setattr(owner, name, lambda *a, **k: calls.append(1) or plain(*a, **k))

    def port_grads(cfg):
        leaves = {p: torch.from_numpy(v).requires_grad_()
                  for p, v in opt_lib.flatten(params).items()}
        h = rwkv7.forward(opt_lib.unflatten(leaves, like=params), cfg,
                          inputs_embeds=torch.from_numpy(inp["x"]),
                          attention_mask=torch.from_numpy(inp["mask"]),
                          resets=torch.from_numpy(inp["resets"]))
        loss = (h * torch.from_numpy(inp["proj"])).sum()
        with _CountProducts() as products:
            grads = torch.autograd.grad(loss, list(leaves.values()))
        return dict(zip(leaves, (g.numpy() for g in grads))), products.n

    got, n_products = port_grads(cfg)
    assert len(calls) == (L if policy in ("wkv", "off") else 2 * L)
    want = jax_grads
    assert got.keys() == want.keys()
    for path, g in got.items():
        assert _rel(g, want[path]) <= 1e-5, path
    if policy in ("dots", "dots_no_batch"):
        _, n_full = port_grads(dataclasses.replace(cfg, remat_policy=None))
        assert n_products < n_full
    with pytest.raises(ValueError, match="remat_policy"):
        port_grads(dataclasses.replace(cfg, remat=True, remat_policy="bogus"))


# the tiny estimator of the Cosy pool tests, non-causal
EST = dict(in_channels=64, out_channels=16, channels=(16,), n_blocks=1, num_mid_blocks=1,
           num_heads=2, attention_head_dim=8, causal=False)


def _estimator_state_dict(rng):
    """A synthetic ConditionalDecoder state dict (the reference's key
    layout) of EST's widths: GroupNorm blocks (block.1), single-level
    convolution resamplers."""
    sd = {}
    td = EST["channels"][0] * 4

    def put(name, *shape):
        sd[name] = (rng.standard_normal(shape) / np.sqrt(max(1, np.prod(shape[1:])))
                    ).astype(np.float32)

    def linear(p, i, o, bias=True):
        put(f"{p}.weight", o, i)
        if bias:
            put(f"{p}.bias", o)

    def conv(p, i, o, k):
        put(f"{p}.weight", o, i, k)
        put(f"{p}.bias", o)

    def block(p, i, o):
        conv(f"{p}.block.0", i, o, 3)
        sd[f"{p}.block.1.weight"] = (1 + 0.1 * rng.standard_normal(o)).astype(np.float32)
        put(f"{p}.block.1.bias", o)

    def resnet(p, i, o):
        linear(f"{p}.mlp.1", td, o)
        block(f"{p}.block1", i, o)
        block(f"{p}.block2", o, o)
        conv(f"{p}.res_conv", i, o, 1)

    def transformer(p, d):
        inner = EST["num_heads"] * EST["attention_head_dim"]
        for n in ("norm1", "norm3"):
            sd[f"{p}.{n}.weight"] = np.ones(d, np.float32)
            put(f"{p}.{n}.bias", d)
        for n in ("to_q", "to_k", "to_v"):
            linear(f"{p}.attn1.{n}", d, inner, bias=False)
        linear(f"{p}.attn1.to_out.0", inner, d)
        linear(f"{p}.ff.net.0.proj", d, 4 * d)
        linear(f"{p}.ff.net.2", 4 * d, d)

    ch = EST["channels"][0]
    linear("time_mlp.linear_1", EST["in_channels"], td)
    linear("time_mlp.linear_2", td, td)
    for p, i in (("down_blocks.0", EST["in_channels"]), ("mid_blocks.0", ch),
                 ("up_blocks.0", 2 * ch)):
        resnet(f"{p}.0", i, ch)
        transformer(f"{p}.1.0", ch)
        if not p.startswith("mid"):
            conv(f"{p}.2", ch, ch, 3)
    block("final_block", ch, ch)
    conv("final_proj", ch, EST["out_channels"], 1)
    return sd


def test_non_causal_estimator_and_importer_match_jax():
    """The non-causal estimator (f32): the port's importer's tree equals
    the JAX importer's (through the bridge) on a synthetic state dict with
    GroupNorm blocks, estimator_apply on it within 1e-5 of JAX's with a
    masked tail, a 3-step CFM solve within 1e-5; the causal importer
    refuses a Downsample1D resampler as before; estimator_init of the
    non-causal config gives the GroupNorm tree."""
    rng = np.random.default_rng(3)
    sd = _estimator_state_dict(rng)
    jcfg, tcfg = jflow.EstimatorConfig(**EST), flow.EstimatorConfig(**EST)
    jtree = jimport.estimator_from_sd(sd, jcfg)
    tp = ti.tensors(cosy_import.estimator_from_sd(sd, tcfg))
    want = opt_lib.flatten(bridge.params_to_numpy(bridge.codec_params_from_numpy(jtree)))
    got = opt_lib.flatten(bridge.params_to_numpy(tp))
    assert got.keys() == want.keys() and any("/gn/" in k for k in got)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    Bn, Tn = 2, 12
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x, mu, cond, spks = f(Bn, Tn, 16), f(Bn, Tn, 16), f(Bn, Tn, 16), f(Bn, 16)
    mask = np.ones((Bn, Tn), np.float32)
    mask[1, 9:] = 0
    t = np.array([0.3, 0.7], np.float32)
    jp = jax.tree.map(jnp.asarray, jtree)
    args = (x, mask, mu, t, spks, cond)
    want = O0(lambda p, *a: jflow.estimator_apply(p, jcfg, *a))(jp, *map(jnp.asarray, args))
    got = flow.estimator_apply(tp, tcfg, *map(torch.from_numpy, args))
    assert _rel(got.numpy(), want) <= 1e-5
    cfm = flow.CFMConfig()
    want = O0(lambda p, *a: jflow.cfm_solve(p, jcfg, jflow.CFMConfig(), *a,
                                                 n_timesteps=3))(
        jp, *map(jnp.asarray, (x, mu, mask, spks, cond)))
    got = flow.cfm_solve(tp, tcfg, cfm, *map(torch.from_numpy, (x, mu, mask, spks, cond)),
                         n_timesteps=3)
    assert _rel(got.numpy(), want) <= 1e-5
    causal = dict(sd)
    causal["down_blocks.0.2.conv.weight"] = causal.pop("down_blocks.0.2.weight")
    with pytest.raises(NotImplementedError, match="Downsample1D"):
        cosy_import.estimator_from_sd(causal, tcfg)
    init = flow.estimator_init(torch.Generator().manual_seed(0), tcfg)
    assert set(init["final_block"]) == {"conv", "gn"}


class FakeTok:
    def encode(self, text):
        return [ord(c) % 200 + 1 for c in text][:12]


def test_memorized_decode_survives_quantization():
    """tests/test_convergence.py's protocol on the port, trained once: a
    tiny Spark (64 x 2, head 16, f32, no remat, no dropout) takes 300 AdamW
    steps (lr 3e-3 -> 3e-4, warmup 10) on one row repeated twice; the loss
    starts above 2 and ends below 0.2; then greedy decode (top-k 1, 20 new
    tokens) reproduces the memorized semantic tokens with the fp decode
    weights, int8, int4 (group 16) and a bf16 state carry. The text table
    has 256 rows, not 65,536: the fake tokenizer's ids are below 201, the
    other rows take no gradient, and the optimizer's pass over them
    would be most of the step on this CPU."""
    cfg = dataclasses.replace(
        spark.default_config(hidden_size=64, num_layers=2, head_size=16, gate_lora=16,
                             dtype=torch.float32, dropout=0.0, remat=False),
        text_vocab_size=256)
    params = spark.init_params(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(3)
    row = {"text": "memorize me", "global_tokens": rng.integers(0, 4096, 4).tolist(),
           "semantic_tokens": rng.integers(0, 100, 16).tolist()}
    tok = FakeTok()
    batch = spark_collator.collate_plain([row, row], tokenizer=tok, eos_id=cfg.eos_token_id,
                                         pad_to=48)
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    opt = opt_lib.AdamW(params, peak_lr=3e-3, final_lr=3e-4, warmup_steps=10, total_steps=300)
    state = ts.init_train_state(params, opt)
    step = ts.make_train_step(cfg, opt)
    losses = []
    for i in range(300):
        state, metrics = step(state, batch, None)
        if i % 50 == 0 or i == 299:
            losses.append(float(metrics["loss"]))
    assert losses[0] > 2.0 and losses[-1] < 0.2, losses

    pb = spark_collator.pad_prompts_left([spark_collator.build_prompt(
        tok.encode(row["text"]), row["global_tokens"])])
    args = [torch.from_numpy(np.asarray(pb[k])).long()
            for k in ("tokens", "modality", "attention_mask")]
    outs = {}
    for name, pack, state_bf16 in (("fp", {}, False), ("int8", dict(quantize_int8=True), False),
                                   ("int4", dict(quantize_int4=True, int4_group=16), False),
                                   ("bf16_state", {}, True)):
        c = dataclasses.replace(cfg, backbone=dataclasses.replace(
            cfg.backbone, decode_state_bf16=state_bf16))
        p = rwkv7.pack_decode_params(state.params, c.backbone, **pack)
        toks, lengths = gen.spark_generate(p, c, *args, max_new_tokens=20, top_k=1, top_p=1.0,
                                           temperature=1.0,
                                           generator=torch.Generator().manual_seed(2))
        outs[name] = toks[0, :int(lengths[0])].tolist()
    assert outs["fp"] == row["semantic_tokens"], outs
    assert outs["int8"] == outs["int4"] == outs["bf16_state"] == outs["fp"], outs
