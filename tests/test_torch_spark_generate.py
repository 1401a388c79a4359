"""The Spark slice end to end, port vs JAX package, on the CPU: the
prefill (JAX side through its Pallas WKV7 kernel in interpret mode) and
the B=64 generation loop (JAX side through its decode megakernel in
interpret mode; port side through the plain versions)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkvtts_tpu.infer import generate as jgen
from rwkvtts_tpu.models import spark as jspark
from rwkvtts_tpu.ops import decode_mega_b64 as jdmb
from rwkvtts_torch import bridge
from rwkvtts_torch.infer import generate as tgen
from rwkvtts_torch.models import spark as tspark
from rwkvtts_torch.ops import decode_mega_b64 as tdmb

torch.set_num_threads(2)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _configs(**jkw):
    jcfg = jspark.default_config(hidden_size=128, num_layers=2, dtype=jnp.float32,
                                 remat=False, **jkw)
    tcfg = tspark.default_config(hidden_size=128, num_layers=2, dtype=torch.float32)
    return jcfg, tcfg


def _prompt(B, T, seed, pad=True):
    """Left-padded random text prompts whose last position is the TAG."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 4000, (B, T))
    modality = np.full((B, T), jspark.MOD_TEXT)
    modality[:, -1] = jspark.MOD_TAG
    tokens[:, -1] = jspark.TAG_START_TTS
    mask = np.ones((B, T), np.int32)
    if pad:
        for b, n in enumerate(rng.integers(0, T // 2, B)):
            mask[b, :n] = 0
            modality[b, :n] = jspark.MOD_PAD
            tokens[b, :n] = 0
    return tokens, modality, mask


def test_prefill_matches_jax_pallas():
    """f32, hidden 128, 2 layers, left-padded: h_last and state within
    1e-4 of the JAX prefill, whose WKV7 runs its Pallas kernel."""
    jcfg, tcfg = _configs(wkv_impl="pallas", wkv_chunk=64)
    params = jax.tree.map(np.asarray, jspark.init_params(jax.random.PRNGKey(0), jcfg))
    tokens, modality, mask = _prompt(4, 20, seed=1)
    # one compiled program (op by op, each primitive would compile on its own)
    h_j, st_j = jax.jit(jspark.prefill, static_argnums=1)(
        jax.tree.map(jnp.asarray, params), jcfg, jnp.asarray(tokens), jnp.asarray(modality),
        jnp.asarray(mask))
    tp = bridge.params_from_numpy(params)
    h_t, st_t = tspark.prefill(tp, tcfg, torch.from_numpy(tokens),
                               torch.from_numpy(modality), torch.from_numpy(mask))
    assert _rel(h_t.numpy(), h_j) <= 1e-4
    for leaf in ("att_x", "wkv", "ffn_x"):
        assert _rel(st_t[leaf].numpy(), st_j[leaf]) <= 1e-4, leaf


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v if isinstance(v, np.ndarray) else v.numpy())
    return out


# leaves the init computes by formula (equal in both packages); the rest are drawn
_FORMULA = {"x_r", "x_w", "x_k", "x_v", "x_a", "x_g", "w0", "w1", "a0", "a1", "v0",
            "v1", "g1", "k_k", "k_a", "r_k", "output", "ln_x_scale", "ln_x_bias",
            "ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias", "ln0_scale", "ln0_bias",
            "ln_out_scale", "ln_out_bias"}


def test_init_params_match_jax_tree():
    """Same tree, shapes and dtype as the JAX init; formula leaves equal;
    drawn leaves follow the JAX distributions (orthogonal rows with the
    JAX gain, uniform bounds, normal scale)."""
    jcfg, tcfg = _configs()
    jp = _flat(jax.tree.map(np.asarray, jspark.init_params(jax.random.PRNGKey(0), jcfg)))
    tp = _flat(tspark.init_params(torch.Generator().manual_seed(0), tcfg))
    assert jp.keys() == tp.keys()
    C, V = 128, jcfg.backbone.vocab_size
    for name, want in jp.items():
        got = tp[name]
        assert got.shape == want.shape and got.dtype == np.float32, name
        leaf = name.split("/", 2)[-1] if name.startswith("blocks/") else name
        if leaf in _FORMULA or name.endswith("ffn/value"):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7, err_msg=name)
    for n in ("w2", "a2", "v2", "g2"):
        w = tp[f"blocks/att/{n}"]  # (L, D, C), rows orthonormal times 0.1
        gram = np.einsum("ldc,lec->lde", w, w)
        np.testing.assert_allclose(gram, np.broadcast_to(0.01 * np.eye(w.shape[1]), gram.shape),
                                   atol=1e-5, err_msg=n)
    head = tp["head"]  # (C, V): rows orthonormal times 0.5 sqrt(V / C)
    np.testing.assert_allclose(head @ head.T, 0.25 * V / C * np.eye(C), atol=1e-3)
    for name, bound in (("blocks/att/receptance", 0.5), ("blocks/att/key", 0.05),
                        ("blocks/att/value", 0.5), ("blocks/ffn/key", 0.5)):
        a = np.abs(tp[name]).max() * np.sqrt(C)
        assert 0.95 * bound < a <= bound, name
    assert np.abs(tp["embedding"]).max() <= 1e-4
    for name in ("text_embedder", "global_embedder", "tts_tag_embedder"):
        assert abs(tp[name].std() / 0.02 - 1) < (0.3 if name == "tts_tag_embedder" else 0.05), name


def test_embed_layout_matches_jax():
    jcfg, tcfg = _configs()
    params = jax.tree.map(np.asarray, jspark.init_params(jax.random.PRNGKey(3), jcfg))
    tokens, modality, _ = _prompt(3, 12, seed=2)
    modality[0, 3:6] = [jspark.MOD_GLOBAL, jspark.MOD_SEMANTIC, jspark.MOD_TAG]
    want = jspark.embed_layout(params, jcfg, jnp.asarray(tokens), jnp.asarray(modality))
    got = tspark.embed_layout(bridge.params_from_numpy(params), tcfg,
                              torch.from_numpy(tokens), torch.from_numpy(modality))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def generation_setup():
    jcfg, tcfg = _configs()
    params = jspark.init_params(jax.random.PRNGKey(0), jcfg)
    params["head"] = 10.0 * params["head"]  # greedy gaps dwarf int8 noise
    params = jax.tree.map(np.asarray, params)
    jmega = jdmb.pack_mega_b64(jax.tree.map(jnp.asarray, params), jcfg.backbone,
                               tile_n=128)
    spec = jmega.pop("spec")
    tp = bridge.params_from_numpy(params)
    tmega = tdmb.pack_mega_b64(tp, tcfg.backbone)
    prompt = _prompt(64, 8, seed=4)
    return jcfg, tcfg, params, jmega, spec, tp, tmega, prompt


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_generate_matches_jax(generation_setup, mode):
    """B=64, 8-token prompt, 4 new tokens. Greedy: tokens and lengths
    equal. Top-k 50 / top-p 0.95 with JAX's per-step Gumbel noise fed to
    the port: at least 98% of the (row, step) tokens equal."""
    jcfg, tcfg, params, jmega, spec, tp, tmega, prompt = generation_setup
    tokens, modality, mask = prompt
    T_new = 4
    top_k, top_p = (1, 1.0) if mode == "greedy" else (50, 0.95)
    key = jax.random.PRNGKey(5)
    toks_j, len_j = jgen.spark_generate_mega_b64(
        jax.tree.map(jnp.asarray, params), jmega, spec, jcfg,
        jnp.asarray(tokens), jnp.asarray(modality), jnp.asarray(mask), key,
        max_new_tokens=T_new, top_k=top_k, top_p=top_p,
    )
    width = top_k if mode == "sampled" else jcfg.backbone.vocab_size
    keys = jax.random.split(key, T_new)
    noise = np.stack([np.asarray(jax.random.gumbel(k, (64, width), jnp.float32))
                      for k in keys])
    toks_t, len_t = tgen.spark_generate_mega_b64(
        tp, tmega, tcfg, torch.from_numpy(tokens), torch.from_numpy(modality),
        torch.from_numpy(mask), max_new_tokens=T_new, top_k=top_k, top_p=top_p,
        noise=torch.from_numpy(noise),
    )
    toks_j, len_j = np.asarray(toks_j), np.asarray(len_j)
    if mode == "greedy":
        np.testing.assert_array_equal(toks_t.numpy(), toks_j)
        np.testing.assert_array_equal(len_t.numpy(), len_j)
    else:
        agree = float((toks_t.numpy() == toks_j).mean())
        assert agree >= 0.98, agree
